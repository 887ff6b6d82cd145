"""Device time of the port's CUDA kernels, by name, from ``torch.profiler``.

A short kernel's time between two CUDA events over back-to-back calls is
the host's launch rate when a call takes longer to launch than to run.
:func:`device_ms` reads what the card itself spent in a source's
kernels instead: the profiler's device time of every kernel whose name
is one of the source's ``__global__`` functions, summed over ``reps``
calls and divided by ``reps``.

On the H100 the profiler at times loses the first kernels of a traced
window (in ``chip_smoke.py``, every time once the lakehouse engine has
run CUDA work on its worker threads, and now and then before). So a
window opens with ``lead`` calls that are not counted, then a marker
kernel (``torch.cuda._sleep``), then the ``reps`` calls that are: only
kernels that start after the marker ends count. The caller says how many
of the source's kernels one call launches, and a window counts only when
it shows that many times ``reps`` after the marker: a window whose
marker is lost, or that shows any other count (one that lost some of
its calls' kernels after the marker, say), is traced again with twice
the lead. There is no fallback to another clock: after ``attempts``
windows it raises. Card only; nothing here runs at import.

:func:`span_times` reads a profile by program layer instead of by
kernel: the device time and the idle time inside each span that
``obs.tracing()`` recorded while the profiler was on (each such span is
a profiler range, ``obs/trace.py``). A device operation belongs to every
span that was open on the thread that launched it, when it was
launched; the launch is found by the profiler's correlation id. Off the
card a host operation stands for itself.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass
from pathlib import Path

__all__ = ["kernel_names", "device_ms", "SpanTimes", "attribute",
           "span_times"]

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def kernel_names(source: str | Path) -> tuple[str, ...]:
    """The names of the ``__global__`` functions of a CUDA source."""
    return tuple(sorted(set(_GLOBAL.findall(Path(source).read_text()))))


def _is_kernel_of(key: str, names: tuple[str, ...]) -> bool:
    """Whether the profiler's (demangled) kernel name ``key`` is one of
    ``names``: ``void (anonymous namespace)::probe_kernel<false>(...)``,
    ``mlstm_combine_kernel(float*, ...)``."""
    return any(re.search(rf"(?:^|[\s:]){n}[<(]", key) for n in names)


_MARKER = "spin_kernel"           # the kernel of torch.cuda._sleep


def _window(fn, reps: int, lead: int) -> list | None:
    """(name, device us) of every device event that starts after the
    marker in one traced window of ``lead`` calls, the marker and
    ``reps`` calls; None when the marker was lost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            fn()
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [(e.time_range.start, e.time_range.elapsed_us(), e.name)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [start + us for start, us, name in events if _MARKER in name]
    if len(marks) != 1:
        return None
    return [(name, us) for start, us, name in events if start >= marks[0]]


def device_ms(fn, source: str | Path, *, launches: int, reps: int = 5,
              attempts: int = 6) -> dict:
    """Device time of one call of ``fn`` in the kernels of ``source``,
    which launches ``launches`` of them, after one warm-up call:
    ``{"device_ms", "device_launches", "device_other_ms",
    "device_windows"}``, with the launches of those kernels per call
    that the window showed, the device time per call of anything else
    the calls ran (memsets, PyTorch's kernels), and the windows
    traced."""
    import torch

    if launches < 1:
        raise ValueError(f"launches must be at least 1, not {launches}")
    names = kernel_names(source)
    fn()
    torch.cuda.synchronize()
    seen = None
    for window in range(1, attempts + 1):
        seen = _window(fn, reps, lead=reps << (window - 1))
        if seen is None:
            continue
        own = [us for name, us in seen if _is_kernel_of(name, names)]
        if len(own) == launches * reps:
            break
    else:
        raise RuntimeError(
            f"the profiler shows no window with {launches} launch(es) a "
            f"call of the kernels of {Path(source).name} "
            f"({', '.join(names)}) in {attempts} windows; the last saw "
            f"{seen}")
    other = sum(us for name, us in seen if not _is_kernel_of(name, names))
    return {"device_ms": sum(own) / reps / 1e3,
            "device_launches": len(own) / reps,
            "device_other_ms": other / reps / 1e3, "device_windows": window}


@dataclass
class SpanTimes:
    """By span name: ``device_s``, the length of the union of the device
    intervals of the operations launched inside it; ``idle_s``, the
    idle gaps of the device whose middle lies inside it. ``busy_s`` is
    the union of every device interval (seconds)."""
    device_s: dict
    idle_s: dict
    busy_s: float


def _merged(intervals) -> tuple[list, list]:
    """Sorted, overlapping intervals merged: (begins, ends)."""
    begins, ends = [], []
    for b, e in sorted(intervals):
        if ends and b <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            begins.append(b)
            ends.append(e)
    return begins, ends


def _inside(merged: tuple[list, list], t: int) -> bool:
    begins, ends = merged
    i = bisect.bisect_right(begins, t) - 1
    return i >= 0 and t <= ends[i]


def _union(intervals) -> int:
    return sum(e - b for b, e in zip(*_merged(intervals)))


def attribute(ranges, ops, start_ns: int) -> SpanTimes:
    """``ranges``: (name, thread, begin ns, end ns) of the spans;
    ``ops``: (begin ns, end ns, launching thread, launch ns) of the
    device operations. Operations that begin before ``start_ns`` are
    left out."""
    ops = sorted(op for op in ops if op[0] >= start_ns)
    if not ops:
        raise RuntimeError("no device operation after the window's start")
    names = sorted({r[0] for r in ranges})
    on_thread, anywhere = {}, {}
    for name, thread, b, e in ranges:
        on_thread.setdefault((name, thread), []).append((b, e))
        anywhere.setdefault(name, []).append((b, e))
    on_thread = {k: _merged(v) for k, v in on_thread.items()}
    anywhere = {k: _merged(v) for k, v in anywhere.items()}
    mine = {name: [] for name in names}
    gaps, reach = [], start_ns
    for b, e, thread, at in ops:
        for name in names:
            m = on_thread.get((name, thread))
            if m is not None and _inside(m, at):
                mine[name].append((b, e))
        if b > reach:
            gaps.append((reach, b))
        reach = max(reach, e)
    idle = {name: 0 for name in names}
    for b, e in gaps:
        for name in names:
            if _inside(anywhere[name], (b + e) // 2):
                idle[name] += e - b
    return SpanTimes(
        device_s={n: _union(v) / 1e9 for n, v in mine.items()},
        idle_s={n: v / 1e9 for n, v in idle.items()},
        busy_s=_union((b, e) for b, e, *_ in ops) / 1e9)


# the host's side of a launch, a call of the CUDA runtime (cuda*) or
# driver (cu*): its correlation id is the device operation's
_LAUNCH = "cu"


def span_times(prof, names, start_ns: int, *,
               on_card: bool = True) -> SpanTimes:
    """The spans ``names`` of a finished ``torch.profiler.profile``
    (recorded under ``obs.tracing()``) over the window from
    ``start_ns`` (``time.time_ns()``, the profiler's base). Off the card
    (a CPU rehearsal) each host operation stands for a device one,
    launched by itself."""
    from torch.autograd import DeviceType
    names = set(names)
    ranges, ops, launches, device = [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        b = e.start_ns()
        span = (b, b + e.duration_ns())
        if e.is_user_annotation():
            # the profiler also draws each range on the device's
            # timeline; it is no operation of the device
            if e.device_type() != DeviceType.CUDA and e.name() in names:
                ranges.append((e.name(), e.start_thread_id()) + span)
        elif e.device_type() == DeviceType.CUDA:
            device.append(span + (e.correlation_id(),))
        elif not on_card:
            ops.append(span + (e.start_thread_id(), b))
        elif e.name().startswith(_LAUNCH):
            launches[e.correlation_id()] = (e.start_thread_id(), b)
    for b, e, corr in device:
        ops.append((b, e) + launches.get(corr, (None, b)))
    return attribute(ranges, ops, start_ns)
