"""What a traced window of a run reads from ``torch.profiler``.

The window is traced with the host and the device both recorded. It
opens with one lead step that is not counted: on the H100 the profiler
at times loses the first kernels of a trace. The counted window starts
at the host's clock (``time.time_ns``, the base the profiler's events
are given in) once the lead step has finished, and ends where the last
device operation ends. Device operations are the kernels, copies and
sets the profiler records on the card; ``busy_s`` is the length of the
union of their intervals inside the window.

Each idle gap between device operations is named by what the host was
doing at its middle: the benchmark's own annotation (``prefill.*``,
``decode.*``) and the innermost operation recorded inside it on that
thread, or ``host outside the step`` where no annotation is open.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["Trace", "breakdown", "is_kernel_of", "kernel_names",
           "read_profile"]

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_MEMORY = ("Memcpy", "Memset", "memcpy", "memset")


def kernel_names(source: str | Path) -> tuple[str, ...]:
    """The names of the ``__global__`` functions of a CUDA source."""
    return tuple(sorted(set(_GLOBAL.findall(Path(source).read_text()))))


def is_kernel_of(name: str, names: tuple[str, ...]) -> bool:
    """Whether the profiler's (demangled) kernel name is one of
    ``names``: ``void (anonymous namespace)::probe_kernel<false>(...)``,
    ``mlstm_combine_kernel(float*, ...)``."""
    return any(re.search(rf"(?:^|[\s:]){n}[<(]", name) for n in names)


@dataclass
class Trace:
    """A traced window: its device operations (name, start s, seconds)
    and what the window's steps were (``steps``, ``work``: the frozen
    operation counts, by part). Per-layer metrics read it."""
    window_s: float
    busy_s: float
    ops: list
    steps: int
    work: dict
    gaps: dict = field(default_factory=dict)

    @property
    def kernels(self) -> list:
        return [op for op in self.ops if not op[0].startswith(_MEMORY)]


def _ns(e, what: str) -> int:
    get = getattr(e, f"{what}_ns", None)
    return int(get()) if get is not None else int(getattr(e, f"{what}_us")()
                                                    * 1000)


def read_profile(prof, start_ns: int, *, steps: int,
                 work: dict, on_card: bool = True) -> Trace:
    """The traced window from ``start_ns``. Off the card (a CPU
    rehearsal) the host's operations stand for the device's."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        begin = _ns(e, "start")
        span = (begin, begin + _ns(e, "duration"), e.name())
        annotation = bool(e.is_user_annotation())
        if e.device_type() != DeviceType.CUDA:
            host.append(span + (e.start_thread_id(), annotation))
        if annotation or begin < start_ns:
            continue
        # the profiler also draws each annotation on the device's
        # timeline; it is no operation of the device
        if e.device_type() == DeviceType.CUDA or not on_card:
            device.append(span)
    marks = {h[2] for h in host if h[4]}
    device = [d for d in device if d[2] not in marks]
    if not device:
        raise RuntimeError("the profiler recorded no device operation in "
                           "the traced window")
    device.sort()
    end_ns = max(e for _, e, _ in device)
    busy, gaps, reach = 0, [], start_ns
    for b, e, _ in device:
        if b > reach:
            gaps.append((reach, b))
        if e > reach:
            busy += e - max(b, reach)
            reach = e
    names = _gap_names(gaps, host)
    named: dict = {}
    for (b, e), name in zip(gaps, names):
        named[name] = named.get(name, 0.0) + (e - b) / 1e9
    ops = [(name, (b - start_ns) / 1e9, (e - b) / 1e9) for b, e, name in device]
    return Trace(window_s=(end_ns - start_ns) / 1e9,
                 busy_s=busy / 1e9, ops=ops, steps=steps, work=work,
                 gaps=named)


def _gap_names(gaps: list, host: list) -> list:
    threads = {t for *_, t, ann in host if ann}
    events = sorted((h for h in host if h[3] in threads),
                    key=lambda h: (h[0], -h[1]))
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    names, stack, at = [None] * len(gaps), [], 0
    for i in order:
        mid = (gaps[i][0] + gaps[i][1]) // 2
        while at < len(events) and events[at][0] <= mid:
            stack.append(events[at])
            at += 1
        stack = [h for h in stack if h[1] >= mid]
        outer = next((h[2] for h in stack if h[4]), None)
        inner = stack[-1][2] if stack else None
        names[i] = (f"{outer} > {inner}" if outer and inner != outer
                    else outer or "host outside the step")
    return names


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle gaps by
    what the host was doing, seconds summed by name."""
    by: dict = {}
    for name, _, secs in trace.ops:
        by[name] = by.get(name, 0.0) + secs
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}
