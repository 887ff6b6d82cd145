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
"""
from __future__ import annotations

import re
from pathlib import Path

__all__ = ["kernel_names", "device_ms"]

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
