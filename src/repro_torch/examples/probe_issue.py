"""Host time to issue one hash-probe call, on one GPU.

    PYTHONPATH=src python src/repro_torch/examples/probe_issue.py \\
        [--lanes 1500000] [--calls 20] [--rounds 50] [--label NAME]

Times the wrappers of ``repro_torch/kernels/hash_join/kernel.py``
(``hash_probe`` and ``masked_hash_probe``) as the host sees them:
``--calls`` back-to-back calls with no synchronization between them,
``--rounds`` times, on ``--lanes`` clustered lanes into a 2^23-slot
table. It prints the host time per call (median and least over the
rounds), the same calls between two CUDA events (as ``chip_smoke.py``'s
``kernel_only_ms``), and the host time of the wrapper's parts: its
checks, its two output allocations (and the lane split where the
wrapper has one), the stream lookup, the device guard, and the C call
that launches the kernel, alone.

It imports nothing of the port but that module, so another checkout's
wrapper is timed by putting that checkout's ``src`` first on
``PYTHONPATH`` and running this file by its path: time two wrappers in
one job on one machine, alternating, to compare them. Prints one JSON
object per wrapper and, last, one with the card's name and power limit
as ``nvidia-smi`` reports them. Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time


def per_call_us(fn, calls: int, rounds: int, sync) -> list[float]:
    """Host microseconds per call of ``fn`` over ``calls`` calls, one
    figure per round; the device is synchronized between rounds only."""
    out = []
    for _ in range(rounds):
        sync()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter_ns() - t0) / calls / 1e3)
    sync()
    return out


def summary(us: list[float]) -> dict:
    return {"median_us": statistics.median(us), "min_us": min(us)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=1_500_000)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("probe_issue: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.hash_join import kernel

    kernel.build()
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    t, n, dev = 1 << 23, args.lanes, torch.device("cuda", 0)
    ts = torch.randint(0, 1 << 20, (t,), generator=g, device=dev,
                       dtype=torch.int32)
    tc = torch.randint(0, 3, (t,), generator=g, device=dev,
                       dtype=torch.int32)
    slots, _ = torch.sort(torch.randint(-1000, t + 1000, (n,), generator=g,
                                        device=dev, dtype=torch.int32))
    mask = torch.rand(n, generator=g, device=dev) < 0.5
    lib = kernel._LIBRARY.load()
    sync = torch.cuda.synchronize
    new = hasattr(kernel, "lane_split")    # the 16-byte-body wrapper

    def outputs():
        if new:
            return (kernel._empty_at_phase(slots),
                    kernel._empty_at_phase(slots))
        return (torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev))

    starts, counts = outputs()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if new:
        head, _ = kernel.lane_split(n, slots.data_ptr(), mask.data_ptr(),
                                    starts.data_ptr(), counts.data_ptr())
        c_args = (slots.data_ptr(), mask.data_ptr(), ts.data_ptr(),
                  tc.data_ptr(), n, t, head, kernel._grid_cap(0),
                  starts.data_ptr(), counts.data_ptr(), stream)

        def split():
            kernel.lane_split(n, slots.data_ptr(), mask.data_ptr(),
                              starts.data_ptr(), counts.data_ptr())

        def guard():
            with (contextlib.nullcontext()
                  if dev.index == torch.cuda.current_device()
                  else torch.cuda.device(dev)):
                pass
    else:
        c_args = (slots.data_ptr(), mask.data_ptr(), ts.data_ptr(),
                  tc.data_ptr(), n, t, starts.data_ptr(), counts.data_ptr(),
                  stream)
        split = None

        def guard():
            with torch.cuda.device(dev):
                pass

    parts = {
        "check": lambda: kernel._check(ts, tc, slots, mask),
        "outputs": outputs,
        **({"split": split} if split else {}),
        "stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "guard": guard,
        "c_call": lambda: lib.repro_hash_probe(*c_args),
    }
    calls = {"hash_probe": lambda: kernel.hash_probe(ts, tc, slots),
             "masked_hash_probe":
                 lambda: kernel.masked_hash_probe(ts, tc, slots, mask)}
    for fn in (*calls.values(), *parts.values()):     # warm up
        for _ in range(5):
            fn()
    sync()
    row = {"label": args.label, "lanes": n, "calls": args.calls,
           "rounds": args.rounds}
    for name, fn in calls.items():
        row[name] = summary(per_call_us(fn, args.calls, args.rounds, sync))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        row[name]["events_ms"] = start.elapsed_time(end) / 10
    row["parts"] = {name: summary(per_call_us(fn, args.calls, args.rounds,
                                              sync))
                    for name, fn in parts.items()}
    print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
