"""Where the time of the mLSTM kernel goes, on one GPU.

    PYTHONPATH=src python -m repro_torch.examples.mlstm_profile \\
        [--reps 5] [--out FILE]

The case is ``chip_smoke.py``'s main mLSTM case, each of xlstm-350m's
prefill calls: B·H = 16, S = 2048, hd = 256, bf16 q, k, v drawn as
``repro``'s tests draw them. ``torch.profiler`` over ``--reps`` calls of
``kernel.mlstm_chunkwise`` gives the device time of each of its three
launches (the chunk states, the combine, the outputs) per call, and CUDA
events the time of a call.

Prints one JSON object, with the card's name and power limit as
``nvidia-smi`` reports them (and writes it to ``--out``). Needs a CUDA
device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("mlstm_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.mlstm import kernel

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    n = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    BH, S, hd = 16, 2048, 256
    q = (n(BH, S, hd) / hd ** 0.5).bfloat16()
    k = (n(BH, S, hd) / hd ** 0.5).bfloat16()
    v = n(BH, S, hd).bfloat16()
    log_i, log_f = -F.softplus(-n(BH, S)), -F.softplus(-n(BH, S) - 2.0)
    call = lambda: kernel.mlstm_chunkwise(q, k, v, log_i, log_f)

    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        call()
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / args.reps

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            call()
        torch.cuda.synchronize()
    by_launch = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        for name in ("state", "combine", "output"):
            if f"mlstm_{name}_kernel" in ev.key:
                by_launch[name] = ev.self_device_time_total / 1e3 / args.reps
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"card": card, "shape": {"BH": BH, "S": S, "hd": hd,
                                      "dtype": "bfloat16"},
              "call_ms": call_ms, "device_ms_by_launch": by_launch}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
