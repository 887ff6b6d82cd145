"""Time the integer segment SUM's shapes against each other, on one GPU.

    PYTHONPATH=src python -m repro_torch.examples.segment_switch \\
        [--rows 6001215] [--seed 0] [--reps 20] [--out FILE]

``csrc/segment_sum.cu`` picks one of its atomic shapes by the number of
segments S, at switch points fixed in the source. This script rebuilds
the source once per shape, with ``-D`` switch points that send every S
it can take to that shape (the register shape takes S <= 16, the shared
bins S <= 4096), and times each build on the same inputs: int64 and int32
values over ``--rows`` rows (10% invalid lanes, a few ids out of range,
ids scattered uniformly over [0, S)), at S from 4 to 8192.
Every result is held bit for bit against the plain version. The switch
points in the source are set from this table (PERF.md).

Prints one line per (S, dtype) and, last, one JSON object with the card's
name and power limit as ``nvidia-smi`` reports them (also written to
``--out``). Needs a CUDA device and ``nvcc``; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# shape -> (the largest S it takes, -D switch points that route every S
# up to that to it)
SHAPES = {
    "register": (16, {"REPRO_SEGMENT_REG_SWITCH": 16,
                      "REPRO_SEGMENT_SHARED_SWITCH": 0}),
    "shared": (4096, {"REPRO_SEGMENT_REG_SWITCH": 0,
                      "REPRO_SEGMENT_SHARED_SWITCH": 4096}),
    "global": (2**31 - 2, {"REPRO_SEGMENT_REG_SWITCH": 0,
                           "REPRO_SEGMENT_SHARED_SWITCH": 0}),
}
SEGMENTS = (4, 16, 17, 64, 175, 256, 1024, 4096, 8192)


def build_shape(shape: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_sum import kernel
    defines = [f"-D{k}={v}" for k, v in SHAPES[shape][1].items()]
    digest = hashlib.sha256(kernel.SOURCE.read_bytes()
                            + " ".join(defines).encode()).hexdigest()[:12]
    lib = build.BUILD_DIR / f"libsegment_switch-{shape}-{digest}.so"
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(".so.tmp")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *defines, "-o",
                        str(tmp), str(kernel.SOURCE)], check=True)
        tmp.replace(lib)
    loaded = ctypes.CDLL(str(lib))
    kernel._bind(loaded)
    return loaded


def sum_atomic(torch, lib, values, ids, valid, num_segments: int):
    """``kernel.segment_sum_atomic`` on ``lib``: (sums, counts)."""
    from repro_torch.kernels.segment_sum import kernel
    dev = values.device
    out = torch.empty(num_segments, dtype=values.dtype, device=dev)
    counts = torch.empty(num_segments, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.repro_segment_atomic_scratch_bytes(
        num_segments), dtype=torch.uint8, device=dev)
    rc = lib.repro_segment_sum_atomic(
        kernel._CODES[values.dtype], values.data_ptr(), ids.data_ptr(),
        valid.data_ptr(), len(values), num_segments, out.data_ptr(),
        counts.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(lib.repro_cuda_error_string(rc).decode())
    return out, counts


def inputs(torch, dtype, num_segments: int, rows: int, g):
    dev = "cuda"
    ids = torch.randint(0, num_segments, (rows,), generator=g, device=dev,
                        dtype=torch.int32)
    r = torch.rand(rows, generator=g, device=dev)
    ids[r < 5e-4] = -1
    ids[r > 1 - 5e-4] = num_segments
    valid = torch.rand(rows, generator=g, device=dev) >= 0.1
    info = torch.iinfo(dtype)
    v = torch.randint(info.min, info.max, (rows,), generator=g, device=dev,
                      dtype=dtype)
    return v, ids, valid


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=6_001_215)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("segment_switch: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.segment_sum import ref
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(SHAPES)) as pool:
        libs = dict(zip(SHAPES, pool.map(build_shape, SHAPES)))
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    rows = []
    for num_segments in SEGMENTS:
        for dtype in (torch.int64, torch.int32):
            v, ids, valid = inputs(torch, dtype, num_segments, args.rows, g)
            want = ref.masked_segment_sum_ref(v, ids, valid, num_segments)
            row = {"S": num_segments, "dtype": str(dtype).split(".")[1]}
            for shape, lib in libs.items():
                if num_segments > SHAPES[shape][0]:
                    continue
                fn = lambda: sum_atomic(torch, lib, v, ids, valid,
                                        num_segments)
                got = fn()
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{shape} differs from the plain "
                                         f"version at S={num_segments} "
                                         f"{dtype}")
                row[f"{shape}_ms"] = cuda_ms(torch, fn, args.reps)
            rows.append(row)
            print("segment switch " + json.dumps(row), flush=True)
    result = {"card": card, "rows": args.rows, "seed": args.seed,
              "reps": args.reps, "times": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
