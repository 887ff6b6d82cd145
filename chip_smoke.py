#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--sf 1] [--seed 0] [--log-dir DIR]

Phases, each of which must pass (any failure raises and exits non-zero
before the result line):

1. card: name and power limit, as ``nvidia-smi`` reports them;
2. build: ``nvcc`` compiles ``kernels/segment_sum/csrc/segment_sum.cu``
   for sm_90a; the build time and ptxas's register report;
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the slice's shapes (n = 6,001,215 rows; S = 4 as in Q1 and
   S = 1.5M as in Q18), over int8/int32/int64/float32/float64 with
   invalid lanes, out-of-range ids, NaNs, empty segments and tied
   ``±0.0``. Integers, counts and MIN/MAX must match bit for bit (the
   sign of a zero included); float sums within the tolerance below, and
   bitwise across two launches. Times of the kernel, the plain version
   and one PyTorch library call, and the bound;
4. slice: TPC-H SF ``--sf`` generated from ``--seed``, run through
   ``Client.run`` on the default backend (``torch`` on ``cuda``); both
   kernels must have launched; every published table must match the
   port's ``vectorized`` backend (integers, counts, MIN/MAX and
   validity exactly, float SUM/MEAN to rtol 1e-9); a rerun with
   ``cache=False`` must reproduce every fingerprint; at SF 0.01 the
   ``reference`` backend must match too.

The last two lines of standard output are one JSON object of the
kernels' numbers, then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
N_ROWS = 6_001_215              # lineitem rows at TPC-H SF1
Q18_GROUPS = 1_500_000          # orders at SF1: Q18's group count
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
# Float SUM tolerance per segment, as a multiple of sum(|v|) over the
# segment's valid lanes. Kernel and plain version both add in the value
# dtype, in different orders (the plain version with atomics on the
# card). For zero-mean inputs like these, the rounding error of either
# order is a random walk of eps-sized steps on the partial sums, of the
# order of eps*sum(|v|); the factors leave ~100x (float32) and ~10^4x
# (float64) margin over that.
SUM_RTOL = {"float32": 1e-5, "float64": 1e-12}
REPLACES = {
    "masked_segment_sum": (
        "src/repro/kernels/segment_sum/kernel.py:59"),
    "masked_segment_reduce": (
        "src/repro/kernels/segment_sum/kernel.py:146"),
}
SOURCE = "src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def expect(cond, *what) -> None:
    """A check of this run; raises (and so fails the script) when false."""
    if not cond:
        raise AssertionError(" ".join(map(str, what)))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up."""
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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_inputs(torch, dtype, num_segments: int, kind: str, g):
    dev = DEVICE
    n = N_ROWS
    used = num_segments - 1 if num_segments <= 8 else num_segments
    ids = torch.randint(0, used, (n,), generator=g, device=dev,
                        dtype=torch.int32)   # small S: the last is empty
    r = torch.rand(n, generator=g, device=dev)
    ids[r < 5e-4] = -1                       # out of range: contribute
    ids[r > 1 - 5e-4] = num_segments         # nothing
    valid = torch.rand(n, generator=g, device=dev) >= 0.1
    if dtype.is_floating_point:
        if kind == "zeros":                  # every tie is a signed zero
            v = torch.where(torch.rand(n, generator=g, device=dev) < 0.5,
                            -0.0, 0.0).to(dtype)
        else:
            v = (torch.randn(n, generator=g, device=dev, dtype=torch.float64)
                 * 100).to(dtype)
            r = torch.rand(n, generator=g, device=dev)
            v[r < 0.02] = 0.0
            v[(r >= 0.02) & (r < 0.04)] = -0.0
            if kind == "nan":
                v[r > 1 - 1e-5] = float("nan")
    else:
        info = torch.iinfo(dtype)
        v = torch.randint(info.min, info.max, (n,), generator=g, device=dev,
                          dtype=dtype)
    return v, ids, valid


def bits(torch, t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def check_config(torch, kernel, ops, ref, op, dtype, num_segments, kind,
                 g):
    """One (op, dtype, S) case: parity, repeatability and times."""
    log(f"kernel check: {op} {str(dtype).split('.')[1]} S={num_segments} "
        f"{kind}")
    v, ids, valid = make_inputs(torch, dtype, num_segments, kind, g)
    if op == "sum":
        call = lambda: ops.masked_segment_sum(v, ids, valid, num_segments)
        plain = lambda: ref.masked_segment_sum_ref(v, ids, valid,
                                                   num_segments)
    else:
        call = lambda: ops.masked_segment_reduce(v, ids, valid,
                                                 num_segments, op=op)
        plain = lambda: ref.masked_segment_reduce_ref(v, ids, valid,
                                                      num_segments, op)
    got, got_n = call()
    again, _ = call()
    want, want_n = plain()
    torch.cuda.synchronize()
    expect(torch.equal(got_n, want_n), op, dtype, num_segments, "counts")
    expect(torch.equal(bits(torch, got), bits(torch, again)),
           op, dtype, num_segments, "not bitwise repeatable")
    err = 0.0
    if op == "sum" and dtype.is_floating_point:
        mass, _ = ref.masked_segment_sum_ref(v.abs(), ids, valid,
                                             num_segments)
        diff = (got.double() - want.double()).abs()
        tol = SUM_RTOL[str(dtype).split(".")[1]] * mass.double()
        bad = int((diff > tol).sum())
        expect(bad == 0, op, dtype, num_segments, f"{bad} sums off")
        err = float(diff.max()) if len(diff) else 0.0
    else:
        expect(torch.equal(bits(torch, got), bits(torch, want)),
               op, dtype, num_segments, kind, "values differ")

    # times: the wrapper (sort + kernel), the kernel alone on run-ordered
    # rows, the plain version, and one PyTorch library call on inputs
    # prepared for it (ids in range, masked lanes at the identity)
    ordered = ops._run_order(v, ids, valid)
    inside = (ids >= 0) & (ids < num_segments)
    safe = torch.where(inside, ids, 0).long()
    if op == "sum":
        alone = lambda: kernel.segment_sum(*ordered, num_segments)
        vm = torch.where(valid & inside, v,
                         torch.zeros((), dtype=dtype, device=DEVICE))
        lib = lambda: torch.zeros(num_segments, dtype=dtype,
                                  device=DEVICE).index_add_(0, safe, vm)
    else:
        alone = lambda: kernel.segment_reduce(*ordered, num_segments, op)
        ident = ref.reduce_identity(ref.numpy_dtype(dtype), op).item()
        vm = torch.where(valid & inside, v,
                         torch.full((), ident, dtype=dtype, device=DEVICE))
        red = "amin" if op == "min" else "amax"
        lib = lambda: torch.full((num_segments,), ident, dtype=dtype,
                                 device=DEVICE).scatter_reduce_(
            0, safe, vm, reduce=red)
    if dtype.itemsize < 4:
        lib = None      # 1- and 2-byte atomics serialize on shared words
    item = v.element_size()
    nbytes = N_ROWS * (item + 4 + 1) + num_segments * (item + 4)
    return {
        "op": op, "dtype": str(dtype).split(".")[1], "S": num_segments,
        "kind": kind, "max_abs_err": err,
        "ms": cuda_ms(torch, call), "kernel_only_ms": cuda_ms(torch, alone),
        "plain_ms": cuda_ms(torch, plain, reps=3),
        "library_ms": None if lib is None else cuda_ms(torch, lib, reps=3),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }


def phase_kernels(torch):
    from repro_torch.kernels.segment_sum import kernel, ops, ref
    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    rows = []
    dtypes = (torch.int8, torch.int32, torch.int64, torch.float32,
              torch.float64)
    for num_segments in (4, Q18_GROUPS):
        for dtype in dtypes:
            for op in ("sum", "min", "max"):
                kinds = ["plain"]
                if dtype.is_floating_point and op != "sum":
                    kinds += ["nan", "zeros"]
                for kind in kinds:
                    row = check_config(torch, kernel, ops, ref, op, dtype,
                                       num_segments, kind, g)
                    rows.append(row)
                    log("kernel " + json.dumps(row))
    return rows


def h2d_ms(torch, np) -> float:
    """Host->device copy of one slice column set (float64 values, int32
    ids, bool validity) from pageable memory, median of 5."""
    cols = [np.random.default_rng(0).random(N_ROWS),
            np.zeros(N_ROWS, np.int32), np.ones(N_ROWS, bool)]
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in cols:
            torch.from_numpy(c).to(DEVICE)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[2]


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

FLOAT_AGGS = {"sum_base_price", "sum_disc_price", "sum_charge", "avg_qty",
              "avg_price", "avg_disc"}


def run_pipeline(data, backend=None, *, cache=True):
    import torch
    from repro_torch.core.planner import plan
    from repro_torch.core.runner import Client
    from repro_torch.data.tables import Table
    from repro_torch.exec import use_backend
    from repro_torch.examples.tpch import build_pipeline, run_slice
    client = Client()
    for name, cols in data.items():
        client.write_source_table("main", name, Table(cols))
    pl = plan(build_pipeline())
    t0 = time.perf_counter()
    if backend is None:
        result = run_slice(client, pl, cache=cache)
    else:
        with use_backend(backend):
            result = run_slice(client, pl, cache=cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect(result.state.status == "committed", result.state)
    tables = {t: client.read_table("main", t) for t in sorted(result.tables)}
    return tables, pl._runtime, wall


def assert_same(np, got, want, label: str) -> None:
    expect(sorted(got) == sorted(want), label)
    for name in got:
        a, b = got[name], want[name]
        expect(a.column_names() == b.column_names(), label, name)
        expect(len(a) == len(b), label, name)
        for c in a.column_names():
            expect(np.array_equal(a.validity(c), b.validity(c)),
                   label, name, c)
            x, y = a.column(c), b.column(c)
            if c in FLOAT_AGGS:
                np.testing.assert_allclose(x, y, rtol=1e-9, atol=0,
                                           err_msg=f"{label} {name}.{c}")
            elif x.dtype == object:
                expect(x.tolist() == y.tolist(), label, name, c)
            else:
                expect(x.dtype == y.dtype, label, name, c)
                expect(x.tobytes() == y.tobytes(), label, name, c)


def phase_slice(torch, np, sf: float, seed: int):
    from repro_torch import exec as exec_backends
    from repro_torch.examples.tpch import generate
    from repro_torch.kernels.segment_sum import ops

    t0 = time.perf_counter()
    data = generate(sf, seed)
    log(f"slice data: sf={sf} seed={seed} rows="
        f"{ {k: len(next(iter(v.values()))) for k, v in data.items()} } "
        f"generated in {time.perf_counter() - t0:.2f} s")
    expect(exec_backends.active_backend().name == "torch",
           "the default backend is not torch")
    log(f"slice backend: {exec_backends.active_backend().cache_token()}")

    ops.masked_segment_sum.launches = 0
    ops.masked_segment_reduce.launches = 0
    tables, runtime, wall = run_pipeline(data)
    launches = {"masked_segment_sum": ops.masked_segment_sum.launches,
                "masked_segment_reduce": ops.masked_segment_reduce.launches}
    log(f"slice launches: {json.dumps(launches)}")
    expect(all(n > 0 for n in launches.values()),
           "a kernel of the path never launched", launches)
    log(f"slice torch run: wall_s={wall:.3f}")
    for name, rec in sorted(runtime.items()):
        log(f"slice node {name}: wall_s={rec['wall_s']:.3f} "
            f"rows_out={rec['rows_out']} cache={rec['cache']}")

    host, _, host_wall = run_pipeline(data, "vectorized")
    assert_same(np, tables, host, "torch vs vectorized")
    log(f"slice vectorized run: wall_s={host_wall:.3f}; tables match")

    again, _, again_wall = run_pipeline(data, cache=False)
    fp = {t: tables[t].fingerprint() for t in tables}
    fp2 = {t: again[t].fingerprint() for t in again}
    expect(fp == fp2, "rerun changed fingerprints", fp, fp2)
    log(f"slice cache=False rerun: wall_s={again_wall:.3f}; "
        f"fingerprints identical {json.dumps(fp)}")
    del host, again

    small = generate(0.01, seed)
    t_small, _, _ = run_pipeline(small)
    assert_same(np, t_small, run_pipeline(small, "vectorized")[0],
                "sf0.01 torch vs vectorized")
    assert_same(np, t_small, run_pipeline(small, "reference")[0],
                "sf0.01 torch vs reference")
    log("slice sf0.01: torch matches vectorized and reference")
    for name, t in sorted(tables.items()):
        log(f"slice table {name}: rows={len(t)} fp={t.fingerprint()}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", default=None,
                    help="also write ptxas's report and the kernel table "
                         "here")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels.segment_sum import kernel
    except ImportError as e:
        print(f"chip_smoke: the port is not in this checkout ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    lib, report = kernel.build(ptxas_report=True)
    build_s = time.perf_counter() - t0
    regs = [line.strip() for line in report.splitlines()
            if "registers" in line]
    spills = [line.strip() for line in report.splitlines()
              if "spill" in line and " 0 bytes spill stores" not in line]
    log(f"build: {lib.name} in {build_s:.1f} s; {len(regs)} kernels; "
        f"max registers {max((int(r.split('Used ')[1].split()[0]) for r in regs), default=0)}; "
        f"spilling: {spills or 'none'}")
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        with open(os.path.join(args.log_dir, "ptxas.txt"), "w") as f:
            f.write(report)

    # 3. kernels
    rows = phase_kernels(torch)
    copy_ms = h2d_ms(torch, np)
    log(f"h2d copy of one column set (float64 + int32 ids + bool, "
        f"{N_ROWS} rows, pageable): {copy_ms:.3f} ms")
    if args.log_dir:
        with open(os.path.join(args.log_dir, "kernels.jsonl"), "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")

    # 4. the slice
    launches = phase_slice(torch, np, args.sf, args.seed)

    main_rows = {   # the heaviest shape each kernel gets on the main path
        "masked_segment_sum": ("sum", "int64", Q18_GROUPS),
        "masked_segment_reduce": ("min", "float64", Q18_GROUPS),
    }
    kernels = []
    for name, (op, dt, s) in main_rows.items():
        row = next(r for r in rows if (r["op"], r["dtype"], r["S"],
                                       r["kind"]) == (op, dt, s, "plain"))
        ops_ = ("sum",) if name == "masked_segment_sum" else ("min", "max")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["op"] in ops_),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "kernel_only_ms": row["kernel_only_ms"],
            "shape": f"n={N_ROWS} S={s} {dt} {op}",
            "h2d_ms": copy_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
