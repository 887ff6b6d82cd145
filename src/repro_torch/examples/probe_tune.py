"""Time the hash probe's launch choices against each other, on one GPU.

    PYTHONPATH=src python -m repro_torch.examples.probe_tune \\
        [--reps 20] [--seed 1] [--out FILE]

``csrc/hash_probe.cu`` takes 4 lanes at a time in 16-byte loads and
stores, streams the lanes with evict-first hints, gathers the table under
an evict-last L2 policy on a quarter of its lines, and caps its grid at
``kernel.BLOCKS_PER_SM`` blocks per SM. This script times, on
``chip_smoke.py``'s probe inputs (6,001,215 lanes clustered and in
random order, 1,500,000 clustered, into 2^23 slots; plain and masked):

- the 16-byte body under grid caps of 4 and 8 blocks per SM, and with
  the grid sized from n (one trip per thread: a cap above any grid);
- every lane through the kernel's scalar path (``head = n``), the form
  of the kernel before the 16-byte body, at the default cap;
- the 16-byte body built with no L2 policy on the table gathers
  (``-DREPRO_PROBE_EVICT_LAST=0``), and with the evict-last policy on all
  of the table's lines (``-DREPRO_PROBE_L2_FRACTION=1.0``);
- 4 groups a thread (``-DREPRO_PROBE_GROUPS=4``).

Each variant's outputs are held bit for bit against the plain version.
Its times are the profiler's device time per call (``obs.device_time``)
over ``--reps`` back-to-back calls (``device_ms``, the table warm in L2
after the first) and over calls that each follow an L2 reset
(``cold_ms``), and CUDA events over the back-to-back calls. An L2 reset
demotes lines an evict-last policy left (``cuCtxResetPersistingL2Cache``)
and then writes 256 MB, so every variant starts from the same L2: such
lines would otherwise favour or hinder whatever runs next. What they
cost the kernels that follow a probe it times too: the segment kernels of
the GROUP BY after Q18's join (int64 SUM and float64 MIN over 6,001,215
rows into 1.5M groups), each right after a 6M-lane probe built with the
policy and without it, after the policy's probe and a demotion of its
lines (``cuCtxResetPersistingL2Cache``), and with no probe before it
(``after_probe`` rows). Prints one JSON
line per (case, variant) and, last, one JSON object with the card's
name and power limit as ``nvidia-smi`` reports them and the context's L2
fetch granularity (all also written to ``--out``). Needs a CUDA device
and ``nvcc``; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from repro_torch.kernels.hash_join.inputs import (INT32_MAX, PROBE_SLOTS,
                                                  probe_inputs)

CASES = ((6_001_215, "clustered"), (6_001_215, "random"),
         (1_500_000, "clustered"))
LINEITEM, ORDERS = 6_001_215, 1_500_000     # rows and Q18's groups at SF1

BUILDS = {      # build -> its -D switches (None: the source as it is)
    "default": None,
    "no_l2_policy": "-DREPRO_PROBE_EVICT_LAST=0",
    "evict_last_all": "-DREPRO_PROBE_L2_FRACTION=1.0",
    "groups4": "-DREPRO_PROBE_GROUPS=4",
}


def build_variant(define: str | None) -> ctypes.CDLL:
    """``hash_probe.cu`` built with ``-D`` switches."""
    from repro_torch.kernels import build
    from repro_torch.kernels.hash_join import kernel
    if define is None:
        return kernel._LIBRARY.load()
    digest = hashlib.sha256(kernel.SOURCE.read_bytes()
                            + define.encode()).hexdigest()[:12]
    lib = build.BUILD_DIR / f"libhash_probe_variant-{digest}.so"
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(".so.tmp")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *define.split(),
                        "-o", str(tmp), str(kernel.SOURCE)], check=True)
        tmp.replace(lib)
    loaded = ctypes.CDLL(str(lib))
    kernel._bind(loaded)
    return loaded


def launch(torch, lib, ts, tc, slots, mask, *, scalar: bool,
           max_blocks: int):
    """One probe on ``lib``, as ``kernel._launch`` makes it, with the
    lane split and the grid's cap chosen here: (starts, counts)."""
    from repro_torch.kernels.hash_join import kernel
    dev, n = slots.device, slots.shape[0]
    sp = slots.data_ptr()
    starts = kernel._empty_at_phase(slots)
    counts = kernel._empty_at_phase(slots)
    head = n if scalar else kernel.lane_split(
        n, sp, None if mask is None else mask.data_ptr(),
        starts.data_ptr(), counts.data_ptr())[0]
    rc = lib.repro_hash_probe(
        sp, None if mask is None else mask.data_ptr(), ts.data_ptr(),
        tc.data_ptr(), n, ts.shape[0], head, max_blocks, starts.data_ptr(),
        counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(lib.repro_hash_probe_error_string(rc).decode())
    return starts, counts


def dram_floors(torch, slots, mask) -> dict:
    """Two floors, as ms at 3.35 TB/s, for the bytes a probe moves when
    device memory is read in 64-byte atoms (the context's L2 fetch
    granularity, :func:`l2_fetch_bytes`, reads 64 on the H100): the lane
    stream (4-byte slot, the mask, 8 bytes out) plus,
    for each of the two table arrays, every distinct atom the live lanes
    touch once (``once_ms``: an L2 that keeps the table), or one atom a
    live lane (``no_reuse_ms``: an L2 that keeps none of it)."""
    live = (slots >= 0) & (slots < PROBE_SLOTS)
    if mask is not None:
        live &= mask
    atoms = int(torch.unique(slots[live] // 16).numel())
    n = slots.shape[0]
    stream = 12 * n + (n if mask is not None else 0)
    return {"atoms": atoms,
            "once_ms": (stream + 128 * atoms) / 3.35e12 * 1e3,
            "no_reuse_ms": (stream + 128 * int(live.sum())) / 3.35e12 * 1e3}


def l2_fetch_bytes() -> int:
    """The context's L2 fetch granularity in bytes
    (``CU_LIMIT_MAX_L2_FETCH_GRANULARITY``)."""
    found = ctypes.c_size_t()
    rc = ctypes.CDLL("libcuda.so.1").cuCtxGetLimit(ctypes.byref(found),
                                                   0x05)
    if rc != 0:
        raise RuntimeError(f"cuCtxGetLimit failed: CUresult {rc}")
    return found.value


def l2_demote() -> None:
    """Demote the L2's evict-last (persisting) lines to normal."""
    rc = ctypes.CDLL("libcuda.so.1").cuCtxResetPersistingL2Cache()
    if rc != 0:
        raise RuntimeError(f"cuCtxResetPersistingL2Cache failed: "
                           f"CUresult {rc}")


def l2_reset(torch, scrub):
    """Demote the L2's evict-last lines, then write ``scrub`` (larger
    than the L2) over them."""
    l2_demote()
    scrub.fill_(1)


def after_probe(torch, libs, scrub, g, cap: int, reps: int) -> list[dict]:
    """Device time of the GROUP BY's segment kernels right after a 6M-lane
    probe into the 2^23-slot table: with the default build (evict-last
    on a quarter of the table's lines), with the build without a policy,
    with the default build and its lines demoted before the segment
    kernel, and with no probe before it. The probes run under the grid
    cap ``cap``."""
    from repro_torch.kernels.segment_sum import kernel as seg
    from repro_torch.obs.device_time import device_ms
    vi = torch.randint(-1000, 1000, (LINEITEM,), generator=g,
                       device="cuda", dtype=torch.int64)
    vf = torch.randn(LINEITEM, generator=g, device="cuda",
                     dtype=torch.float64)
    ids = torch.randint(0, ORDERS, (LINEITEM,), generator=g, device="cuda",
                        dtype=torch.int32)
    valid = torch.rand(LINEITEM, generator=g, device="cuda") < 0.9
    segments = {   # name -> (call, launches a call)
        "sum_int64": (lambda: seg.segment_sum_atomic(vi, ids, valid,
                                                     ORDERS), 1),
        "min_float64": (lambda: seg.segment_reduce(vf, ids, valid, ORDERS,
                                                   "min"), 2)}
    rows = []
    for order in ("clustered", "random"):
        ts, tc, slots, _ = probe_inputs(LINEITEM, order, g)
        probes = {b: (lambda lb=libs[b]: launch(
            torch, lb, ts, tc, slots, None, scalar=False, max_blocks=cap))
            for b in ("default", "no_l2_policy")}
        before = {"evict_last_probe": probes["default"],
                  "no_policy_probe": probes["no_l2_policy"],
                  "evict_last_probe_demoted": lambda: (
                      probes["default"](), torch.cuda.synchronize(),
                      l2_demote()),
                  "no_probe": lambda: None}
        for name, (call, launches) in segments.items():
            for label, first in before.items():
                l2_reset(torch, scrub)
                row = {"after_probe": label, "order": order,
                       "segment": name,
                       **device_ms(lambda: (first(), call()),
                                   seg.SOURCE, launches=launches,
                                   reps=reps)}
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def events_ms(torch, fn, reps: int) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("probe_tune: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.hash_join import kernel, ref
    from repro_torch.obs.device_time import device_ms

    with ThreadPoolExecutor(len(BUILDS)) as pool:
        libs = dict(zip(BUILDS, pool.map(build_variant, BUILDS.values())))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cap = kernel.BLOCKS_PER_SM * sms
    lib = libs["default"]
    variants = {f"cap{c}": (lib, False, c * sms) for c in (4, 8)}
    variants.update({"grid_from_n": (lib, False, INT32_MAX),
                     "scalar": (lib, True, cap),
                     **{b: (libs[b], False, cap) for b in
                        ("no_l2_policy", "evict_last_all", "groups4")}})
    scrub = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    rows = []
    for n, order in CASES:
        ts, tc, slots, full_mask = probe_inputs(n, order, g)
        for masked in (False, True):
            mask = full_mask if masked else None
            want = (ref.masked_hash_probe_ref(ts, tc, slots, mask) if masked
                    else ref.hash_probe_ref(ts, tc, slots))
            floor = dram_floors(torch, slots, mask)
            for name, (lb, scalar, blocks) in variants.items():
                call = lambda: launch(torch, lb, ts, tc, slots, mask,
                                      scalar=scalar, max_blocks=blocks)
                got = call()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name} differs from the plain "
                                         f"version: n={n} {order} {masked}")
                l2_reset(torch, scrub)
                row = {"n": n, "order": order, "masked": masked,
                       "variant": name, "max_blocks": blocks, **floor,
                       **device_ms(call, kernel.SOURCE, launches=1,
                                   reps=args.reps)}
                row["cold_ms"] = device_ms(
                    lambda: (l2_reset(torch, scrub), call()), kernel.SOURCE,
                    launches=1, reps=args.reps)["device_ms"]
                l2_reset(torch, scrub)
                row["events_ms"] = events_ms(torch, call, args.reps)
                rows.append(row)
                print(json.dumps(row), flush=True)
    rows += after_probe(torch, libs, scrub, g, cap, args.reps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    head = {"card": card, "sms": sms, "l2_fetch_bytes": l2_fetch_bytes()}
    print(json.dumps(head))
    result = {**head, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
