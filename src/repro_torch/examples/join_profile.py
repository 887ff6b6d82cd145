"""Where the time of the port's SF1 join goes, on one GPU.

    PYTHONPATH=src python -m repro_torch.examples.join_profile \\
        [--sf 1] [--seed 0] [--pairs 5] [--out FILE]

The join is the one ``chip_smoke.py``'s query phase runs: ``lineitem``
(the columns the query keeps) joined to ``orders`` on the order key, as
the SQL compiler builds it (``o_orderkey`` renamed ``l_orderkey``), plain
and with the probe-side mask of ``WHERE l_discount >= 0.05``. Measured:

1. ``--pairs`` alternating runs of the ``partitioned`` join on the card
   and the ``vectorized`` join on the host, on the same column dicts
   (host clock around work that ends in a synchronize; medians and
   quartiles);
2. one traced ``partitioned`` join: the ``partitioned.probe`` span
   (keys up, table build, probe kernel, results down) against the whole
   call; the rest is host work (key coding, layout, mapping back,
   emission);
3. ``torch.profiler`` over one ``partitioned`` join and over the whole
   query through ``Client.sql`` on ``torch_auto``: the device's busy
   time (the union of its kernel and copy intervals), its share of the
   wall time, and the device ops that take most of it.

Prints one JSON object, with the card's name and power limit as
``nvidia-smi`` reports them (and writes it to ``--out``). Needs a CUDA
device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


QUERY = ("SELECT o_custkey, SUM(l_quantity) AS qty, "
         "SUM(l_extendedprice) AS revenue, COUNT(l_quantity) AS n_lines "
         "FROM lineitem JOIN orders ON l_orderkey = o_orderkey "
         "GROUP BY o_custkey")


def _wall(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _spread(xs: list[float]) -> dict:
    q = (statistics.quantiles(xs, n=4, method="inclusive") if len(xs) > 1
         else [xs[0]] * 3)
    return {"median_s": statistics.median(xs), "q1_s": q[0], "q3_s": q[2],
            "runs_s": xs}


def _device_profile(torch, fn) -> dict:
    """Wall time of ``fn`` under the profiler, the union of the device's
    kernel and copy intervals, and the five device ops with the most
    time. ``device_busy_s`` is None when the trace holds no device
    event (the profiler saw nothing on the card)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _wall(torch, fn)
    spans = []
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start) / 1e6
    busy = 0.0
    last = None
    for start, end in sorted(spans):
        if last is None or start > last:
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_s": wall,
            "device_busy_s": busy / 1e6 if spans else None,
            "device_busy_share": busy / 1e6 / wall if spans else None,
            "device_events": len(spans),
            "top_device_ops_s": dict(top)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("join_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.runner import Client
    from repro_torch.data.tables import Table
    from repro_torch.examples.tpch import generate
    from repro_torch.exec import use_backend
    from repro_torch.exec.partitioned import PartitionedBackend
    from repro_torch.exec.torch_auto import TorchAutoBackend
    from repro_torch.exec.vectorized import VectorizedBackend
    from repro_torch.obs import tracing

    data = generate(args.sf, args.seed)
    li, od = data["lineitem"], data["orders"]
    left = {c: (li[c], None) for c in ("l_orderkey", "l_quantity",
                                      "l_extendedprice")}
    right = {"o_custkey": (od["o_custkey"], None),
             "l_orderkey": (od["o_orderkey"], None)}
    mask = li["l_discount"] >= 0.05
    card, host = PartitionedBackend(device="cuda"), VectorizedBackend()
    on = ["l_orderkey"]
    runs = {
        "join": lambda be: be.hash_join(left, right, on, "inner"),
        "join_where": lambda be: be.masked_hash_join(
            left, right, on, "inner", left_mask=mask),
    }
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"device": torch.cuda.get_device_name(0), "card": card_line,
           "sf": args.sf,
           "rows": {"lineitem": len(li["l_orderkey"]),
                    "orders": len(od["o_orderkey"])}}
    for label, run in runs.items():
        run(card)                            # builds and loads the kernels
        times = {"partitioned": [], "vectorized": []}
        for i in range(args.pairs):          # alternate which runs first
            order = (card, host) if i % 2 == 0 else (host, card)
            for be in order:
                times[be.name].append(_wall(torch, lambda: run(be)))
        with tracing() as rec:
            total = _wall(torch, lambda: run(card))
        probe = sum(s.duration_s for s in rec.spans("kernel"))
        out[label] = {
            "partitioned": _spread(times["partitioned"]),
            "vectorized": _spread(times["vectorized"]),
            "traced_partitioned_s": total,
            "probe_span_s": probe,
            "host_outside_probe_s": total - probe,
            "profile_partitioned": _device_profile(torch, lambda: run(card)),
        }

    client = Client()
    for name, cols in data.items():
        client.write_source_table("main", name, Table(cols))
    with use_backend(TorchAutoBackend(device="cuda")):
        client.sql(QUERY, cache=False)        # warm
        out["query_join_torch_auto"] = _device_profile(
            torch, lambda: client.sql(QUERY, cache=False))
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
