"""Readings that the limits of ``correct`` are set from.

    python3 bench_port/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n,n,...> [--control-seeds <n,n,...>]

One process runs the cell once per seed (a window of ``--seconds`` at
the cell's own load; kernels are built once) and prints, one JSON line
a seed, the numbers the reference compares for the program; on each
control seed it also runs the control (the float8 reference put in the
program's place, on the same prompts and served tokens) and prints its
numbers. The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench_port import harness
    spec = harness.load_spec(args.workload, ROOT)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        r = harness.run(spec, seed, args.seconds, False, device="cuda",
                        control=seed in controls)
        line = json.dumps({"seed": seed, "program": {
            k: c["value"] for k, c in r["checks"].items()},
            "control": r.get("control"), "judged": r["judged"],
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
            "memory_peak_bytes": r["device"]["memory_peak_bytes"]})
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
