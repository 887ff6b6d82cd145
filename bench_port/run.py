"""The port's benchmark: run one cell once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout. ``src`` (the program, ``repro_torch``) and
the checkout's root (``bench_port``) go on ``sys.path``; the kernels the
program builds go to the checkout's ``build/repro_torch/``, keyed by a
hash of their source, so only a cell's first run in a checkout compiles.
The run needs a CUDA card: without one, or in a checkout without the
program, it exits non-zero and prints no result. It also refuses to
print one if JAX or the JAX package (``repro``) was loaded.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each compared
number beside its limit; the same numbers end standard error.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for d, var in (("triton", "TRITON_CACHE_DIR"),
                   ("torch_extensions", "TORCH_EXTENSIONS_DIR")):
        os.environ[var] = str(ROOT / "build" / "bench_port" / d)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from bench_port import harness

    spec = harness.load_spec(args.workload, ROOT)
    chips = {w["name"]: w["chips"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (a checkout without the program stops here)
    out = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench_port: the run loaded {bad}, which the port must not "
              f"import", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
