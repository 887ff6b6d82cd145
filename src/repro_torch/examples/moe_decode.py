"""Time granite-moe-3b's decode step and its MoE layer at the decode
shape, on the card (host-bound: a step issues a few thousand kernels).

    PYTHONPATH=src python -m repro_torch.examples.moe_decode

Draws the full model from ``--seed``, fills the caches' length to
``--len`` (the K/V stay zero: the step's work is the same), runs
``--warmup`` then ``--steps`` decode steps of one token in ``--batch``
rows and prints one JSON line: the step's mean ms, the MoE layer's
host ms over ``--reps`` calls, and its device ms and kernels from one
profiled call. Put another checkout's ``src`` first on ``PYTHONPATH``
to time that one's layer (two checkouts alternating in one call).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.model import Model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--len", type=int, default=4096)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("moe_decode: no CUDA device")
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("granite_moe_3b")
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    model = Model(cfg, device="cuda").init_params(g)
    caches = model.init_cache(args.batch, args.len + args.warmup
                              + args.steps)
    for c in caches:
        c["attn"]["len"] = args.len
    tok = torch.randint(0, cfg.vocab_size, (args.batch, 1), device="cuda",
                        generator=g)
    out = {"moe": moe.__file__, "card": torch.cuda.get_device_name(0)}
    with torch.no_grad():
        for _ in range(args.warmup):
            _, caches = model.decode_step(tok, caches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            _, caches = model.decode_step(tok, caches)
        torch.cuda.synchronize()
        out["decode_ms"] = (time.perf_counter() - t0) / args.steps * 1e3
        x = torch.randn(args.batch, 1, cfg.d_model, device="cuda",
                        dtype=torch.bfloat16, generator=g)
        ffn = model.layers[0].ffn
        for _ in range(args.warmup):
            moe.moe_forward(ffn, x, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            moe.moe_forward(ffn, x, cfg)
        torch.cuda.synchronize()
        out["moe_layer_host_ms"] = (time.perf_counter() - t0) / args.reps \
            * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            moe.moe_forward(ffn, x, cfg)
            torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_time_total > 0]
    out["moe_layer_device_ms"] = sum(e.device_time_total for e in ev) / 1e3
    out["moe_layer_kernels"] = sum(e.count for e in ev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
