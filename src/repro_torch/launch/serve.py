"""Serving launcher: batched requests against a *pinned commit*.

``python -m repro_torch.launch.serve [--arch xlstm_350m] [--device cpu]``

The port of ``repro/launch/serve.py``, with its flags and its smoke
config, on the card unless ``--device`` says otherwise. It publishes
freshly initialized params (and an AdamW state) as one checkpoint on
``main``, pins the serving replica to the tag ``serving/v0``, loads the
replica's params from that tag, and serves the requests through
continuous batching. A checkpoint published to ``main`` later cannot
change what the replica serves. Serving builds no autograd graph: the
model runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.checkpoints.checkpointing import CheckpointManager
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.core.catalog import Catalog
from repro_torch.models.model import Model
from repro_torch.serving.serve_loop import Request, ServeLoop, load_params_at
from repro_torch.training.optimizer import adamw_init


class _Client:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        self.store = catalog.store


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, default="xlstm_350m")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if cfg.encoder_layers:
        print(f"[serve] {args.arch}: enc-dec serving needs per-request "
              "encoder features; use "
              "repro_torch/examples/transactional_training.py")
        return 0

    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = Model(cfg, device=device).init_params(gen)
    params = model.state_dict()

    # publish params to the catalog and PIN the serving replica to a tag
    catalog = Catalog()
    ckpt = CheckpointManager(catalog, branch="main")
    ckpt.save(step=0, params=params, opt_state=adamw_init(params),
              data_state={"step": 0, "epoch": 0, "shard_order_seed": 0},
              metrics={}, code=f"{cfg.name}@serve")
    tag = catalog.tag("serving/v0", "main")
    print(f"[serve] pinned replica to tag serving/v0 -> {tag[:12]}")
    model.load_state_dict(load_params_at(_Client(catalog), "serving/v0",
                                         params))

    loop = ServeLoop(cfg, model, batch_slots=args.slots,
                     max_len=args.max_len)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(4, 12)).astype(np.int32)
        loop.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))

    loop.run()
    print(f"[serve] {cfg.name}: completed {args.requests} requests "
          f"({args.slots} continuous-batching slots) on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
