"""End-to-end training launcher: ``python -m repro_torch.launch.train --arch …``.

The port of ``repro/launch/train.py``, with its flags, plus ``--device``
(default ``cuda``), as ``launch/serve.py`` has. Runs the full stack:
synthetic corpus → data pipeline → contracts → train step → transactional
checkpoints on a versioned branch (the paper's run protocol applied to
training). With ``--smoke`` (the default) the arch's reduced config is
used so a few hundred steps finish in minutes; ``--full`` takes the
published config.

Fault-tolerance drill: ``--kill-at N`` raises a simulated worker death at
step N; the launcher restarts from the branch head, and the committed
pipeline cursor replays the same stream (the paper's reproducible-run
claim).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.checkpoints.checkpointing import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.catalog import Catalog
from repro_torch.data.pipeline import DataPipeline, TokenDataset
from repro_torch.data.synthetic import markov_corpus
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     resilient_train)
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, default="xlstm_350m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="simulate a worker death at this step")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    device = torch.device(args.device)
    print(f"[train] {cfg.name} ({cfg.family}) "
          f"{cfg.num_params()/1e6:.1f}M params on {device}")

    tokens = markov_corpus(args.batch * args.seq_len * 64, cfg.vocab_size,
                           seed=args.seed)
    ds = TokenDataset(tokens, shard_tokens=args.batch * args.seq_len * 4)

    def pipeline_factory():
        return DataPipeline(ds, batch=args.batch, seq_len=args.seq_len,
                            seed=args.seed)

    catalog = Catalog()
    ckpt = CheckpointManager(catalog, branch="main",
                             registry=None)
    tc = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                     seed=args.seed, device=args.device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 4),
                          total_steps=args.steps)

    if args.kill_at is not None:
        inj = FailureInjector(fail_at=(args.kill_at,))
        result = resilient_train(
            cfg, pipeline_factory=pipeline_factory, opt_cfg=opt_cfg,
            tc=tc, ckpt=ckpt, injector=inj)
        print(f"[train] survived {len(inj._fired)} injected failure(s); "
              f"restarts resumed from committed branch head")
    else:
        result = train(cfg, pipeline=pipeline_factory(), opt_cfg=opt_cfg,
                       tc=tc, ckpt=ckpt)

    hist = result["history"]
    first, last = hist[0], hist[-1]
    print(f"[train] step {first['step']}: loss={first['loss']:.4f}  ->  "
          f"step {last['step']}: loss={last['loss']:.4f}")
    assert np.isfinite(last["loss"]), "non-finite loss"
    assert last["loss"] < first["loss"], "loss did not decrease"
    log = catalog.log("main", limit=5)
    print(f"[train] branch main head={log[0].id[:12]} "
          f"({len(log)} recent commits, all transactional)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hist, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
