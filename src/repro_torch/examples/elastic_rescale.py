"""Elastic rescaling: lose ranks mid-training, continue on fewer.

    PYTHONPATH=src python -m repro_torch.examples.elastic_rescale

The port of the root ``examples/elastic_rescale.py``. Checkpoints are
*logical* (whole tensors in the versioned store), so rescaling is purely
a placement decision: restore the branch head, derive placements from
the new mesh, continue. Eight gloo ranks on the CPU train the smoke
xlstm on a (pod, data, model) = (2, 2, 2) mesh, each step sharded by
``make_rules("train", mesh)``, and commit every 5 steps to a store on
disk. Then four ranks on a (2, 2) mesh ("a pod died") and two on a
(2, 1) mesh restore the same branch head onto their own mesh and
continue. The global batch contract is preserved (the pipeline cursor is
part of the commit), so each phase resumes at the committed step: the
paper's partial-vs-total-failure upgrade applied to cluster capacity.

Each rank keeps a catalog of its own over the shared store (blobs are
content-addressed and published by an atomic rename); a phase opens the
previous phase's head from the table keys its rank 0 reported.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import torch

from repro_torch.launch.mesh import make_host_mesh, run_ranks

B, S = 8, 32
PHASES = [((2, 2, 2), 10), ((2, 2), 20), ((2, 1), 30)]   # mesh, last step
CKPT_EVERY = 5


def _mesh(shape):
    if len(shape) == 3:
        return make_host_mesh(shape[1], shape[2], pod=shape[0], device="cpu")
    return make_host_mesh(*shape, device="cpu")


def _phase(rank, world, shape, steps, root, head_tables):
    from repro_torch.checkpoints.checkpointing import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.catalog import Catalog
    from repro_torch.core.store import FileStore
    from repro_torch.data.pipeline import DataPipeline, TokenDataset
    from repro_torch.data.synthetic import markov_corpus
    from repro_torch.distributed.elastic import reshard
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_sharded_train_step,
                                                 train)
    cfg = get_smoke_config("xlstm_350m")
    tokens = markov_corpus(B * S * 64, cfg.vocab_size, seed=0)
    pipeline = DataPipeline(TokenDataset(tokens, shard_tokens=B * S * 2),
                            batch=B, seq_len=S, seed=0)
    catalog = Catalog(FileStore(root))
    if head_tables:
        catalog.write_tables("main", head_tables, message="restore head")
    ckpt = CheckpointManager(catalog)
    mesh = _mesh(shape)
    rules = make_rules("train", mesh)
    # the placements to restore into: a fresh init's, on this mesh
    model = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    like = {k: v.detach() for k, v in model.state_dict().items()}
    params = reshard(like, mesh, rules)
    opt_state = reshard(adamw_init(like), mesh, rules)
    opt = AdamWConfig(lr=3e-3)
    tc = TrainConfig(steps=steps, ckpt_every=CKPT_EVERY, device="cpu")
    res = train(cfg, pipeline=pipeline, opt_cfg=opt, tc=tc, ckpt=ckpt,
                params=params, opt_state=opt_state,
                jit_fn=make_sharded_train_step(
                    cfg, opt, tc, mesh, rules,
                    model=Model(cfg, device="meta")))
    return {"history": [(h["step"], h["loss"]) for h in res["history"]],
            "head": dict(catalog.head("main").tables)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a phase's ranks may take")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="elastic-") as root:
        head, start = {}, 0
        for shape, steps in PHASES:
            world = 1
            for s in shape:
                world *= s
            outs = run_ranks(_phase, world, shape, steps, root, head,
                             backend="gloo", timeout_s=args.timeout,
                             threads=1)
            hist = outs[0]["history"]
            if hist[0][0] != start:
                raise SystemExit(f"{shape}: resumed at step {hist[0][0]}, "
                                 f"not the committed {start}")
            if any(o["history"] != hist for o in outs):
                raise SystemExit(f"{shape}: the ranks' losses differ")
            print(f"[{world} ranks {shape}] steps {hist[0][0]}..{hist[-1][0]}"
                  f"  loss {hist[0][1]:.3f} -> {hist[-1][1]:.3f}")
            head, start = outs[0]["head"], steps
        print("[check] training continued across each rescale from the "
              "committed data cursor: slow but CORRECT")
        print(json.dumps({"phases": [list(s) for s, _ in PHASES],
                          "last_step": start}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
