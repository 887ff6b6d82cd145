"""Train with transactional checkpoints, kill the worker mid-run, restart,
and check that the resumed run reproduces an uninterrupted one.

    PYTHONPATH=src python -m repro_torch.examples.transactional_training \\
        [--steps 200] [--device cpu]

The port of ``examples/transactional_training.py``, on the card unless
``--device`` says otherwise. This is the paper's protocol applied to the
training pipeline: the checkpoint {params, opt_state, data_state,
metrics} is one transactional run, so a restart can never observe params
from step N with a dataloader cursor from step N-k. Run A trains
uninterrupted; run B is killed at a third and at two thirds of the
steps and restarts each time from the branch head. The final losses must
agree within 1e-4, and every published checkpoint commit must hold all
four tables.
"""
import argparse

from repro_torch.checkpoints.checkpointing import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core.catalog import Catalog
from repro_torch.data.pipeline import DataPipeline, TokenDataset
from repro_torch.data.synthetic import markov_corpus
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     resilient_train)
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig, train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="xlstm_350m")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    B, S = 8, 64
    tokens = markov_corpus(B * S * 128, cfg.vocab_size, seed=0)

    def pipeline():
        return DataPipeline(TokenDataset(tokens, shard_tokens=B * S * 2),
                            batch=B, seq_len=S, seed=0)

    opt = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    tc = TrainConfig(steps=args.steps, ckpt_every=25, device=args.device)

    # -- run A: uninterrupted ------------------------------------------------
    cat_a = Catalog()
    res_a = train(cfg, pipeline=pipeline(), opt_cfg=opt, tc=tc,
                  ckpt=CheckpointManager(cat_a))
    la = res_a["history"]
    print(f"[A] steps 0..{la[-1]['step']}  "
          f"loss {la[0]['loss']:.3f} -> {la[-1]['loss']:.3f}")

    # -- run B: killed twice, restarted from the committed branch head -------
    cat_b = Catalog()
    ckpt_b = CheckpointManager(cat_b)
    inj = FailureInjector(fail_at=(args.steps // 3, 2 * args.steps // 3))
    res_b = resilient_train(cfg, pipeline_factory=pipeline, opt_cfg=opt,
                            tc=tc, ckpt=ckpt_b, injector=inj)
    lb = res_b["history"]
    print(f"[B] killed at steps {sorted(inj._fired)}; "
          f"final loss {lb[-1]['loss']:.3f}")

    # -- the paper's claim: restart == replay --------------------------------
    drift = abs(la[-1]["loss"] - lb[-1]["loss"])
    print(f"[check] |loss_A - loss_B| = {drift:.2e} "
          f"{'OK (reproducible restart)' if drift < 1e-4 else 'MISMATCH!'}")
    assert drift < 1e-4

    # every PUBLISHED checkpoint commit (where main's head actually
    # moved) carries the complete artifact set — intermediate commits
    # exist only on (merged) txn branches, never as a head of main.
    published = [r for r in ckpt_b.registry.runs()
                 if r.status == "committed"]
    assert published
    for r in published:
        c = cat_b.commit(r.final_commit)
        assert {"params", "opt_state", "data_state",
                "metrics"} <= set(c.tables), "torn checkpoint!"
    print(f"[check] all {len(published)} published checkpoints complete "
          f"(head never observed torn)")
    return {"loss_a": la[-1]["loss"], "loss_b": lb[-1]["loss"],
            "drift": drift, "published": len(published),
            "killed_at": sorted(inj._fired)}


if __name__ == "__main__":
    main()
