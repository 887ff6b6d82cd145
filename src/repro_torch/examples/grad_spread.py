"""How closely float32 pins xlstm-350m's gradient at full width.

    PYTHONPATH=src python -m repro_torch.examples.grad_spread \\
        [--steps 6] [--lr 3e-3] [--seed 0] [--device cuda]

Draws the full config's weights from ``--seed`` and trains ``--steps``
steps on ``chip_smoke.py``'s 4 x 512 ``markov_corpus`` batches, then
takes one float32 step's gradients (``make_grad_fn``) at the trained
weights, at 4 x 512 and at 4 x 128 tokens, four ways:

- through the mLSTM kernel (the model as it is), twice;
- through ``repro``'s plain chunk form (``_mlstm_chunk`` over chunks of
  256) and through the kernel's plain two-pass form, each patched in
  for ``models.xlstm.mlstm`` here alone;
- through the kernel at the weights times ``1 + 1e-6 * N(0, 1)``.

It prints, per gradient of ``embed``, of two mLSTM and two sLSTM
parameters, max|a - b| / max|b| of each pair against the kernel path,
and the plain forms against each other: how far the gradient moves under
a perturbation as small as float32 rounding says how closely any two
forms of the step can agree. ``chip_smoke.py`` phase 8d holds the
kernel path against the plain chunk by that spread.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline, TokenDataset
from repro_torch.data.synthetic import markov_corpus
from repro_torch.kernels.mlstm.ref import mlstm_two_pass_ref
from repro_torch.models import xlstm as X
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig, make_grad_fn, train

B, S = 4, 512
PICKS = ("embed", "layers.0.mix.wq", "layers.0.mix.w_if",
         "layers.1.mix.w_in", "layers.1.mix.r")


def chunk_form(q, k, v, log_i, log_f, *, chunk: int = 256):
    """repro's plain chunk, the state carried across chunks of 256."""
    BH, L, hd = q.shape
    C = torch.zeros(1, BH, hd, hd, device=q.device)
    n = torch.zeros(1, BH, hd, device=q.device)
    m = torch.zeros(1, BH, device=q.device)
    outs = []
    for lo in range(0, L, chunk):
        part = [t[None, :, lo:lo + chunk] for t in (q, k, v, log_i, log_f)]
        out, C, n, m = X._mlstm_chunk(*part, C, n, m)
        outs.append(out[0])
    return torch.cat(outs, dim=1)


def two_pass_form(q, k, v, log_i, log_f, *, chunk: int = 256):
    return mlstm_two_pass_ref(q, k, v, log_i, log_f)[0]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = get_config("xlstm_350m")
    tokens = markov_corpus(B * S * 32, cfg.vocab_size, seed=args.seed)
    ds = TokenDataset(tokens, shard_tokens=B * S * 2)
    tc = TrainConfig(steps=args.steps, ckpt_every=args.steps + 1,
                     seed=args.seed, device=args.device)
    res = train(cfg, pipeline=DataPipeline(ds, batch=B, seq_len=S,
                                           seed=args.seed),
                opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=2,
                                    total_steps=args.steps), tc=tc)
    out = {"grad_norm": [h["grad_norm"] for h in res["history"]],
           "loss": [h["loss"] for h in res["history"]]}
    print(json.dumps(out), flush=True)
    batch = DataPipeline(ds, batch=B, seq_len=S, seed=args.seed).next_batch()
    inputs, targets = (torch.from_numpy(x).to(args.device) for x in batch)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    p32 = {k: v.float() for k, v in res["params"].items()}
    del res
    grad_fn = make_grad_fn(cfg32, tc)
    gen = torch.Generator(device=args.device).manual_seed(args.seed + 3)
    perturbed = {k: v * (1 + 1e-6 * torch.randn(
        v.shape, generator=gen, device=args.device)) for k, v in p32.items()}

    def grads(length, params=p32, form=None):
        kernel = X.mlstm
        X.mlstm = form or kernel
        try:
            (loss, _), g = grad_fn(params, inputs[:, :length],
                                   targets[:, :length])
        finally:
            X.mlstm = kernel
        return float(loss), {k: g[k] for k in PICKS}

    for length in (S, 128):
        runs = {"kernel": grads(length), "kernel again": grads(length),
                "chunk": grads(length, form=chunk_form),
                "two-pass": grads(length, form=two_pass_form),
                "perturbed 1e-6": grads(length, params=perturbed)}
        base = runs.pop("kernel")
        pairs = {f"kernel vs {name}": (g, base) for name, g in runs.items()}
        pairs["chunk vs two-pass"] = (runs["chunk"], runs["two-pass"])
        row = {name: {"loss": abs(a[0] - b[0]),
                      **{k: rel(a[1][k], b[1][k]) for k in PICKS}}
               for name, (a, b) in pairs.items()}
        out[f"{B}x{length}"] = row
        for name, r in row.items():
            print(f"{B}x{length} {name}: {json.dumps(r)}", flush=True)
    return out


if __name__ == "__main__":
    main()
