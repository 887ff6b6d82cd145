"""Synthetic corpora for training examples and tests.

Generates a deterministic, seeded token stream with learnable structure
(a Markov chain over the vocab + copy motifs) so a ~100M model's loss
visibly decreases within a few hundred steps.
"""
from __future__ import annotations

import numpy as np


def markov_corpus(num_tokens: int, vocab_size: int, *, seed: int = 0,
                  order_bias: float = 6.0) -> np.ndarray:
    """Token stream from a sparse random Markov chain (low entropy)."""
    rng = np.random.default_rng(seed)
    V = vocab_size
    k = min(8, V)
    next_tokens = rng.integers(0, V, size=(V, k))
    logits = rng.normal(size=(V, k)) * order_bias
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    out = np.empty(num_tokens, dtype=np.int32)
    tok = int(rng.integers(0, V))
    for i in range(num_tokens):
        out[i] = tok
        j = rng.choice(k, p=probs[tok])
        tok = int(next_tokens[tok, j])
    return out


def copy_task_batch(rng: np.random.Generator, batch: int, seq_len: int,
                    vocab_size: int) -> np.ndarray:
    """[prefix | SEP | prefix] sequences — quick sanity-check task."""
    half = (seq_len - 1) // 2
    prefix = rng.integers(2, vocab_size, size=(batch, half), dtype=np.int32)
    sep = np.ones((batch, 1), dtype=np.int32)
    rest = seq_len - (2 * half + 1)
    pad = np.zeros((batch, rest), dtype=np.int32)
    return np.concatenate([prefix, sep, prefix, pad], axis=1)
