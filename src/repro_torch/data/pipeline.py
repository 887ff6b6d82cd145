"""Deterministic, restartable input pipeline with versioned state.

The pipeline's *cursor* (shard assignment, epoch, step, RNG key) is a
first-class artifact: the training loop commits it in the same
transactional run as params/optimizer snapshots, so a restart resumes
the exact token stream — the paper's replayable-pipelines property
applied to training data (DESIGN.md §2).

Straggler mitigation: shards are leased from a work queue with deadlines;
a shard whose lease expires is reassigned to the next idle reader
(simulated single-process here, exercised in tests).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineState:
    """Everything needed to resume the stream bitwise-identically."""

    shard_order_seed: int
    epoch: int
    step: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "PipelineState":
        return cls(**d)


class TokenDataset:
    """A token array split into shards of `shard_tokens` tokens."""

    def __init__(self, tokens: np.ndarray, shard_tokens: int):
        n = (len(tokens) // shard_tokens) * shard_tokens
        self.shards = tokens[:n].reshape(-1, shard_tokens)

    @property
    def num_shards(self) -> int:
        return len(self.shards)


class DataPipeline:
    """Global-batch iterator over a sharded token dataset."""

    def __init__(self, dataset: TokenDataset, *, batch: int, seq_len: int,
                 state: PipelineState | None = None, seed: int = 0):
        self.ds = dataset
        self.batch = batch
        self.seq_len = seq_len
        self.state = state or PipelineState(shard_order_seed=seed,
                                            epoch=0, step=0)
        self._tokens_per_batch = batch * (seq_len + 1)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.state.shard_order_seed, epoch))
        return rng.permutation(self.ds.num_shards)

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (inputs (B,S), targets (B,S)) and advances the cursor."""
        st = self.state
        flat_needed = self._tokens_per_batch
        shard_tokens = self.ds.shards.shape[1]
        shards_per_batch = -(-flat_needed // shard_tokens)
        order = self._epoch_order(st.epoch)
        start = st.step * shards_per_batch
        if start + shards_per_batch > len(order):
            st = PipelineState(st.shard_order_seed, st.epoch + 1, 0)
            order = self._epoch_order(st.epoch)
            start = 0
        idx = order[start:start + shards_per_batch]
        flat = self.ds.shards[idx].reshape(-1)[:flat_needed]
        arr = flat.reshape(self.batch, self.seq_len + 1)
        self.state = PipelineState(st.shard_order_seed, st.epoch,
                                   st.step + 1)
        return arr[:, :-1], arr[:, 1:]


# ---------------------------------------------------------------------------
# Straggler-tolerant shard leasing (work-stealing queue)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Lease:
    shard: int
    reader: str
    deadline: float
    done: bool = False


class ShardLeaseQueue:
    """Deadline-based shard leasing: slow readers lose their lease and the
    shard is reassigned — no shard is lost, no shard is published twice
    (publication goes through the transactional run)."""

    def __init__(self, num_shards: int, *, lease_seconds: float = 30.0,
                 clock=time.monotonic):
        self.pending: list[int] = list(range(num_shards))
        self.leases: dict[int, Lease] = {}
        self.completed: set[int] = set()
        self.lease_seconds = lease_seconds
        self.clock = clock

    def acquire(self, reader: str) -> int | None:
        now = self.clock()
        # reclaim expired leases (straggler mitigation)
        for shard, lease in list(self.leases.items()):
            if not lease.done and lease.deadline < now:
                del self.leases[shard]
                self.pending.append(shard)
        if not self.pending:
            return None
        shard = self.pending.pop(0)
        self.leases[shard] = Lease(shard, reader,
                                   now + self.lease_seconds)
        return shard

    def complete(self, reader: str, shard: int) -> bool:
        lease = self.leases.get(shard)
        if lease is None or lease.reader != reader:
            return False  # lease was reassigned; drop duplicate work
        if shard in self.completed:
            return False
        lease.done = True
        self.completed.add(shard)
        return True

    @property
    def finished(self) -> bool:
        return len(self.completed) == \
            len(self.completed | set(self.pending)) and not self.pending \
            and all(l.done for l in self.leases.values())
