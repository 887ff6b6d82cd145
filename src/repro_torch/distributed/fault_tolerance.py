"""Fault tolerance: crash-consistent restart + failure simulation.

The port of ``repro/distributed/fault_tolerance.py``, imports rewritten.

The guarantees come from composition with the paper's machinery:

1. **Crash consistency** — checkpoints are transactional commits
   (CheckpointManager), so a worker dying mid-save can never publish a
   torn {params, opt_state, cursor} triple; the branch head always names
   a complete checkpoint.
2. **Restart** — `resilient_train` wraps the training loop, catches
   (simulated or real) worker failures, and restarts from the branch
   head. The committed pipeline cursor makes the re-run bitwise identical.
3. **Straggler mitigation** — data-plane shard leases
   (`repro_torch.data.pipeline.ShardLeaseQueue`); slow readers lose leases,
   work is reassigned, and transactional publication deduplicates.
4. **Elastic downscale** — on repeated failure of the same pod, the
   caller can pass a smaller mesh; `repro_torch.distributed.elastic.
   reshard` places the restored logical checkpoint on it
   (`examples/elastic_rescale.py`).

`FailureInjector` deterministically kills the "worker" at chosen steps so
tests can assert all of the above without real hardware.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.checkpoints.checkpointing import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataPipeline
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig, train


class WorkerDied(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Kills the worker at each step listed in ``fail_at`` (once each)."""

    fail_at: tuple[int, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def on_step(self, step: int, metrics: dict) -> None:
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise WorkerDied(f"injected node failure at step {step}")


def resilient_train(cfg: ModelConfig, *, pipeline_factory: Callable[[], DataPipeline],
                    opt_cfg: AdamWConfig, tc: TrainConfig,
                    ckpt: CheckpointManager,
                    injector: FailureInjector | None = None,
                    max_restarts: int = 10,
                    jit_fn: Callable | None = None) -> dict:
    """Training with automatic restart-from-last-commit on worker death."""
    restarts = 0
    while True:
        pipeline = pipeline_factory()
        try:
            return train(cfg, pipeline=pipeline, opt_cfg=opt_cfg, tc=tc,
                         ckpt=ckpt, jit_fn=jit_fn,
                         on_step=injector.on_step if injector else None)
        except WorkerDied:
            restarts += 1
            if restarts > max_restarts:
                raise
            # loop: train() restores from the branch head (atomic commit)
            continue
