"""Serving against a pinned commit while training publishes new
checkpoints (the snapshot-read guarantee at the serving boundary).

    PYTHONPATH=src python -m repro_torch.examples.serve_pinned_commit \\
        [--device cpu]

The port of the root ``examples/serve_pinned_commit.py``: its steps,
prints and asserts, on the card unless ``--device`` says otherwise
(``repro_torch.examples.entry``). The smoke ``phi4_mini_3b`` config's
weights are drawn from seed 0, or given as a ``state_dict`` (a test
passes ``repro``'s ``init_params(PRNGKey(0))`` through
``repro_torch.convert.params_from_jax``); the checkpoint goes through
the port's ``CheckpointManager``, the replica reads it back with
``load_params_at``, and ``ServeLoop`` serves eight requests on the
model's device.
"""
import numpy as np
import torch

from repro_torch.checkpoints.checkpointing import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core.catalog import Catalog
from repro_torch.examples.entry import device_arg, on_device
from repro_torch.models.model import Model
from repro_torch.serving.serve_loop import Request, ServeLoop, load_params_at
from repro_torch.training.optimizer import adamw_init


class _Client:
    def __init__(self, catalog):
        self.catalog = catalog
        self.store = catalog.store


def run(device: str, params: "dict | None" = None) -> list:
    cfg = get_smoke_config("phi4_mini_3b")
    if params is None:
        g = torch.Generator(device=device)
        g.manual_seed(0)
        params = {k: v.detach().cpu() for k, v in Model(
            cfg, device=device).init_params(g).state_dict().items()}

    catalog = Catalog()
    ckpt = CheckpointManager(catalog)
    ckpt.save(step=100, params=params, opt_state=adamw_init(params),
              data_state={"epoch": 0, "shard_order_seed": 0},
              metrics={"loss": 2.0}, code="v1")
    catalog.tag("serving/v1", "main")
    print("replica pinned to tag serving/v1")

    # replica loads from the immutable tag
    client = _Client(catalog)
    like = params
    served_params = load_params_at(client, "serving/v1", like)

    # training publishes newer checkpoints on main — replica unaffected
    noisier = {k: v + 1.0 if v.is_floating_point() else v
               for k, v in like.items()}
    ckpt.save(step=200, params=noisier, opt_state=adamw_init(params),
              data_state={"epoch": 0, "shard_order_seed": 0},
              metrics={"loss": 1.5}, code="v2")
    pinned_again = load_params_at(client, "serving/v1", like)
    same = all(torch.equal(served_params[k], pinned_again[k])
               for k in served_params)
    print(f"main advanced to step {ckpt.latest_step('main')}; "
          f"pinned replica params unchanged: {same}")
    assert same

    # continuous-batching decode on the pinned params
    model = Model(cfg, device=device)
    model.load_state_dict(served_params)
    loop = ServeLoop(cfg, model, batch_slots=4, max_len=64)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, 6).astype(np.int32), max_new=8)
        for i in range(8)]
    for r in reqs:
        loop.submit(r)
    loop.run()
    print(f"served {sum(r.done for r in reqs)}/8 requests; "
          f"sample completion: {reqs[0].out}")

    # promotion is a catalog op, not a file copy:
    catalog.tag("serving/v2", "main")
    print("promotion: tagged serving/v2 ->", catalog.head("serving/v2").id[:10])
    return [r.out for r in reqs]


def main(device: str = "cuda", params: "dict | None" = None) -> list:
    """The walk-through on ``device`` (with ``torch_auto`` there active),
    serving ``params`` when given; returns each request's tokens."""
    with on_device(device):
        return run(device, params)


if __name__ == "__main__":
    main(device_arg(__doc__))
