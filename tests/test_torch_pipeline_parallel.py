"""The port's GPipe pipeline (``repro_torch.distributed.pipeline_
parallel``) on two gloo ranks on the CPU: S=2 stages of tanh layers in
M=4 microbatches against ``repro``'s sequential composition, and the
smoke phi4-mini split into two stages against its one-rank forward."""
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.launch.mesh import make_host_mesh, run_ranks

S, M, B, D = 2, 4, 8, 16
TIMEOUT_S = 180


def _tanh_stages(rank, world, ws, x):
    from repro_torch.distributed.pipeline_parallel import pipeline_forward
    mesh = make_host_mesh(pipe=world, device="cpu")
    mine = {"w": torch.from_numpy(ws[rank])}       # this stage's alone
    return pipeline_forward(lambda p, h: torch.tanh(h @ p["w"]), mine,
                            torch.from_numpy(x), mesh=mesh,
                            num_microbatches=M).numpy()


def test_tanh_stages_match_repros_composition():
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(S, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    want = jnp.asarray(x)
    for s in range(S):
        want = jnp.tanh(want @ jnp.asarray(ws[s]))
    outs = run_ranks(_tanh_stages, S, ws, x, backend="gloo",
                     timeout_s=TIMEOUT_S, threads=1)
    for got in outs:                  # every rank returns the full batch
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_one_stage_pipeline_is_the_stage():
    """A one-rank ``pipe`` mesh: no transfer, the stage over each
    microbatch in order (``tests/test_distributed.py``'s case)."""
    out = run_ranks(_one_stage, 1, backend="gloo", timeout_s=TIMEOUT_S)[0]
    assert torch.equal(out, torch.arange(8.0).reshape(2, 4) * 2)


def _one_stage(rank, world):
    from repro_torch.distributed.pipeline_parallel import pipeline_forward
    mesh = make_host_mesh(pipe=1, device="cpu")
    x = torch.arange(8.0).reshape(2, 4)
    return pipeline_forward(lambda p, h: h * p, 2.0, x, mesh=mesh,
                            num_microbatches=2)


def _smoke_model(cfg):
    from repro_torch.models.model import Model
    model = Model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    return model


def _phi4_stages(rank, world, tokens):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.pipeline_parallel import pipeline_forward
    from repro_torch.models import layers as L
    cfg = get_smoke_config("phi4_mini_3b")
    model = _smoke_model(cfg)
    per = cfg.num_layers // world
    mine = model.layers[rank * per:(rank + 1) * per]
    mesh = make_host_mesh(pipe=world, device="cpu")
    tokens = torch.from_numpy(tokens)
    with torch.no_grad():
        # stage 0 embeds; the others pass a placeholder of its shape
        x = (model._embed(tokens) if rank == 0 else torch.zeros(
            *tokens.shape, cfg.d_model, dtype=getattr(torch, cfg.dtype)))

        def stage(layers, h):
            for layer in layers:
                h = layer(h)[0]
            return h
        h = pipeline_forward(stage, mine, x, mesh=mesh,
                             num_microbatches=M)
        return L.rmsnorm(model.final_norm, h, cfg.norm_eps).float().numpy()


def test_smoke_phi4_in_two_stages_matches_one_rank():
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("phi4_mini_3b")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 16)).astype(np.int64)
    with torch.no_grad():
        want, _ = _smoke_model(cfg)(torch.from_numpy(tokens), mode="hidden")
    outs = run_ranks(_phi4_stages, 2, tokens, backend="gloo",
                     timeout_s=TIMEOUT_S, threads=1)
    for got in outs:
        # the same layers on the same rows, in the same order: equal
        np.testing.assert_array_equal(got, want.float().numpy())
