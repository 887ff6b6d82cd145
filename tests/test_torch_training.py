"""The port's training loop, transactional checkpoints and fault tolerance
on the CPU (``repro_torch/training``, ``distributed/fault_tolerance.py``,
``launch/train.py``, ``examples/transactional_training.py``).

The loop tests mirror ``tests/test_training.py`` on the xlstm smoke
config. The port's CPU run is exact: a run killed and restarted from the
branch head ends with the same loss and the same parameters, bit for
bit, as an uninterrupted one (``repro`` holds it at rtol 1e-5).

The optimizer's functions are held against ``repro``'s on the same
numpy trees: float32 within rtol 1e-6 (float32 on both sides, in other
orders), a bfloat16 parameter within one bfloat16 step (2^-8 of the
value: the float32 updates may straddle a rounding boundary).

The kernels' ``autograd.Function``\\ s run here with their CUDA launch
replaced by the plain version (the card's launch is all they add), to
hold their backward passes against autograd of the plain versions,
inside and outside activation checkpointing.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_loop as JTL  # noqa: E402
from repro_torch.checkpoints.checkpointing import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.catalog import Catalog, Visibility  # noqa: E402
from repro_torch.core.errors import QualityError  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, TokenDataset  # noqa: E402
from repro_torch.data.synthetic import markov_corpus  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    FailureInjector, WorkerDied, resilient_train)
from repro_torch.examples import transactional_training  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.mlstm import kernel as mkernel  # noqa: E402
from repro_torch.kernels.mlstm import ops as mops  # noqa: E402
from repro_torch.kernels.mlstm.ref import mlstm_ref  # noqa: E402
from repro_torch.kernels.rglru import kernel as rkernel  # noqa: E402
from repro_torch.kernels.rglru import ops as rops  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.serve_loop import Request, ServeLoop  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training.train_loop import (TrainConfig,  # noqa: E402
                                             make_grad_fn, train)

CFG = get_smoke_config("xlstm_350m")
B, S = 4, 32


def _pipeline(seed=0):
    tokens = markov_corpus(B * S * 64, CFG.vocab_size, seed=seed)
    return DataPipeline(TokenDataset(tokens, shard_tokens=B * S * 2),
                        batch=B, seq_len=S, seed=seed)


@pytest.fixture(scope="module")
def short_run():
    catalog = Catalog()
    ckpt = CheckpointManager(catalog, branch="main")
    tc = TrainConfig(steps=8, ckpt_every=4, seed=0, device="cpu")
    result = train(CFG, pipeline=_pipeline(), opt_cfg=TO.AdamWConfig(lr=1e-3),
                   tc=tc, ckpt=ckpt)
    return catalog, ckpt, result


# ---------------------------------------------------------------------------
# the loop (mirrors of tests/test_training.py)
# ---------------------------------------------------------------------------

def test_loss_decreases(short_run):
    _, _, result = short_run
    hist = result["history"]
    assert [h["step"] for h in hist] == list(range(8))
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert all(p.device.type == "cpu" for p in result["params"].values())


def test_checkpoints_published_transactionally(short_run):
    catalog, ckpt, _ = short_run
    head = catalog.tables("main")
    assert set(head) == {"params", "opt_state", "data_state", "metrics"}
    assert ckpt.latest_step() == 8
    state = catalog.store.get_json(head["data_state"])
    assert state["step"] == 8
    assert set(state) == {"step", "shard_order_seed", "epoch"}
    prev = [c for c in catalog.log("main")
            if c.run_id == "ckpt_4" and len(c.tables) >= 4]
    assert prev, "step-4 checkpoint commit not found"


def test_restart_resumes_and_reproduces(short_run):
    """8 steps with a kill at step 5: the restart resumes from the step-4
    checkpoint and ends exactly where the uninterrupted run does."""
    _, _, baseline = short_run
    ckpt2 = CheckpointManager(Catalog(), branch="main")
    tc = TrainConfig(steps=8, ckpt_every=4, seed=0, device="cpu")
    inj = FailureInjector(fail_at=(5,))
    result = resilient_train(
        CFG, pipeline_factory=_pipeline, opt_cfg=TO.AdamWConfig(lr=1e-3),
        tc=tc, ckpt=ckpt2, injector=inj)
    assert inj._fired == {5}
    assert [h["step"] for h in result["history"]] == [4, 5, 6, 7]
    want = baseline["history"][-1]["loss"]
    np.testing.assert_allclose(result["history"][-1]["loss"], want,
                               rtol=1e-5)
    assert result["history"][-1]["loss"] == want          # exact on the CPU
    for k, p in baseline["params"].items():
        assert torch.equal(result["params"][k], p), k


def test_restart_gives_up_after_max_restarts():
    tc = TrainConfig(steps=3, ckpt_every=1, seed=0, device="cpu")
    inj = FailureInjector(fail_at=(1, 2))
    with pytest.raises(WorkerDied):
        resilient_train(CFG, pipeline_factory=_pipeline,
                        opt_cfg=TO.AdamWConfig(lr=1e-3), tc=tc,
                        ckpt=CheckpointManager(Catalog()), injector=inj,
                        max_restarts=1)


def test_checkpoint_rejects_nonfinite_params(short_run):
    _, _, result = short_run
    catalog = Catalog()
    ckpt = CheckpointManager(catalog, branch="main")
    params = dict(result["params"])
    params["embed"] = params["embed"].clone()
    params["embed"][0, 0] = float("nan")
    with pytest.raises(QualityError):
        ckpt.save(step=1, params=params, opt_state=result["opt_state"],
                  data_state={"epoch": 0, "shard_order_seed": 0},
                  metrics={})
    assert "params" not in catalog.tables("main")
    aborted = [b for b in catalog.branches()
               if catalog.branch_info(b).visibility is Visibility.ABORTED]
    assert aborted


def test_serving_reads_pinned_tag_during_training(short_run):
    """A replica pinned to a tag never sees later checkpoints."""
    catalog, ckpt, result = short_run
    cid = catalog.tag("serving/test", "main")
    ckpt.save(step=99, params=result["params"],
              opt_state=result["opt_state"],
              data_state={"epoch": 0, "shard_order_seed": 0},
              metrics={"loss": 0.0}, code="later")
    assert catalog.head("serving/test").id == cid
    assert ckpt.latest_step("serving/test") == 8
    assert ckpt.latest_step("main") == 99
    restored = ckpt.restore(result["params"], result["opt_state"],
                            ref="serving/test")
    assert restored[2]["step"] == 8


def test_restore_moves_the_state_back_to_the_models_dtype():
    """``restore`` returns CPU tensors; ``train`` puts them back on the
    model's device and dtype, and the step counter with them."""
    ckpt = CheckpointManager(Catalog())
    tc = TrainConfig(steps=2, ckpt_every=2, seed=0, device="cpu")
    first = train(CFG, pipeline=_pipeline(), opt_cfg=TO.AdamWConfig(),
                  tc=tc, ckpt=ckpt)
    more = train(CFG, pipeline=_pipeline(), opt_cfg=TO.AdamWConfig(),
                 tc=dataclasses.replace(tc, steps=3), ckpt=ckpt)
    assert [h["step"] for h in more["history"]] == [2]
    assert int(more["opt_state"].step) == 3
    assert more["opt_state"].step.dtype == torch.int32
    for k, p in first["params"].items():
        assert more["params"][k].dtype == p.dtype
    assert more["opt_state"].mu["embed"].dtype == torch.float32


@pytest.mark.parametrize("remat", [None, "full", "dots"])
def test_remat_changes_no_number(remat):
    model = Model(CFG, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in model.state_dict().items()}
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab_size, (2, 17)).astype(np.int32))
    base = make_grad_fn(CFG, TrainConfig(device="cpu"))(
        params, tok[:, :-1], tok[:, 1:])
    got = make_grad_fn(CFG, TrainConfig(remat=remat, device="cpu"))(
        params, tok[:, :-1], tok[:, 1:])
    assert float(got[0][0]) == float(base[0][0])
    for k, g in base[1].items():
        assert torch.equal(got[1][k], g), k


def test_batches_are_validated_against_the_contract():
    """An int64 token stream breaks the batch contract (int32) at the
    worker moment, before any step runs."""
    from repro_torch.core.errors import ContractRuntimeError
    tokens = markov_corpus(B * S * 8, CFG.vocab_size).astype(np.int64)
    bad = DataPipeline(TokenDataset(tokens, shard_tokens=B * S * 2),
                       batch=B, seq_len=S)
    with pytest.raises(ContractRuntimeError, match="inputs"):
        train(CFG, pipeline=bad, opt_cfg=TO.AdamWConfig(),
              tc=TrainConfig(steps=1, device="cpu"),
              on_step=lambda *_: pytest.fail("a step ran"))


@pytest.mark.parametrize("field", dataclasses.fields(JTL.TrainConfig),
                         ids=lambda f: f.name)
def test_train_config_takes_every_field_of_repros(field):
    """Code written for ``repro`` constructs the port's config: every
    field of ``repro``'s ``TrainConfig``, at ``repro``'s default."""
    value = (field.default_factory() if field.default is dataclasses.MISSING
             else field.default)
    tc = TrainConfig(**{field.name: value})
    assert getattr(tc, field.name) == value
    assert getattr(TrainConfig(), field.name) == value


def test_train_config_with_repros_logging_field_trains():
    """The root example's ``log_every=50`` trains a step (it is ignored,
    as ``repro``'s ``train`` ignores it)."""
    tc = TrainConfig(steps=1, ckpt_every=25, log_every=50, device="cpu")
    result = train(CFG, pipeline=_pipeline(), opt_cfg=TO.AdamWConfig(lr=1e-3),
                   tc=tc, ckpt=CheckpointManager(Catalog(), branch="main"))
    [step] = result["history"]
    assert step["step"] == 0 and np.isfinite(step["loss"])


# ---------------------------------------------------------------------------
# the optimizer against repro's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_repro(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=50, schedule=schedule)
    for step in (0, 1, 5, 10, 11, 30, 49, 50, 80):
        got = TO.lr_at(TO.AdamWConfig(**kw), torch.tensor(step))
        want = JO.lr_at(JO.AdamWConfig(**kw), jnp.asarray(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=str(step))


def _trees(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_repro(max_norm):
    g = _trees(0, np.float32)
    got, gn = TO.clip_by_global_norm({k: torch.from_numpy(v)
                                      for k, v in g.items()}, max_norm)
    want, wn = JO.clip_by_global_norm({k: jnp.asarray(v)
                                       for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_repro(dtype):
    p, g = _trees(1, np.float32), _trees(2, np.float32)
    tdt = getattr(torch, dtype)
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p.items()}
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in p.items()}
    tg = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
    jg = {k: jnp.asarray(v).astype(dtype) for k, v in g.items()}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0)
    ts, js = TO.adamw_init(tp), JO.adamw_init(jp)
    for _ in range(3):
        tp, ts, tm = TO.adamw_update(TO.AdamWConfig(**cfg), tg, ts, tp)
        jp, js, jm = JO.adamw_update(JO.AdamWConfig(**cfg), jg, js, jp)
        assert int(ts.step) == int(js.step)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        rtol = 1e-6 if dtype == "float32" else 2 ** -8
        for k in p:
            assert tp[k].dtype == tdt and ts.mu[k].dtype == torch.float32
            np.testing.assert_allclose(tp[k].float().numpy(),
                                       np.asarray(jp[k], np.float32),
                                       rtol=rtol, atol=1e-7)
            np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]),
                                       rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# the kernels' autograd.Functions, launch replaced by the plain version
# ---------------------------------------------------------------------------

def _functions(monkeypatch):
    """Each kernel's Function, with the CUDA launch replaced by the plain
    version, and its plain version."""
    monkeypatch.setattr(mkernel, "mlstm_chunkwise", mlstm_ref)
    monkeypatch.setattr(rkernel, "rglru_scan", rglru_scan_ref)
    monkeypatch.setattr(fkernel, "flash_attention",
                        lambda q, k, v, **kw: (flash_attention_ref(
                            q, k, v, **kw), "simt"))
    g = torch.Generator().manual_seed(0)
    n = lambda *s: torch.randn(*s, generator=g)
    mlstm_in = [n(4, 40, 16) / 4, n(4, 40, 16) / 4, n(4, 40, 16),
                -torch.nn.functional.softplus(-n(4, 40)),
                -torch.nn.functional.softplus(-n(4, 40) - 2.0)]
    kw = dict(causal=True, window=7)
    return [
        (mops._MlstmKernel.apply, mlstm_ref, mlstm_in, mops.mlstm),
        (lambda q, k, v: fops._FlashKernel.apply(q, k, v, True, 7),
         lambda q, k, v: flash_attention_ref(q, k, v, **kw),
         [n(2, 4, 24, 16), n(2, 2, 24, 16), n(2, 2, 24, 16)],
         fops.flash_attention),
        (rops._RglruKernel.apply, rglru_scan_ref,
         [torch.sigmoid(n(2, 24, 8)), n(2, 24, 8)], rops.rglru_scan)]


@pytest.mark.parametrize("under", [None, "full", "dots"])
def test_kernel_functions_give_the_plain_gradients(monkeypatch, under):
    """Alone, and inside the model's two remat contexts (a checkpoint,
    and the selective one that saves the weight products)."""
    import functools
    from torch.utils import checkpoint

    from repro_torch.models import model as M
    context = (functools.partial(checkpoint.create_selective_checkpoint_contexts,
                                 M._dots_policy) if under == "dots"
               else checkpoint.noop_context_fn)
    for fn, plain, inputs, wrapper in _functions(monkeypatch):
        inputs = [t.requires_grad_(True) for t in inputs]
        before = wrapper.launches
        run = fn if under is None else (
            lambda *xs, fn=fn: checkpoint.checkpoint(
                fn, *xs, use_reentrant=False, context_fn=context))
        out = run(*inputs)
        assert out.grad_fn is not None
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
        got = torch.autograd.grad((out * g).sum(), inputs)
        # one launch for the forward, and one more when checkpointing
        # recomputes it; the backward itself launches nothing
        assert wrapper.launches - before == (1 if under is None else 2)
        want = torch.autograd.grad((plain(*inputs) * g).sum(), inputs)
        for a, b in zip(got, want):
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_launcher_trains_on_the_cpu(capsys):
    rc = launch_train.main(["--device", "cpu", "--steps", "10", "--batch",
                            "4", "--seq-len", "32", "--ckpt-every", "4",
                            "--kill-at", "6", "--lr", "3e-3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "survived 1 injected failure(s)" in out
    assert "on cpu" in out and "all transactional" in out


def test_launcher_defaults_to_the_card_and_repros_arch(monkeypatch):
    seen = {}
    monkeypatch.setattr(launch_train, "train",
                        lambda cfg, **kw: seen.update(cfg=cfg, **kw) or
                        (_ for _ in ()).throw(SystemExit(0)))
    with pytest.raises(SystemExit):
        launch_train.main([])
    assert seen["tc"].device == "cuda" and seen["cfg"].name == "xlstm-350m"
    assert seen["cfg"] == CFG                          # --smoke by default


def test_example_kills_restarts_and_matches(capsys):
    out = transactional_training.main(["--device", "cpu", "--steps", "26"])
    assert out["killed_at"] == [8, 17] and out["published"] == 1
    assert out["drift"] == 0.0                          # exact on the CPU
    assert "published checkpoints complete" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# serving builds no graph
# ---------------------------------------------------------------------------

def test_serving_builds_no_autograd_graph(monkeypatch):
    """The model's parameters require gradients, yet ``ServeLoop`` and the
    serving launcher give no output a ``grad_fn``."""
    outputs = []
    for name in ("forward", "decode_step"):
        orig = getattr(Model, name)

        def spy(self, *a, _orig=orig, **kw):
            out = _orig(self, *a, **kw)
            outputs.append(out[0])
            return out
        monkeypatch.setattr(Model, name, spy)
    model = Model(CFG, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert all(p.requires_grad for p in model.parameters())
    loop = ServeLoop(CFG, model, batch_slots=2, max_len=16)
    loop.submit(Request(rid=0, prompt=np.array([1, 2, 3], np.int32),
                        max_new=3))
    loop.run()
    assert launch_serve.main(["--device", "cpu", "--requests", "2"]) == 0
    assert outputs and all(o.grad_fn is None for o in outputs)
    # the same model outside a serving caller does build one
    assert model(torch.zeros(1, 4, dtype=torch.int32))[0].grad_fn is not None


@pytest.mark.parametrize("H,K,window", [(4, 4, None), (4, 2, 5), (6, 1, 11)])
def test_flash_backward_by_query_blocks_matches_autograd(H, K, window):
    """The flash wrapper's plain backward, one block of queries at a time
    (blocks of 8 over 37 queries), against autograd of the whole-matrix
    plain version, in float64 inputs (float32 math on both sides)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, n, 37, 16, generator=g, dtype=torch.float64,
                           requires_grad=True) for n in (H, K, K))
    out = flash_attention_ref(q, k, v, causal=True, window=window)
    dout = torch.randn(out.shape, generator=g, dtype=torch.float64)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                  out.detach(), dout, causal=True,
                                  window=window, block_q=8)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
