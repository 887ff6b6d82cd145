"""The port's serving path (``repro_torch/serving``, ``checkpoints``,
``launch/serve.py``) against ``repro``'s.

- ``ServeLoop``: the same requests (a numpy seed) on both packages with
  the same float32 smoke parameters give the same generated tokens (the
  port reproduces ``repro``'s slot refill as it is; ROADMAP R6).
- The pinned-commit guarantee: a later checkpoint on ``main`` leaves the
  replica's params bit-equal.
- A checkpoint that ``repro``'s ``CheckpointManager`` wrote into a
  ``FileStore`` reads into the port with the same params, bit for bit.
- The launcher runs on the CPU when asked, and serves the same
  architecture as ``repro``'s when no ``--arch`` is given.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.checkpoints.checkpointing import CheckpointManager as JCkpt  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.catalog import Catalog as JCatalog  # noqa: E402
from repro.core.store import FileStore as JFileStore  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import serve_loop as JS  # noqa: E402
from repro.training.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro_torch.checkpoints.checkpointing import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_from_store  # noqa: E402
from repro_torch.core.catalog import Catalog  # noqa: E402
from repro_torch.core.store import FileStore, get_pytree_leaves  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.serve_loop import (Request, ServeLoop,  # noqa: E402
                                            load_params_at)
from repro_torch.training.optimizer import AdamWState, adamw_init  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")


class _Client:
    def __init__(self, catalog):
        self.catalog = catalog
        self.store = catalog.store


def _prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(4, 12)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "phi4_mini_3b",
                                  "xlstm_350m"])
def test_serve_loop_generates_the_same_tokens(arch):
    jc = dataclasses.replace(jax_smoke(arch), **F32)
    tc = dataclasses.replace(get_smoke_config(arch), **F32)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    model = Model(tc, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), tc))
    prompts = _prompts(8, tc.vocab_size)
    jloop = JS.ServeLoop(jc, jp, batch_slots=4, max_len=64)
    tloop = ServeLoop(tc, model, batch_slots=4, max_len=64)
    jreqs = [JS.Request(rid=i, prompt=p, max_new=8)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new=8)
             for i, p in enumerate(prompts)]
    for loop, reqs in ((jloop, jreqs), (tloop, treqs)):
        for r in reqs:
            loop.submit(r)
        loop.run()
    assert all(r.done and len(r.out) == 8 for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]


def test_pinned_commit_is_not_torn_by_a_later_checkpoint():
    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3b"), **F32)
    model = Model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    params = model.state_dict()
    catalog = Catalog()
    ckpt = CheckpointManager(catalog)
    ckpt.save(step=100, params=params, opt_state=adamw_init(params),
              data_state={"epoch": 0, "shard_order_seed": 0},
              metrics={"loss": 2.0}, code="v1")
    catalog.tag("serving/v1", "main")
    client = _Client(catalog)
    served = load_params_at(client, "serving/v1", params)
    noisier = {k: v + 1.0 for k, v in params.items()}
    ckpt.save(step=200, params=noisier, opt_state=adamw_init(noisier),
              data_state={"epoch": 0, "shard_order_seed": 0},
              metrics={"loss": 1.5}, code="v2")
    assert ckpt.latest_step("main") == 200
    again = load_params_at(client, "serving/v1", params)
    for k in params:
        assert torch.equal(served[k], again[k])
        assert torch.equal(served[k], params[k])
    restored = ckpt.restore(params, adamw_init(params))
    assert torch.equal(restored[0]["embed"], noisier["embed"])
    assert isinstance(restored[1], AdamWState)
    assert restored[2]["step"] == 200 and restored[3]["loss"] == 1.5


def test_non_finite_params_are_refused():
    from repro_torch.core.errors import QualityError
    params = {"w": torch.tensor([1.0, float("nan")])}
    catalog = Catalog()
    with pytest.raises(QualityError, match="non-finite"):
        CheckpointManager(catalog).save(
            step=1, params=params, opt_state=adamw_init(params),
            data_state={}, metrics={})
    assert CheckpointManager(catalog).latest_step() is None


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reads_a_checkpoint_that_repro_wrote(tmp_path, dtype):
    over = dict(num_layers=5, dtype=dtype, param_dtype=dtype)
    jc = dataclasses.replace(jax_smoke("recurrentgemma_9b"), **over)
    tc = dataclasses.replace(get_smoke_config("recurrentgemma_9b"), **over)
    jp = JM.init_params(jax.random.PRNGKey(3), jc)
    jcatalog = JCatalog(JFileStore(str(tmp_path)))
    JCkpt(jcatalog).save(step=7, params=jp, opt_state=jadamw_init(jp),
                         data_state={"epoch": 0}, metrics={})
    key = jcatalog.read_table("main", "params")
    got = params_from_store(FileStore(str(tmp_path)), key, tc)
    want = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
    Model(tc, device="meta").load_state_dict(got, assign=True)
    opt_key = jcatalog.read_table("main", "opt_state")
    leaves = get_pytree_leaves(FileStore(str(tmp_path)), opt_key)
    assert leaves[0].dtype == torch.int32 and int(leaves[0]) == 0   # step


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "phi4_mini_3b",
                                  "xlstm_350m"])
def test_launcher_runs_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu", "--requests", "4",
                       "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "pinned replica to tag serving/v0" in out
    assert "completed 4 requests" in out


def test_launcher_defaults_to_repros_arch(monkeypatch, capsys):
    """With no ``--arch`` the port's launcher serves what ``repro``'s
    serves by default: xlstm_350m."""
    from repro.launch import serve as jserve
    picked = {}

    class _Stop(Exception):
        pass

    def spy(mod, key, stop):
        real = mod.get_smoke_config

        def get(arch):
            picked[key] = arch
            if stop:
                raise _Stop
            return real(arch)
        monkeypatch.setattr(mod, "get_smoke_config", get)

    spy(jserve, "repro", True)    # read repro's default, serve nothing
    spy(serve, "port", False)
    with pytest.raises(_Stop):
        jserve.main([])
    assert serve.main(["--device", "cpu", "--requests", "2",
                       "--max-new", "2"]) == 0
    assert picked == {"repro": "xlstm_350m", "port": "xlstm_350m"}
    assert "xlstm-350m: completed 2 requests" in capsys.readouterr().out
