"""The port's mLSTM (``repro_torch/kernels/mlstm``) and xLSTM blocks
(``repro_torch/models/xlstm.py``) against ``repro``'s.

On the CPU the wrapper runs the plain sequential recurrence; it is held
against ``repro``'s sequential oracle (``mlstm_ref``) and the Pallas
chunkwise kernel in interpret mode (``repro.kernels.mlstm.ops.mlstm``)
on the shapes and input distributions of ``tests/test_kernels.py``, at
``repro``'s own tolerance for the chunkwise form against the recurrence,
rtol = atol = 2e-4 (the two forms sum in different orders, all float32),
and beside it to 1e-5 of the largest |h|: at this draw a typical |h| is
~1e-2, so 2e-4 alone would pass products rounded to TF32 or bf16 (the
readings are ~1e-7 to 1e-6 of the largest |h|). bfloat16 inputs are the same bfloat16 values on both sides and are cast
to float32 on entry, so they keep that tolerance.

The blocks take ``repro``'s parameters (drawn by its initializers) on
the same numpy inputs, in float32, at rtol = atol = 1e-4: the same
arithmetic in another summation order (measured ~1e-6).

The CUDA kernel itself runs only on the card:
``test_torch_mlstm_cuda.py``, which needs no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.mlstm.ops import mlstm as jmlstm  # noqa: E402
from repro.kernels.mlstm.ref import mlstm_ref as jref  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.mlstm import ops, ref  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402

TOL = 2e-4
REL = 1e-5      # of max |h|
F32 = dict(dtype="float32", param_dtype="float32")


def _inputs(B, S, hd, seed, dtype=np.float32):
    """``tests/test_kernels.py``'s distribution: q, k ~ N(0, 1/hd), v ~
    N(0, 1), log_i <= 0, log_f = log sigmoid(N(2, 1))."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, S, hd)) / np.sqrt(hd)
    k = r.standard_normal((B, S, hd)) / np.sqrt(hd)
    v = r.standard_normal((B, S, hd))
    log_i = -np.logaddexp(0, -r.standard_normal((B, S)))
    log_f = -np.logaddexp(0, -r.standard_normal((B, S)) - 2.0)
    qkv = [np.asarray(jnp.asarray(x, dtype)) for x in (q, k, v)]
    return (*qkv, log_i.astype(np.float32), log_f.astype(np.float32))


def _close_to(got, want):
    """Within repro's 2e-4 and within REL of the largest |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def _torch(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,hd", [(1, 128, 64), (2, 256, 32),
                                    (1, 512, 64)])
def test_plain_matches_oracle_and_pallas_kernel(B, S, hd, dtype):
    args = _inputs(B, S, hd, seed=S + hd, dtype=dtype)
    got = ops.mlstm(*map(_torch, args), chunk=64)
    assert got.dtype == torch.float32 and got.shape == (B, S, hd)
    jargs = [jnp.asarray(a) for a in args]
    oracle = np.asarray(jref(*jargs))
    pallas = np.asarray(jmlstm(*jargs, chunk=64, interpret=True))
    _close_to(got.numpy(), oracle)
    _close_to(got.numpy(), pallas)


def test_extreme_gates_stay_finite_and_match():
    """log_f near -30 (the state is forgotten every step) and log_i up to
    +10: the stabilizer keeps every exponent <= 0 on both sides."""
    q, k, v, _, _ = _inputs(2, 96, 32, seed=7)
    r = np.random.default_rng(8)
    log_i = r.uniform(-10, 10, (2, 96)).astype(np.float32)
    log_f = r.uniform(-31, -29, (2, 96)).astype(np.float32)
    got = ref.mlstm_ref(*map(_torch, (q, k, v, log_i, log_f))).numpy()
    want = np.asarray(jref(*(jnp.asarray(a)
                             for a in (q, k, v, log_i, log_f))))
    assert np.isfinite(got).all()
    _close_to(got, want)


def test_cpu_calls_do_not_count_and_the_chunk_must_divide_s():
    args = [_torch(a) for a in _inputs(1, 300, 32, seed=3)]
    before = ops.mlstm.launches
    ops.mlstm(*args, chunk=100)
    ops.mlstm(*args, chunk=512)          # min(chunk, S) = S divides S
    assert ops.mlstm.launches == before
    with pytest.raises(ValueError, match="divide"):
        ops.mlstm(*args)                 # 256 does not divide 300
    with pytest.raises(ValueError, match="BH, S, hd"):
        ops.mlstm(args[0][0], *args[1:])


# ---------------------------------------------------------------------------
# the CUDA kernel's two-pass algebra (kernels/mlstm/ref.py), on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 64, 256])
@pytest.mark.parametrize("gates", ["paper", "extreme"])
def test_two_pass_states_and_outputs(chunk, gates):
    """The chunk-parallel form the kernel computes: each chunk's own
    state, the sequential combine at the chunk starts, the outputs. Its
    (C, n, m) at every chunk start equal the recurrence's, C and n to
    1e-5 of their largest entry, m to 1e-5, and its h is finite. With
    the paper's gates its h equals repro's Pallas kernel in interpret
    mode (chunks of ``chunk``) and the recurrence within repro's 2e-4
    and 1e-5 of max|h|; with extreme gates, at the kernel's chunk of 64,
    the recurrence. (At chunk 16 this draw's extreme gates leave rows
    whose |n . q| cancels to ~1e-2 of |q||k|: there every float32 form,
    repro's Pallas kernel included, moves by more than 1e-5 of max|h|
    with the order of its sums.) S = 500 leaves a ragged last chunk."""
    q, k, v, log_i, log_f = _inputs(2, 500, 32, seed=chunk)
    if gates == "extreme":
        r = np.random.default_rng(9)
        log_i = r.uniform(-10, 10, (2, 500)).astype(np.float32)
        log_f = r.uniform(-31, -29, (2, 500)).astype(np.float32)
    args = [_torch(a) for a in (q, k, v, log_i, log_f)]
    got, (C, n, m) = ref.mlstm_two_pass_ref(*args, chunk=chunk)
    want_C, want_n, want_m = ref.mlstm_ref_states(*args, chunk=chunk)
    np.testing.assert_allclose(m.numpy(), want_m.numpy(), rtol=0, atol=1e-5)
    for x, y in ((C, want_C), (n, want_n)):
        assert float((x - y).abs().max()) <= 1e-5 * max(
            float(y.abs().max()), 1e-30)
    assert bool(torch.isfinite(got).all())
    if gates == "extreme":
        if chunk == 64:
            _close_to(got.numpy(), ref.mlstm_ref(*args).numpy())
        return
    _close_to(got.numpy(), ref.mlstm_ref(*args).numpy())
    # repro's kernel needs the chunk to divide S: its first 256 or 384 steps
    cut = 384 if chunk != 256 else 256
    jargs = [jnp.asarray(a[:, :cut]) for a in (q, k, v, log_i, log_f)]
    pallas = np.asarray(jmlstm(*jargs, chunk=chunk, interpret=True))
    _close_to(got.numpy()[:, :cut], pallas)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _cfgs(**over):
    return (dataclasses.replace(jax_smoke("xlstm_350m"), **F32, **over),
            dataclasses.replace(get_smoke_config("xlstm_350m"), **F32,
                                **over))


def _tree(tree):
    return {k: _torch(v) for k, v in tree.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                               np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("S", [48, 512], ids=["S48", "S512"])
def test_mlstm_forward_prefill(S):
    """Prefill from no state: the port's kernel path (its plain version
    here) against repro's chunks of 256 (S = 512 crosses one)."""
    jc, tc = _cfgs()
    p = JX.mlstm_init(jax.random.PRNGKey(0), jc)
    x = _x((2, S, jc.d_model), 1)
    want, wst = jax.jit(lambda x: JX.mlstm_forward(p, x, jc))(jnp.asarray(x))
    got, gst = TX.mlstm_forward(_tree(p), _torch(x), tc)
    assert wst is None and gst is None
    _close(got, want)


def test_mlstm_decode_steps_and_prefill_with_state():
    jc, tc = _cfgs()
    p = JX.mlstm_init(jax.random.PRNGKey(1), jc)
    tp = _tree(p)
    jst, tst = JX.mlstm_state_init(jc, 2), TX.mlstm_state_init(tc, 2)
    for name in ("C", "n", "m"):
        assert tuple(tst[name].shape) == jst[name].shape
        assert tst[name].dtype == torch.float32
    step = jax.jit(lambda s, x: JX.mlstm_forward(p, x, jc, s))
    for x in _x((30, 2, 1, jc.d_model), 2):
        want, jst = step(jst, jnp.asarray(x))
        got, tst = TX.mlstm_forward(tp, _torch(x), tc, tst)
        _close(got, want)
    for name in ("C", "n", "m"):
        _close(tst[name], jst[name])
    # a prefill from a carried state is refused: only decode carries one
    with pytest.raises(ValueError, match="one token"):
        TX.mlstm_forward(tp, _torch(_x((2, 16, jc.d_model), 3)), tc, tst)


def test_slstm_forward_decode_and_state():
    jc, tc = _cfgs()
    p = JX.slstm_init(jax.random.PRNGKey(2), jc)
    tp = _tree(p)
    x = _x((2, 40, jc.d_model), 4)
    want, wnone = jax.jit(lambda x: JX.slstm_forward(p, x, jc))(
        jnp.asarray(x))
    got, gnone = TX.slstm_forward(tp, _torch(x), tc)
    assert wnone is None and gnone is None
    _close(got, want)
    jst, tst = JX.slstm_state_init(jc, 2), TX.slstm_state_init(tc, 2)
    assert all(tuple(tst[k].shape) == jst[k].shape for k in jst)
    step = jax.jit(lambda s, x: JX.slstm_forward(p, x, jc, s))
    for x in _x((20, 2, 1, jc.d_model), 5):
        want, jst = step(jst, jnp.asarray(x))
        got, tst = TX.slstm_forward(tp, _torch(x), tc, tst)
        _close(got, want)
    for name in ("c", "n", "m", "h"):
        _close(tst[name], jst[name])


def test_params_follow_repro_shapes_dtypes_and_inits():
    from repro_torch.models.layers import ParamModule
    jc, tc = _cfgs()
    for jinit, tparams in ((JX.mlstm_init, TX.mlstm_params),
                           (JX.slstm_init, TX.slstm_params)):
        want = jinit(jax.random.PRNGKey(3), jc)
        mod = ParamModule(tparams(tc), "cpu")
        mod.init_params(torch.Generator().manual_seed(0))
        assert sorted(want) == sorted(dict(mod.named_parameters()))
        for name, w in want.items():
            assert tuple(mod[name].shape) == w.shape, name
            assert str(mod[name].dtype).split(".")[1] == str(w.dtype), name
        if "b_if" in want:
            np.testing.assert_array_equal(mod["b_if"].detach().numpy(),
                                          np.asarray(want["b_if"]))
            assert abs(float(mod["w_if"].std()) - 0.01) < 2e-3
        else:
            assert abs(float(mod["r"].std()) - 0.05) < 5e-3
            assert bool((mod["b"] == 0).all())
