"""The port's ``torch`` execution backend against ``repro``'s backends.

``TorchBackend(device="cpu")`` (the plain PyTorch versions of the
segment kernels) is held against ``repro``'s ``reference`` oracle and
its ``jax`` backend with the Pallas kernels in interpret mode, for every
aggregate function, on the differential fixtures of
``tests/test_exec_backends.py`` and ``tests/test_group_by_agg.py``: NULL
and NaN keys and values, object and int64 columns. Integers, counts,
MIN/MAX and validity are exact; float SUM/MEAN compare at rtol 1e-9
(atol 1e-9 near zero), the summation-order carve-out of
``repro/exec/base.py``.

Signed zeros are held against ``reference`` only: ``jax`` (XLA and
Pallas) returns -0.0 for every tied MIN and +0.0 for every tied MAX,
where ``reference`` keeps the later row's zero (ROADMAP R4).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.data.tables import Table as JTable  # noqa: E402
from repro.data.tables import _ColumnData as JColumn  # noqa: E402
from repro.exec.base import AGG_FNS  # noqa: E402
from repro.exec.jax_backend import JaxBackend  # noqa: E402
from test_exec_backends import random_table  # noqa: E402
from test_group_by_agg import _pin_fixtures, adversarial_table  # noqa: E402

from repro_torch import exec as exec_backends  # noqa: E402
from repro_torch.data.tables import Table, _ColumnData  # noqa: E402
from repro_torch.exec import BackendUnavailable  # noqa: E402
from repro_torch.exec import torch_backend  # noqa: E402
from repro_torch.exec.torch_backend import TorchBackend  # noqa: E402

CPU = TorchBackend(device="cpu")
PALLAS = JaxBackend(use_pallas=True, interpret=True)


def to_port(t: JTable) -> Table:
    """The same columns (values and validity) as a port Table."""
    out = Table({})
    for name in t.column_names():
        c = t._data[name]
        out._data[name] = _ColumnData(
            c.values.copy(), None if c.valid is None else c.valid.copy())
    return out


def assert_agg_equal(got: Table, want: JTable, float_cols=()):
    assert got.column_names() == want.column_names()
    assert len(got) == len(want)
    for c in got.column_names():
        assert got.validity(c).tolist() == want.validity(c).tolist(), c
        if c in float_cols:
            m = want.validity(c)
            np.testing.assert_allclose(
                np.asarray(got.column(c)[m], dtype=float),
                np.asarray(want.column(c)[m], dtype=float),
                rtol=1e-9, atol=1e-9)
        else:
            # repr equality: NaN == NaN, None == None, dtype-faithful
            assert ([repr(x) for x in got.column(c)]
                    == [repr(y) for y in want.column(c)]), c


def _specs(values):
    return tuple((fn, v) for fn in AGG_FNS for v in values)


def _float_outs(values, float_values):
    return {f"{v}_{fn}" for v in float_values for fn in ("sum", "mean")}


@pytest.fixture
def device_calls(monkeypatch):
    """Counts the backend's calls into the segment wrappers, on any
    device (the wrappers' own ``launches`` count the card only)."""
    calls = {"sum": 0, "reduce": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(torch_backend, "masked_segment_sum",
                        spy("sum", torch_backend.masked_segment_sum))
    monkeypatch.setattr(torch_backend, "masked_segment_reduce",
                        spy("reduce", torch_backend.masked_segment_reduce))
    return calls


# ---------------------------------------------------------------------------
# differential: every agg fn, the repo's fixtures, two oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("oracle", ["reference", PALLAS],
                         ids=["reference", "jax-pallas"])
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("keys", [["ki"], ["ks"], ["f"], ["ki", "ks"]])
def test_random_table_matches(oracle, seed, keys):
    jt = random_table(300, seed)
    values = ("f", "v", "v32")
    want = jt.group_by(keys).agg(*_specs(values), backend=oracle)
    got = to_port(jt).group_by(keys).agg(*_specs(values), backend=CPU)
    assert_agg_equal(got, want, _float_outs(values, ["f"]))


@pytest.mark.parametrize("oracle", ["reference", PALLAS],
                         ids=["reference", "jax-pallas"])
@pytest.mark.parametrize("keys", [["ki"], ["kf"], ["ks"], ["ki", "ks"]])
def test_adversarial_table_matches(oracle, keys):
    jt = adversarial_table(400, seed=1)
    values = ("v32", "f", "vo")
    want = jt.group_by(keys).agg(*_specs(values), backend=oracle)
    got = to_port(jt).group_by(keys).agg(*_specs(values), backend=CPU)
    assert_agg_equal(got, want, _float_outs(values, ["f"]))


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.int8,
                                   np.float32])
def test_wide_values_stay_on_the_device_path(dtype, device_calls):
    """int64 and float64 go through the segment wrappers (no numpy
    fallback: torch has native 64-bit types), NULLs and NaNs included,
    and match ``reference``."""
    r = np.random.default_rng(4)
    n = 500
    vals = (r.integers(-2**40, 2**40, n) if np.dtype(dtype).kind == "i"
            and np.dtype(dtype).itemsize == 8 else
            r.integers(-100, 100, n) if np.dtype(dtype).kind == "i"
            else r.normal(size=n)).astype(dtype)
    if np.dtype(dtype).kind == "f":
        vals[r.random(n) < 0.05] = np.nan
    jt = JTable({"k": r.integers(0, 9, n).astype(np.int64)})
    jt._data["x"] = JColumn(vals, r.random(n) > 0.2)
    want = jt.group_by(["k"]).agg(*_specs(["x"]), backend="reference")
    got = to_port(jt).group_by(["k"]).agg(*_specs(["x"]), backend=CPU)
    float_cols = ({"x_sum", "x_mean"} if np.dtype(dtype).kind == "f"
                  else set())
    assert_agg_equal(got, want, float_cols)
    assert device_calls == {"sum": 2, "reduce": 2}    # sum+mean, min+max


def test_host_columns_take_the_vectorized_path(device_calls):
    """Object and datetime values are routed to the host path, as
    the JAX backend routes them; they never reach the wrappers."""
    jt = JTable({"k": np.array([1, 1, 2]),
                 "o": np.array([3, None, 5], dtype=object),
                 "d": np.array(["2020-01-01", "2021-01-01", "2019-01-01"],
                               dtype="datetime64[ns]")})
    for spec in (("sum", "o"), ("min", "o"), ("max", "d"), ("min", "d")):
        want = jt.group_by(["k"]).agg(spec, backend="reference")
        got = to_port(jt).group_by(["k"]).agg(spec, backend=CPU)
        assert_agg_equal(got, want)
    assert device_calls == {"sum": 0, "reduce": 0}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,groups", [(4000, 8), (40, 2)])
def test_signed_zero_groups_match_reference(dtype, n, groups):
    """±0.0 values in a few groups (runs far longer than 16 rows): MIN
    and MAX keep the later row's zero, as ``reference`` does. The
    ``jax`` backend is not held to this: it returns -0.0 for every MIN
    and +0.0 for every MAX (ROADMAP R4)."""
    r = np.random.default_rng(n)
    jt = JTable({"k": r.integers(0, groups, n).astype(np.int64),
                 "v": np.where(r.random(n) < 0.5, -0.0, 0.0).astype(dtype)})
    specs = (("min", "v"), ("max", "v"), ("count", "v"))
    want = jt.group_by(["k"]).agg(*specs, backend="reference")
    got = to_port(jt).group_by(["k"]).agg(*specs, backend=CPU)
    for c in ("v_min", "v_max"):
        np.testing.assert_array_equal(np.signbit(got.column(c)),
                                      np.signbit(want.column(c)))
    assert got.fingerprint() == want.fingerprint()


def test_group_by_sum_pins_match_reference():
    for name, t in _pin_fixtures().items():
        want = t.group_by_sum(["k"], "v", out="s", backend="reference")
        got = to_port(t).group_by_sum(["k"], "v", out="s", backend=CPU)
        assert got.fingerprint() == want.fingerprint(), name


def test_empty_table():
    jt = JTable({"k": np.array([], dtype=np.int64),
                 "v": np.array([], dtype=np.float64)})
    want = jt.group_by(["k"]).agg(*_specs(["v"]), backend="reference")
    got = to_port(jt).group_by(["k"]).agg(*_specs(["v"]), backend=CPU)
    assert_agg_equal(got, want)


def test_float_sums_repeat_bitwise():
    jt = random_table(500, seed=9)
    a = to_port(jt).group_by(["ks"]).agg(("sum", "f"), ("mean", "f"),
                                         backend=CPU)
    b = to_port(jt).group_by(["ks"]).agg(("sum", "f"), ("mean", "f"),
                                         backend=CPU)
    assert a.fingerprint() == b.fingerprint()


# ---------------------------------------------------------------------------
# registry, device default, cache tokens
# ---------------------------------------------------------------------------

def test_registry_names_and_default():
    assert exec_backends.DEFAULT_BACKEND == "torch_auto"
    assert set(exec_backends._factories) == {"reference", "vectorized",
                                             "torch", "partitioned",
                                             "torch_auto"}


def test_cache_token_names_the_device():
    assert CPU.cache_token() == "torch[cpu]"
    assert CPU.cache_token() != PALLAS.cache_token()


def test_default_backend_runs_on_cuda_or_raises(monkeypatch):
    """Without CUDA the default backend raises, naming how to ask for
    the CPU; it never carries on silently there."""
    monkeypatch.setattr(exec_backends, "_active", None)
    monkeypatch.delenv("REPRO_TORCH_EXEC_BACKEND", raising=False)
    if torch.cuda.is_available():
        be = exec_backends.active_backend()
        assert be.name == "torch_auto" and be.device.type == "cuda"
        return
    with pytest.raises(BackendUnavailable, match=r'device="cpu"'):
        exec_backends.active_backend()
    with pytest.raises(BackendUnavailable):
        TorchBackend()
    assert exec_backends.available_backends() == ["reference",
                                                  "vectorized"]


def test_use_backend_takes_an_instance():
    with exec_backends.use_backend(CPU) as be:
        assert be is CPU
        assert exec_backends.active_backend() is CPU
    with exec_backends.use_backend("vectorized"):
        assert exec_backends.active_backend().name == "vectorized"


def test_unknown_device_is_refused():
    with pytest.raises(ValueError):
        TorchBackend(device="meta")
