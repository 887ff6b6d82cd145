"""Tensor blobs and pytree snapshots in the port's store
(``repro_torch/core/store.py``).

A tensor is stored as the same bytes ``repro`` writes for the equal
numpy array: a dtype header line, then ``.npy`` of the raw bits
(``uint16`` for bfloat16). The port reads bfloat16 without
``ml_dtypes``, which ships with JAX and is absent where only the port
runs. All comparisons are bit for bit.
"""
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.core.store import (FileStore, MemoryStore, get_pytree,
                                    get_pytree_leaves, put_pytree,
                                    tree_flatten, tree_unflatten)

TENSORS = [
    torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).bfloat16(),
    torch.randn(7, generator=torch.Generator().manual_seed(1)),
    torch.arange(-4, 8, dtype=torch.int32).reshape(3, 4),
    torch.tensor(5, dtype=torch.int32),
]


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("store_kind", ["memory", "file"])
def test_tensor_round_trip_without_ml_dtypes(monkeypatch, tmp_path,
                                             store_kind):
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)   # import fails
    store = MemoryStore() if store_kind == "memory" else FileStore(
        str(tmp_path))
    for t in TENSORS:
        back = store.get_tensor(store.put_tensor(t))
        assert _bits_equal(back, t)
    key = store.put_tensor(TENSORS[0])
    with pytest.raises(TypeError, match="get_tensor"):
        store.get_array(key)           # numpy has no bfloat16


def test_reads_blobs_that_repro_wrote():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.store import MemoryStore as JaxStore

    jstore, store = JaxStore(), MemoryStore()
    for t in TENSORS:
        if t.dtype == torch.bfloat16:
            arr = np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
        else:
            arr = t.numpy()
        key = jstore.put_array(arr)
        # same bytes, so the same content key in either package
        assert store.put_tensor(t) == key
        assert store.put(jstore.get(key)) == key
        assert _bits_equal(store.get_tensor(key), t)


def test_bf16_table_column_is_refused():
    """A lake ``repro`` wrote with a bfloat16 column is no longer
    refused: it loads without ``ml_dtypes``, the column as its bits under
    the port's bfloat16 dtype, with the fingerprint and values ``repro``
    gives; the store's own ``get_array`` still names ``get_tensor`` and
    ``get_column`` for such a blob."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.store import MemoryStore as JaxStore
    from repro.data.tables import Table as JaxTable
    from repro_torch.data import bfloat16
    from repro_torch.data.tables import Table

    jstore = JaxStore()
    f32 = np.arange(4, dtype=np.float32)
    jt = JaxTable({"x": np.asarray(jnp.asarray(f32, jnp.bfloat16)),
                   "y": f32})
    key = jt.to_blobs(jstore)
    store = MemoryStore()
    for k in jstore.keys():
        assert store.put(jstore.get(k)) == k
    t = Table.from_blobs(store, key)
    assert bfloat16.is_bfloat16(t.column("x").dtype)
    assert t.fingerprint() == jt.fingerprint()
    assert t.to_pydict() == jt.to_pydict()
    assert t.to_blobs(store) == key
    cols = store.get_json(key)["columns"]
    assert cols["x"]["dtype"] == "bfloat16"
    with pytest.raises(TypeError, match="get_column"):
        store.get_array(cols["x"]["values"])
    np.testing.assert_array_equal(store.get_array(cols["y"]["values"]), f32)
    assert torch.equal(store.get_tensor(cols["x"]["values"]),
                       torch.from_numpy(f32).bfloat16())


class _State(NamedTuple):
    step: torch.Tensor
    mu: dict


def test_pytree_round_trip_and_structure_check():
    tree = {"b": [TENSORS[1], {"z": TENSORS[2], "a": TENSORS[0]}],
            "a": _State(step=TENSORS[3], mu={"x": TENSORS[1] * 2}),
            "none": None}
    store = MemoryStore()
    key = put_pytree(store, tree)
    back = get_pytree(store, key, tree)
    leaves, structure = tree_flatten(tree)
    # repro's (JAX's) order: dict keys sorted, NamedTuple fields in order
    assert [id(x) for x in leaves] == [
        id(TENSORS[3]), id(tree["a"].mu["x"]), id(TENSORS[1]),
        id(TENSORS[0]), id(TENSORS[2])]
    assert tree_flatten(back)[1] == structure
    assert isinstance(back["a"], _State) and back["none"] is None
    for a, b in zip(tree_flatten(back)[0], leaves):
        assert _bits_equal(a, b)
    assert all(_bits_equal(a, b) for a, b in
               zip(get_pytree_leaves(store, key), leaves))
    with pytest.raises(ValueError, match="treedef mismatch"):
        get_pytree(store, key, {"b": tree["b"]})
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten({"a": 0}, [1, 2])
