"""The port's elastic restore (``repro_torch.distributed.elastic``):
``param_spec`` equal to ``repro``'s for every leaf of all ten
``configs.ARCHS`` at full size (``jax.eval_shape`` against ``meta``;
``repro``'s stacked layer dim dropped), and the smoke xlstm resharded
over (2, 2, 2), (2, 2) and (2, 1) gloo meshes on the CPU, its forward
equal to ``repro``'s single-device forward at 2e-2, as
``tests/test_multidevice.py::test_elastic_rescale_8_to_4_to_2``."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.distributed.elastic import param_spec as repro_param_spec
from repro.distributed.sharding import make_rules as repro_rules
from repro.models import model as JM
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.convert import _layer_source, params_from_jax
from repro_torch.distributed.elastic import param_spec, tree_map_named
from repro_torch.distributed.sharding import MeshShape, make_rules
from repro_torch.launch.mesh import make_host_mesh, run_ranks
from repro_torch.models.model import Model

TIMEOUT_S = 300
MESHES = [(("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("pod", "data", "model"), (2, 2, 2)), (("data", "model"), (2, 1))]
RULES = [("train", {}), ("train", {"fsdp": True}),
         ("train", {"dp_only": True}), ("decode", {})]


class _JaxMeshShape:
    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _repro_name(port: str, cfg) -> tuple[str, bool]:
    """``repro``'s '/'-joined path of the port's leaf, and whether
    ``repro`` stacks it on a leading layer dim."""
    parts = port.split(".")
    if parts[0] == "layers":
        where, j, _ = _layer_source(cfg, int(parts[1]))
        return "/".join([where, str(j), *parts[2:]]), where == "slots"
    if parts[:2] == ["encoder", "layers"]:
        return "/".join(["encoder", "layers", *parts[3:]]), True
    return "/".join(parts), False


def _path_name(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_repros_with_the_stacked_dim_dropped(arch):
    jc, tc = jax_config(arch), get_config(arch)
    abstract = jax.eval_shape(lambda k: JM.init_params(k, jc),
                              jax.random.PRNGKey(0))
    leaves = {_path_name(p): leaf for p, leaf in
              jax.tree_util.tree_flatten_with_path(abstract)[0]}
    port = dict(Model(tc, device="meta").named_parameters())
    for names, sizes in MESHES:
        for kind, knobs in RULES:
            jr = repro_rules(kind, _JaxMeshShape(names, sizes), **knobs)
            tr = make_rules(kind, MeshShape(names, sizes), **knobs)
            for name, t in port.items():
                rname, stacked = _repro_name(name, tc)
                leaf = leaves[rname]
                path = [jax.tree_util.DictKey(k) for k in rname.split("/")]
                want = tuple(repro_param_spec(path, leaf, jr))
                want = want[1:] if stacked else want
                assert tuple(leaf.shape)[int(stacked):] == tuple(t.shape)
                assert tuple(param_spec(name, t, tr)) == want, (name, kind)


def test_optimizer_state_leaves_take_their_parameters_spec():
    cfg = get_smoke_config("phi4_mini_3b")
    from repro_torch.training.optimizer import adamw_init
    params = {k: v.detach() for k, v in
              Model(cfg, device="meta").state_dict().items()}
    rules = make_rules("train", MeshShape(("data", "model"), (2, 2)))
    specs = tree_map_named(lambda n, leaf: param_spec(n, leaf, rules),
                           adamw_init(params))
    for k, t in params.items():
        assert specs.mu[k] == specs.nu[k] == param_spec(k, t, rules)
    assert specs.step == ()


def _reshard_forward(rank, world, shape, axes, params, tokens):
    from repro_torch.distributed.elastic import reshard
    from repro_torch.distributed.sharding import use_rules
    cfg = get_smoke_config("xlstm_350m")
    if len(shape) == 3:
        mesh = make_host_mesh(shape[1], shape[2], pod=shape[0], device="cpu")
    else:
        mesh = make_host_mesh(*shape, device="cpu")
    assert mesh.mesh_dim_names == axes
    rules = make_rules("train", mesh)
    placed = reshard(params, mesh, rules)
    # every value arrives as it left the checkpoint
    for k, v in placed.items():
        assert torch.equal(v.full_tensor(), params[k]), k
    model = Model(cfg, device="meta")
    from repro_torch.training.train_loop import _bind
    _bind(model, placed)
    with torch.no_grad(), use_rules(rules):
        out, _ = model(torch.from_numpy(tokens))
    return out.full_tensor().float().numpy()


@pytest.mark.parametrize("shape,axes", [
    ((2, 2, 2), ("pod", "data", "model")), ((2, 2), ("data", "model")),
    ((2, 1), ("data", "model"))], ids=["8", "4", "2"])
def test_reshard_keeps_the_forward_of_repro(shape, axes):
    jc = jax_smoke("xlstm_350m")
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tokens = np.zeros((4, 16), np.int32)
    ref, _ = JM.forward(jp, jc, tokens)
    host = params_from_jax(jax.tree.map(np.asarray, jp),
                           get_smoke_config("xlstm_350m"))
    world = int(np.prod(shape))
    outs = run_ranks(_reshard_forward, world, shape, axes, host, tokens,
                     backend="gloo", timeout_s=TIMEOUT_S, threads=1)
    for got in outs:
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   rtol=2e-2, atol=2e-2)
