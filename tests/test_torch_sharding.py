"""The port's sharding rules held against the reference's, spec for spec.

For every architecture at its full config, on the abstract meshes of the
reference's ``tests/test_sharding_rules.py`` ((16, 16) ("data",
"model") and (2, 16, 16) ("pod", "data", "model")): the port's
``tree_specs(logical_axes(cfg))``, then ``sanitize`` against the
parameters' shapes, equal ``repro.distributed.sharding``'s on the
reference's trees, and ``validate_specs`` accepts them; likewise the
decode cache's axes (``cache_logical_axes``, shapes from the port's
``init_cache`` on the meta device, so nothing is allocated).  Pure spec
logic: no ranks, no devices.
"""
import pytest

import jax
from jax.sharding import PartitionSpec as JPS

from repro import models as RM
from repro.configs import ARCH_IDS
from repro.configs import get_config as r_config
from repro.distributed import sharding as rsh

from repro_torch import models as M
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.mesh import AbstractMesh

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
#: The decode cache's batch and length (the reference's decode cell).
CACHE = (32, 32768)


def _r_mesh(shape, axes):
    from jax.sharding import AbstractMesh as JAbstractMesh
    try:
        return JAbstractMesh(tuple(zip(axes, shape)))
    except TypeError:
        return JAbstractMesh(shape, axes)


def _r_leaves(tree) -> list:
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JPS))


def _p_leaves(tree) -> list:
    """Leaves in sorted-key order; specs and axes are tuples, so flatten
    only through the dicts."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_p_leaves(v) if isinstance(v, dict) else [v])
    return out


def _entries(spec) -> list:
    return [tuple(e) if isinstance(e, (tuple, list)) else e for e in spec]


def _same(port_tree, ref_tree):
    got, want = _p_leaves(port_tree), _r_leaves(ref_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, sh.PartitionSpec)
        assert _entries(g) == _entries(w), (g, w)


def _meta_shapes(tree) -> dict:
    return {k: _meta_shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    shape, axes = MESHES[mesh]
    pm, rm = AbstractMesh(shape, axes), _r_mesh(shape, axes)
    cfg, rcfg = get_config(arch), r_config(arch, kernel_impl="xla")
    ax, rax = M.logical_axes(cfg), RM.logical_axes(rcfg)
    assert _p_leaves(ax) == jax.tree.leaves(
        rax, is_leaf=lambda x: isinstance(x, tuple))
    specs, rspecs = sh.tree_specs(ax, mesh=pm), rsh.tree_specs(rax, mesh=rm)
    _same(specs, rspecs)
    shapes = M.model_spec(cfg)
    rshapes = jax.eval_shape(lambda: RM.init_params(
        rcfg, jax.random.PRNGKey(0)))
    fixed = sh.sanitize(shapes, specs, pm)
    _same(fixed, rsh.sanitize(rshapes, rspecs, rm))
    sh.validate_specs(shapes, fixed, pm)
    assert sh.tree_shardings_for(shapes, ax, pm) == fixed


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh):
    shape, axes = MESHES[mesh]
    pm, rm = AbstractMesh(shape, axes), _r_mesh(shape, axes)
    cfg, rcfg = get_config(arch), r_config(arch, kernel_impl="xla")
    specs = sh.tree_specs(M.cache_logical_axes(cfg), mesh=pm)
    rspecs = rsh.tree_specs(RM.cache_logical_axes(rcfg), mesh=rm)
    _same(specs, rspecs)
    shapes = _meta_shapes(M.init_cache(cfg, *CACHE, device="meta"))
    rshapes = RM.cache_spec(rcfg, *CACHE)
    assert _p_leaves(shapes) == [tuple(s.shape) for s in
                                 jax.tree.leaves(rshapes)]
    fixed = sh.sanitize(shapes, specs, pm)
    _same(fixed, rsh.sanitize(rshapes, rspecs, rm))
    sh.validate_specs(shapes, fixed, pm)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_no_mesh_axis_twice_in_a_spec(arch):
    pm = AbstractMesh(*MESHES["multi"])
    cfg = get_config(arch)
    for tree in (M.logical_axes(cfg), M.cache_logical_axes(cfg)):
        for spec in _p_leaves(sh.tree_specs(tree, mesh=pm)):
            flat = [a for e in spec if e is not None
                    for a in ((e,) if isinstance(e, str) else e)]
            assert len(flat) == len(set(flat)), (arch, spec)


def test_axis_without_rule_raises():
    with pytest.raises(KeyError, match="no sharding rule"):
        sh.spec_from_axes(("embed", "no_such_axis"))
    with pytest.raises(KeyError):
        sh.tree_specs({"w": ("heads", "bogus")})


def test_sanitize_drops_indivisible_axes_and_validate_raises():
    pm = AbstractMesh(*MESHES["single"])
    assert sh.sanitize([(8, 33)], [sh.PartitionSpec("data", "model")],
                       pm)[0] == sh.PartitionSpec()
    # a 2-axis entry keeps the axes that divide, greedily in order
    multi = AbstractMesh(*MESHES["multi"])
    assert sh.sanitize([(32,)], [sh.PartitionSpec(("pod", "data"))],
                       multi)[0] == sh.PartitionSpec(("pod", "data"))
    assert sh.sanitize([(16,)], [sh.PartitionSpec(("pod", "data"))],
                       multi)[0] == sh.PartitionSpec("pod")
    with pytest.raises(ValueError, match="not divisible"):
        sh.validate_specs([(8, 33)], [sh.PartitionSpec("data")], pm)


def test_partition_spec_compares_with_jax():
    assert tuple(sh.PartitionSpec("data", None, ("pod", "model"))) == \
        tuple(JPS("data", None, ("pod", "model")))
    assert sh.spec_from_axes(None) == sh.PartitionSpec() == ()
    assert AbstractMesh(*MESHES["multi"]).size == 512
