"""The port's sharding rules (``repro_torch/distributed/sharding.py``)
against the reference's (``repro/distributed/sharding.py``), with no
device: both sides run on device-free meshes of the production shapes
(jax's ``AbstractMesh`` and the port's).

* ``to_pspec`` with tuple axes and physical axes used twice, under every
  rule set;
* ``param_pspec`` of every leaf of all ten archs at full width (the
  reference's tree from ``jax.eval_shape(init_model)``, its paths from
  ``_path_str``; the port's from its meta init) on the (16, 16) and
  (2, 16, 16) meshes under ``LOGICAL_RULES_1POD`` / ``_2POD`` and every
  ``Strategy`` profile: equal as tuples, leaf for leaf;
* ``input_shardings`` with ``positions`` on dim 1;
* ``logical_constraint``: a no-op without a context, and the reference
  test's indivisible (3, 5) array unchanged under one (the reference
  itself fails that test, ROADMAP Queue C);
* ``mesh_rules`` nesting and thread-locality.

A DTensor under a constraint is held to its placements in
``tests/test_torch_ranks.py`` (two ranks).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import ARCH_NAMES
from repro.configs import get_config as ref_config
from repro.distributed import sharding as RS
from repro.launch import strategy as RST
from repro.models import model as RM
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as TS
from repro_torch.launch import strategy as TST
from repro_torch.launch.mesh import make_production_mesh, make_rules
from repro_torch.models import model as TM

PROFILES = ("fsdp", "tp_ep", "tp_ep_full", "tp_serve")


def _meshes(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return JaxAbstractMesh(shape, axes), TS.AbstractMesh(shape, axes)


def _rule_sets(multi_pod: bool) -> list:
    sets = [RS.LOGICAL_RULES_1POD] + ([RS.LOGICAL_RULES_2POD] if multi_pod
                                      else [])
    return sets + [RST._rules(p, multi_pod) for p in PROFILES]


@pytest.fixture(scope="module")
def ref_trees():
    """{arch: {path: shape}} of the reference's full-width parameters."""
    out = {}
    for a in ARCH_NAMES:
        tree = jax.eval_shape(
            lambda a=a: RM.init_model(ref_config(a), jax.random.PRNGKey(0)))
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        out[a] = {RS._path_str(p): tuple(leaf.shape) for p, leaf in flat}
    return out


def _port_tree(arch: str) -> dict:
    flat = {}
    TS.tree_map_with_path(
        lambda p, t: flat.__setitem__(TS._path_str(p), tuple(t.shape)),
        TM.init_model(get_config(arch), None, "meta"))
    return flat


def test_port_keeps_the_reference_tables():
    assert TS.PARAM_RULES == RS.PARAM_RULES
    assert TS.LOGICAL_RULES_1POD == RS.LOGICAL_RULES_1POD
    assert TS.LOGICAL_RULES_2POD == RS.LOGICAL_RULES_2POD
    for multi in (False, True):
        for p in PROFILES:
            assert TST._rules(p, multi) == RST._rules(p, multi)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_to_pspec_tuple_and_repeated_axes(multi_pod):
    jm, tm = _meshes(multi_pod)
    logicals = [("batch", "seq", None), ("batch", "fsdp"),
                ("fsdp", "fsdp"), ("tensor", "expert"),
                ("fsdp", "batch", "tensor"), ("kv_heads", "tensor"),
                (None, "expert", "fsdp", None), ("unknown", "batch"), ()]
    for rules in _rule_sets(multi_pod):
        ref, port = RS.MeshRules(jm, rules), TS.MeshRules(tm, rules)
        for logical in logicals:
            assert port.to_pspec(logical) == tuple(ref.to_pspec(logical)), \
                (rules, logical)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_pspec_every_leaf_full_width(arch, ref_trees):
    want_shapes = ref_trees[arch]
    got_shapes = _port_tree(arch)
    assert got_shapes == want_shapes
    checked = 0
    for multi in (False, True):
        jm, tm = _meshes(multi)
        for rules in _rule_sets(multi):
            ref, port = RS.MeshRules(jm, rules), TS.MeshRules(tm, rules)
            for path, shape in want_shapes.items():
                want = tuple(RS.param_pspec(path, shape, ref))
                got = TS.param_pspec(path, shape, port)
                assert got == want, (arch, multi, rules, path, shape)
                checked += 1
            # the sharding tree names the same specs, leaf for leaf
            shards = TS.param_shardings(
                TM.init_model(get_config(arch), None, "meta"), port)
            flat = {}
            TS.tree_map_with_path(
                lambda p, s: flat.__setitem__(TS._path_str(p), s.spec),
                shards)
            assert flat == {p: tuple(RS.param_pspec(p, s, ref))
                            for p, s in want_shapes.items()}
    assert checked == len(want_shapes) * 11


@pytest.mark.parametrize("multi_pod", [False, True])
def test_input_shardings_positions_on_dim_1(multi_pod):
    jm, tm = _meshes(multi_pod)
    shapes = {"tokens": (256, 4096), "labels": (256, 4096),
              "positions": (3, 256, 4096), "odd": (3, 5)}
    for rules in _rule_sets(multi_pod):
        ref = RS.input_shardings(
            {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()},
            RS.MeshRules(jm, rules), batch_axes={"positions": 1})
        port = TS.input_shardings(
            {k: torch.empty(s, device="meta") for k, s in shapes.items()},
            TS.MeshRules(tm, rules), batch_axes={"positions": 1})
        for k in shapes:
            assert port[k].spec == tuple(ref[k].spec), (rules, k)
            assert port[k].shard_shape(shapes[k]) == \
                ref[k].shard_shape(shapes[k])


def test_production_mesh_and_rules():
    for multi in (False, True):
        jm, _ = _meshes(multi)
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.shape == dict(jm.shape)
        assert mesh.axis_names == tuple(jm.axis_names)
        want = RS.LOGICAL_RULES_2POD if multi else RS.LOGICAL_RULES_1POD
        assert make_rules(mesh).rules == want


def test_logical_constraint_noop_without_context():
    x = torch.ones(4, 8)
    assert TS.logical_constraint(x, "batch", None) is x
    assert TS.logical_constraint(x, "any", "names", "at", "all") is x


def test_logical_constraint_skips_indivisible():
    """The reference test's case (tests/test_distributed.py:174-179):
    nothing divides, so the (3, 5) array comes back unchanged; a rank
    that does not match raises, as the reference's assert does."""
    _, tm = _meshes(False)
    x = torch.ones(3, 5)
    with TS.mesh_rules(TS.MeshRules(tm, TS.LOGICAL_RULES_1POD)):
        y = TS.logical_constraint(x, "batch", "tensor")
        with pytest.raises(AssertionError):
            TS.logical_constraint(x, "batch")
    assert y is x
    np.testing.assert_array_equal(y.numpy(), np.ones((3, 5)))


def test_mesh_rules_nesting_and_threads():
    _, tm = _meshes(False)
    outer = TS.MeshRules(tm, TS.LOGICAL_RULES_1POD)
    inner = TS.MeshRules(tm, RST._rules("fsdp", False))
    seen = {}

    def other():
        seen["thread"] = TS._current()

    assert TS._current() is None
    with TS.mesh_rules(outer):
        assert TS._current() is outer
        with TS.mesh_rules(inner):
            assert TS._current() is inner
            t = threading.Thread(target=other)
            t.start()
            t.join()
            with TS.mesh_rules(None):
                assert TS._current() is None
            assert TS._current() is inner
        assert TS._current() is outer
    assert TS._current() is None
    assert seen == {"thread": None}
    with pytest.raises(KeyError):
        with TS.mesh_rules(outer):
            raise KeyError("x")
    assert TS._current() is None


def test_named_sharding_placements_and_shard_shape():
    from torch.distributed.tensor import Replicate, Shard
    _, tm = _meshes(True)
    sh = TS.NamedSharding(tm, (("pod", "data"), None, "model"))
    assert sh.shard_shape((64, 3, 32)) == (2, 3, 2)
    with pytest.raises(ValueError):
        sh.shard_shape((48, 3, 32))
    assert TS.placements(tm, (("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert TS.placements(tm, ()) == [Replicate()] * 3
