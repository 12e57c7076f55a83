"""The port's cell grid, strategies, mesh planning and specs
(``repro_torch.configs.all_cells``, ``launch/strategy.py``,
``distributed/elastic.py::plan_mesh``, ``launch/specs.py``) against the
reference's, with no device:

* ``all_cells`` equal: 32 cells, ten archs by three shapes and the two
  sub-quadratic archs' ``long_500k`` (the reference's docstring says
  40);
* ``pick_strategy`` equal on all 32 cells on both production meshes:
  name, rules and every hyperparameter (jnp dtypes mapped to torch's),
  also with each override;
* the mesh plan for n = 1..1024 devices and model_parallel in {1, 2, 4,
  8, 16} equal to the reference's ``replan_mesh`` arithmetic (its
  ``jax.make_mesh`` replaced by a recorder for the run of this test:
  the reference needs that many devices), and the reference's own mesh
  at n = 1;
* ``model_specs`` / ``batch_specs`` / ``decode_specs`` of every cell on
  both meshes under the cell's strategy: every leaf's shape, dtype, spec
  and shard shape equal to the reference's ``jax.eval_shape`` stand-ins'.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro import configs as RCF
from repro.distributed import elastic as RE
from repro.distributed import sharding as RS
from repro.launch import specs as RSP
from repro.launch import strategy as RST
from repro_torch import configs as TCF
from repro_torch.distributed import elastic as TE
from repro_torch.distributed import sharding as TS
from repro_torch.launch import specs as TSP
from repro_torch.launch import strategy as TST
from repro_torch.launch.mesh import make_production_mesh

DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.int32: "int32", torch.int8: "int8"}
CELLS = RCF.all_cells()


def _jax_mesh(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return JaxAbstractMesh(shape, axes)


def test_all_cells_equal():
    assert TCF.all_cells() == CELLS
    assert len(CELLS) == 32
    assert "all_cells" in TCF.__all__


def _hparams_equal(port, ref):
    for f in ("lr", "weight_decay", "n_micro", "quantized_opt_state",
              "remat", "loss_chunk"):
        assert getattr(port, f) == getattr(ref, f), f
    assert DTYPES[port.accum_dtype] == np.dtype(ref.accum_dtype).name


@pytest.mark.parametrize("multi_pod", [False, True])
def test_pick_strategy_every_cell(multi_pod):
    for arch, shape in CELLS:
        ref = RST.pick_strategy(RCF.get_config(arch), RCF.SHAPES[shape],
                                multi_pod=multi_pod)
        port = TST.pick_strategy(TCF.get_config(arch), TCF.SHAPES[shape],
                                 multi_pod=multi_pod)
        assert port.name == ref.name, (arch, shape)
        assert port.logical_rules == ref.logical_rules, (arch, shape)
        _hparams_equal(port.hparams, ref.hparams)
        for kw in ({"override_profile": "tp_ep_full"},
                   {"override_profile": "tp_serve", "override_micro": 3}):
            r = RST.pick_strategy(RCF.get_config(arch), RCF.SHAPES[shape],
                                  multi_pod=multi_pod, **kw)
            p = TST.pick_strategy(TCF.get_config(arch), TCF.SHAPES[shape],
                                  multi_pod=multi_pod, **kw)
            assert (p.name, p.logical_rules) == (r.name, r.logical_rules)
            _hparams_equal(p.hparams, r.hparams)
    with pytest.raises(ValueError):
        TST._rules("nope", multi_pod)


def test_mesh_plan_matches_the_reference(monkeypatch):
    monkeypatch.setattr(RE.jax, "make_mesh",
                        lambda shape, axes, devices: (tuple(shape),
                                                      tuple(axes),
                                                      len(devices)))
    n_plans = 0
    for mp in (1, 2, 4, 8, 16):
        for n in range(1, 1025):
            if n < mp:
                with pytest.raises(AssertionError):
                    RE.replan_mesh(n, model_parallel=mp,
                                   devices=list(range(n)))
                with pytest.raises(AssertionError):
                    TE.plan_mesh(n, model_parallel=mp)
                continue
            shape, axes, used = RE.replan_mesh(n, model_parallel=mp,
                                               devices=list(range(n)))
            assert TE.plan_mesh(n, model_parallel=mp) == (shape, axes)
            assert used == int(np.prod(shape))
            n_plans += 1
    assert n_plans == 5 * 1024 - (0 + 1 + 3 + 7 + 15)


def test_mesh_plan_at_one_device_is_the_references_mesh():
    mesh = RE.replan_mesh(1, model_parallel=1)
    shape, axes = TE.plan_mesh(1, model_parallel=1)
    assert shape == mesh.devices.shape and axes == tuple(mesh.axis_names)


def _flat_ref(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {RS._path_str(p): leaf for p, leaf in flat}


def _flat_port(tree) -> dict:
    out = {}
    TS.tree_map_with_path(
        lambda p, leaf: out.__setitem__(TS._path_str(p), leaf), tree)
    return out


def _same_specs(port_tree, ref_tree, what):
    got, want = _flat_port(port_tree), _flat_ref(ref_tree)
    assert set(got) == set(want), what
    for k, r in want.items():
        p = got[k]
        assert p.shape == tuple(r.shape), (what, k)
        assert DTYPES[p.dtype] == np.dtype(r.dtype).name, (what, k)
        assert p.sharding.spec == tuple(r.sharding.spec), (what, k)
        assert p.shard_shape == tuple(r.sharding.shard_shape(r.shape)), \
            (what, k)
    return len(want)


@pytest.mark.parametrize("arch", RCF.ARCH_NAMES)
def test_specs_every_cell_both_meshes(arch):
    n = 0
    for multi in (False, True):
        jm, tm = _jax_mesh(multi), make_production_mesh(multi_pod=multi)
        for a, shape_name in CELLS:
            if a != arch:
                continue
            rcfg, tcfg = RCF.get_config(a), TCF.get_config(a)
            rshape, tshape = RCF.SHAPES[shape_name], TCF.SHAPES[shape_name]
            rst = RST.pick_strategy(rcfg, rshape, multi_pod=multi)
            tst = TST.pick_strategy(tcfg, tshape, multi_pod=multi)
            rr = RST.make_mesh_rules(jm, rst)
            tr = TST.make_mesh_rules(tm, tst)
            what = (a, shape_name, multi)
            if rshape.kind == "decode":
                rt, rs = RSP.decode_specs(rcfg, rshape, rr)
                pt, ps = TSP.decode_specs(tcfg, tshape, tr)
                n += _same_specs({"t": pt, "s": ps}, {"t": rt, "s": rs},
                                 what)
            else:
                n += _same_specs(TSP.batch_specs(tcfg, tshape, tr),
                                 RSP.batch_specs(rcfg, rshape, rr), what)
            if rshape.kind != "train":
                continue
            rp, ro = RSP.model_specs(rcfg, rr, rst.hparams)
            pp, po = TSP.model_specs(tcfg, tr, tst.hparams)
            n += _same_specs(pp, rp, what)
            for field in ("m", "v", "m_scale", "v_scale"):
                if getattr(ro, field) is None:
                    assert getattr(po, field) is None
                    continue
                n += _same_specs(getattr(po, field), getattr(ro, field),
                                 what + (field,))
            assert po.step.shape == () and po.step.sharding.spec == ()
    assert n > 0


@pytest.mark.parametrize("arch", ["stablelm-12b", "deepseek-v3-671b"])
def test_unrolled_decode_specs_and_no_rules(arch):
    rcfg, tcfg = RCF.get_config(arch), TCF.get_config(arch)
    rr = RS.MeshRules(_jax_mesh(False), RS.LOGICAL_RULES_1POD)
    tr = TS.MeshRules(make_production_mesh(), TS.LOGICAL_RULES_1POD)
    rt, rs = RSP.decode_specs(rcfg, RCF.SHAPES["decode_32k"], rr,
                              unrolled=True)
    pt, ps = TSP.decode_specs(tcfg, TCF.SHAPES["decode_32k"], tr,
                              unrolled=True)
    _same_specs({"t": pt, "s": ps}, {"t": rt, "s": rs}, arch)
    # no rules: whole leaves, the reference's shapes
    rp, _ = RSP.model_specs(rcfg, None)
    pp, po = TSP.model_specs(tcfg, None)
    assert po is None
    got = _flat_port(pp)
    for k, r in _flat_ref(rp).items():
        assert got[k].shape == tuple(r.shape) == got[k].shard_shape
        assert got[k].sharding is None
