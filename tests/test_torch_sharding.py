"""The port's meshes, sharding rules and probe adapters against the
reference's (``repro.launch.mesh``, ``repro.models.sharding``,
``repro.data.pipeline.make_batch_sharding``, ``repro.launch.perf_probe``).

Sharding specs are compared leaf for leaf for all ten archs at full width
on the production meshes (16, 16) and (2, 16, 16) and on (4, 2) and (2, 4)
data/model meshes.  The reference runs on ``jax.sharding.AbstractMesh``
(no devices); the port reads ``meta`` tensors: for parameters, stand-ins of
the reference's ``jax.eval_shape`` tree, whose key paths and shapes are
first checked equal to the port's own smoke tree; for decode states, the
port's own ``init_decode_state`` on ``meta``."""

from __future__ import annotations

import os

# keep perf_probe's import-time default (512 forced host devices, meant for
# its CLI probe) from leaking into this test process's jax backend
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.tree_util import tree_flatten_with_path

from repro import configs as rconfigs
from repro.data.pipeline import make_batch_sharding as ref_make_batch_sharding
from repro.launch import mesh as rmesh
from repro.launch.perf_probe import probe_to_request as ref_probe_to_request
from repro.launch.perf_probe import probe_to_workload as ref_probe_to_workload
from repro.models import get_model as ref_get_model
from repro.models import sharding as rsharding
from repro_torch import configs
from repro_torch.core import period, plan_request
from repro_torch.core.metrics import single_processor_mapping
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.perf_probe import probe_to_request, probe_to_workload
from repro_torch.models import get_model, sharding
from repro_torch.models.registry import lm_workload
from repro_torch.models.common import SHAPES

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((2, 4), ("data", "model"))]
MESH_IDS = ["16x16", "2x16x16", "4x2", "2x4"]
DECODE_CAPACITY = 32768          # decode_32k


def _meshes(shape, axes):
    return AbstractMesh(shape, axes), tmesh.Mesh(axes, shape)


def _names(path) -> tuple:
    return tuple(rsharding._path_names(path))


def _ref_leaves(tree) -> dict:
    return {_names(p): leaf for p, leaf in tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


def _port_leaves(tree) -> dict:
    out = {}
    sharding._map_with_path(lambda p, x: out.__setitem__(tuple(p), x), tree)
    return out


def _meta_like(tree):
    """``meta`` tensors of the reference tree's shapes, in its structure."""
    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), device="meta")


_PARAMS = {}


def _params(arch):
    """(reference eval_shape tree, port stand-ins) of ``arch`` at full width,
    after the port's smoke tree is held to the reference's smoke tree."""
    if arch not in _PARAMS:
        smoke_ref = jax.eval_shape(ref_get_model(rconfigs.get_smoke_config(arch)).init,
                                   jax.random.key(0))
        smoke_port = get_model(configs.get_smoke_config(arch)).init(0, "cpu", master=True)
        want = {k: tuple(v.shape) for k, v in _ref_leaves(smoke_ref).items()}
        got = {k: tuple(v.shape) for k, v in _port_leaves(smoke_port).items()}
        assert got == want, arch
        full = jax.eval_shape(ref_get_model(rconfigs.get_config(arch)).init, jax.random.key(0))
        _PARAMS[arch] = (full, _meta_like(full))
    return _PARAMS[arch]


def _same_specs(port_specs, ref_specs):
    got, want = _port_leaves(port_specs), _ref_leaves(ref_specs)
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert isinstance(got[k], sharding.PartitionSpec), k
        assert got[k] == tuple(spec), (k, got[k], spec)
    return len(want)


@pytest.mark.parametrize("shape, axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_and_zero1_specs_equal_the_references(arch, shape, axes):
    rmesh_, pmesh = _meshes(shape, axes)
    ref_tree, port_tree = _params(arch)
    cfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
    n = _same_specs(sharding.param_specs(port_tree, cfg, pmesh),
                    rsharding.param_specs(ref_tree, rcfg, rmesh_))
    _same_specs(sharding.zero1_specs(port_tree, cfg, pmesh),
                rsharding.zero1_specs(ref_tree, rcfg, rmesh_))
    assert n > 0


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_state_specs_equal_the_references(arch, batch):
    cfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
    ref_state = jax.eval_shape(lambda: ref_get_model(rcfg).init_decode_state(
        batch, DECODE_CAPACITY))
    port_state = get_model(cfg).init_decode_state(batch, DECODE_CAPACITY, "meta")
    want = {k: tuple(v.shape) for k, v in _ref_leaves(ref_state).items()}
    assert {k: tuple(v.shape) for k, v in _port_leaves(port_state).items()} == want
    for shape, axes in MESHES:
        rmesh_, pmesh = _meshes(shape, axes)
        _same_specs(sharding.state_specs(port_state, cfg, pmesh, batch),
                    rsharding.state_specs(ref_state, rcfg, rmesh_, batch))


@pytest.mark.parametrize("shape, axes", MESHES + [((4,), ("stage",))],
                         ids=MESH_IDS + ["stage"])
def test_batch_specs_and_axis_sizes_equal_the_references(shape, axes):
    rmesh_, pmesh = _meshes(shape, axes)
    assert sharding.batch_spec(pmesh) == tuple(rsharding.batch_spec(rmesh_))
    for B in (1, 3, 8, 256, 512):
        want = ref_make_batch_sharding(rmesh_, B)
        assert isinstance(want, NamedSharding)
        assert sharding.make_batch_sharding(pmesh, B) == tuple(want.spec), B
    assert tmesh.data_axis_size(pmesh) == rmesh.data_axis_size(rmesh_)
    assert tmesh.model_axis_size(pmesh) == rmesh.model_axis_size(rmesh_)


def test_production_meshes_are_the_references_shapes():
    for multi in (False, True):
        got = tmesh.make_production_mesh(multi_pod=multi)
        assert got.devices is None
        want = {"pod": 2, "data": 16, "model": 16} if multi else {"data": 16, "model": 16}
        assert got.shape == want and list(got.shape) == list(want)
        assert got.size == (512 if multi else 256)
        assert (tmesh.data_axis_size(got), tmesh.model_axis_size(got)) == \
            ((32, 16) if multi else (16, 16))


def test_named_maps_specs_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    m = tmesh.Mesh(("pod", "data", "model"), (2, 4, 2))
    specs = {"w": sharding.PartitionSpec(("pod", "data"), None, "model"),
             "b": sharding.PartitionSpec(None, "data")}
    got = sharding.named(specs, m)
    assert got["w"] == (Shard(0), Shard(0), Shard(2))
    assert got["b"] == (Replicate(), Shard(1), Replicate())


def test_make_mesh_never_repeats_a_card_it_was_not_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="needs 4 cards and 2 are visible"):
        tmesh.make_mesh((4,), ("stage",))
    two = tmesh.make_mesh((2,), ("stage",))
    assert two.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    one_card = tmesh.make_mesh((4,), ("stage",), devices=["cuda"] * 4)
    assert one_card.devices == (torch.device("cuda"),) * 4
    with pytest.raises(ValueError, match="needs 8 devices"):
        tmesh.make_mesh((4, 2), ("stage", "data"), devices=["cpu"] * 4)
    cpus = tmesh.make_mesh((2, 2), ("stage", "data"), devices=["cpu"] * 4)
    assert cpus.shape == {"stage": 2, "data": 2} and cpus.axis_devices("data", 1) == (
        torch.device("cpu"),) * 2


# ---------------------------------------------------------------------------
# The perf-probe -> planner bridge (tests/test_perf_probe_adapter.py's cases)
# ---------------------------------------------------------------------------

ARCH, SHAPE = "qwen3-4b", "decode_32k"


def _base_workload():
    return lm_workload(configs.get_smoke_config(ARCH), SHAPES[SHAPE])


def _probe_out(base, devices=8, flop_factor=2.0, comm_factor=3.0):
    return {
        "terms": {"compute": 0.1, "memory": 0.2, "collective": 0.05},
        "res": {
            "dot_flops": flop_factor * float(base.w.sum()) / devices,
            "bytes_accessed": 1e9,
            "collective_bytes": comm_factor * float(base.delta.sum()) / devices,
        },
        "temp_gb": 1.0,
        "devices": devices,
    }


def _same_workload(got, want):
    assert got.name == want.name
    np.testing.assert_array_equal(got.w, want.w)
    np.testing.assert_array_equal(got.delta, want.delta)


def test_probe_to_workload_calibrates_totals_preserving_shape():
    base = _base_workload()
    wl = probe_to_workload(_probe_out(base), ARCH, SHAPE, smoke=True)
    _same_workload(wl, ref_probe_to_workload(_probe_out(base), ARCH, SHAPE, smoke=True))
    assert wl.w.sum() == pytest.approx(2.0 * base.w.sum())
    assert wl.delta.sum() == pytest.approx(3.0 * base.delta.sum())
    assert np.allclose(wl.w, base.w * 2.0) and np.allclose(wl.delta, base.delta * 3.0)
    assert wl.n == base.n


def test_probe_to_workload_per_device_scaling():
    base = _base_workload()
    out = _probe_out(base, devices=8)
    out["devices"] = 16
    wl16 = probe_to_workload(out, ARCH, SHAPE, smoke=True)
    _same_workload(wl16, ref_probe_to_workload(out, ARCH, SHAPE, smoke=True))
    wl8 = probe_to_workload(_probe_out(base, devices=8), ARCH, SHAPE, smoke=True)
    assert np.allclose(wl16.w, 2.0 * wl8.w)
    _same_workload(probe_to_workload(out, ARCH, SHAPE, smoke=True, devices=4),
                   ref_probe_to_workload(out, ARCH, SHAPE, smoke=True, devices=4))


def test_probe_to_workload_zero_collectives_keeps_analytic_delta():
    base = _base_workload()
    out = _probe_out(base)
    out["res"]["collective_bytes"] = 0.0
    wl = probe_to_workload(out, ARCH, SHAPE, smoke=True)
    _same_workload(wl, ref_probe_to_workload(out, ARCH, SHAPE, smoke=True))
    assert np.allclose(wl.delta, base.delta)


def test_probe_to_workload_full_width_equals_the_references():
    out = _probe_out(lm_workload(configs.get_config(ARCH), SHAPES["train_4k"]), devices=256)
    _same_workload(probe_to_workload(out, ARCH, "train_4k"),
                   ref_probe_to_workload(out, ARCH, "train_4k"))


def test_probe_to_request_plans_in_seconds():
    base = _base_workload()
    req = probe_to_request(_probe_out(base), ARCH, SHAPE, pods=4, smoke=True)
    want = ref_probe_to_request(_probe_out(base), ARCH, SHAPE, pods=4, smoke=True)
    _same_workload(req.workload, want.workload)
    np.testing.assert_array_equal(req.platform.s, want.platform.s)
    assert (req.platform.b, req.platform.name) == (want.platform.b, want.platform.name)
    assert [(o.minimize, o.bound) for o in req.objectives] == [
        (o.minimize, o.bound) for o in want.objectives]
    report = plan_request(req, device="cpu")
    assert report.feasible
    serial_s = period(req.workload, req.platform,
                      single_processor_mapping(req.workload, req.platform.fastest()))
    assert 0.0 < report.plan.period <= serial_s
