"""Serving's planner hooks against the JAX reference, on the CPU: the pod
platform and the paper-pipeline presets, the planner's workload extraction
(``lm_workload``) for all ten architectures, ``plan_serving``, and
``serve_pool`` with ``pods`` and ``replan``.

Everything here is the planner's host arithmetic and its split scoring,
which the port keeps exact: every compared value is ``==`` (float64
included), except the candidates' ``wall_ms`` (a time) and, in
``serve_pool``, the fleet metrics that read the clock.  The replan path
reads the serve loop's step times: both serve modules get one fake clock
that advances by a fixed step per ``perf_counter`` call, so both see the
same windows, the same drift and the same straggler events.
"""

import types

import numpy as np
import pytest

import repro.launch.serve as jserve
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.configs import paper_pipeline as jpp
from repro.core import tpu_pod_platform as j_tpu_pod_platform
from repro.models import get_model as j_get_model
from repro.models.common import SHAPES as J_SHAPES
from repro.models.registry import layer_flops as j_layer_flops
from repro.models.registry import lm_workload as j_lm_workload

import repro_torch.launch.serve as tserve
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs import paper_pipeline as tpp
from repro_torch.core import tpu_pod_platform
from repro_torch.models import SHAPES, get_model, layer_flops, lm_workload

COUNTS = ("ticks", "events", "requests", "solves", "warm_hits", "mean_churn")


def _platform_eq(got, want):
    assert got.name == want.name and got.b == want.b
    np.testing.assert_array_equal(got.s, want.s)
    assert got.s.dtype == want.s.dtype and got.fail is None and want.fail is None


def _workload_eq(got, want):
    assert got.name == want.name
    for f in ("w", "delta"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [dict(pods=2), dict(pods=8, chips_per_pod=64),
                                dict(pods=4, degraded={0: 3.0, 2: 1.5}),
                                dict(pods=3, peak_flops=1e15, efficiency=0.5,
                                     dcn_bandwidth=1e11)])
def test_tpu_pod_platform_equals_reference(kw):
    _platform_eq(tpu_pod_platform(**kw), j_tpu_pod_platform(**kw))


def test_paper_pipeline_presets_equal_reference():
    _platform_eq(tpp.tpu_two_pod_platform(), jpp.tpu_two_pod_platform())
    _platform_eq(tpp.tpu_two_pod_platform({1: 2.0}), jpp.tpu_two_pod_platform({1: 2.0}))
    _platform_eq(tpp.tpu_many_pod_platform(), jpp.tpu_many_pod_platform())
    _platform_eq(tpp.tpu_many_pod_platform(16, {3: 4.0}), jpp.tpu_many_pod_platform(16, {3: 4.0}))
    for exp, n, p, seed in (("E1", 20, 10, 0), ("E3", 7, 5, 3)):
        (gw, gp), (ww, wp) = tpp.paper_instance(exp, n, p, seed), jpp.paper_instance(exp, n, p, seed)
        _workload_eq(gw, ww)
        np.testing.assert_array_equal(gp.s, wp.s)
        assert gp.b == wp.b


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_lm_workload_equals_reference(arch):
    assert ARCH_IDS == J_ARCH_IDS and sorted(SHAPES) == sorted(J_SHAPES)
    for smoke in (False, True):
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        jcfg = j_get_smoke_config(arch) if smoke else j_get_config(arch)
        for name in SHAPES:
            _workload_eq(lm_workload(cfg, SHAPES[name]), j_lm_workload(jcfg, J_SHAPES[name]))
            assert layer_flops(cfg, 77, 3) == j_layer_flops(jcfg, 77, 3)


def test_model_api_workload():
    for arch in ("qwen3-4b", "zamba2-7b"):
        cfg = get_smoke_config(arch)
        _workload_eq(get_model(cfg).workload(SHAPES["train_4k"]),
                     j_get_model(j_get_smoke_config(arch)).workload(J_SHAPES["train_4k"]))


def _digest_eq(got, want):
    """Every field ``==``, the candidates' ``wall_ms`` left out."""
    assert sorted(got) == sorted(want)

    def strip(d):
        return d | {"candidates": [{k: v for k, v in c.items() if k != "wall_ms"}
                                   for c in d["candidates"]]}
    assert strip(got) == strip(want)
    assert all(isinstance(c["wall_ms"], float) for c in got["candidates"])


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_plan_serving_equals_reference(arch):
    for pods in (2, 4, 8):
        got = tserve.plan_serving(arch, pods, device="cpu")
        want = jserve.plan_serving(arch, pods)
        _digest_eq(got, want)
        n = len(lm_workload(get_smoke_config(arch), SHAPES["decode_32k"]).w)
        assert got["feasible"] and sum(got["stage_sizes"]) == n


def _fake_clock(step: float = 1e-3):
    """A clock for both serve modules: ``perf_counter`` advances by ``step``
    per call, so every decode step measures ``step`` seconds."""
    now = [0.0]

    def tick():
        now[0] += step
        return now[0]
    return types.SimpleNamespace(perf_counter=tick, time=tick)


def test_serve_pool_replan_equals_reference(monkeypatch):
    """``pods=4, replan=True, inject_straggler=3.0``: after the warm-up
    window every window reports stage 0 three times slower than predicted,
    and the fleet service republishes the placement.  The plan and the
    replan digests (counts) are the reference's."""
    monkeypatch.setattr(jserve, "time", _fake_clock())
    monkeypatch.setattr(tserve, "time", _fake_clock())
    monkeypatch.setattr(jserve, "jnp", types.SimpleNamespace(
        asarray=lambda x: jserve.jax.numpy.asarray(np.array(x))))
    kw = dict(arch="qwen3-4b", smoke=True, n_requests=4, batch=4, prompt_len=16,
              max_new=32, capacity=1024, pods=4, replan=True, replan_every=8,
              inject_straggler=3.0)
    want = jserve.serve_pool(**kw)
    got = tserve.serve_pool(**kw, device="cpu")
    assert sorted(got) == sorted(want)
    for key in ("requests", "decode_steps", "tokens_generated", "all_done"):
        assert got[key] == want[key], key
    _digest_eq(got["plan"], want["plan"])
    gr, wr = got["replan"], want["replan"]
    for key in ("replans", "stage_sizes", "pods", "period"):
        assert gr[key] == wr[key], key
    assert {k: gr["metrics"][k] for k in COUNTS} == {k: wr["metrics"][k] for k in COUNTS}
    assert gr["replans"] == 3 and got["decode_steps"] == 32


def test_serve_pool_replan_without_pods_is_the_plain_result():
    """``replan=True`` with ``pods=0`` builds no fleet, as in the reference:
    the plain metrics, no ``plan`` or ``replan`` key."""
    kw = dict(n_requests=2, batch=2, prompt_len=3, max_new=2, capacity=8, replan=True)
    got = tserve.serve_pool(**kw, device="cpu")
    want = jserve.serve_pool(**kw)
    assert sorted(got) == sorted(want) == sorted(
        ["requests", "decode_steps", "tokens_generated", "tokens_per_s", "wall_s", "all_done"])
    assert got["all_done"]
