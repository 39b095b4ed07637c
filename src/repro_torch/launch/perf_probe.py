"""The perf-probe -> planner bridge (the port of the reference's
``launch/perf_probe.py`` adapters).

A probe's output (per-device dot flops and collective bytes of a lowered
model cell, the devices of its mesh, roofline terms in seconds) becomes a
planner ``Workload`` / ``PlanRequest``, so the pipeline planner places the
PROBED model rather than the purely analytic one.  :func:`probe` itself,
which measures a cell, waits for the dry-run slice (ROADMAP.md Queue 1):
what it measures on the card is defined there.  Unlike the reference's
module, this one sets no environment variable.
"""

from __future__ import annotations

from ..configs import get_config, get_smoke_config
from ..core import Objective, PlanRequest, make_workload, tpu_pod_platform
from ..models.common import SHAPES
from ..models.registry import lm_workload

__all__ = ["probe_to_request", "probe_to_workload"]


def probe_to_workload(probe_out: dict, arch: str, shape_name: str,
                      smoke: bool = False, devices: int = None):
    """Calibrate the analytic per-layer pipeline workload with a probe's
    MEASURED totals — the bridge from a measured profile to the planner.

    Units (the normalization contract, so planner outputs line up with the
    probe's roofline terms):

    - probe ``terms`` are SECONDS (per-device quantities over per-device
      peak rates);
    - workload ``w`` is FLOPS per stage, ``delta`` is BYTES per boundary;
    - :func:`repro_torch.core.tpu_pod_platform` speeds are FLOPS/SECOND and
      bandwidth BYTES/SECOND —

    so every period/latency the planner reports on the returned workload is
    in SECONDS, directly comparable to ``max(terms.values())``.

    ``res["dot_flops"]`` / ``res["collective_bytes"]`` are PER-DEVICE
    numbers; they are scaled by the probe mesh's device count (recorded in
    ``probe_out["devices"]``) back to global totals, then spread over the
    analytic per-layer profile (:func:`repro_torch.models.lm_workload`),
    preserving its relative stage shape (encoder/decoder and
    hybrid-attention asymmetries) while pinning the totals to what the
    measured program actually does.
    """
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    base = lm_workload(cfg, SHAPES[shape_name])
    devices = devices if devices is not None else int(probe_out.get("devices", 1))
    res = probe_out["res"]
    flops_global = float(res["dot_flops"]) * devices
    coll_global = float(res["collective_bytes"]) * devices
    w_total = float(base.w.sum())
    d_total = float(base.delta.sum())
    flop_scale = flops_global / w_total if w_total and flops_global else 1.0
    comm_scale = coll_global / d_total if d_total and coll_global else 1.0
    return make_workload(base.w * flop_scale, base.delta * comm_scale,
                         name=f"{cfg.arch_id}-probed")


def probe_to_request(probe_out: dict, arch: str, shape_name: str, pods: int,
                     objective=None, smoke: bool = False, devices: int = None):
    """A ready-to-solve :class:`repro_torch.core.PlanRequest` for the probed
    cell: the measured-calibrated workload of :func:`probe_to_workload` over
    a ``pods``-pod platform (same second/flop/byte normalization, so the
    planned period is in seconds)."""
    wl = probe_to_workload(probe_out, arch, shape_name, smoke=smoke, devices=devices)
    return PlanRequest(wl, tpu_pod_platform(pods), objective or Objective("period"))
