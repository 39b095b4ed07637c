"""The perf probe and the probe -> planner bridge (the port of the
reference's ``launch/perf_probe.py``).

:func:`probe` runs one cell's step through the dry run
(:func:`repro_torch.launch.dryrun.run_cell`, on ``meta`` tensors by
default, for real with ``device="cuda"``) and prints the roofline terms
against one H100's peaks, the ops of most bytes, the collectives and the
contractions, each with the ``repro_torch.models`` function that issued it:

    PYTHONPATH=src python -m repro_torch.launch.perf_probe --arch mixtral-8x7b \
        --shape train_4k [--multi-pod] [--top 12] [--set use_pallas=True]

A probe's output (per-device dot flops and collective bytes of the cell,
over the devices that compute, their count, roofline terms in seconds)
becomes a planner
``Workload`` / ``PlanRequest`` (:func:`probe_to_workload`,
:func:`probe_to_request`), so the pipeline planner places the PROBED model
rather than the purely analytic one.  Unlike the reference's module, this
one sets no environment variable.
"""

from __future__ import annotations

import argparse
import ast

from ..configs import get_config, get_smoke_config
from ..core import Objective, PlanRequest, make_workload, tpu_pod_platform
from ..models.common import SHAPES
from ..models.registry import lm_workload

__all__ = ["CARD", "HBM_BW", "LINK_BW", "PEAK_FLOPS", "probe", "probe_to_request",
           "probe_to_workload"]

# One NVIDIA H100 SXM (data sheet), the card of the port's chip runs: dense
# bf16 tensor-core rate and HBM3 bandwidth (chip_smoke.py's bounds), and one
# direction of NVLink 4 (900 GB/s both ways).  The card's name and power
# limit as nvidia-smi --query-gpu=name,power.limit reports them there:
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS, HBM_BW, LINK_BW = 989e12, 3.35e12, 450e9


def probe(arch: str, shape_name: str, multi_pod: bool = False, overrides: dict = None,
          top: int = 12, *, device="meta") -> dict:
    """Probe one cell: returns ``{"terms", "res", "temp_gb", "devices"}`` as
    the reference's does, and ``mesh_devices``.  ``res`` is the op analysis
    with ``dot_flops``, ``bytes_accessed`` and ``collective_bytes`` per
    computing device: the totals over ``devices``, the slots that compute
    (every model slot of each data slot that took rows, tensor-parallel:
    256 on pod16x16), not over the mesh's ``mesh_devices``; ``terms`` are those over the peaks of one H100
    (:data:`CARD`), in seconds.  ``overrides`` are applied with
    ``cfg.replace``."""
    from .dryrun import run_cell

    rec = run_cell(arch, shape_name, multi_pod, device=device, overrides=overrides)
    an = rec["hlo"]
    res = dict(an) | an["per_device"]
    terms = {"compute": res["dot_flops"] / PEAK_FLOPS,
             "memory": res["bytes_accessed"] / HBM_BW,
             "collective": res["collective_bytes"] / LINK_BW}
    dom = max(terms, key=terms.get)
    mem = rec["memory"]
    n, k = rec["devices"], an["computing_devices"]
    print(f"== {arch} {shape_name} {rec['mesh']} {overrides or ''} on {device}; peaks of "
          f"one H100 SXM ({CARD}): {PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, "
          f"{HBM_BW / 1e12:.2f} TB/s HBM, {LINK_BW / 1e9:.0f} GB/s NVLink per direction")
    print(f"terms per computing device ({k} of the {n} slots): "
          f"compute={terms['compute']:.3f}s memory={terms['memory']:.3f}s "
          f"collective={terms['collective']:.3f}s  dominant={dom}  "
          f"frac={terms['compute'] / max(max(terms.values()), 1e-30):.3f}")
    print(f"per slot: temp={mem['temp_size_in_bytes'] / 1e9:.1f}GB  "
          f"args={mem['argument_size_in_bytes'] / 1e9:.1f}GB  fits={mem['fits']}")
    print("bytes_by_kind (GB, all slots):",
          {k: round(v / 1e9, 1) for k, v in sorted(
              an["bytes_by_kind"].items(), key=lambda kv: -kv[1])[:8]})
    if an["launches"]:
        print("kernel launches:", an["launches"])
    print("-- top HBM-bytes ops (all slots):")
    for b in (an["detail"] or [])[:top]:
        print(f"  {b[0] / 1e9:8.2f}GB x{b[1]:6d} {b[2]:22s} {b[3]}")
    print(f"-- collectives ({an['collective_bytes'] / 1e9:.1f} GB over {n} slots):")
    for op, nbytes in sorted(an["collectives"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {nbytes / 1e9:8.2f}GB x{an['collective_counts'][op]:6d} {op}")
    print(f"-- top dots ({an['dot_flops'] / 1e12:.1f} TF total, all slots):")
    for d in (an["dot_detail"] or [])[:max(top // 2, 6)]:
        print(f"  {d[0] / 1e12:8.2f}TF x{d[1]:6d} {d[2]:22s} {d[3]}")
    return {"terms": terms, "res": res, "temp_gb": mem["temp_size_in_bytes"] / 1e9,
            "devices": k, "mesh_devices": n}


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
    numbers; they are scaled by the count they were divided by (recorded in
    ``probe_out["devices"]``: the devices that compute, see :func:`probe`)
    back to global totals, then spread over the
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Probe one cell: roofline terms on one H100 and "
                                             "the top ops, collectives and contractions.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--set", action="append", default=[],
                    help="a config override key=value (a Python literal)")
    ap.add_argument("--device", default="meta", help="meta (default), cpu or cuda")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = ast.literal_eval(v)
    probe(args.arch, args.shape, args.multi_pod, overrides, args.top, device=args.device)


if __name__ == "__main__":
    main()
