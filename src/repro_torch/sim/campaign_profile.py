"""Where a campaign's time goes on the card.

    PYTHONPATH=src python -m repro_torch.sim.campaign_profile --out <file.json> \
        [--engine batched|fused|sharded]

Runs the full-width Section-5 campaign (E1-E4 x 50 instance pairs, n = 160
stages, p = 1000 processors, 12 bounds, H4 with 10 bisection steps) on cuda
through ``--engine`` (default ``batched``, the engine of the earlier
profiles) three times:

  1. a warm-up run;
  2. a run timed by the host clock around work that ends in
     ``torch.cuda.synchronize()`` (``wall_s``);
  3. a run under ``torch.profiler`` (CPU and CUDA activities): the wall time
     of each campaign stage on the host and on the device (the ``campaign.*``
     spans of :mod:`repro_torch.sim.experiments`), the device time summed
     over every kernel (one stream, so no overlap), its share of the profiled
     wall time, the number of device kernels and copies, the kernels that
     take the most device time, and the device time of the port's own
     split-scoring kernels.

With the fused or sharded engine the timed run also counts graph replays
and host polls.  It prints the summary as JSON and writes it to ``--out``.
Needs a CUDA device; device times are null when the profiler records none.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import torch

from .. import resolve_device
from ..core import fused, sharded
from ..kernels import split_score
from .experiments import run_campaign

FAMILIES = ("E1", "E2", "E3", "E4")
PORT_KERNELS = ("score_2way_kernel", "score_3way_kernel")
N_STAGES, N_PROCS, N_PAIRS, N_BOUNDS, H4_ITERS = 160, 1000, 50, 12, 10
TOP = 15


def profile(engine: str = "batched") -> dict:
    dev = resolve_device(None)
    n, p = N_STAGES, N_PROCS
    kw = dict(n_pairs=N_PAIRS, n_bounds=N_BOUNDS, h4_iters=H4_ITERS, engine=engine,
              device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    out = {"card": smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None,
           "torch": torch.__version__, "config": {"families": FAMILIES, "n": n,
                                                  "p": p, **kw, "device": str(dev)}}
    run_campaign(FAMILIES, n, p, **kw)                       # warm-up
    torch.cuda.synchronize()
    split_score.score_2way_cuda.launches = 0
    split_score.score_3way_cuda.launches = 0
    engines = (fused, sharded)
    for m in engines:
        m.reset_dispatch_count()
        m.reset_sync_count()
    t0 = time.perf_counter()
    run_campaign(FAMILIES, n, p, **kw)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = {"score_2way_f64": split_score.score_2way_cuda.launches,
                       "score_3way_f64": split_score.score_3way_cuda.launches}
    out["replays"] = sum(m.dispatch_count() for m in engines)
    out["polls"] = sum(m.sync_count() for m in engines)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_campaign(FAMILIES, n, p, **kw)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    spans: dict = {}
    kernels: dict = {}
    device_us = 0.0
    device_events = 0
    for evt in prof.events():
        dur = evt.time_range.elapsed_us()
        on_device = evt.device_type == torch.autograd.DeviceType.CUDA
        if evt.name.startswith("campaign."):
            side = "device" if on_device else "host"
            spans.setdefault(evt.name, {"host_s": 0.0, "device_s": 0.0})[f"{side}_s"] += dur / 1e6
        elif on_device:
            device_us += dur
            device_events += 1
            mine = [k for k in PORT_KERNELS if k in evt.name]
            k = kernels.setdefault(mine[0] if mine else evt.name[:120], [0, 0.0])
            k[0] += 1
            k[1] += dur / 1e6
    out["profiled_wall_s"] = wall_prof
    out["spans"] = spans
    out["device_busy_s"] = device_us / 1e6 if device_us > 0 else None
    out["device_busy_share"] = device_us / 1e6 / wall_prof if device_us > 0 else None
    out["device_events"] = device_events
    ranked = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)
    out["top_device"] = [{"name": name, "count": c, "device_s": s}
                         for name, (c, s) in ranked[:TOP]]
    out["port_kernels"] = {name: {"count": kernels.get(name, [0, 0.0])[0],
                                  "device_s": kernels.get(name, [0, 0.0])[1]}
                           for name in PORT_KERNELS}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=pathlib.Path, required=True)
    ap.add_argument("--engine", choices=("batched", "fused", "sharded"), default="batched")
    args = ap.parse_args()
    res = profile(args.engine)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
