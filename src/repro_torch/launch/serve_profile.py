"""Where the serving path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve_profile [--arch ARCH] \
        [--layers L] [--seq S] --out <file.json>

One model at full width (``--arch``: any of the ten, qwen3-4b the default;
``--layers`` cuts its depth where its weights would not fit the card,
chip_smoke.py's phase 19 cuts being mixtral-8x7b 8 and arctic-480b 2;
random weights from seed 0), kernels on, the shapes of ``chip_smoke.py``'s
serving phases:

  1. decode: a batch of 4 against a cache of 1024 slots; 64 warm-up steps,
     then 32 steps timed by the host clock (each step as ``serve_pool`` runs
     it: ``decode`` and the logits copied to the host), then 8 steps under
     ``torch.profiler``;
  2. forward: B = 1 at ``--seq`` positions (4096; the VLM's patch
     embeddings count, the enc-dec model's 1,500 frames do not), the stub
     frontends' inputs ``normal * 0.02``; one warm-up call, one timed, one
     profiled.

For each profiled window: the wall time, the device time summed over every
kernel (one stream, so no overlap) and its share of the wall, the kernels
with the most device time, the host operators with the most self time, and
the count of host-device synchronizations (CUDA runtime calls that block the
host).  It prints the summary as JSON and writes it to ``--out``.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import torch

from .. import resolve_device
from ..configs import get_config
from ..models import get_model, stub_inputs

BATCH, CAPACITY, WARM_STEPS, TIMED_STEPS, PROFILED_STEPS = 4, 1024, 64, 32, 8
FWD_S = 4096
TOP = 15
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
              "cudaMemcpyAsync", "cudaEventSynchronize")


def _breakdown(prof, wall: float) -> dict:
    device_us, kernels, syncs = 0.0, {}, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            dur = evt.time_range.elapsed_us()
            device_us += dur
            k = kernels.setdefault(evt.name[:120], [0, 0.0])
            k[0] += 1
            k[1] += dur / 1e6
        elif evt.name in SYNC_CALLS:
            syncs[evt.name] = syncs.get(evt.name, 0) + 1
    ranked = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return {
        "wall_s": wall,
        "device_busy_s": device_us / 1e6 if device_us > 0 else None,
        "device_busy_share": device_us / 1e6 / wall if device_us > 0 else None,
        "kernel_launches": sum(c for c, _ in kernels.values()),
        "host_syncs": syncs,
        "top_device": [{"name": n, "count": c, "device_s": s} for n, (c, s) in ranked[:TOP]],
        "top_host_self": [{"name": e.key, "count": e.count,
                           "self_cpu_s": e.self_cpu_time_total / 1e6} for e in host[:TOP]],
    }


def profile(arch: str = "qwen3-4b", layers: int = None, seq: int = FWD_S) -> dict:
    dev = resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    cfg = get_config(arch).replace(use_pallas=True)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    api = get_model(cfg)
    params = api.init(0, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {"card": smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None,
           "torch": torch.__version__,
           "config": {"arch": arch, "layers": cfg.n_layers, "batch": BATCH,
                      "capacity": CAPACITY, "warm_steps": WARM_STEPS,
                      "timed_steps": TIMED_STEPS, "profiled_steps": PROFILED_STEPS,
                      "forward_S": seq}}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    state = api.init_decode_state(BATCH, CAPACITY, dev)
    toks = torch.randint(1, cfg.vocab_size, (WARM_STEPS + TIMED_STEPS + PROFILED_STEPS,
                                             BATCH, 1), device="cpu")

    def step(t):
        nonlocal state
        logits, state = api.decode(params, state, toks[t].to(dev))
        return logits[:, 0].float().cpu()

    for t in range(WARM_STEPS):
        step(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(WARM_STEPS, WARM_STEPS + TIMED_STEPS):
        step(t)
    torch.cuda.synchronize()
    out["decode_ms_per_step"] = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for t in range(WARM_STEPS + TIMED_STEPS, WARM_STEPS + TIMED_STEPS + PROFILED_STEPS):
            step(t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["decode"] = _breakdown(prof, wall)
    del state

    text = seq - (cfg.n_vis_tokens if cfg.family == "vlm" else 0)
    tokens = torch.randint(1, cfg.vocab_size, (1, text), device=dev, generator=gen)
    batch = {"tokens": tokens} | stub_inputs(cfg, 1, dev, gen)
    for timed in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.forward(params, batch, cfg)
        torch.cuda.synchronize()
        if timed:
            out["forward_s"] = time.perf_counter() - t0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        api.forward(params, batch, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["forward"] = _breakdown(prof, wall)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", help="any of the ten arch ids")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers (default: its full depth)")
    ap.add_argument("--seq", type=int, default=FWD_S, help="forward positions")
    ap.add_argument("--out", type=pathlib.Path, required=True)
    args = ap.parse_args()
    res = profile(args.arch, args.layers, args.seq)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
