"""Training loop: checkpointed and fault-tolerant (the port of the
reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --smoke \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

  - deterministic restart: the data stream is a pure function of (seed,
    step), so crash + ``restore_latest`` resumes the exact token sequence;
  - throughput metrics: tokens/s, step time, loss.

The model trains as the reference's does: float32 master weights, plain
autograd through the plain versions of the kernels (``use_pallas`` off),
each block recomputed in the backward pass (``cfg.remat``), blocked
attention above S = 2048, the MoE load-balance loss at weight 0.01, and
``cfg.accum_steps`` microbatches per step.  The VLM family reads zero patch
embeddings and the enc-dec family zero frames, as in the reference (both
frontends are stubs).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import SyntheticLMDataset
from ..models import get_model, stub_inputs
from ..models.train import init_optimizer, make_train_step

__all__ = ["build", "main", "train_loop"]


def build(arch: str, smoke: bool, batch: int, seq: int, base_lr: float,
          total_steps: int):
    """(cfg, api, train_step) of ``arch``."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    api = get_model(cfg)
    train_step = make_train_step(api.train_forward, cfg, base_lr=base_lr,
                                 total_steps=total_steps)
    return cfg, api, train_step


def train_loop(arch: str = "qwen3-4b", smoke: bool = True, steps: int = 100,
               batch: int = 8, seq: int = 128, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 50, base_lr: float = 3e-4, seed: int = 0,
               log_every: int = 10, fail_at_step: Optional[int] = None,
               device=None) -> dict:
    """Train on ``device`` (``None`` means cuda); returns final metrics, the
    reference's keys, plus ``losses`` (every step's) and ``step_s`` (every
    step's wall, host clock around work that ends in a device
    synchronization).  ``fail_at_step`` simulates a crash (tests)."""
    dev = resolve_device(device)
    cfg, api, train_step = build(arch, smoke, batch, seq, base_lr, steps)
    params = api.init(seed, dev, master=True)
    opt_state = init_optimizer(params)
    start_step = 0

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr is not None:
        restored = mgr.restore_latest({"params": params, "opt": opt_state})
        if restored is not None:
            tree, manifest = restored
            params, opt_state = tree["params"], tree["opt"]
            start_step = manifest["step"] + 1
            print(f"[train] restored checkpoint at step {manifest['step']}")

    ds = SyntheticLMDataset(cfg.vocab_size, seq, batch, seed=seed)
    losses = []
    t_last = time.time()
    step_times = []
    for step in range(start_step, steps):
        batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(step).items()}
        batch_dev |= stub_inputs(cfg, batch, dev)
        params, opt_state, metrics = train_step(params, opt_state, batch_dev)
        loss = float(metrics["loss"])
        losses.append(loss)
        now = time.time()
        step_times.append(now - t_last)
        t_last = now
        if step % log_every == 0:
            tps = batch * seq / max(step_times[-1], 1e-9)
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({step_times[-1]*1000:.0f} ms, {tps:.0f} tok/s)")
        if mgr is not None and step > 0 and step % ckpt_every == 0:
            mgr.save(step, {"params": params, "opt": opt_state},
                     extras={"loss": loss})
        if fail_at_step is not None and step == fail_at_step:
            mgr and mgr.wait()
            raise RuntimeError(f"simulated failure at step {step}")
    if mgr is not None:
        mgr.save(steps - 1, {"params": params, "opt": opt_state},
                 extras={"loss": losses[-1]})
        mgr.wait()
    return {
        "first_loss": losses[0] if losses else None,
        "final_loss": float(np.mean(losses[-5:])) if losses else None,
        "steps_run": len(losses),
        "start_step": start_step,
        "mean_step_s": float(np.mean(step_times[1:])) if len(step_times) > 1 else None,
        "losses": losses,
        "step_s": step_times,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()
    out = train_loop(arch=args.arch, smoke=args.smoke, steps=args.steps,
                     batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, base_lr=args.lr, seed=args.seed,
                     device=args.device)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
