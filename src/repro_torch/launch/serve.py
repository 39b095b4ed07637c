"""Serving: the continuous-batching decode loop (the port of the
reference's ``launch/serve.py::serve_pool``).

A request pool feeds a fixed-width decode batch; finished sequences free
their slot for the next request.  A new request's prompt is fed token by
token through full-batch decode steps (prefill-as-decode), exactly as the
reference does, so the other slots' caches advance on those steps too.  The
loop is model-agnostic: every family that :func:`repro_torch.models.get_model`
takes runs through it (the decode state holds KV caches, Mamba states,
xLSTM memories, or an enc-dec model's self caches beside its cross K/V).
As in the reference, an enc-dec model is served without running its
encoder: its cross K/V stay the decode state's zeros.

With ``pods > 0`` the result carries the placement of the served model over
that many pods (:func:`plan_serving`, the planner portfolio); with
``replan`` the fleet service shadows the decode loop and republishes the
placement when the measured step time drifts.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --requests 8 --batch 4 --prompt-len 64 --max-new 32 --capacity 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --requests 8 --batch 4 --prompt-len 32 --max-new 16 --capacity 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --pods 4 --replan
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, get_smoke_config
from ..core import Objective, PlanRequest, plan_request, tpu_pod_platform
from ..models import SHAPES, get_model, lm_workload

__all__ = ["Request", "plan_serving", "sample_tokens", "serve_pool"]


def plan_serving(arch: str, pods: int, smoke: bool = True,
                 shape_name: str = "decode_32k", device=None) -> dict:
    """Plan the pipeline placement of ``arch`` over ``pods`` pods via the
    solver-registry portfolio, split scoring on ``device`` (``None`` means
    cuda); returns a JSON-able digest of the PlanReport (chosen mapping +
    per-solver provenance), keyed as the reference's."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    wl = lm_workload(cfg, SHAPES[shape_name])
    pf = tpu_pod_platform(pods)
    report = plan_request(PlanRequest(wl, pf, Objective("period")), device=dev)
    digest = {
        "feasible": report.feasible,
        "pareto": [list(pt) for pt in report.pareto],
        "candidates": [
            {"solver": c.solver, "period": c.period, "latency": c.latency,
             "feasible": c.feasible, "wall_ms": c.wall_time * 1e3,
             **({"error": c.error} if c.error else {})}
            for c in report.candidates
        ],
    }
    if report.feasible:
        digest.update(
            planner=report.plan.planner,
            stage_sizes=list(report.plan.stage_sizes),
            pods=[int(u) for u in report.plan.mapping.alloc],
            period=report.plan.period,
            latency=report.plan.latency,
        )
    return digest


def sample_tokens(logits: np.ndarray, rng: Optional[np.random.Generator] = None,
                  greedy: bool = True, temperature: float = 1.0) -> np.ndarray:
    """Next-token choice for a (B, V) logit batch, on the host.

    Greedy (or ``temperature <= 0``) takes the argmax.  Otherwise Gumbel-max
    sampling from the seeded generator: ``argmax(logits/T + Gumbel)`` draws
    exactly from ``softmax(logits/T)`` without materializing the softmax.
    """
    if greedy or temperature <= 0:
        return logits.argmax(-1)
    if rng is None:
        raise ValueError("sampling needs a seeded Generator")
    return (logits / temperature + rng.gumbel(size=logits.shape)).argmax(-1)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new: int
    generated: Optional[List[int]] = None
    done: bool = False


def serve_pool(arch: str = "qwen3-4b", smoke: bool = True, n_requests: int = 16,
               batch: int = 4, prompt_len: int = 16, max_new: int = 32,
               capacity: int = 128, seed: int = 0, greedy: bool = True,
               temperature: float = 1.0, pods: int = 0, replan: bool = False,
               replan_every: int = 8, inject_straggler: float = 0.0,
               device=None, params: Optional[dict] = None) -> dict:
    """Run a request pool to completion on ``device`` (``None`` means cuda);
    returns the reference's throughput metrics.

    The model runs its hand-written kernels (the config's ``use_pallas`` is
    set): on the card the serving path is the kernel path.  With
    ``pods > 0`` the metrics include a ``plan`` digest (:func:`plan_serving`).
    With ``replan`` (and ``pods > 0``) the fleet service
    (:mod:`repro_torch.fleet`) shadows the decode loop: every
    ``replan_every`` steps the measured step time (the decode call and the
    logits copy, on this module's ``time.perf_counter``) feeds a
    ``StageTimings`` event (``inject_straggler`` > 1 additionally slows
    stage 0, a deterministic straggler) and the service republishes the
    placement when its EWMA flags drift; the result then has a ``replan``
    digest.  Planning and replanning score splits on ``device``.  With
    ``params=None`` the parameters are drawn from a ``torch.Generator``
    seeded with ``seed``; otherwise ``params`` (e.g. from the
    ``params_from_numpy`` of the family's module) are used.  The
    prompts come from ``np.random.default_rng(seed)`` as in the reference."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cfg = cfg.replace(use_pallas=True)
    api = get_model(cfg)
    if params is None:
        params = api.init(seed, dev)
    rng = np.random.default_rng(seed)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, prompt_len).astype(np.int32),
                    max_new, []) for i in range(n_requests)]

    def decode(state, tokens: np.ndarray):
        return api.decode(params, state, torch.from_numpy(tokens).to(dev))

    state = api.init_decode_state(batch, capacity, dev)
    slots: List[Optional[Request]] = [None] * batch
    slot_steps = np.zeros(batch, np.int32)
    cur_tokens = np.zeros((batch, 1), np.int32)
    queue = list(reqs)
    sample_rng = np.random.default_rng(seed + 1)

    fleet = None
    if replan and pods > 0:
        from ..core import interval_cycle_times
        from ..fleet import ReplanService, StageTimings

        wl = lm_workload(cfg, SHAPES["decode_32k"])
        fleet = ReplanService([(wl, tpu_pod_platform(pods))], device=dev)
        replans = 0
        baseline_wall = None
        window: List[float] = []

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    tokens_out = 0
    steps = 0

    def admit(state):
        """Fill free slots: run the prompt through decode steps (prefill-as-
        decode keeps the loop model-agnostic across cache/SSM states)."""
        nonlocal cur_tokens
        for s in range(batch):
            if slots[s] is None and queue:
                r = queue.pop(0)
                slots[s] = r
                slot_steps[s] = 0
                # feed the prompt token by token into this slot
                for t in r.prompt[:-1]:
                    tok = cur_tokens.copy()
                    tok[s, 0] = t
                    cur_tokens = tok
                    _, state = decode(state, cur_tokens)
                cur_tokens[s, 0] = r.prompt[-1]
        return state

    state = admit(state)
    while any(slots) or queue:
        ts = time.perf_counter()
        logits, state = decode(state, cur_tokens)
        steps += 1
        logits_np = logits[:, 0].float().cpu().numpy()
        if fleet is not None:
            window.append(time.perf_counter() - ts)
            if len(window) == replan_every:
                mean_wall = float(np.mean(window))
                window.clear()
                if baseline_wall is None:
                    baseline_wall = mean_wall     # warmup window sets the norm
                else:
                    # the fastest window seen is the platform's true speed;
                    # measuring against it keeps the drift ratio robust to a
                    # slow warmup window
                    baseline_wall = min(baseline_wall, mean_wall)
                    st = fleet.states[0]
                    predicted = interval_cycle_times(st.workload, st.platform,
                                                     st.plan.mapping)
                    observed = predicted * (mean_wall / baseline_wall)
                    if inject_straggler > 1.0:
                        observed[0] *= inject_straggler
                    replans += len(fleet.tick([StageTimings(0, tuple(observed))]))
        nxt = sample_tokens(logits_np, sample_rng, greedy, temperature)
        for s in range(batch):
            r = slots[s]
            if r is None:
                continue
            tok = int(nxt[s])
            r.generated.append(tok)
            tokens_out += 1
            slot_steps[s] += 1
            cur_tokens[s, 0] = tok
            if slot_steps[s] >= r.max_new:
                r.done = True
                slots[s] = None
        if any(sl is None for sl in slots) and queue:
            state = admit(state)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    out = {
        "requests": n_requests,
        "decode_steps": steps,
        "tokens_generated": tokens_out,
        "tokens_per_s": tokens_out / max(dt, 1e-9),
        "wall_s": dt,
        "all_done": all(r.done for r in reqs),
    }
    if pods > 0:
        out["plan"] = plan_serving(arch, pods, smoke=smoke, device=dev)
    if fleet is not None:
        fplan = fleet.states[0].plan
        out["replan"] = {
            "replans": replans,
            "stage_sizes": list(fplan.stage_sizes),
            "pods": [int(u) for u in fplan.mapping.alloc],
            "period": fplan.period,
            "metrics": fleet.metrics.summary(),
        }
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b",
                    help="any of the ten arch ids, e.g. qwen3-4b (dense), zamba2-7b "
                         "(hybrid), mixtral-8x7b or arctic-480b (moe), internvl2-26b "
                         "(vlm), whisper-large-v3 (encdec), xlstm-350m (xlstm)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sample", action="store_true",
                    help="temperature sampling instead of greedy decode")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--pods", type=int, default=0,
                    help="also plan pipeline placement over this many pods")
    ap.add_argument("--replan", action="store_true",
                    help="drive the fleet replanning service from live "
                         "decode-step timings (needs --pods)")
    ap.add_argument("--replan-every", type=int, default=8)
    ap.add_argument("--inject-straggler", type=float, default=0.0,
                    help="slow stage 0 by this factor after warmup "
                         "(deterministic straggler for smoke tests)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()
    out = serve_pool(arch=args.arch, smoke=args.smoke, n_requests=args.requests,
                     batch=args.batch, prompt_len=args.prompt_len,
                     max_new=args.max_new, capacity=args.capacity, seed=args.seed,
                     greedy=not args.sample, temperature=args.temperature,
                     pods=args.pods, replan=args.replan,
                     replan_every=args.replan_every,
                     inject_straggler=args.inject_straggler, device=args.device)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
