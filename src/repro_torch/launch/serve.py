"""Serving: the continuous-batching decode loop (the port of the
reference's ``launch/serve.py::serve_pool``).

A request pool feeds a fixed-width decode batch; finished sequences free
their slot for the next request.  A new request's prompt is fed token by
token through full-batch decode steps (prefill-as-decode), exactly as the
reference does, so the other slots' caches advance on those steps too.  The
loop is model-agnostic: any family that :func:`repro_torch.models.get_model`
takes runs through it (the dense qwen3-4b, and the hybrid zamba2-7b, whose
decode state holds the Mamba states beside the KV caches).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --requests 8 --batch 4 --prompt-len 64 --max-new 32 --capacity 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --requests 8 --batch 4 --prompt-len 32 --max-new 16 --capacity 1024
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
from ..models import get_model

__all__ = ["Request", "sample_tokens", "serve_pool"]


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
    ``params=None`` the parameters are drawn from a ``torch.Generator``
    seeded with ``seed``; otherwise ``params`` (e.g. from the
    ``params_from_numpy`` of :mod:`repro_torch.models.transformer` or
    :mod:`repro_torch.models.hybrid`) are used.  The
    prompts come from ``np.random.default_rng(seed)`` as in the reference.
    ``pods > 0`` and ``replan`` need the planner portfolio and the fleet
    service, which are not ported yet, and raise."""
    if pods > 0 or replan:
        raise NotImplementedError("pods/replan need the planner portfolio and the "
                                  "fleet service, not ported yet (ROADMAP.md Queue 1)")
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
        logits, state = decode(state, cur_tokens)
        steps += 1
        logits_np = logits[:, 0].float().cpu().numpy()
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
    return {
        "requests": n_requests,
        "decode_steps": steps,
        "tokens_generated": tokens_out,
        "tokens_per_s": tokens_out / max(dt, 1e-9),
        "wall_s": dt,
        "all_done": all(r.done for r in reqs),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b",
                    help="a ported family's arch id: qwen3-4b (dense) or zamba2-7b (hybrid)")
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
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()
    out = serve_pool(arch=args.arch, smoke=args.smoke, n_requests=args.requests,
                     batch=args.batch, prompt_len=args.prompt_len,
                     max_new=args.max_new, capacity=args.capacity, seed=args.seed,
                     greedy=not args.sample, temperature=args.temperature,
                     device=args.device)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
