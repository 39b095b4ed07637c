"""Which CPU op makes a process's first CPU forward differ from its second.

    PYTHONPATH=src python -m repro_torch.launch.first_forward_probe \\
        [--processes 30] [--seq 1536] [--device cuda] [--out PATH]

Runs, in each of ``--processes`` fresh Python processes one after another,
the sequence of the card test ``test_smoke_model_on_card_matches_cpu
[float32]`` (``tests/test_torch_model_kernels_cuda.py``): the smoke qwen3-4b
in float32 with kernels, parameters from seed 0 on the CPU and a copy on
``--device``, tokens from ``numpy.random.default_rng(5)``; one forward on
the device, then one on the CPU, then a second one on the CPU.  A
``TorchDispatchMode`` records every op of both CPU forwards: its name, its
inputs' shapes, a digest of its outputs' bytes and ``torch.get_num_threads()``
when it ran.  A process whose two CPU forwards differ reports the first op
whose outputs differ, its inputs' shapes and the thread count at that moment
in each forward.

Prints one JSON object: per process the logits' max difference device vs
the first and the second CPU forward, whether the two CPU forwards agree bit
for bit, and the first differing op; then how many processes missed.
``--device cpu`` runs the same sequence with the "device" forward on the CPU
too (a rehearsal of the probe, not of the card).

:func:`recorded_cpu_forwards` is the recording alone: the card test itself
runs its two CPU forwards through it, inside the test process, after the
tests before it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import resolve_device
from ..configs import get_smoke_config
from ..models import get_model


def _digest(t: torch.Tensor) -> str:
    flat = t.detach().contiguous().reshape(-1)
    return hashlib.blake2b(flat.view(torch.uint8).numpy().tobytes(), digest_size=12).hexdigest()


class OpRecorder(TorchDispatchMode):
    """Every op run under the mode: (name, input shapes, output digest,
    torch.get_num_threads())."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if outs and all(t.device.type == "cpu" for t in outs):
            shapes = [list(t.shape) for t in tree_flatten((args, kwargs))[0]
                      if isinstance(t, torch.Tensor)]
            self.ops.append((str(func), shapes, "".join(_digest(t) for t in outs),
                             torch.get_num_threads()))
        return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def recorded_cpu_forwards(api, params, toks, cfg, got=None) -> tuple:
    """Two CPU forwards of ``toks``, each with every op recorded.  Returns
    ``(first logits, second logits, summary)``: whether the two repeat bit
    for bit, the op counts, the first op whose outputs differ (its inputs'
    shapes and the thread count when it ran in each forward), and, given the
    device's logits ``got``, the max difference to each CPU forward."""
    runs = []
    for _ in range(2):
        rec = OpRecorder()
        with rec:
            want, _ = api.forward(params, {"tokens": toks}, cfg)
        runs.append((want, rec.ops))
    (first, ops1), (second, ops2) = runs
    out = {"threads": torch.get_num_threads(),
           "cpu_repeats_bitwise": bool(torch.equal(first, second)),
           "ops": [len(ops1), len(ops2)], "first_differing_op": None}
    if got is not None:
        got = got.float().cpu()
        out["max_err_first"] = float((got - first).abs().max())
        out["max_err_second"] = float((got - second).abs().max())
    for i, (a, b) in enumerate(zip(ops1, ops2)):
        if a != b:
            out["first_differing_op"] = {
                "index": i, "op": [a[0], b[0]], "input_shapes": [a[1], b[1]],
                "num_threads": [a[3], b[3]], "ops_before": [o[0] for o in ops1[max(0, i - 3):i]]}
            break
    return first, second, out


def run_sequence(seq: int = 1536, device=None) -> dict:
    """One process's sequence: device forward, CPU forward, CPU forward."""
    dev = resolve_device(device)
    cfg = get_smoke_config("qwen3-4b").replace(dtype="float32", use_pallas=True)
    api = get_model(cfg)
    params = api.init(0, "cpu")
    on_dev = _to(params, dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(1, cfg.vocab_size, (1, seq)))
    got, _ = api.forward(on_dev, {"tokens": toks.to(dev)}, cfg)
    _, _, rec = recorded_cpu_forwards(api, params, toks, cfg, got)
    return {"device": str(dev), "seq": seq} | rec


def probe(processes: int = 30, seq: int = 1536, device=None) -> dict:
    """The sequence in ``processes`` fresh processes, one after another."""
    dev = resolve_device(device)
    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    runs = []
    for _ in range(processes):
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.first_forward_probe",
                              "--child", "--seq", str(seq), "--device", str(dev)],
                             env=env, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"probe process failed (rc {res.returncode}): {res.stderr[-2000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    return {"processes": processes, "seq": seq, "device": str(dev),
            "cpu_misses": sum(not r["cpu_repeats_bitwise"] for r in runs),
            "over_1e-4": sum(r["max_err_first"] >= 1e-4 for r in runs), "runs": runs}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=30)
    ap.add_argument("--seq", type=int, default=1536)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(run_sequence(args.seq, args.device)))
        return
    res = probe(args.processes, args.seq, args.device)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps({k: res[k] for k in ("processes", "seq", "device", "cpu_misses",
                                          "over_1e-4")}))
    for r in res["runs"]:
        if r["first_differing_op"] is not None:
            print(json.dumps(r))


if __name__ == "__main__":
    main()
