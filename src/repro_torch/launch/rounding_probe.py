"""How far rounding order alone moves a model's logits.

    PYTHONPATH=src python -m repro_torch.launch.rounding_probe --device cpu \\
        [--arch zamba2-7b] [--layers 6] [--dtype bfloat16] [--seq 1536] [--seed 7]

One forward of the model on ``--device`` (default cuda; the smoke config,
or with ``--layers`` the full-width config cut to that depth; parameters and
tokens from ``--seed``; ``use_pallas`` set, so the kernels on the card and
their plain versions on the CPU), run again with only what a correct
implementation does not fix changed:

  - ``threads`` (CPU only): the thread count, 8 against 3 (the GEMMs'
    float32 sums in another order);
  - ``ssd_route`` (hybrid family only): the model's plain ``ssd_chunked`` in
    place of the kernel route ``kernels.ops.ssd_chunked`` (the same
    function, another summation order);
  - ``cpu`` (on the card only): the same forward on the CPU, with the
    kernels' plain versions (every sum in another order).

Prints, as JSON, the max and mean relative logit difference of each against
the first forward: the floor under any comparison of the same model between
two devices, which a tolerance must clear.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import torch

from .. import resolve_device
from ..configs import get_config, get_smoke_config
from ..kernels import ops
from ..models import get_model, ssm


def _diff(got: torch.Tensor, want: torch.Tensor) -> dict:
    err = (got.float() - want.float()).abs()
    return {"max": float(err.max()), "mean_rel": float(err.mean() / want.float().abs().mean())}


def probe(arch: str, layers: int = 0, dtype: str = "bfloat16", seq: int = 1536,
          seed: int = 7, device=None) -> dict:
    dev = resolve_device(device)
    cfg = get_config(arch).replace(n_layers=layers) if layers else get_smoke_config(arch)
    cfg = cfg.replace(dtype=dtype, use_pallas=True)
    api = get_model(cfg)
    params = api.init(seed, dev)
    toks = torch.randint(1, cfg.vocab_size, (1, seq),
                         generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    threads = torch.get_num_threads()

    def forward(n_threads: int) -> torch.Tensor:
        torch.set_num_threads(n_threads)
        try:
            return api.forward(params, {"tokens": toks}, cfg)[0]
        finally:
            torch.set_num_threads(threads)

    base = forward(8)
    out = {"arch": cfg.arch_id, "layers": cfg.n_layers, "dtype": dtype, "seq": seq,
           "seed": seed, "device": str(dev), "max_abs_logit": float(base.float().abs().max())}
    if dev.type == "cpu":
        out["threads"] = _diff(forward(3), base)
    if cfg.family in ("ssm", "hybrid"):
        kernel_route = ops.ssd_chunked
        ops.ssd_chunked = lambda x, dt, A, B, C, chunk=256: ssm.ssd_chunked(x, dt, A, B, C, chunk)
        try:
            out["ssd_route"] = _diff(forward(8), base)
        finally:
            ops.ssd_chunked = kernel_route
    if dev.type == "cuda":
        on_cpu = {"tokens": toks.cpu()}
        params = _to_cpu(params)
        out["cpu"] = _diff(api.forward(params, on_cpu, cfg)[0], base.cpu())
    return out


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--layers", type=int, default=0,
                    help="full width cut to this depth (0: the smoke config)")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--seq", type=int, default=1536)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    res = probe(args.arch, args.layers, args.dtype, args.seq, args.seed, args.device)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
