"""End-to-end training example (the port of the reference's
``examples/train_pipeline.py``): a smoke-size qwen3-family model trained
for a few hundred steps on the synthetic stream, with checkpointing
enabled, on ``--device`` (the card by default).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_pipeline [--steps 300] [--device cpu]

The batch is the reference's (8 rows of 128 tokens); ``--batch`` and
``--seq`` cut it for a quick run.
"""

import argparse
import json
import tempfile

from repro_torch.launch.train import train_loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as ckpt:
        out = train_loop(arch=args.arch, smoke=True, steps=args.steps,
                         batch=args.batch, seq=args.seq, ckpt_dir=ckpt, ckpt_every=100,
                         log_every=20, device=args.device)
    print(json.dumps({k: v for k, v in out.items() if k not in ("losses", "step_s")}, indent=2))
    assert out["final_loss"] < out["first_loss"], "model must learn"
    return out


if __name__ == "__main__":
    main()
