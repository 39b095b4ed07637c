"""Batched serving example: continuous-batching decode over a request pool
(the port of the reference's ``examples/serve_batched.py``), the model's
hand-written kernels on the card (``--device``, the card by default; on
the CPU their plain versions).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]

The pool's sizes are the reference's (12 requests of 16 prompt tokens, 24
new tokens each, 4 at a time); the options cut them for a quick run.
"""

import argparse
import json

from repro_torch.launch.serve import serve_pool


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)

    out = serve_pool(arch="qwen3-4b", smoke=True, n_requests=args.requests, batch=args.batch,
                     prompt_len=args.prompt_len, max_new=args.max_new, device=args.device)
    print(json.dumps(out, indent=2))
    assert out["all_done"]
    return out


if __name__ == "__main__":
    main()
