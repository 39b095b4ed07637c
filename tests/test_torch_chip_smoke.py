"""chip_smoke.py's diagnosis of a cpu-vs-card forward that parts, run here
with both sides on the CPU: a fault planted in one weight of the second
copy is named, and so is the first layer whose residual stream it moves."""

from __future__ import annotations

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("fault", [None, ("mlp", "wo", 1)])
def test_diagnose_forward_names_the_faulty_weight_and_layer(fault):
    cfg = get_smoke_config("qwen3-4b").replace(dtype="float32", use_pallas=True)
    api = get_model(cfg)
    params = api.init(7, "cpu")
    other = _copy(params)
    if fault is not None:
        part, name, layer = fault
        other["layers"][part][name][layer, 3, 5] += 1e-3
    toks = torch.randint(1, cfg.vocab_size, (1, 1536), generator=torch.Generator().manual_seed(8))
    got, _ = api.forward(other, {"tokens": toks}, cfg)
    want, _ = api.forward(params, {"tokens": toks}, cfg)
    diag = chip_smoke.diagnose_forward(torch, api, cfg, params, other, toks, got, want)
    assert diag["card_repeats_bitwise"]
    # 2 RMSNorms per layer and the final one; one flash call per layer (S > 1024)
    names = [n for n, _ in diag["kernel_vs_plain_max_err"]]
    assert names.count("rmsnorm") == 2 * cfg.n_layers + 1
    assert names.count("flash_attention") == cfg.n_layers
    assert all(e == 0.0 for _, e in diag["kernel_vs_plain_max_err"])
    assert len(diag["layer_max_err"]) == cfg.n_layers
    if fault is None:
        assert diag["params_differing"] == [] and diag["rows_over"] == 0
        assert all(e == 0.0 for e in diag["layer_max_err"])
    else:
        assert diag["params_differing"] == [f"/layers/{part}/{name}"]
        assert diag["rows_over"] > 0
        assert diag["layer_max_err"][:layer] == [0.0] * layer
        assert diag["layer_max_err"][layer] > chip_smoke.LOGIT_F32_TOL
