"""chip_smoke.py's phase 19 (the MoE, VLM, enc-dec and xLSTM families) run
here with every side on the CPU at the smoke configs: its helpers pass, and
they refuse planted faults (a top-k that breaks ties the other way, a
capacity-buffer fill that overwrites where it must add, a routing that
moves between two runs of the same inputs without a near-tie, a launch
count off by one)."""

from __future__ import annotations

import inspect
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import decode_attention, flash_attention, mamba2_ssd, rmsnorm  # noqa: E402
from repro_torch.models import get_model, moe  # noqa: E402

COUNTERS = [rmsnorm.rmsnorm, rmsnorm.rmsnorm_residual, flash_attention.flash_attention,
            decode_attention.decode_attention, mamba2_ssd.ssd_intra_chunk]


def _runs(seq=64):
    return tuple(dict(r, seq=24 if r["arch"] == "whisper-large-v3" else seq)
                 for r in chip_smoke.FAMILY_RUNS)


def test_families_phase_passes_on_cpu():
    """Every model of the phase at its smoke config (S = 64; whisper 24
    decoder tokens), then the smoke configs cpu against cpu at S = 128."""
    out = chip_smoke.families_phase(torch, COUNTERS, "cpu", device="cpu", runs=_runs(),
                                    smoke=True, smoke_seq=128)
    assert sorted(out["models"]) == sorted(r["arch"] for r in chip_smoke.FAMILY_RUNS)
    for arch, res in out["models"].items():
        assert res["vs_plain"]["ok"], arch
        assert ("moe" in res) == arch.startswith(("mixtral", "arctic")), arch
        assert ("decode_vs_plain" in res) == (
            arch in ("mixtral-8x7b", "internvl2-26b", "whisper-large-v3")), arch
        assert ("serve" in res) == (arch != "arctic-480b"), arch
    moe_res = out["models"]["mixtral-8x7b"]["moe"]
    assert moe_res["layers"] == 2 and moe_res["across_routes"]["flipped_tokens"] == 0
    # cpu against the cpu in a child with MKL_CBWR=COMPATIBLE: the same but
    # for MKL's code path, within the float32 limits
    for arch, res in out["smoke_cpu_vs_card"].items():
        assert res["forward"]["ok"] and res["decode"]["ok"] and res["train"]["ok"], arch
        assert res["forward_in_process"]["vs_card"] == 0.0, arch
    assert "mixtral-8x7b prefill" in out["by_path"] and "xlstm-350m serve" in out["by_path"]


def test_family_launches_at_full_width():
    """The exact counts phase 19 holds the card to: RMSNorm 2L + 1 and flash
    L per transformer forward (mixtral cut to 8 layers 17 / 8, arctic cut to
    2 5 / 2, internvl2 97 / 48), none for whisper (its 1,500 frames and 448
    tokens miss the flash gate) and xlstm; prefill RMSNorm only; decode
    attention per layer per call (whisper 32, xlstm 0); an off-by-one count
    refused."""
    want = {"mixtral-8x7b": (8, 8192, 17, 8), "arctic-480b": (2, 4096, 5, 2),
            "internvl2-26b": (48, 4096, 97, 48), "whisper-large-v3": (32, 448, 0, 0),
            "xlstm-350m": (24, 4096, 0, 0)}
    for run in chip_smoke.FAMILY_RUNS:
        cfg = chip_smoke.family_cfg(run)
        L, seq, rms, flash = want[run["arch"]]
        assert (cfg.n_layers, run["seq"]) == (L, seq)
        assert cfg.n_layers == (run["layers"] or get_config(run["arch"]).n_layers)
        got = chip_smoke.family_launches(cfg, "forward", seq)
        assert (got["rmsnorm"], got["flash_attention"]) == (rms, flash), run["arch"]
        assert got["decode_attention"] == got["ssd_intra_chunk"] == 0
        assert chip_smoke.family_launches(cfg, "prefill")["rmsnorm"] == rms
        dec = chip_smoke.family_launches(cfg, "decode", calls=3)
        assert dec["decode_attention"] == (0 if run["arch"] == "xlstm-350m" else 3 * L)
        assert dec["rmsnorm"] == 0
        chip_smoke.check_launches("planted", got, dict(got))
        with pytest.raises(SystemExit):
            chip_smoke.check_launches("planted", got, dict(got, rmsnorm=got["rmsnorm"] + 1))
    assert chip_smoke.decode_calls(**chip_smoke.FAMILY_SERVE) == 4 * 15 + 16


def _mutated(fn, old: str, new: str):
    """``fn`` of the port's ``moe`` module with one fault planted in its
    source (a copy: the module's own function is left as it is)."""
    src = inspect.getsource(fn)
    assert old in src
    real = getattr(moe, fn.__name__)
    exec(src.replace(old, new), vars(moe))       # its globals: the module's own
    planted = getattr(moe, fn.__name__)
    setattr(moe, fn.__name__, real)
    return planted


def _moe_layer(capacity_factor=1.25, seed=0):
    cfg = get_smoke_config("mixtral-8x7b").replace(dtype="float32",
                                                   capacity_factor=capacity_factor)
    params = get_model(cfg).init(seed, "cpu")
    layer = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(seed))
    x[:, ::4] = 0.0                      # all-zero tokens: every router logit ties
    return cfg, layer, x


def test_moe_checks_pass_and_refuse_a_wrong_tie_order(monkeypatch):
    cfg, layer, x = _moe_layer()
    with chip_smoke.moe_checks(torch, moe) as recs:
        moe.moe_ffn(layer, x, cfg)
    assert len(recs) == 1 and recs[0]["out_max_err"] <= 1e-5
    assert (recs[0]["top_ids"][::4] == torch.tensor([0, 1])).all()
    topk = lambda x, k: tuple(torch.topk(x, k))     # noqa: E731  no promise on ties
    if torch.equal(topk(torch.zeros(1, cfg.n_experts), 2)[1], torch.tensor([[0, 1]])):
        pytest.skip("this torch's topk happens to break these ties by the lower index")
    monkeypatch.setattr(moe, "top_k", topk)
    with pytest.raises(SystemExit):
        with chip_smoke.moe_checks(torch, moe):
            moe.moe_ffn(layer, x, cfg)


def test_moe_checks_refuse_an_overwriting_buffer_fill(monkeypatch):
    """With drops (capacity factor 0.5), a dropped pair's zeros land on slot
    C - 1 beside a kept pair: ``index_copy_`` in place of ``index_add_``
    loses that pair, and the plain MoE tells."""
    cfg, layer, x = _moe_layer(capacity_factor=0.5, seed=1)
    with chip_smoke.moe_checks(torch, moe) as recs:
        moe.moe_ffn(layer, x, cfg)
    assert recs[0]["dropped_pairs"] > 0
    monkeypatch.setattr(moe, "_grouped_dispatch", _mutated(
        moe._grouped_dispatch, "buf.index_add_(", "buf.index_copy_("))
    with pytest.raises(SystemExit):
        with chip_smoke.moe_checks(torch, moe):
            moe.moe_ffn(layer, x, cfg)


def test_routing_oracle_and_across_routes():
    """The oracle breaks ties by the lower expert and keeps a pair while its
    expert's running count is under the capacity; between two runs of the
    same inputs (the routes) a moved choice passes only at a near-tie."""
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0], [0.0] * 5, [5.0, 4.0, 3.0, 2.0, 1.0]])
    ids, keep = chip_smoke.routing_oracle(torch, logits, 2, 1)
    assert ids.tolist() == [[1, 2], [0, 1], [0, 1]]
    assert keep.tolist() == [[True, True], [True, False], [False, False]]
    own, logits = torch.tensor([[0, 1]]), torch.tensor([[2.0, 1.0, 0.95]])
    # the other run's third logit overtook the second by less than twice its move
    other, recorded = torch.tensor([[0, 2]]), torch.tensor([[2.0, 0.96, 0.99]])
    flips, worst = chip_smoke.routing_flips(own, other, logits, recorded, 2)
    assert flips == 1 and 0 < worst <= 1
    assert chip_smoke.routing_flips(own, own, logits, recorded, 2) == (0, 0.0)
    # the same logits in both runs, another choice: a fault, not rounding
    with pytest.raises(SystemExit):
        chip_smoke.routing_flips(own, other, logits, logits, 2)


def test_forced_routing_replays_another_runs_choices():
    """A run under ``forced_routing`` takes the recorded top-k ids (here a
    planted routing: every token to experts 2 and 3, recorded from logits
    that favour them) with its own logits' softmax at them; the same planted
    routing recorded from this run's own logits is refused (a moved choice
    that is no near-tie), and so is a record left unused."""
    cfg, layer, x = _moe_layer()
    with chip_smoke.moe_checks(torch, moe) as recs:
        free, _ = moe.moe_ffn(layer, x, cfg)
    favour = torch.zeros(cfg.n_experts)
    favour[2:4] = torch.tensor([200.0, 100.0])
    planted = [dict(recs[0], top_ids=torch.tensor([2, 3]).expand_as(recs[0]["top_ids"]),
                    logits=recs[0]["logits"] + favour)]
    seen = []
    real = moe.route

    def route(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    moe.route = route
    try:
        with chip_smoke.forced_routing(moe, planted) as flips:
            forced, _ = moe.moe_ffn(layer, x, cfg)
    finally:
        moe.route = real
    assert (seen[0].top_ids == torch.tensor([2, 3])).all()
    assert not torch.equal(forced, free) and flips["flipped_tokens"] > 0
    with pytest.raises(SystemExit):
        with chip_smoke.forced_routing(moe, [dict(planted[0], logits=recs[0]["logits"])]):
            moe.moe_ffn(layer, x, cfg)
    with chip_smoke.forced_routing(moe, recs) as flips:
        again, _ = moe.moe_ffn(layer, x, cfg)
    assert torch.equal(again, free) and flips["flipped_tokens"] == 0
    with pytest.raises(SystemExit):
        with chip_smoke.forced_routing(moe, recs + recs):
            moe.moe_ffn(layer, x, cfg)
