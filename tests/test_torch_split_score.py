"""The port's split scoring against the JAX reference, exactly.

Inputs are made with numpy from a seed and fed to both sides: the port's
plain PyTorch ``score_2way``/``score_3way`` and its kernel wrappers (which
run the plain version for CPU tensors) against the reference's numpy
``score_*_kernel`` and its Pallas kernels in interpret mode.  Tolerance: exact
(``==``, NaN equal to NaN) on every live lane — bit-identity is the
reference's own contract.  The kernels themselves run only on a CUDA card;
their tests are in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

from repro.core.heuristics import _PERMS3, score_2way_kernel, score_3way_kernel
from repro.kernels import split_score as ref_split
from repro_torch.core.heuristics import score_2way, score_3way, score_kernels
from repro_torch.kernels import split_score


def _split_inputs(rng, A, K):
    pre = np.sort(rng.uniform(0.0, 100.0, (A, K + 2)), axis=1)
    pre_d1, pre_C, pre_e = pre[:, :1], pre[:, 1:-1], pre[:, -1:]
    delta = rng.uniform(0.0, 50.0, (A, K + 2))
    del_d1, del_C, del_e = delta[:, :1], delta[:, 1:-1], delta[:, -1:]
    inv_j = rng.uniform(0.05, 2.0, (A, 1))
    inv_p = rng.uniform(0.05, 2.0, (A, 1))
    return pre_d1, pre_C, pre_e, del_d1, del_C, del_e, inv_j, inv_p


def _three_inputs(rng, A, span):
    o1, o2 = np.triu_indices(span - 1, k=1)
    K = o1.size
    dI = rng.uniform(0.0, 10.0, (A, 1, 3, K))
    W = rng.uniform(0.1, 100.0, (A, 1, 3, K))
    dO = rng.uniform(0.0, 10.0, (A, 1, 3, K))
    inv = rng.uniform(0.05, 2.0, (A, 3))
    invp = inv[:, np.asarray(_PERMS3)][:, :, :, None]
    base = rng.uniform(1.0, 50.0, (A, 1, 1))
    spans = rng.integers(3, span + 1, A)
    return (dI, W, dO, invp, base), spans, o2


def _t(x, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


@pytest.mark.parametrize("A,K", [(5, 37), (8, 128), (17, 300), (1, 1)])
def test_score_2way_matches_reference_on_live_lanes(A, K):
    rng = np.random.default_rng(11)
    ins = _split_inputs(rng, A, K)
    b = 10.0
    need = rng.integers(1, K + 1, A)
    want = score_2way_kernel(*ins[:6], b, *ins[6:], xp=np)
    pallas = ref_split.score_2way_pallas(*ins[:6], b, *ins[6:], need=need)
    plain = score_2way(*map(_t, ins[:6]), b, *map(_t, ins[6:]))
    wrapped = split_score.score_2way_cuda(*map(_t, ins[:6]), b, *map(_t, ins[6:]),
                                          need=_t(need))
    lanes = np.arange(K)[None, :] < need[:, None]
    live = np.concatenate([lanes, lanes], axis=1)
    for w, p, pl, wr in zip(want, pallas, plain, wrapped):
        pl, wr, p = pl.numpy(), wr.numpy(), np.asarray(p)
        assert pl.shape == wr.shape == w.shape
        assert _same(pl, w)                      # every lane, like numpy
        assert _same(pl[live], p[live])          # the Pallas kernel's live lanes
        assert _same(wr[live], w[live])
        assert not wr[~live].any()               # lanes past need are zero


@pytest.mark.parametrize("A,span", [(4, 5), (9, 12), (16, 20)])
def test_score_3way_matches_reference_on_live_lanes(A, span):
    rng = np.random.default_rng(13)
    ins, spans, o2 = _three_inputs(rng, A, span)
    need = ref_split.pair_need(spans, span)
    assert _same(split_score.pair_need(torch.from_numpy(spans), span).numpy(), need)
    want = score_3way_kernel(*ins, xp=np)
    pallas = ref_split.score_3way_pallas(*ins, need=need)
    plain = score_3way(*map(_t, ins))
    wrapped = split_score.score_3way_cuda(*map(_t, ins), need=_t(need))
    live_l = o2[None, :] <= (spans - 2)[:, None]
    below = np.arange(o2.size)[None, :] < need[:, None]
    for w, p, pl, wr in zip(want, pallas, plain, wrapped):
        pl, wr, p = pl.numpy(), wr.numpy(), np.asarray(p)
        assert pl.shape == wr.shape == w.shape
        shape = (A,) + (1,) * (w.ndim - 2) + (o2.size,)
        live = np.broadcast_to(live_l.reshape(shape), w.shape)
        dead = ~np.broadcast_to(below.reshape(shape), w.shape)
        assert _same(pl, w)
        assert _same(pl[live], p[live])
        assert _same(wr[live], w[live])
        assert not wr[dead].any()


@pytest.mark.parametrize("span", [3, 4, 7, 40, 160])
def test_pair_need_matches_reference(span):
    spans = np.arange(0, span + 1)
    assert _same(split_score.pair_need(spans, span).numpy(),
                 ref_split.pair_need(spans, span))


def test_score_kernels_selects_plain_or_wrappers():
    assert score_kernels("torch") == (score_2way, score_3way)
    assert score_kernels("cuda") == (split_score.score_2way_cuda,
                                     split_score.score_3way_cuda)
    with pytest.raises(ValueError):
        score_kernels("pallas")


def test_cpu_tensors_do_not_count_as_launches():
    rng = np.random.default_rng(5)
    ins = _split_inputs(rng, 3, 9)
    before = split_score.score_2way_cuda.launches
    split_score.score_2way_cuda(*map(_t, ins[:6]), 10.0, *map(_t, ins[6:]))
    assert split_score.score_2way_cuda.launches == before
