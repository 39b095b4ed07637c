"""The port's Section-5 campaign against the JAX reference, end to end.

``repro_torch.sim.paper_sim.run`` on ``device="cpu"`` must write the golden
files of ``tests/golden/paper_sim/`` byte for byte (the reference's own
regression grid: every family, n=5, p=10, 3 pairs, 4 bounds), and
``run_campaign`` (batched, fused and sharded engines) must equal
``repro.sim.experiments.run_campaign`` exactly on a mixed-family point.
"""

import pathlib

import numpy as np
import pytest

from repro.sim import experiments as ref
from repro_torch.sim import experiments as port
from repro_torch.sim import paper_sim

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "paper_sim"


def test_paper_sim_csvs_match_golden(tmp_path):
    res = paper_sim.run(tmp_path, families="all", ns=(5,), ps=(10,), n_pairs=3,
                        n_bounds=4, device="cpu")
    assert all(c.startswith("[PASS]") for c in res["claims"]), res["claims"]
    golden_files = sorted(f.name for f in GOLDEN.iterdir())
    assert golden_files, "golden set missing"
    assert sorted(f.name for f in tmp_path.iterdir()) == golden_files
    for name in golden_files:
        assert (tmp_path / name).read_bytes() == (GOLDEN / name).read_bytes(), name


@pytest.mark.parametrize("n,p", [(9, 10), (14, 100)])
def test_run_campaign_matches_reference(n, p):
    exps = ["E1", "E3", "I2", "R4"]
    kw = dict(n_pairs=4, n_bounds=5, seed0=77, h4_iters=6)
    want = ref.run_campaign(exps, n, p, **kw)
    got = port.run_campaign(exps, n, p, device="cpu", **kw)
    assert list(got) == exps
    for exp in exps:
        g, w = got[exp], want[exp]
        assert port.summarize_experiment(g) == ref.summarize_experiment(w)
        assert np.array_equal(g.bounds_rel, w.bounds_rel)
        assert g.thresholds == w.thresholds
        assert sorted(g.curves) == sorted(w.curves)
        for code in w.curves:
            for a, b in zip(g.curves[code], w.curves[code]):
                assert np.array_equal(a, b, equal_nan=True), (exp, code)


@pytest.mark.parametrize("engine", ["fused", "sharded"])
@pytest.mark.parametrize("n,p", [(9, 10), (14, 100)])
def test_run_campaign_engines_match_reference(n, p, engine):
    """The fused and sharded engines give the reference's campaign too."""
    exps = ["E1", "E3", "I2", "R4"]
    kw = dict(n_pairs=4, n_bounds=5, seed0=77, h4_iters=6)
    want = ref.run_campaign(exps, n, p, **kw)
    got = port.run_campaign(exps, n, p, engine=engine, device="cpu", **kw)
    for exp in exps:
        assert port.summarize_experiment(got[exp]) == ref.summarize_experiment(want[exp])
        assert got[exp].thresholds == want[exp].thresholds
        for code in want[exp].curves:
            for a, b in zip(got[exp].curves[code], want[exp].curves[code]):
                assert np.array_equal(a, b, equal_nan=True), (exp, code)


def test_run_experiment_is_one_family_campaign():
    got = port.run_experiment("E2", 8, 10, n_pairs=3, n_bounds=4, device="cpu")
    want = ref.run_experiment("E2", 8, 10, n_pairs=3, n_bounds=4)
    assert port.summarize_experiment(got) == ref.summarize_experiment(want)
