"""The port's Section-5 harness against the JAX package's, on the CPU: the
scalar engine, the paper's Table 1 (``failure_thresholds``) and the
replication sweeps with their ``*_ci.csv`` files.

Both packages draw the same instances from the same seeds; the port runs
with ``device="cpu"``.  Tolerance: none — result dicts ``==`` and CSV text
byte for byte.
"""

import pathlib

import numpy as np
import pytest

from benchmarks import paper_sim as ref_paper_sim
from repro.sim import experiments as ref
from repro_torch.sim import experiments as port
from repro_torch.sim import paper_sim

CPU = "cpu"
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "paper_sim"


@pytest.mark.parametrize("exp", ["E2", "I1", "I3"])
def test_scalar_engine_equals_batched_engine_and_the_reference(exp):
    """tests/test_engine_equivalence.py's harness case: (8, 10), 4 pairs."""
    kw = dict(n_pairs=4, n_bounds=4)
    scalar = port.run_experiment(exp, 8, 10, engine="scalar", device=CPU, **kw)
    batched = port.run_experiment(exp, 8, 10, engine="batched", device=CPU, **kw)
    want = ref.run_experiment(exp, 8, 10, engine="scalar", **kw)
    text = port.summarize_experiment(scalar)
    assert text == port.summarize_experiment(batched) == ref.summarize_experiment(want)
    assert scalar.thresholds == want.thresholds
    for code in want.curves:
        for a, b in zip(scalar.curves[code], want.curves[code]):
            assert np.array_equal(a, b, equal_nan=True), (exp, code)


@pytest.mark.parametrize("include_h4,h4_iters", [(True, 3), (False, 10)])
def test_scalar_engine_options_equal_the_reference(include_h4, h4_iters):
    kw = dict(n_pairs=3, n_bounds=5, seed0=77, include_h4=include_h4, h4_iters=h4_iters)
    got = port.run_experiment("R2", 9, 10, engine="scalar", device=CPU, **kw)
    want = ref.run_experiment("R2", 9, 10, engine="scalar", **kw)
    assert port.summarize_experiment(got) == ref.summarize_experiment(want)
    assert sorted(got.curves) == sorted(want.curves)


def test_scalar_engine_writes_the_golden_csv():
    got = port.run_experiment("E1", 5, 10, n_pairs=3, n_bounds=4, engine="scalar",
                              device=CPU)
    assert (port.summarize_experiment(got)
            == (GOLDEN / "curves_E1_n5_p10.csv").read_text())


@pytest.mark.parametrize("engine", ["batched", "scalar"])
def test_failure_thresholds_equal_the_reference(engine):
    kw = dict(ns=(5, 9), p=10, n_pairs=3, seed0=11)
    got = port.failure_thresholds(("E1", "E4", "I2"), engine=engine, device=CPU, **kw)
    assert got == ref.failure_thresholds(("E1", "E4", "I2"), engine=engine, **kw)
    assert got == port.failure_thresholds(("E1", "E4", "I2"), engine="batched",
                                          device=CPU, **kw)


@pytest.mark.parametrize("engine", ["batched", "scalar"])
def test_run_replicated_equals_the_reference(engine):
    kw = dict(n_pairs=3, replications=3, n_bounds=4, seed0=5, h4_iters=4)
    got, first = port.run_replicated(["E2", "I4"], 7, 10, engine=engine, device=CPU, **kw)
    want, wfirst = ref.run_replicated(["E2", "I4"], 7, 10, engine=engine, **kw)
    for exp in ("E2", "I4"):
        g, w = got[exp], want[exp]
        assert port.summarize_replicated(g) == ref.summarize_replicated(w)
        assert (g.n, g.p, g.n_pairs, g.replications) == (w.n, w.p, w.n_pairs, w.replications)
        assert g.thresholds == w.thresholds
        for code in w.curves:
            for a, b in zip(g.curves[code], w.curves[code]):
                assert np.array_equal(a, b, equal_nan=True), (exp, code)
        assert port.summarize_experiment(first[exp]) == ref.summarize_experiment(wfirst[exp])


@pytest.mark.parametrize("engine", ["batched", "scalar"])
def test_replicated_csvs_equal_the_reference_and_bank_0_the_single_run(engine, tmp_path):
    grid = dict(ns=(5,), ps=(10,), n_pairs=3, n_bounds=4)
    ref_paper_sim.run(out_dir=tmp_path / "ref", engine=engine, replications=2, **grid)
    res = paper_sim.run(tmp_path / "rep", engine=engine, replications=2, device=CPU, **grid)
    paper_sim.run(tmp_path / "one", engine=engine, device=CPU, **grid)
    assert res["replications"] == 2 and res["engine"] == engine
    names = sorted(f.name for f in (tmp_path / "ref").iterdir())
    assert "table1_thresholds_ci.csv" in names
    assert sum(n.endswith("_ci.csv") for n in names) == 5
    assert sorted(f.name for f in (tmp_path / "rep").iterdir()) == names
    for name in names:
        assert ((tmp_path / "rep" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes()), name
    single = sorted(f.name for f in (tmp_path / "one").iterdir())
    assert single == [n for n in names if not n.endswith("_ci.csv")]
    for name in single:  # bank 0 is the non-replicated run
        assert ((tmp_path / "one" / name).read_bytes()
                == (tmp_path / "rep" / name).read_bytes()), name


def test_large_grid_points_equal_the_reference(tmp_path):
    """--large-grid adds n in {80, 160} at p = 1000 (one pair here)."""
    grid = dict(families=("E3",), ns=(5,), ps=(10,), n_pairs=2, n_bounds=3,
                large_grid=True, large_pairs=1)
    ref_paper_sim.run(out_dir=tmp_path / "ref", **grid)
    res = paper_sim.run(tmp_path / "port", device=CPU, **grid)
    assert res["points"] == 3
    names = sorted(f.name for f in (tmp_path / "ref").iterdir())
    assert "curves_E3_n160_p1000.csv" in names
    assert sorted(f.name for f in (tmp_path / "port").iterdir()) == names
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes()), name


@pytest.mark.parametrize("engine", ["fused", "sharded", "auto", "nope"])
def test_engines_not_ported_raise(engine, tmp_path):
    """The fused, sharded and auto engines (once refused, hence the name)
    give the batched engine's output from ``run_experiment``,
    ``failure_thresholds``, ``run_replicated`` and ``paper_sim.run`` (the
    golden CSVs byte for byte); an unknown engine raises."""
    if engine == "nope":
        for call in (lambda: port.run_experiment("E1", 5, 10, engine=engine, device=CPU),
                     lambda: port.failure_thresholds(engine=engine, device=CPU),
                     lambda: port.run_replicated(["E1"], 5, 10, engine=engine, device=CPU),
                     lambda: port.run_campaign(["E1"], 5, 10, engine=engine, device=CPU)):
            with pytest.raises(ValueError, match="unknown engine"):
                call()
        with pytest.raises(ValueError, match="unknown engine"):
            paper_sim.run(pathlib.Path("unused"), engine=engine, device=CPU)
        return
    kw = dict(n_pairs=3, n_bounds=4, seed0=9, h4_iters=4)

    def both(fn, **more):
        return (fn(engine=engine, device=CPU, **more), fn(engine="batched", device=CPU, **more))

    got, want = both(lambda **a: port.run_experiment("I3", 8, 10, **kw, **a))
    assert port.summarize_experiment(got) == port.summarize_experiment(want)
    assert got.thresholds == want.thresholds
    got, want = both(lambda **a: port.failure_thresholds(("E2", "R1"), ns=(5, 9), p=10,
                                                         n_pairs=3, seed0=11, **a))
    assert got == want
    (got, gfirst), (want, wfirst) = both(lambda **a: port.run_replicated(
        ["E4"], 7, 10, replications=2, **kw, **a))
    assert port.summarize_replicated(got["E4"]) == port.summarize_replicated(want["E4"])
    assert port.summarize_experiment(gfirst["E4"]) == port.summarize_experiment(wfirst["E4"])
    res = paper_sim.run(tmp_path, families="all", ns=(5,), ps=(10,), n_pairs=3, n_bounds=4,
                        engine=engine, device=CPU)
    assert res["engine"] == engine
    names = sorted(f.name for f in GOLDEN.iterdir())
    assert sorted(f.name for f in tmp_path.iterdir()) == names
    for name in names:
        assert (tmp_path / name).read_bytes() == (GOLDEN / name).read_bytes(), name


@pytest.mark.parametrize("n,p,want", [(5, 10, "fused"), (40, 50, "fused"),
                                      (41, 50, "batched"), (160, 1000, "batched")])
def test_auto_engine_keeps_the_references_rule_on_the_cpu(n, p, want):
    assert port.auto_engine(n, p, device=CPU) == want == ref.auto_engine(n, p)
