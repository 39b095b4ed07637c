"""Scenario-family subsystem: random application/platform generators.

The port's own copy of ``repro.sim.generators``: the numpy random streams
below are the seed contract (the golden CSVs under ``tests/golden/paper_sim``
assert them byte for byte), so they are kept verbatim and run on the host.

Common to all families: b = 10, processor speeds uniform integers in [1, 20].
A family is an :class:`ExperimentSpec` carrying two pluggable *samplers* —
``comp(rng, n) -> (n,)`` stage works and ``comm(rng, n, w) -> (n+1,)``
inter-stage data volumes (the comm sampler sees the drawn works so families
can correlate communication with computation).  Sampler combinators below
(:func:`uniform_comp`, :func:`bimodal_comp`, :func:`correlated_comm`,
:func:`jpeg_profile_comp` / :func:`jpeg_profile_comm`, ...) cover every
registered family; new families plug in via :func:`register_experiment` and
automatically flow through the lockstep engine and the campaign harness.

The source paper's families (Section 5.1):

  E1  balanced comm/comp, homogeneous comms:     delta_i = 10,        w in [1, 20]
  E2  balanced comm/comp, heterogeneous comms:   delta in [1, 100],   w in [1, 20]
  E3  large computations:                        delta in [1, 20],    w in [10, 1000]
  E4  small computations:                        delta in [1, 20],    w in [0.01, 10]

(The paper draws integer w for E1-E3; E4's range [0.01, 10] is continuous.)

The follow-up study's families ("Bi-criteria Pipeline Mappings for Parallel
Image Processing", Benoit, Kosch, Rehn-Sonigo & Robert, 2008) model realistic
per-stage comm/comp structure; we register them as I1-I4:

  I1  JPEG encoder stage profile: the 7-stage encoder pipeline (scale,
      RGB->YCbCr, 4:2:0 subsample, block split, DCT, quantize, entropy encode)
      tiled to n stages with multiplicative jitter — data volumes shrink at
      subsampling and at entropy coding, DCT dominates compute;
  I2  bimodal computations: light preprocessing stages mixed with heavy
      transform/encode stages (mixture of uniform ranges);
  I3  correlated comm ∝ comp: inter-stage volumes proportional to the
      adjacent stages' work (heavy stages exchange heavy data);
  I4  uniform wide-range: continuous uniform comm and comp over [0.5, 50].

The reliability sequel (arXiv 0711.1231) adds per-processor failure
probabilities; its scenario families are registered as R1-R4 (family
"reliability"), each an E-style comm/comp pair plus a pluggable *failure
sampler* ``fail(rng, p, s) -> (p,)`` which sees the drawn speeds so failure
can correlate with hardware quality:

  R1  balanced comm/comp, uniform failures:      f in [1e-3, 2e-2] i.i.d.
  R2  balanced comm/comp, bimodal failures:      reliable majority + a flaky
      20% minority an order of magnitude worse;
  R3  speed-correlated failures: slower processors (older hardware) fail
      more — f interpolates [1e-3, 3e-2] from fastest to slowest, with
      multiplicative jitter;
  R4  large computations + bimodal failures: E3's compute-heavy stages on a
      mixed-quality fleet (long intervals concentrate work on few
      processors, making replication decisions non-trivial).

Failure draws happen AFTER comp/comm/speeds so the E/I streams are untouched
(the draw order is the seed contract asserted by the golden CSVs).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from ..core import Platform, Workload


# ---------------------------------------------------------------------------
# Sampler combinators.
#
# comp samplers:  fn(rng, n)    -> (n,)   per-stage work
# comm samplers:  fn(rng, n, w) -> (n+1,) inter-stage data volumes (see the
#                 drawn works, so communication can correlate with computation)
# ---------------------------------------------------------------------------

def uniform_comp(lo: float, hi: float, integer: bool = True) -> Callable:
    """Per-stage i.i.d. uniform work; integer draws match the paper's
    'randomly chosen between lo and hi' wording for E1-E3."""
    if integer:
        return lambda rng, n: rng.integers(int(lo), int(hi) + 1, n).astype(float)
    return lambda rng, n: rng.uniform(lo, hi, n)


def uniform_comm(lo: float, hi: float, integer: bool = True) -> Callable:
    """I.i.d. uniform inter-stage data volumes (independent of the works)."""
    if integer:
        return lambda rng, n, w: rng.integers(int(lo), int(hi) + 1,
                                              n + 1).astype(float)
    return lambda rng, n, w: rng.uniform(lo, hi, n + 1)


def constant_comm(value: float) -> Callable:
    """Homogeneous data volumes (E1's delta_i = 10)."""
    return lambda rng, n, w: np.full(n + 1, float(value))


def bimodal_comp(light=(1.0, 4.0), heavy=(50.0, 100.0),
                 heavy_frac: float = 0.3) -> Callable:
    """Mixture of light and heavy stages: each stage is heavy with
    probability ``heavy_frac`` (uniform within its range) — the image
    pipelines' cheap pixel passes vs dominant transform/encode stages."""
    def fn(rng, n):
        is_heavy = rng.random(n) < heavy_frac
        light_w = rng.uniform(light[0], light[1], n)
        heavy_w = rng.uniform(heavy[0], heavy[1], n)
        return np.where(is_heavy, heavy_w, light_w)
    return fn


def correlated_comm(rho: float = 1.0, noise: float = 0.5) -> Callable:
    """Inter-stage volumes proportional to the adjacent stages' mean work
    (edge volumes see the boundary stage only), with multiplicative jitter:
    heavy stages exchange heavy data."""
    def fn(rng, n, w):
        wpad = np.concatenate([w[:1], w, w[-1:]])
        adj = 0.5 * (wpad[:-1] + wpad[1:])               # (n+1,)
        return rho * adj * rng.uniform(1.0 - noise, 1.0 + noise, n + 1)
    return fn


# The JPEG encoder pipeline of the image-processing follow-up study: per-stage
# relative compute cost and the data volume flowing OUT of each stage
# (relative units per image tile).  Chroma subsampling (4:2:0) halves the
# volume, entropy coding compresses it; the DCT dominates compute.
JPEG_STAGES = ("scale", "rgb2ycbcr", "subsample", "blocksplit", "dct",
               "quantize", "encode")
JPEG_COMP = np.array([4.0, 6.0, 2.0, 1.0, 12.0, 3.0, 8.0])
JPEG_OUT = np.array([16.0, 16.0, 8.0, 8.0, 8.0, 8.0, 2.0])
JPEG_IN_RAW = 16.0   # raw image volume entering the first stage


def jpeg_profile_comp(jitter: float = 0.2) -> Callable:
    """The encoder's per-stage compute profile tiled cyclically to n stages
    with multiplicative uniform jitter (instance diversity)."""
    def fn(rng, n):
        base = JPEG_COMP[np.arange(n) % len(JPEG_COMP)]
        return base * rng.uniform(1.0 - jitter, 1.0 + jitter, n)
    return fn


def jpeg_profile_comm(jitter: float = 0.2) -> Callable:
    """The encoder's inter-stage volumes: raw input ahead of stage 1, then
    each stage's output volume, tiled with the compute profile."""
    def fn(rng, n, w):
        base = np.empty(n + 1)
        base[0] = JPEG_IN_RAW
        base[1:] = JPEG_OUT[np.arange(n) % len(JPEG_OUT)]
        return base * rng.uniform(1.0 - jitter, 1.0 + jitter, n + 1)
    return fn


# ---------------------------------------------------------------------------
# Failure samplers (the reliability sequel's platform model).
#
# fail samplers: fn(rng, p, s) -> (p,) per-processor failure probabilities in
#                [0, 1); they see the drawn speeds so failure probability can
#                correlate with hardware quality.
# ---------------------------------------------------------------------------

def uniform_fail(lo: float = 1e-3, hi: float = 2e-2) -> Callable:
    """I.i.d. uniform failure probabilities (R1)."""
    return lambda rng, p, s: rng.uniform(lo, hi, p)


def bimodal_fail(lo: float = 1e-3, hi: float = 2e-2,
                 flaky_frac: float = 0.2) -> Callable:
    """A reliable majority near ``lo`` plus a flaky minority near ``hi`` (R2):
    the realistic mixed-fleet shape, where replication pays only when it
    avoids pairing two flaky processors."""
    def fn(rng, p, s):
        flaky = rng.random(p) < flaky_frac
        base = rng.uniform(lo, 2 * lo, p)
        bad = rng.uniform(0.5 * hi, hi, p)
        return np.where(flaky, bad, base)
    return fn


def speed_correlated_fail(lo: float = 1e-3, hi: float = 3e-2,
                          noise: float = 0.25) -> Callable:
    """Failure probability anti-correlated with speed (R3): the slowest
    processor sits near ``hi``, the fastest near ``lo`` (older hardware is
    both slower and flakier), with multiplicative jitter.  Homogeneous
    speeds degenerate to ~``hi`` everywhere."""
    def fn(rng, p, s):
        s = np.asarray(s, dtype=float)
        span = s.max() - s.min()
        t = (s.max() - s) / span if span > 0 else np.ones(p)   # 0 fast .. 1 slow
        base = lo + (hi - lo) * t
        f = base * rng.uniform(1.0 - noise, 1.0 + noise, p)
        return np.clip(f, 0.0, 0.999)
    return fn


# ---------------------------------------------------------------------------
# Family registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """A named scenario family: per-stage comm/comp samplers plus metadata.

    ``family`` groups specs into selectable sets ("paper" = the source
    paper's E1-E4, "image" = the image-processing follow-up's I1-I4).
    """

    name: str
    description: str
    comp: Callable            # (rng, n) -> (n,) stage works
    comm: Callable            # (rng, n, w) -> (n+1,) inter-stage volumes
    family: str = "paper"
    # Reliability-sequel families carry a failure sampler (rng, p, s) -> (p,);
    # None keeps the platform's fail unset (bi-criteria families unchanged).
    fail: "Callable | None" = None


EXPERIMENTS: dict = {}


def register_experiment(spec: ExperimentSpec, *,
                        override: bool = False) -> ExperimentSpec:
    """Register a scenario family; it immediately flows through the lockstep
    engine and ``run_campaign``/``paper_sim``.  Re-registering an existing name
    raises unless ``override=True`` — the built-in families' random streams
    are part of the seed contract (golden CSVs assert them byte-for-byte),
    so silently replacing one would corrupt every seeded campaign."""
    if not override and spec.name in EXPERIMENTS:
        raise ValueError(f"scenario family {spec.name!r} is already "
                         "registered; pass override=True to replace it")
    EXPERIMENTS[spec.name] = spec
    return spec


for _spec in (
    ExperimentSpec("E1", "balanced comm/comp, homogeneous comms",
                   uniform_comp(1, 20), constant_comm(10.0)),
    ExperimentSpec("E2", "balanced comm/comp, heterogeneous comms",
                   uniform_comp(1, 20), uniform_comm(1, 100)),
    ExperimentSpec("E3", "large computations",
                   uniform_comp(10, 1000), uniform_comm(1, 20)),
    ExperimentSpec("E4", "small computations",
                   uniform_comp(0.01, 10.0, integer=False),
                   uniform_comm(1, 20)),
    ExperimentSpec("I1", "JPEG encoder stage profile (image study)",
                   jpeg_profile_comp(), jpeg_profile_comm(), family="image"),
    ExperimentSpec("I2", "bimodal computations (light/heavy stages)",
                   bimodal_comp(), uniform_comm(1, 20), family="image"),
    ExperimentSpec("I3", "correlated comm proportional to comp",
                   uniform_comp(1, 20), correlated_comm(), family="image"),
    ExperimentSpec("I4", "uniform wide-range comm/comp",
                   uniform_comp(0.5, 50.0, integer=False),
                   uniform_comm(0.5, 50.0, integer=False), family="image"),
    ExperimentSpec("R1", "balanced comm/comp, uniform failures",
                   uniform_comp(1, 20), uniform_comm(1, 100),
                   family="reliability", fail=uniform_fail()),
    ExperimentSpec("R2", "balanced comm/comp, bimodal failures (flaky minority)",
                   uniform_comp(1, 20), uniform_comm(1, 100),
                   family="reliability", fail=bimodal_fail()),
    ExperimentSpec("R3", "speed-correlated failures (slow = old = flaky)",
                   uniform_comp(1, 20), uniform_comm(1, 100),
                   family="reliability", fail=speed_correlated_fail()),
    ExperimentSpec("R4", "large computations on a mixed-quality fleet",
                   uniform_comp(10, 1000), uniform_comm(1, 20),
                   family="reliability", fail=bimodal_fail()),
):
    register_experiment(_spec)

PAPER_FAMILIES = ("E1", "E2", "E3", "E4")
IMAGE_FAMILIES = ("I1", "I2", "I3", "I4")
RELIABILITY_FAMILIES = ("R1", "R2", "R3", "R4")
FAMILY_SETS = {
    "paper": PAPER_FAMILIES,
    "image": IMAGE_FAMILIES,
    "reliability": RELIABILITY_FAMILIES,
    "all": PAPER_FAMILIES + IMAGE_FAMILIES + RELIABILITY_FAMILIES,
}

BANDWIDTH = 10.0
SPEED_LOW, SPEED_HIGH = 1, 20


def gen_instance(exp: str, n: int, p: int, seed: int) -> tuple:
    """One random (workload, platform) pair for family ``exp``.

    Draw order (comp, then comm, then speeds) is part of the seed contract:
    the E1-E4 streams are byte-identical to the original generators, so every
    seeded campaign/golden CSV stays reproducible across the refactor.
    """
    spec = EXPERIMENTS[exp]
    rng = np.random.default_rng(seed)
    w = np.asarray(spec.comp(rng, n), dtype=float)
    delta = np.asarray(spec.comm(rng, n, w), dtype=float)
    if w.shape != (n,) or delta.shape != (n + 1,):
        raise ValueError(f"family {exp!r} sampler shapes {w.shape}/{delta.shape}"
                         f" do not match (n,)/(n+1,) for n={n}")
    s = rng.integers(SPEED_LOW, SPEED_HIGH + 1, p).astype(float)
    # failure draws come LAST so families without a fail sampler keep their
    # original byte-identical streams (the seed contract)
    fail = (np.asarray(spec.fail(rng, p, s), dtype=float)
            if spec.fail is not None else None)
    return (
        Workload(w, delta, name=f"{exp}-n{n}-seed{seed}"),
        Platform(s, BANDWIDTH, name=f"{exp}-p{p}-seed{seed}", fail=fail),
    )


@dataclasses.dataclass
class InstanceBatch:
    """A campaign's instances as stacked structure-of-arrays state.

    Rows are the instances of :func:`gen_instance` for ``seeds`` (identical
    draws — the per-instance objects are kept in ``workloads``/``platforms``
    for the scalar reference path and for tests).  ``prefix`` (stage-work
    prefix sums) and ``order`` (speed-sorted processor indices) are
    precomputed once here; :func:`repro_torch.sim.experiments.run_campaign`
    hands them to ``ProblemBatch.from_arrays``.
    """

    exp: str
    n: int
    p: int
    seeds: tuple
    w: np.ndarray          # (B, n)
    delta: np.ndarray      # (B, n+1)
    s: np.ndarray          # (B, p)
    b: float
    prefix: np.ndarray     # (B, n+1)
    order: np.ndarray      # (B, p) int
    workloads: tuple       # per-instance Workload objects
    platforms: tuple       # per-instance Platform objects

    def __len__(self) -> int:
        return len(self.seeds)

    def __iter__(self):
        return iter(zip(self.workloads, self.platforms))

    def instance(self, i: int) -> tuple:
        return self.workloads[i], self.platforms[i]


def gen_instance_batch(exp: str, n: int, p: int, seeds: Sequence[int]) -> InstanceBatch:
    """B random instances stacked for the batched campaign engine."""
    pairs = [gen_instance(exp, n, p, seed=int(sd)) for sd in seeds]
    return InstanceBatch(
        exp=exp, n=n, p=p, seeds=tuple(int(sd) for sd in seeds),
        w=np.stack([wl.w for wl, _ in pairs]),
        delta=np.stack([wl.delta for wl, _ in pairs]),
        s=np.stack([pf.s for _, pf in pairs]),
        b=BANDWIDTH,
        prefix=np.stack([wl.prefix_w() for wl, _ in pairs]),
        order=np.stack([pf.sorted_indices() for _, pf in pairs]),
        workloads=tuple(wl for wl, _ in pairs),
        platforms=tuple(pf for _, pf in pairs),
    )
