"""The dry run of the port (the counterpart of the reference's
``launch/dryrun.py``): one step of each (architecture x input shape) cell on
the production meshes, counted op by op, without allocating.

The reference lowers and compiles each cell on forced host devices and
reads XLA's memory analysis and its HLO.  Here the step runs eagerly, as
the port runs it, on ``meta`` tensors (``device="meta"``, the default: no
memory is allocated and no card is needed) under the op analysis
(:mod:`repro_torch.launch.hlo_analysis`).  ``device="cuda"`` (or ``"cpu"``)
runs the same step for real and returns the same record (``step_s`` then
the step's wall time under the analysis) and, on the card,
``torch.cuda.max_memory_allocated``; the two records' op
counts are then equal (``chip_smoke.py`` phase 22).  :func:`run_cell` is the
one entry point of the port whose device defaults to ``meta``, not cuda: a
dry run allocates nothing.  Nothing here sets an environment variable.

A cell's step, as in the reference:

  - ``train``: the train step (forward, backward, AdamW).  Every family
    trains under a mesh (its ``train_forward.slots``): the state is placed
    by ``zero1_specs`` (``cfg.fsdp_params``) or ``param_specs``
    (:func:`repro_torch.models.train.place_train_state`) and the batch by
    ``batch_spec``, and the step runs under the mesh, tensor-parallel:
    every model slot of each data slot computes from its own block of the
    weights.
  - ``prefill``: the forward, returning the logits.  The parameters are
    placed by their specs and the batch by ``batch_spec``, and the forward
    runs on the placed state over the grid (``train_forward.slots``),
    returning each data slot's logits split over its model slots, with
    nothing gathered to one slot.  The hybrid, enc-dec and xLSTM families
    have no ``prefill`` of their own: their cell runs that forward.
  - ``decode``: one decode step against a decode state of ``seq_len``
    slots, placed by ``state_specs``.  The step runs on the placed
    parameters and state over the grid (``decode.slots``): each slot reads
    and writes its own blocks of the state in place, and nothing is
    gathered to one slot.

Every cell says ``"placement": "mesh"``.

The data slots of a mesh step are symmetric: the same shapes on other rows.
Where they compute independently (every dense, VLM, hybrid, enc-dec and
xLSTM step; an MoE whose
dispatch is per data slot; a decode whose state splits its batch, not its
cache length, over the data slots), the step runs data slot 0's model slots alone,
under :func:`repro_torch.launch.mesh.symmetric_data_slots` (``symmetric``,
on by default on every device): each op, launch and collective of that data
slot counts once per data slot, and its results stand in for the others'
in the step's sums over the data slots.  The additive figures (flops,
bytes by kind, collectives, launches) are then those of the whole step
(``tests/test_torch_tp.py`` holds them ``==`` on a (2, 4) mesh); the peak
is that of one data slot's model slots.  ``symmetric=False`` simulates
every data slot.

The record keeps the reference's keys: ``arch``, ``shape``, ``kind``,
``mesh``, ``devices``, ``seq_len``, ``global_batch``, ``memory``, ``hlo``
(the op analysis), ``model_flops``, ``model_flops_6nd``, ``ok``.  ``memory``
is per slot:

  - ``argument_size_in_bytes``: the bytes one slot holds of the step's
    arguments (parameters, optimizer state, batch, decode state), computed
    from their specs (:func:`repro_torch.models.sharding.slot_bytes`).
  - ``output_size_in_bytes``: the bytes of the tensors the step returns that
    it allocated (a train step updates its state in place), per computing
    slot.
  - ``temp_size_in_bytes``: the peak of live bytes the step allocated,
    per computing slot.  One process runs every slot, and here every slot
    names one device, so the simulated slots' live sets add up in that
    peak: the computing slots are every model slot of each data slot that
    took rows (the model slots of data slot 0 alone under the symmetric
    shortcut), each with an equal share, and one slot is charged
    ``peak / k`` for ``k`` simulated slots.  Nothing in that peak is
    shared between slots: a ``zero1_specs`` block is all-gathered over the
    data axes by each computing slot where a layer uses it, inside the
    layer's checkpoint, and freed with the layer (one layer's gathered
    weights per slot at a time, as GSPMD gathers them next to their op).
  - ``fits``: whether argument plus temp bytes fit one H100's 80 GB.

:func:`run_pipeline_cell` runs the paper's technique at production scale:
the planner's intervals over the 2-pod mesh, loss and gradient of the
pipelined step.  Its arguments are the port's own placement: each pod's
stack of layers on its pod's first device, the embedding and final norm
with pod 0.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both] [--jobs 4]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --pipeline --arch qwen3-4b [--straggler 2]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import gc
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

import torch

from .. import resolve_device

__all__ = ["DEFAULT_OUT", "H100_HBM_BYTES", "cell_path", "make_inputs", "model_flops",
           "pipeline_plan", "run_cell", "run_pipeline_cell"]

DEFAULT_OUT = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
# NVIDIA H100 SXM data sheet: 80 GB of HBM3 per card
H100_HBM_BYTES = 80e9


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def cell_path(out_dir: pathlib.Path, arch: str, shape: str, multi_pod: bool) -> pathlib.Path:
    return out_dir / f"{arch}__{shape}__{_mesh_tag(multi_pod)}.json"


def make_inputs(specs: dict, device, vocab: int, seed: int = 0) -> dict:
    """Tensors of ``specs`` (name -> TensorSpec) on ``device``: ``meta``
    tensors, or tokens drawn uniformly from the vocabulary and the stub
    frontends' inputs as ``normal * 0.02``, from ``seed``."""
    from ..models.registry import spec_tensors

    dev = resolve_device(device)
    if dev.type == "meta":
        return spec_tensors(specs, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for k, s in specs.items():
        if s.dtype.is_floating_point:
            out[k] = (torch.randn(s.shape, generator=gen, device=dev) * 0.02).to(s.dtype)
        else:
            out[k] = torch.randint(0, vocab, s.shape, generator=gen, device=dev,
                                   dtype=s.dtype)
    return out


def model_flops(cfg, api, shape) -> tuple:
    """(model_flops, model_flops_6nd), the reference's formulas
    (``dryrun.py:147-157``): the analytic forward plus the unembedding, three
    times for a train step; and 6 (train) or 2 flops per active parameter
    and token."""
    from ..models.common import active_param_count

    B, S = shape.global_batch, shape.seq_len
    wl = api.workload(shape)
    unembed = 2.0 * B * (S if shape.kind != "decode" else 1) * cfg.d_model * cfg.vocab_size
    fwd = wl.total_work + unembed
    tokens = B * (S if shape.kind != "decode" else 1)
    return (float(fwd * (3.0 if shape.kind == "train" else 1.0)),
            float((6.0 if shape.kind == "train" else 2.0) * active_param_count(cfg) * tokens))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tree_bytes(tree) -> int:
    from ..optim.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _new_bytes(out, args_storages: set) -> int:
    """Bytes of the tensors in ``out`` whose storages are not among the
    arguments', each storage once."""
    from ..models import sharding

    seen, total = set(), 0

    def one(t):
        nonlocal total
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen and id(st) not in args_storages:
                seen.add(id(st))
                total += st.nbytes()
        return t

    sharding._map_leaves(one, out)
    return total


def _held_bytes(*trees) -> int:
    """The bytes of the distinct storages of the trees' tensors (each placed
    block of a :class:`~repro_torch.models.sharding.ShardedTensor`): what
    the process holds of them over every slot."""
    from ..models import sharding

    seen = {}

    def one(t):
        for x in (t.shards if isinstance(t, sharding.ShardedTensor)
                  else (t,) if isinstance(t, torch.Tensor) else ()):
            st = x.untyped_storage()
            seen.setdefault(id(st), st.nbytes())
        return t

    for tree in trees:
        sharding._map_leaves(one, tree)
    return sum(seen.values())


def _storages(*trees) -> set:
    from ..models import sharding

    out = set()

    def one(t):
        if isinstance(t, sharding.ShardedTensor):
            for s in t.shards:
                out.add(id(s.untyped_storage()))
        elif isinstance(t, torch.Tensor):
            out.add(id(t.untyped_storage()))
        return t

    for tree in trees:
        sharding._map_leaves(one, tree)
    return out


def _memory(peak: int, args_bytes: int, out_bytes: int, k: int,
            computing: int = None) -> dict:
    """The per-slot memory record of a step whose peak holds ``k``
    simulated slots' live sets (of ``computing`` that compute): one slot
    is charged ``peak / k``."""
    temp = peak / k
    return {"argument_size_in_bytes": int(args_bytes),
            "output_size_in_bytes": int(out_bytes / k),
            "temp_size_in_bytes": int(temp),
            "computing_slots": computing or k,
            "simulated_slots": k,
            "fits": bool(args_bytes + temp <= H100_HBM_BYTES)}


def _run_step(step, dev, mesh_devices: int, computing: int, detail: bool,
              args_trees: tuple) -> tuple:
    """(the op analysis of ``step()`` on a mesh of ``mesh_devices`` slots,
    ``computing`` of them computing, the bytes of its outputs, its wall
    seconds, the peak bytes the card allocated or None)."""
    from .hlo_analysis import analyze

    on_card = dev.type == "cuda"
    _sync(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    def synced():
        out = step()
        _sync(dev)
        return out

    t0 = time.perf_counter()
    out, an = analyze(synced, devices=mesh_devices, detail=detail, computing=computing)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    return an, _new_bytes(out, _storages(*args_trees)), wall, peak


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *, device="meta",
             shape=None, mesh=None, overrides: dict = None, seed: int = 0,
             smoke: bool = False, detail: bool = True, symmetric: bool = True) -> dict:
    """One step of the cell (``arch``, ``shape_name``) on the production
    mesh (``multi_pod``: 2x16x16, else 16x16), every slot naming ``device``,
    under the op analysis; returns the record (module docstring).

    ``shape`` (a ShapeSpec) replaces ``SHAPES[shape_name]``, ``mesh`` (a
    pair of axis sizes and names) the production mesh, and ``overrides``
    are applied with ``cfg.replace`` (to the smoke config with ``smoke``).
    ``symmetric`` takes the symmetric data-slot shortcut where the step
    allows it.  On a real device the inputs and weights are drawn from
    ``seed``, and on the card the record adds ``max_memory_allocated``."""
    from ..configs import SHAPES, get_config, get_smoke_config
    from ..models import get_model, make_train_step, sharding
    from ..models.train import init_optimizer, place_train_state
    from . import collectives
    from .mesh import data_axis_size, make_mesh, model_axis_size, symmetric_data_slots, use_mesh

    dev = resolve_device(device)
    t_start = time.perf_counter()
    if dev.type == "cuda":
        gc.collect()    # what the process holds before the cell: its live tensors only
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    cfg = (get_smoke_config if smoke else get_config)(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    api = get_model(cfg)
    shape = shape or SHAPES[shape_name]
    dims, axes = mesh or (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                          else ((16, 16), ("data", "model")))
    m = make_mesh(dims, axes, devices=[dev] * math.prod(dims))
    tag = mesh and "x".join(map(str, dims)) or _mesh_tag(multi_pod)
    B, S = shape.global_batch, shape.seq_len
    rec = {"arch": arch, "shape": shape.name, "kind": shape.kind, "mesh": tag,
           "devices": m.size, "seq_len": S, "global_batch": B, "device": str(dev)}
    if overrides:
        rec["overrides"] = {k: repr(v) for k, v in overrides.items()}
    dsize, msize = data_axis_size(m), model_axis_size(m)
    bspec = sharding.batch_spec(m)
    inputs = make_inputs(api.input_specs(shape), dev, cfg.vocab_size, seed)
    in_specs = {k: sharding.P(bspec[0] if v.shape[0] % dsize == 0 else None)
                for k, v in inputs.items()}
    master = shape.kind == "train"
    params = api.init(seed, dev, master=master)
    pspecs = (sharding.zero1_specs if cfg.fsdp_params else sharding.param_specs)(
        params, cfg, m)
    if shape.kind == "decode":
        dstate = api.init_decode_state(B, S, device=dev)
        sspecs = sharding.state_specs(dstate, cfg, m, batch=B)
    rows = B // max(cfg.accum_steps, 1) if shape.kind == "train" else B
    n_data = len(m.row_devices(rows))
    with use_mesh(m):
        if shape.kind == "decode":
            sym = symmetric and n_data > 1 and api.decode.independent(dstate, B)
        else:
            sym = symmetric and n_data > 1 and api.train_forward.independent(
                cfg, rows, S + (cfg.n_vis_tokens if cfg.family == "vlm" else 0))
    k = n_data * msize
    k_sim = msize if sym else k
    rec["symmetric_data_slots"] = sym
    rec["placement"] = "mesh"

    if shape.kind == "train":
        opt = init_optimizer(params)
        args_bytes = (sum(sharding.slot_bytes(t, pspecs, m) for t in (params, opt.m, opt.v))
                      + 4 + sharding.slot_bytes(inputs, in_specs, m))
        placed, popt = place_train_state(params, opt, cfg, m)
        batch = sharding.place(inputs, in_specs, m)
        del params, opt, inputs
        train_step = make_train_step(api.train_forward, cfg)

        def step():
            with use_mesh(m), symmetric_data_slots(sym):
                return train_step(placed, popt, batch)
        args = (placed, popt, batch)
    else:
        placed = sharding.place(params, pspecs, m)
        batch = sharding.place(inputs, in_specs, m)
        args_bytes = sharding.slot_bytes(params, pspecs, m) + sharding.slot_bytes(
            inputs, in_specs, m)
        del params, inputs
        if shape.kind == "prefill":
            def step():
                rows = [{kk: v.shards[m.slot(**m.data_coords(j))] for kk, v in batch.items()}
                        for j in range(n_data)]
                out = []
                with use_mesh(m), torch.inference_mode():
                    views = api.train_forward.slot_views(placed, cfg, range(1 if sym else n_data))
                    for jj in range(1 if sym else n_data):
                        with collectives.counted_as(n_data if sym else 1):
                            out.append(api.train_forward.slots(views.subset([jj]), [rows[jj]],
                                                               cfg, n_data))
                return out
            args = (placed, batch)
        else:
            args_bytes += sharding.slot_bytes(dstate, sspecs, m)
            pstate = sharding.place(dstate, sspecs, m)
            del dstate
            args = (placed, batch, pstate)

            def step():
                toks = [batch["token"].shards[m.slot(**m.data_coords(j))]
                        for j in range(n_data)]
                with use_mesh(m), torch.inference_mode():
                    views = api.decode.slot_views(placed, cfg, range(1 if sym else n_data))
                    with collectives.counted_as(n_data if sym else 1):
                        return api.decode.slots(views, pstate, toks[:1] if sym else toks,
                                                n_data)

    t_setup = time.perf_counter()
    an, out_bytes, wall, card_peak = _run_step(step, dev, m.size, k, detail, args)
    rec["memory"] = _memory(an["peak_bytes"], args_bytes, out_bytes, k_sim, k)
    # what one process holds over every slot of the mesh: the placed
    # arguments' storages and the step's peak above them (the card's
    # ``measured_peak_bytes``, phase 22)
    rec["memory"]["process_bytes"] = int(_held_bytes(*args) + an["peak_bytes"])
    rec["hlo"] = an
    rec["model_flops"], rec["model_flops_6nd"] = model_flops(cfg, api, shape)
    rec["setup_s"] = t_setup - t_start
    rec["step_s"] = wall
    if card_peak is not None:
        rec["max_memory_allocated"] = int(card_peak)
        rec["measured_peak_bytes"] = int(card_peak - base)
    rec["ok"] = True
    return rec


def pipeline_plan(cfg, shape, straggler: float = 1.0, device=None):
    """The stage plan of the pipeline cell, from the reference's inputs
    (``dryrun.py:193-197``): ``lm_workload`` of ``cfg`` at ``shape``, two
    pods of the reference's pod model (:func:`repro_torch.core.tpu_pod_platform`)
    with pod 1 slowed by ``straggler``, ``Objective("period")``,
    ``mode="auto"``; scored on ``device`` (``None`` means cuda, as every
    planner entry point)."""
    from ..core import Objective, plan, tpu_pod_platform
    from ..models.registry import lm_workload

    pf = tpu_pod_platform(2, degraded={1: straggler})
    return plan(lm_workload(cfg, shape), pf, Objective("period"), mode="auto", device=device)


def _placed_slot_bytes(tree) -> int:
    """The bytes one slot holds of a tree of placed tensors (every slot's
    block of a leaf is as large)."""
    from ..models import sharding

    total = []
    sharding._map_leaves(lambda x: total.append(x.shards[0].numel()
                                                * x.shards[0].element_size()), tree)
    return sum(total)


def run_pipeline_cell(arch: str, num_microbatches: int = 8, straggler: float = 1.0, *,
                      device="meta", shape=None, seed: int = 0, smoke: bool = False,
                      detail: bool = True, layers: int = None) -> dict:
    """Loss and gradient of the planner-driven pipeline over the 2-pod mesh
    (``pod`` is the stage axis), the reference's ``run_pipeline_cell``: the
    planner partitions the arch's layers into intervals from the
    reference's inputs (``lm_workload``, two pods of the reference's pod
    model with pod 1 slowed by ``straggler``, ``Objective("period")``,
    ``mode="auto"``), and the pipelined loss runs them, each pod's stage
    over its pod's (data, model) slots from its stack placed by
    ``param_specs`` (``make_stage_params(..., mesh=)``).  ``smoke`` takes
    the smoke config, ``shape`` replaces ``train_4k``, ``layers`` cuts the
    depth (the plan covers the cut depth).  Where the data slots compute
    independently it takes the symmetric data-slot shortcut: each pod's
    data slot 0 alone, counted once per data slot."""
    from ..configs import SHAPES, get_config, get_smoke_config
    from ..models import get_model, sharding
    from ..pipeline.runtime import make_stage_params, pipelined_loss_fn
    from .mesh import make_mesh, model_axis_size, symmetric_data_slots, use_mesh

    dev = resolve_device(device)
    t_start = time.perf_counter()
    cfg = (get_smoke_config if smoke else get_config)(arch)
    if layers:
        cfg = cfg.replace(n_layers=min(cfg.n_layers, layers))
    shape = shape or SHAPES["train_4k"]
    pl = pipeline_plan(cfg, shape, straggler, dev if dev.type == "cuda" else "cpu")
    dims = (2, 16, 16)
    m = make_mesh(dims, ("pod", "data", "model"), devices=[dev] * math.prod(dims))
    subs = [m.submesh("pod", p) for p in range(2)]
    api = get_model(cfg)
    params = api.init(seed, dev, master=True)
    stages, mask = make_stage_params(params["layers"], pl, 2, mesh=m, cfg=cfg, stage_axis="pod")
    pipe = {"embed": params["embed"], "stages": stages, "ln_f": params["ln_f"]}
    head = {"embed": params["embed"], "ln_f": params["ln_f"]}
    del params
    B, S = shape.global_batch, shape.seq_len
    M = num_microbatches
    batch = make_inputs({k: v for k, v in api.input_specs(shape).items()
                         if k in ("tokens", "labels")}, dev, cfg.vocab_size, seed)
    # per (pod, data, model) slot, as the reference places them: the pod's
    # stack by param_specs, the embedding and final norm by theirs (every
    # pod holds them), the batch over the data axis
    bspec = {k: sharding.make_batch_sharding(subs[0], B) for k in batch}
    args_bytes = (max(_placed_slot_bytes(stages[p]) for p in range(2))
                  + sharding.slot_bytes(head, sharding.param_specs(head, cfg, subs[0]), subs[0])
                  + sharding.slot_bytes(batch, bspec, subs[0]))
    n_data = len(subs[0].row_devices(B // M))
    msize = model_axis_size(subs[0])
    with use_mesh(subs[0]):
        sym = n_data > 1 and api.train_forward.independent(cfg, B // M, S)
    loss_fn = pipelined_loss_fn(cfg, pl, M, mask, mesh=m, stage_axis="pod")
    leaves = sharding.tensors(pipe)

    def step():
        with torch.enable_grad(), symmetric_data_slots(sym):
            for p in leaves:
                p.requires_grad_(True)
            try:
                loss = loss_fn(pipe, batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
        return loss.detach(), grads

    t_setup = time.perf_counter()
    k = pl.num_stages * n_data * msize
    k_sim = pl.num_stages * (1 if sym else n_data) * msize
    an, out_bytes, wall, card_peak = _run_step(step, dev, m.size, k, detail, (pipe, batch))
    rec = {
        "arch": arch, "shape": shape.name, "mesh": "pod2x16x16", "mode": "pipeline",
        "placement": "mesh", "symmetric_data_slots": sym, "n_layers": cfg.n_layers,
        "device": str(dev), "devices": m.size, "ok": True,
        "plan": {"planner": pl.planner, "stage_sizes": list(pl.stage_sizes),
                 "alloc": list(pl.mapping.alloc), "period_s": pl.period,
                 "latency_s": pl.latency, "padding_overhead": pl.padding_overhead,
                 "straggler": straggler},
        "num_microbatches": M, "seq_len": S, "global_batch": B,
        "memory": _memory(an["peak_bytes"], args_bytes, out_bytes, k_sim, k),
        "hlo": an,
        "setup_s": t_setup - t_start, "step_s": wall,
    }
    if card_peak is not None:
        rec["max_memory_allocated"] = int(card_peak)
    return rec


def _failure(rec: dict, e: Exception) -> dict:
    return rec | {"ok": False, "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}


def _summary(rec: dict) -> dict:
    mem = rec["memory"]
    out = {k: rec.get(k) for k in ("arch", "shape", "mesh", "ok", "step_s", "placement")}
    out["argument_gb"] = mem["argument_size_in_bytes"] / 1e9
    out["temp_gb"] = mem["temp_size_in_bytes"] / 1e9
    out["fits"] = mem["fits"]
    out["dot_tflops"] = rec["hlo"]["dot_flops"] / 1e12
    out["collective_gb"] = rec["hlo"]["collective_bytes"] / 1e9
    if "plan" in rec:
        out["plan"] = rec["plan"]
    return out


def _run_child(out_dir: pathlib.Path, arch: str, shape: str, multi_pod: bool,
               device: str) -> bool:
    """One cell of ``--all`` in its own process; its record gets the
    process's seconds, or records the process's failure where it wrote
    none."""
    path = cell_path(out_dir, arch, shape, multi_pod)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--multi-pod", "yes" if multi_pod else "no", "--out", str(out_dir),
           "--device", device]
    print(f"[dryrun] {arch} {shape} {_mesh_tag(multi_pod)} ...", flush=True)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    rec = json.loads(path.read_text()) if path.exists() else {
        "arch": arch, "shape": shape, "mesh": _mesh_tag(multi_pod), "ok": False,
        "error": f"exit code {r.returncode}", "stderr": r.stderr[-4000:]}
    rec["process_s"] = secs
    path.write_text(json.dumps(rec, indent=1))
    if r.returncode != 0:
        print(r.stdout[-2000:] + r.stderr[-2000:], flush=True)
    return r.returncode == 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="The port's dry run: op counts and memory of "
                                             "each cell's step on the production meshes.")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", default="no", choices=["no", "yes", "both"])
    ap.add_argument("--all", action="store_true", help="every supported cell, one process each")
    ap.add_argument("--force", action="store_true", help="rerun cells that have a record")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--pipeline", action="store_true",
                    help="the planner-driven pipeline over the pod axis")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--straggler", type=float, default=1.0)
    ap.add_argument("--layers", type=int, default=None,
                    help="with --pipeline: cut the depth (the plan covers the cut)")
    ap.add_argument("--device", default="meta", help="meta (default), cpu or cuda")
    ap.add_argument("--jobs", type=int, default=1, help="cells of --all run at once")
    args = ap.parse_args(argv)

    from ..configs import cells

    if args.list:
        for a, s in cells():
            print(f"{a:18s} {s.name}")
        return
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.pipeline:
        tag = (f"straggler{args.straggler}" if args.straggler != 1.0 else "even") + (
            f"_{args.layers}L" if args.layers else "")
        path = out_dir / f"{args.arch}__pipeline_{tag}__pod2x16x16.json"
        try:
            rec = run_pipeline_cell(args.arch, args.microbatches, args.straggler,
                                    device=args.device, layers=args.layers)
        except Exception as e:
            rec = _failure({"arch": args.arch, "mode": "pipeline"}, e)
            path.write_text(json.dumps(rec, indent=1))
            raise
        path.write_text(json.dumps(rec, indent=1))
        print(json.dumps(_summary(rec), indent=1))
        return

    if args.all:
        pods = [False, True] if args.multi_pod == "both" else [args.multi_pod == "yes"]
        todo = [(a, s.name, mp) for mp in pods for a, s in cells()
                if args.force or not cell_path(out_dir, a, s.name, mp).exists()]
        with concurrent.futures.ThreadPoolExecutor(max(args.jobs, 1)) as pool:
            fails = sum(not ok for ok in pool.map(
                lambda cell: _run_child(out_dir, *cell, args.device), todo))
        print(f"[dryrun] complete: {len(todo) - fails} ok, {fails} failed")
        sys.exit(1 if fails else 0)

    mp = args.multi_pod == "yes"
    path = cell_path(out_dir, args.arch, args.shape, mp)
    try:
        rec = run_cell(args.arch, args.shape, mp, device=args.device)
    except Exception as e:      # recorded: each failure is a fault to fix
        rec = _failure({"arch": args.arch, "shape": args.shape, "mesh": _mesh_tag(mp)}, e)
        path.write_text(json.dumps(rec, indent=1))
        print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "ok", "error")},
                         indent=1))
        raise
    path.write_text(json.dumps(rec, indent=1))
    print(json.dumps(_summary(rec), indent=1))


if __name__ == "__main__":
    main()
