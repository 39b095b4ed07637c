"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 [-fmad=false]
         -shared -Xcompiler -fPIC -Xptxas -v
         -o build/repro_torch/<name>-<hash>.so <name>.cu

under ``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``).  The file name carries a hash of the source and the flags, so
an edited source is rebuilt and a current one is reused.  ``-fmad=false``
(``split_score.cu`` only) keeps nvcc from contracting a product and a sum
into one FMA, which those kernels' bit-identity to numpy needs; the model
kernels are held to a tolerance and keep the FMA.  A failed build raises;
nothing falls back.  Nothing here runs when the module is imported.

:func:`note_launch` tells the listeners in :data:`LAUNCH_LISTENERS` (the op
analysis, :mod:`repro_torch.launch.hlo_analysis`) of one launch of a model
kernel, with the bytes it moves and the operations it does; a wrapper calls
it where it launches on the card and where it stands in for a launch on a
``meta`` tensor, only while a listener is there (a launch with none costs
one test of the list).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCE_FLAGS = {"split_score": ("-fmad=false",)}

_LOCK = threading.Lock()
_LIBS: dict = {}
# fn(kernel name, bytes, operations) for each model kernel launch
LAUNCH_LISTENERS: list = []


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    """The CUDA compiler: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (looked on PATH, $CUDA_HOME and "
                           "/usr/local/cuda); the CUDA kernels cannot be built")


def sources() -> list:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: pathlib.Path) -> tuple:
    """Start one nvcc.  It writes to a private temporary name that
    ``_finish`` renames into place, so a concurrent build never leaves a
    partial file for another process to load.  Returns ``(process, temporary path)``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *nvcc_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, job: tuple, out: pathlib.Path) -> str:
    """Wait for one nvcc and move its library into place; returns its log
    (``-Xptxas -v`` prints each kernel's registers and spills)."""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict:
    """Build every out-of-date source, one nvcc each, all started together.
    Returns ``{name: nvcc log}`` (empty for a library that was current)."""
    with _LOCK:
        outs = {name: library_path(name) for name in sources()}
        jobs = {name: _start(name, out) for name, out in outs.items()
                if not out.exists()}
        logs = {name: "" for name in outs}
        try:
            for name, job in jobs.items():
                logs[name] = _finish(name, job, outs[name])
        finally:
            for proc, _ in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not out.exists():
            _finish(name, _start(name, out), out)
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib


def launch(name: str, fn: str, argtypes: list, *args) -> None:
    """Call ``fn`` of ``csrc/<name>.cu`` with ``args`` and PyTorch's current
    stream appended; raise if it returns a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    f = getattr(load(name), fn)
    if f.argtypes is None:
        f.argtypes = list(argtypes) + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    err = f(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed with cudaError_t {err}")


def note_launch(name: str, nbytes: int, flops: int) -> None:
    """One launch of model kernel ``name``: ``nbytes`` moved (each input read
    once, each output written once) and ``flops`` done, by the wrapper's
    ``*_cost`` function, which ``chip_smoke.py``'s bound of its row calls
    too."""
    for fn in LAUNCH_LISTENERS:
        fn(name, nbytes, flops)


def check_tensor(name, t, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this shape, type and device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
