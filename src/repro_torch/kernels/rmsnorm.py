"""Wrappers of the hand-written CUDA RMSNorm kernels (``csrc/rmsnorm.cu``).

The port's counterpart of the reference's Pallas ``kernels/rmsnorm.py``:

  - :func:`rmsnorm` normalizes the last axis of ``x`` with float32
    statistics and a float32 ``scale``, rounding once to ``x``'s type;
  - :func:`rmsnorm_residual` adds ``residual`` in float32, returns the sum
    rounded to ``x``'s type as the new residual, and normalizes the float32
    sum (the TPU kernel's formula, which differs from the reference oracle's;
    its plain version is :func:`repro_torch.kernels.ref.rmsnorm_residual_ref`).

``x`` is float32 or bfloat16, ``scale`` float32 of shape ``(d,)``.
:func:`rmsnorm` takes one of two kernels, by shape and alignment
(:func:`rmsnorm_route`); both count as one launch.  A CUDA
tensor launches the kernel on the current stream and adds one to the
wrapper's ``launches``; a CPU tensor runs the plain version.  Nothing falls
back: a CUDA input the kernel does not take raises.  A ``meta`` tensor (the
dry run) gets the kernel's result as a meta tensor, allocated as on the
card; nothing runs.  Both routes tell :func:`~.build.note_launch` of the
launch, with :func:`rmsnorm_cost` / :func:`rmsnorm_residual_cost`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import rmsnorm_ref, rmsnorm_residual_ref

__all__ = ["rmsnorm", "rmsnorm_cost", "rmsnorm_residual", "rmsnorm_residual_cost",
           "rmsnorm_route"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
WARP_MAX_VECTORS = 32  # 16-byte vectors per lane of the warp kernel (kMaxVec)
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = {
    # x, scale, out, n, d, eps, dtype, warp (then the stream)
    "rmsnorm": [_P] * 3 + [_I64] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_int],
    # x, residual, scale, out, r_out, n, d, eps, dtype (then the stream)
    "rmsnorm_residual": [_P] * 5 + [_I64] * 2 + [ctypes.c_float, ctypes.c_int],
}


def rmsnorm_cost(n: int, d: int, itemsize: int) -> tuple:
    """(bytes, operations) of :func:`rmsnorm` over ``n`` rows of ``d``: x
    read and out written, the float32 scale read; 4 operations an element
    (chip_smoke.py's bound for the row)."""
    return 2 * itemsize * n * d + 4 * d, 4 * n * d


def rmsnorm_residual_cost(n: int, d: int, itemsize: int) -> tuple:
    """(bytes, operations) of :func:`rmsnorm_residual`: x and the residual
    read, both outputs written, the scale read; 5 operations an element."""
    return 4 * itemsize * n * d + 4 * d, 5 * n * d


def _rows(x, scale, others=()) -> tuple:
    """Check the kernel's inputs; returns ``(rows, d, dtype code)``."""
    dev = x.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"the RMSNorm kernels run on cuda or cpu, not {dev}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    d = x.shape[-1]
    n = x.numel() // d if d else 0
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows exceed the kernel's grid")
    build.check_tensor("x", x, x.shape, x.dtype, dev)
    for name, t in others:
        build.check_tensor(name, t, x.shape, x.dtype, dev)
    build.check_tensor("scale", scale, (d,), torch.float32, dev)
    return n, d, DTYPE_CODES[x.dtype]


def rmsnorm_route(x, scale) -> str:
    """Which CUDA kernel :func:`rmsnorm` launches for these inputs: ``"warp"``
    (a warp per row, the row in registers as 16-byte vectors) when a row is
    whole 16-byte vectors, at most ``WARP_MAX_VECTORS`` per lane, and x and
    scale are 16-byte aligned; else ``"block"`` (a block per row)."""
    vec = 16 // x.element_size()
    d = x.shape[-1]
    if (d % vec == 0 and 0 < d <= 32 * WARP_MAX_VECTORS * vec
            and x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0):
        return "warp"
    return "block"


def rmsnorm(x, scale, *, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (any leading shape)."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps=eps)
    n, d, code = _rows(x, scale)
    out = torch.empty_like(x)
    if x.device.type == "cuda":
        build.launch("rmsnorm", "rmsnorm", _ARGTYPES["rmsnorm"], x.data_ptr(),
                     scale.data_ptr(), out.data_ptr(), n, d, float(eps), code,
                     int(rmsnorm_route(x, scale) == "warp"))
        rmsnorm.launches += 1
    if build.LAUNCH_LISTENERS:
        build.note_launch("rmsnorm", *rmsnorm_cost(n, d, x.element_size()))
    return out


def rmsnorm_residual(x, residual, scale, *, eps: float = 1e-5) -> tuple:
    """Fused ``x + residual`` then RMSNorm; returns ``(normed, new_residual)``."""
    if x.device.type == "cpu":
        return rmsnorm_residual_ref(x, residual, scale, eps=eps)
    n, d, code = _rows(x, scale, (("residual", residual),))
    out, r_out = torch.empty_like(x), torch.empty_like(x)
    if x.device.type == "cuda":
        build.launch("rmsnorm", "rmsnorm_residual", _ARGTYPES["rmsnorm_residual"],
                     x.data_ptr(), residual.data_ptr(), scale.data_ptr(), out.data_ptr(),
                     r_out.data_ptr(), n, d, float(eps), code)
        rmsnorm_residual.launches += 1
    if build.LAUNCH_LISTENERS:
        build.note_launch("rmsnorm_residual", *rmsnorm_residual_cost(n, d, x.element_size()))
    return out, r_out


rmsnorm.launches = 0
rmsnorm_residual.launches = 0
