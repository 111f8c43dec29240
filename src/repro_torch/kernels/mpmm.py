"""Mixed-precision packed matmul: the CUDA kernel's wrapper and the requant
vector (counterpart of ``repro.kernels.mpmm``).

The kernel (``csrc/mpmm.cu``) replaces ``mpmm_pallas`` and covers all 27
(x, w, y) cells and the three output kinds; its plain PyTorch version is
:func:`repro_torch.kernels.ref.mpmm_ref`, which it matches bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import pack as P
from repro_torch.core import quant as Q
from repro_torch.kernels import build
from repro_torch.kernels.ref import mpmm_ref  # noqa: F401  (the plain version)

OUT_KINDS = {"f32": 0, "int32": 1, "packed": 2}

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def requant_vector(rq: Q.RequantParams) -> torch.Tensor:
    """Fold RequantParams into the kernel's vector: [shift, bias,
    thresholds...] (int32, host)."""
    return torch.from_numpy(
        np.concatenate([[rq.shift, rq.bias], rq.thresholds.astype(np.int64)]).astype(np.int32))


def mpmm_cuda(
    x_p: torch.Tensor,  # (M, K/rx) int8, CUDA
    w_p: torch.Tensor,  # (N, K/rw) int8, CUDA
    rqv,  # int32 [2 + 2^y - 1] on the device (packed output), else None
    scale,  # f32 [1] on the device (f32 output), else None
    *,
    x_bits: int,
    w_bits: int,
    y_bits: int,
    x_signed: bool = False,
    out_kind: str = "packed",
) -> torch.Tensor:
    """Launch the CUDA kernel on unpadded operands. Returns (M, N) f32 or
    int32, or packed (M, N/ry) int8."""
    dev = x_p.device
    if dev.type != "cuda":
        raise ValueError(f"mpmm_cuda needs CUDA tensors, got {dev}")
    build.check_tensor(x_p, "x_p", torch.int8, dev)
    build.check_tensor(w_p, "w_p", torch.int8, dev)
    rx, rw, ry = P.pack_ratio(x_bits), P.pack_ratio(w_bits), P.pack_ratio(y_bits)
    if x_p.dim() != 2 or w_p.dim() != 2:
        raise ValueError("mpmm operands must be 2-D")
    M, N, K = x_p.shape[0], w_p.shape[0], x_p.shape[1] * rx
    if w_p.shape[1] * rw != K:
        raise ValueError(f"K mismatch: x gives {K}, w gives {w_p.shape[1] * rw}")
    kind = OUT_KINDS[out_kind]
    if out_kind == "packed":
        if N % ry:
            raise ValueError(f"N={N} not divisible by the output pack ratio {ry}")
        build.check_tensor(rqv, "rqv", torch.int32, dev)
        if rqv.numel() != 2 + (1 << y_bits) - 1:
            raise ValueError(f"rqv has {rqv.numel()} entries for y_bits={y_bits}")
        out = torch.empty((M, N // ry), dtype=torch.int8, device=dev)
    elif out_kind == "f32":
        build.check_tensor(scale, "scale", torch.float32, dev)
        out = torch.empty((M, N), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((M, N), dtype=torch.int32, device=dev)
    if M == 0 or N == 0:
        return out
    fn = build.lib("mpmm").mpmm_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    vec = int(K % 16 == 0 and w_p.data_ptr() % 16 == 0)
    err = fn(x_p.data_ptr(), w_p.data_ptr(),
             rqv.data_ptr() if rqv is not None else None,
             scale.data_ptr() if scale is not None else None,
             out.data_ptr(), M, N, K, x_bits, w_bits, y_bits, int(x_signed), kind, vec,
             build.stream_ptr(dev))
    build.check(err, "mpmm_launch")
    build.LAUNCHES["mpmm"] += 1
    return out
