"""Standalone QntPack: the CUDA kernel's wrapper (counterpart of
``repro.kernels.qntpack``).

The kernel (``csrc/qntpack.cu``) replaces ``qntpack_pallas``: int32
accumulators (M, N) are requantized (shift-and-clamp at 8 bits, the
threshold ladder at 4 and 2) and packed into (M, N/ry) int8, with the same
device code as mpmm's and conv2d's packed epilogue (``csrc/quant.cuh``). Its
plain PyTorch version is :func:`repro_torch.kernels.ref.qntpack_ref`, which
it matches bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import pack as P
from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def qntpack_cuda(phi: torch.Tensor, rqv: torch.Tensor, *, y_bits: int) -> torch.Tensor:
    """Launch the CUDA kernel: phi (M, N) int32 and the requant vector
    (int32 [2 + 2^y - 1]) on the card -> (M, N/ry) int8."""
    dev = phi.device
    if dev.type != "cuda":
        raise ValueError(f"qntpack_cuda needs CUDA tensors, got {dev}")
    build.check_tensor(phi, "phi", torch.int32, dev)
    build.check_tensor(rqv, "rqv", torch.int32, dev, (2 + (1 << y_bits) - 1,))
    ry = P.pack_ratio(y_bits)
    if phi.dim() != 2 or phi.shape[1] % ry:
        raise ValueError(f"phi must be (M, N) with N % {ry} == 0, got {tuple(phi.shape)}")
    M, N = phi.shape
    out = torch.empty((M, N // ry), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    fn = build.lib("qntpack").qntpack_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(phi.data_ptr(), rqv.data_ptr(), out.data_ptr(), out.numel(), y_bits,
             build.stream_ptr(dev))
    build.check(err, "qntpack_launch")
    build.LAUNCHES["qntpack"] += 1
    return out
