"""The paper's Reference-Layer conv: the CUDA kernel's wrapper (counterpart
of ``repro.kernels.conv2d``).

The kernel (``csrc/conv2d.cu``) replaces ``conv2d_pallas``: a 3x3, stride-1,
pad-1 HWC conv over all 27 (x, w, y) cells, im2col + MatMul + QntPack in one
pass, the MatMul an implicit GEMM on the int8 tensor cores. Unlike the
reference's wrapper, nothing pads the ifmap: the kernel stages the 1-pixel
border as zeros itself. Its plain PyTorch version is
:func:`repro_torch.kernels.ref.conv2d_ref`, which it matches bit for bit;
:func:`repro_torch.kernels.ref.conv2d_igemm_ref` repeats the kernel's
addressing on the CPU for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import pack as P
from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
#: cudaErrorInvalidValue: what the launcher returns for a shape it refuses
CUDA_ERROR_INVALID_VALUE = 1


def conv2d_cuda(
    x_p: torch.Tensor,  # (H, W, C/rx) int8, CUDA, unpadded
    w_p: torch.Tensor,  # (Cout, 9C/rw) int8, CUDA
    rqv: torch.Tensor,  # int32 [2 + 2^y - 1] on the card
    *,
    x_bits: int,
    w_bits: int,
    y_bits: int,
) -> torch.Tensor:
    """Launch the CUDA kernel. Returns (H, W, Cout/ry) int8. The kernel picks
    its tiles (csrc/conv2d.cu ``plan``) and refuses (ValueError here) only a
    C too wide for its smallest tile's shared memory."""
    dev = x_p.device
    if dev.type != "cuda":
        raise ValueError(f"conv2d_cuda needs CUDA tensors, got {dev}")
    build.check_tensor(x_p, "x_p", torch.int8, dev)
    build.check_tensor(w_p, "w_p", torch.int8, dev)
    build.check_tensor(rqv, "rqv", torch.int32, dev, (2 + (1 << y_bits) - 1,))
    rx, rw, ry = P.pack_ratio(x_bits), P.pack_ratio(w_bits), P.pack_ratio(y_bits)
    if x_p.dim() != 3 or w_p.dim() != 2:
        raise ValueError("conv2d takes an (H, W, C/rx) ifmap and (Cout, 9C/rw) weights")
    H, W, C = x_p.shape[0], x_p.shape[1], x_p.shape[2] * rx
    Cout = w_p.shape[0]
    if w_p.shape[1] * rw != 9 * C:
        raise ValueError(f"weights hold {w_p.shape[1] * rw} taps, the ifmap needs 9C = {9 * C}")
    if Cout % ry:
        raise ValueError(f"Cout={Cout} not divisible by the output pack ratio {ry}")
    out = torch.empty((H, W, Cout // ry), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    fn = build.entry("conv2d", "conv2d_launch", _ARGTYPES)
    err = fn(x_p.data_ptr(), w_p.data_ptr(), rqv.data_ptr(), out.data_ptr(), H, W, C, Cout,
             x_bits, w_bits, y_bits, build.stream_ptr(dev))
    if err == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"conv2d kernel: C={C} is too wide for a block's shared memory")
    build.check(err, "conv2d_launch")
    build.LAUNCHES["conv2d"] += 1
    return out
