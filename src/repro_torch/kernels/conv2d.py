"""The paper's Reference-Layer conv: the CUDA kernel's wrapper (counterpart
of ``repro.kernels.conv2d``).

The kernel (``csrc/conv2d.cu``) replaces ``conv2d_pallas``: a 3x3, stride-1,
pad-1 HWC conv over all 27 (x, w, y) cells, im2col + s8 MatMul + QntPack in
one pass. Unlike the reference's wrapper, nothing pads the ifmap: the kernel
masks the 1-pixel border itself. Its plain PyTorch version is
:func:`repro_torch.kernels.ref.conv2d_ref`, which it matches bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import pack as P
from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

#: output channels per block and the shared memory a block may take
#: (csrc/conv2d.cu: CT; the H100's 227 KB per block)
COUT_TILE = 64
MAX_SMEM = 227 * 1024


def staged_channels(C: int) -> int:
    """The kernel's per-pixel channel width in shared memory: C rounded up
    to a multiple of 4 (whole __dp4a words), with an odd number of words so
    a warp's 32 pixels fall in 32 different banks."""
    cp = -(-C // 4) * 4
    return cp + 4 if (cp // 4) % 2 == 0 else cp


def conv2d_cuda(
    x_p: torch.Tensor,  # (H, W, C/rx) int8, CUDA, unpadded
    w_p: torch.Tensor,  # (Cout, 9C/rw) int8, CUDA
    rqv: torch.Tensor,  # int32 [2 + 2^y - 1] on the card
    *,
    x_bits: int,
    w_bits: int,
    y_bits: int,
) -> torch.Tensor:
    """Launch the CUDA kernel. Returns (H, W, Cout/ry) int8."""
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
    cp = staged_channels(C)
    smem = 3 * (W + 2) * cp + COUT_TILE * 9 * cp + COUT_TILE * 4
    if smem > MAX_SMEM:
        raise ValueError(f"conv2d kernel: W={W}, C={C} need {smem} B of shared memory per "
                         f"block, above {MAX_SMEM}")
    out = torch.empty((H, W, Cout // ry), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    fn = build.lib("conv2d").conv2d_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(x_p.data_ptr(), w_p.data_ptr(), rqv.data_ptr(), out.data_ptr(), H, W, C, cp, Cout,
             x_bits, w_bits, y_bits, build.stream_ptr(dev))
    build.check(err, "conv2d_launch")
    build.LAUNCHES["conv2d"] += 1
    return out
