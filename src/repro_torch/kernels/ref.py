"""Plain PyTorch oracles for the packed kernels (counterpart of
``repro.kernels.ref``): the matmul, the standalone QntPack and the paper's
Reference-Layer conv (bit-exact ground truth), and the weight-only dequant
matmul (the f32 twin of ``repro.kernels.wdqmm.wdqmm_ref``).

The integer products are float64 matmuls of the unpacked values: every
partial sum is an integer below 2^53 (|sum| <= K * 255 * 128, K = 9C for
the conv), so it is exact in any summation order, and it runs on either
device (PyTorch has no int32 matmul on CUDA).
"""

from __future__ import annotations

import torch

from repro_torch.core import pack as P
from repro_torch.core import quant as Q


def mpmm_ref(
    x_p: torch.Tensor,  # (M, K/rx) packed unsigned ifmaps (int8 bit patterns)
    w_p: torch.Tensor,  # (N, K/rw) packed signed weights
    rq: Q.RequantParams,
    *,
    x_bits: int,
    w_bits: int,
    y_bits: int,
    x_signed: bool = False,
    out_kind: str = "packed",  # "packed" | "int32" | "f32"
    out_scale=1.0,  # eps_x * eps_w, for out_kind == "f32"
) -> torch.Tensor:
    """y[m, n] = requant(sum_k w[n, k] x[m, k]); ``x_signed``: ifmaps stored
    offset-binary (q + 2^(b-1)), recovered before accumulating."""
    x = P.unpack(x_p, x_bits, signed=False).to(torch.float64)  # (M, K)
    if x_signed:
        x = x - (1 << (x_bits - 1))
    w = P.unpack(w_p, w_bits, signed=True).to(torch.float64)  # (N, K)
    phi = (x @ w.T).to(torch.int32)  # exact integers
    if out_kind == "int32":
        return phi
    if out_kind == "f32":
        scale = torch.as_tensor(out_scale, dtype=torch.float32, device=phi.device)
        return phi.to(torch.float32) * scale
    if out_kind != "packed":
        raise ValueError(out_kind)
    return P.pack(Q.requant(phi, rq), y_bits)


def wdqmm_ref(x: torch.Tensor, w_p: torch.Tensor, eps_w, *, w_bits: int) -> torch.Tensor:
    """Weight-only dequant matmul: y[m, n] = sum_k x[m, k] * (eps_w * w[n, k])
    in f32. ``x`` (M, K) bf16/f32, ``w_p`` (N, K/rw) packed signed, ``eps_w``
    an f32 scalar. The dequantized weights are their own f32 array (each
    product ``w * eps_w`` rounded once), as in the reference's twin."""
    eps = torch.as_tensor(eps_w, dtype=torch.float32, device=w_p.device)
    w = P.unpack(w_p, w_bits, signed=True).to(torch.float32) * eps
    return x.to(torch.float32) @ w.T


def qntpack_ref(phi: torch.Tensor, rq: Q.RequantParams, *, y_bits: int) -> torch.Tensor:
    """Standalone QntPack oracle: requantize int32 -> pack along the last
    axis."""
    return P.pack(Q.requant(phi, rq), y_bits)


def conv2d_ref(
    x_p: torch.Tensor,  # (H, W, C/rx) packed unsigned HWC ifmap
    w_p: torch.Tensor,  # (Cout, 9C/rw) packed signed weights, (dy, dx, c) order
    rq: Q.RequantParams,
    *,
    x_bits: int,
    w_bits: int,
    y_bits: int,
) -> torch.Tensor:
    """The paper's Reference-Layer conv oracle: 3x3, stride 1, integer zero
    pad 1, HWC; im2col -> MatMul -> QntPack, exactly the three phases.
    Returns (H, W, Cout/ry) int8."""
    H, W, _ = x_p.shape
    cols = im2col(x_p, x_bits).to(torch.float64)  # (H*W, 9C)
    w = P.unpack(w_p, w_bits, signed=True).to(torch.float64)  # (Cout, 9C)
    phi = (cols @ w.T).to(torch.int32)  # exact integers
    return P.pack(Q.requant(phi, rq), y_bits).reshape(H, W, -1)


def im2col(x_p: torch.Tensor, x_bits: int) -> torch.Tensor:
    """The conv's first phase: the packed (H, W, C/rx) ifmap -> its unpacked
    (H*W, 9C) int32 patches in (dy, dx, c) order, padded with integer 0."""
    H, W, _ = x_p.shape
    x = P.unpack(x_p, x_bits, signed=False).to(torch.int32)  # (H, W, C)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))  # INT 0 == real 0.0 (alpha = 0)
    cols = torch.stack(
        [torch.stack([xp[dy:dy + H, dx:dx + W, :] for dx in range(3)], dim=2)
         for dy in range(3)], dim=2)  # (H, W, 3, 3, C)
    return cols.reshape(H * W, -1)
