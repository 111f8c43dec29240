"""Plain PyTorch oracle for the packed matmul (counterpart of
``repro.kernels.ref.mpmm_ref``). Bit-exact ground truth.

The integer product is a float64 matmul of the unpacked values: every
partial sum is an integer below 2^53 (|sum| <= 8192 * 255 * 128), so it is
exact in any summation order, and it runs on either device (PyTorch has no
int32 matmul on CUDA).
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
