"""Weight-only dequant matmul: the CUDA kernel's wrapper (counterpart of
``repro.kernels.wdqmm``).

y[m, n] = sum_k x[m, k] * (eps_w * unpack(w_p)[n, k]), the layers of a
weight-only policy: activations stay bf16, weights are packed at 8, 4 or 2
bits. The kernel (``csrc/wdqmm.cu``) replaces ``wdqmm_pallas``; its plain
PyTorch version is :func:`repro_torch.kernels.ref.wdqmm_ref`, the reference's
f32 twin, which sums the f32 products x * (eps_w * w). On bf16 activations
the kernel multiplies on the tensor cores, x by the exact integer weights
(every product exact in f32), and scales the sum once by eps_w; on f32
activations it sums the twin's products with FMAs. Either way it stays
within ``TOL * sum_k |x[m, k] * w[n, k]|`` of the plain version, and a row
gives the same bits at every M.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import pack as P
from repro_torch.kernels import build
from repro_torch.kernels.ref import wdqmm_ref  # noqa: F401  (the plain version)

#: kernel vs plain version: |difference| <= TOL * sum_k |x[m, k] w[n, k]|.
#: Two f32 sums of the same products in different orders, or eps_w applied
#: to each product against once to the sum, differ by about 2^-24 to 2^-23
#: times that sum, far below 2^-20; one wrong product among K = 16384 is
#: above it.
TOL = 2.0**-20

#: bf16 activations: the kernel's K chunk (``KP`` in ``csrc/wdqmm.cu``). Each
#: chunk's 64 products are summed by four bf16 tensor-core steps from a zero
#: accumulator, and the chunks' partials are added in increasing k in f32
#: (round to nearest), then scaled once by ``eps_w``. The tensor cores'
#: f32 sums are not round-to-nearest; restarting every chunk keeps their
#: error far below TOL at K = 18432 (``tests/test_torch_wdqmm_mma.py``).
MMA_CHUNK = 64

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def wdqmm_cuda(
    x: torch.Tensor,  # (M, K) bf16 or f32, CUDA
    w_p: torch.Tensor,  # (N, K/rw) int8 packed signed weights, CUDA
    eps_w: torch.Tensor,  # one f32 on the same device (never read on the host)
    *,
    w_bits: int,
) -> torch.Tensor:
    """Launch the CUDA kernel on unpadded operands. Returns (M, N) f32."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"wdqmm_cuda needs CUDA tensors, got {dev}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x dtype {x.dtype}, expected bfloat16 or float32")
    build.check_tensor(x, "x", x.dtype, dev)
    build.check_tensor(w_p, "w_p", torch.int8, dev)
    build.check_tensor(eps_w, "eps_w", torch.float32, dev)
    if eps_w.numel() != 1:
        raise ValueError(f"eps_w must hold one value, got shape {tuple(eps_w.shape)}")
    if x.dim() != 2 or w_p.dim() != 2:
        raise ValueError("wdqmm operands must be 2-D")
    rw = P.pack_ratio(w_bits)
    M, K = x.shape
    N = w_p.shape[0]
    if w_p.shape[1] * rw != K:
        raise ValueError(f"K mismatch: x gives {K}, w gives {w_p.shape[1] * rw}")
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    fn = build.entry("wdqmm", "wdqmm_launch", _ARGTYPES)
    # the launcher picks the vector or the scalar path from K and the pointers
    err = fn(x.data_ptr(), w_p.data_ptr(), eps_w.data_ptr(), out.data_ptr(), M, N, K, w_bits,
             int(x.dtype == torch.float32), build.stream_ptr(dev))
    build.check(err, "wdqmm_launch")
    build.LAUNCHES["wdqmm"] += 1
    return out
