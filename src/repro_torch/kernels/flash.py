"""Whole-sequence flash attention: the CUDA kernel's wrapper (counterpart of
``repro.kernels.flash``).

Causal / windowed attention forward with GQA, in f32: what whole-prompt
prefill and whole-sequence scoring run. The kernel (``csrc/flash_mha.cu``)
replaces ``flash_mha_pallas``; its plain PyTorch version is
:func:`repro_torch.kernels.ref.flash_mha_ref`. Both take the model's
``(B, S, H, D)`` layout (the Pallas kernel's ``(B, H, S, D)`` transposed)
and return ``(B, Sq, Hq, D)`` f32. Both follow the same running softmax
over kv tiles and round the scores alike (one f32 FMA chain over d); only
the order of the other f32 sums differs (tiles of 64 keys in the kernel,
chunks of 512 in the plain version; on bf16 operands the kernel's P . V
sums each p, split exactly into three bf16 parts, on the tensor cores), so
they agree within :data:`TOL`. The kernel gives the same bits on every call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_mha_check_rows, flash_mha_ref  # noqa: F401  (the plain version)

#: kernel vs plain version, atol = rtol: the reference's own bound between
#: its fused attention kernels and their twins (tests/test_paged_attn.py)
TOL = 1e-5
#: head widths the kernel is instantiated for
HEAD_DIMS = (16, 128)

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
             + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def flash_mha_cuda(
    q: torch.Tensor,  # (B, Sq, Hq, D) bf16 or f32, CUDA, d contiguous
    k: torch.Tensor,  # (B, Sk, Hkv, D), q's dtype
    v: torch.Tensor,  # (B, Sk, Hkv, D), q's dtype
    *,
    causal: bool = True,
    window=None,
) -> torch.Tensor:
    """Launch the CUDA kernel on the operands as they lie (any batch,
    sequence and head strides whose rows start on 4-byte boundaries).
    Returns (B, Sq, Hq, D) f32. Refuses, as the plain version does, a
    window that leaves a query row with no key."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_mha_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q dtype {q.dtype}, expected bfloat16 or float32")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is {q.dtype} on {dev}")
        if tuple(t.shape) != (B, Sk, Hkv, D):
            raise ValueError(f"{name} shape {tuple(t.shape)}: expected (B, Sk, Hkv, D) = "
                             f"{(B, Sk, Hkv, D)}, v's head dim equal to the key's")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not among the kernel's {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    flash_mha_check_rows(Sq, Sk, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along the head dim")
        # the kernel stages 32-bit words: every row starts on a 4-byte boundary
        if t.data_ptr() % 4 or any(t.stride(i) * t.element_size() % 4 for i in range(3)):
            raise ValueError(f"{name}'s rows must start on 4-byte boundaries "
                             f"(strides {t.stride()}, offset {t.storage_offset()})")
    out = torch.empty((B, Sq, Hq, D), dtype=torch.float32, device=dev)
    if B == 0 or Sq == 0 or Hq == 0:
        return out
    # bf16 tiles stage with 16-byte copies where every row starts on a
    # 16-byte boundary (the model's rows do), else with 4-byte ones
    vec = all(t.data_ptr() % 16 == 0 and all(t.stride(i) * t.element_size() % 16 == 0
                                             for i in range(3)) for t in (q, k, v))
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v) for i in (0, 1, 2)))
    fn = build.lib("flash_mha").flash_mha_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
             ctypes.cast(strides, ctypes.c_void_p), int(causal),
             0 if window is None else int(window), 1.0 / (D**0.5),
             int(q.dtype == torch.float32), int(vec), build.stream_ptr(dev))
    build.check(err, "flash_mha_launch")
    build.LAUNCHES["flash_mha"] += 1
    return out
