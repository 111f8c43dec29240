"""Decode attention over a dense quantized KV cache (counterpart of
``repro.kernels.qkv_decode``): the CUDA kernel's wrapper, the choice by
device, and the dequantize-then-attend oracle.

One new query token per sequence, ``q`` (B, Hq, D), attends over int8 (or
packed int4) ``k_q`` / ``v_q`` (B, S, Hkv, D/r) with f32 per-(token, head)
scales ``k_s`` / ``v_s`` (B, S, Hkv); one scalar ``pos`` is shared by every
sequence (keys past it score BIG_NEG; pos < 0 gives the mean of v). The
dequantization is f32 (``code * scale``), not the bf16 rounding of
``models.attention.kv_dequantize`` that ``paged_attn`` follows, so no model
path goes through here: as in the reference, the serving decode stays on
``paged_attn`` and this module is its own API.

The kernel (``csrc/qkv_decode.cu``) replaces ``qkv_decode_pallas``; its
plain version is :func:`repro_torch.kernels.ref.qkv_decode_plain`, which
walks the Pallas kernel's ``bs``-key blocks. The kernel splits the keys
into runs of :data:`KEYS_PER_SPLIT`, one block a run, and merges the runs'
partials in a fixed order (``kernels.ref.qkv_decode_split_ref`` repeats
that order on the CPU; only tests use it), so kernel and plain version
differ only in the order of the f32 sums (within :data:`TOL`); the kernel
gives the same bits on every call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import pack as P
from repro_torch.kernels import build
from repro_torch.kernels.ref import BIG_NEG, qkv_decode_plain

#: kernel vs plain version, atol = rtol: the reference's own bound between
#: its fused attention kernels and their twins (tests/test_paged_attn.py)
TOL = 1e-5
#: head widths the kernel is instantiated for
HEAD_DIMS = (16, 64, 80, 128)
#: keys a block of the split pass takes (csrc/qkv_decode.cu: KPS); the
#: scratch holds one partial a (sequence, kv head, run of keys)
KEYS_PER_SPLIT = 128

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]


def _shapes(q, k_q, k_s, v_q, v_s, bits: int, bs: int) -> tuple[int, int, int, int, int]:
    """Check the operands' shapes against each other; returns
    (B, Hq, D, S, Hkv). Raises where the Pallas kernel asserts (S % bs)."""
    if bits not in (8, 4):
        raise ValueError(f"qkv_decode: bits {bits} not in (8, 4)")
    B, Hq, D = q.shape
    if k_q.dim() != 4 or k_q.shape[0] != B:
        raise ValueError(f"k_q shape {tuple(k_q.shape)}: expected (B={B}, S, Hkv, D/r)")
    _, S, Hkv, Dr = k_q.shape
    if Dr * P.pack_ratio(bits) != D:
        raise ValueError(f"packed head dim {Dr} does not hold D={D} at bits={bits}")
    if tuple(v_q.shape) != tuple(k_q.shape):
        raise ValueError(f"v_q shape {tuple(v_q.shape)} != k_q shape {tuple(k_q.shape)}")
    for name, t in (("k_s", k_s), ("v_s", v_s)):
        if tuple(t.shape) != (B, S, Hkv):
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected {(B, S, Hkv)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"qkv_decode: Hq={Hq} not a multiple of Hkv={Hkv}")
    bs_ = min(bs, S)
    if bs_ < 1 or S % bs_:
        raise ValueError(f"qkv_decode: S={S} is not a multiple of the key block {bs_}")
    return B, Hq, D, S, Hkv


def qkv_decode_cuda(q, k_q, k_s, v_q, v_s, pos: int, *, bits: int = 8,
                    bs: int = 512) -> torch.Tensor:
    """Launch the CUDA kernel. q (B, Hq, D) any float dtype (read as f32);
    k_q / v_q (B, S, Hkv, D/r) int8, contiguous, 16-byte aligned; k_s / v_s
    (B, S, Hkv) f32; ``pos`` a host int. ``bs`` only checks S % bs, as the
    plain version does: the kernel walks its own runs of keys. Launches the
    split pass and its merge (counted as one launch of ``qkv_decode``).
    Returns (B, Hq, D) f32."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"qkv_decode_cuda needs CUDA tensors, got {dev}")
    B, Hq, D, S, Hkv = _shapes(q, k_q, k_s, v_q, v_s, bits, bs)
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not among the kernel's {HEAD_DIMS}")
    if not q.dtype.is_floating_point:
        raise TypeError(f"q dtype {q.dtype}, expected a float type")
    q = q.to(torch.float32).contiguous()
    for name, t, dtype in (("k_q", k_q, torch.int8), ("v_q", v_q, torch.int8),
                           ("k_s", k_s, torch.float32), ("v_s", v_s, torch.float32)):
        build.check_tensor(t, name, dtype, dev)
    for name, t in (("k_q", k_q), ("v_q", v_q)):
        if t.data_ptr() % 16:  # the kernel stages rows with 16- or 8-byte loads
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=dev)
    if B == 0 or Hq == 0:
        return out
    nsplit = -(-S // KEYS_PER_SPLIT)
    part = torch.empty(B * Hq * nsplit * (D + 2), dtype=torch.float32, device=dev)
    fn = build.entry("qkv_decode", "qkv_decode_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
             out.data_ptr(), part.data_ptr(), B, Hq, Hkv, S, D, bits, int(pos), 1.0 / (D**0.5),
             build.stream_ptr(dev))
    build.check(err, "qkv_decode_launch")
    build.LAUNCHES["qkv_decode"] += 1
    return out


def qkv_decode(q, k_q, k_s, v_q, v_s, pos, *, bits: int = 8, bs: int = 512) -> torch.Tensor:
    """Decode attention over the dense quantized cache -> (B, Hq, D) f32.
    CUDA tensors go to the kernel (which raises on what it cannot take; no
    fallback), CPU tensors to the plain version. ``pos`` is an int or a
    one-element tensor (read on the host)."""
    pos = int(pos)
    if q.device.type == "cuda":
        return qkv_decode_cuda(q, k_q, k_s, v_q, v_s, pos, bits=bits, bs=bs)
    _shapes(q, k_q, k_s, v_q, v_s, bits, bs)
    return qkv_decode_plain(q, k_q, k_s, v_q, v_s, pos, bits=bits, bs=bs)


def qkv_decode_ref(q, k_q, k_s, v_q, v_s, pos, *, bits: int = 8) -> torch.Tensor:
    """Oracle (counterpart of the reference's ``qkv_decode_ref``): dequantize
    the whole cache through ``kv_dequantize`` (bf16 rounding, the model
    path's), then masked softmax attention in f32. Returns (B, Hq, D)."""
    from repro_torch.models.attention import kv_dequantize

    D = q.shape[-1]
    k = kv_dequantize(k_q, k_s, bits).to(torch.float32)  # (B, S, Hkv, D)
    v = kv_dequantize(v_q, v_s, bits).to(torch.float32)
    groups = q.shape[1] // k.shape[2]
    k = torch.repeat_interleave(k, groups, dim=2)
    v = torch.repeat_interleave(v, groups, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.to(torch.float32), k) / (D**0.5)
    mask = torch.arange(k.shape[1], device=q.device)[None, None, :] <= int(pos)
    s = torch.where(mask, s, torch.tensor(BIG_NEG, dtype=torch.float32, device=q.device))
    return torch.einsum("bhs,bshd->bhd", torch.softmax(s, dim=-1), v)
