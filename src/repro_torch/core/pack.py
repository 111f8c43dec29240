"""Sub-byte packing along the last axis (PyTorch counterpart of
``repro.core.pack``).

Layout: little-endian within a byte along the feature (last) axis:
  4-bit: byte b holds elements [2b] (low nibble), [2b+1] (high nibble)
  2-bit: byte b holds elements [4b..4b+3], 2 bits each, low-to-high
  8-bit: identity.

Sign extension uses the arithmetic-shift pair ``(v << (8-b)) >> (8-b)`` on
int8, the semantics of the paper's sign-extending ``bext``. Packed bytes are
int8 bit patterns, as in the reference.
"""

from __future__ import annotations

import torch


def pack_ratio(bits: int) -> int:
    """Elements per storage byte."""
    if bits not in (2, 4, 8):
        raise ValueError(f"unsupported bits: {bits}")
    return 8 // bits


def _as_u8(p: torch.Tensor) -> torch.Tensor:
    """Reinterpret a byte tensor as uint8 (exact bit pattern)."""
    if p.dtype == torch.uint8:
        return p
    if p.dtype == torch.int8:
        return p.view(torch.uint8)
    raise TypeError(f"expected a byte tensor, got {p.dtype}")


def pack(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack byte-held {2,4,8}-bit values along the last axis (``bins``).

    Works for signed (int8) or unsigned (uint8) values: the low ``bits`` of
    the two's complement are kept. Returns int8 bit patterns.
    """
    if bits == 8:
        return q if q.dtype == torch.int8 else q.to(torch.uint8).view(torch.int8)
    r = pack_ratio(bits)
    mask = (1 << bits) - 1
    *lead, n = q.shape
    if n % r:
        raise ValueError(f"last axis {n} not divisible by {r}")
    u = (q.to(torch.int32) & mask).reshape(*lead, n // r, r)
    shifts = torch.arange(r, dtype=torch.int32, device=q.device) * bits
    word = (u << shifts).sum(dim=-1, dtype=torch.int32)  # < 256, fits a byte
    return word.to(torch.uint8).view(torch.int8)


def unpack(p: torch.Tensor, bits: int, *, signed: bool) -> torch.Tensor:
    """Unpack to byte values (``bext``): int8 when ``signed`` (sign-extended),
    else uint8."""
    if bits == 8:
        return p.view(torch.int8) if signed else _as_u8(p)
    r = pack_ratio(bits)
    mask = (1 << bits) - 1
    *lead, np_ = p.shape
    u = _as_u8(p).to(torch.int32)
    shifts = torch.arange(r, dtype=torch.int32, device=p.device) * bits
    v = (u[..., None] >> shifts) & mask  # (..., np_, r)
    if signed:
        v = (v << (8 - bits)).to(torch.uint8).view(torch.int8)
        v = v >> (8 - bits)  # arithmetic on int8: sign-extends
    else:
        v = v.to(torch.uint8)
    return v.reshape(*lead, np_ * r)
