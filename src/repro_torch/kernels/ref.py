"""Plain PyTorch oracles for the packed kernels (counterpart of
``repro.kernels.ref``): the matmul, the standalone QntPack and the paper's
Reference-Layer conv (bit-exact ground truth), the weight-only dequant
matmul (the f32 twin of ``repro.kernels.wdqmm.wdqmm_ref``), the
whole-sequence flash attention (the function of
``repro.kernels.flash.flash_mha_pallas``, in the order of the reference's
CPU path ``repro.models.attention.flash_attention``) and decode attention
over a dense quantized cache (``repro.kernels.qkv_decode.qkv_decode_pallas``,
step for step).

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


BIG_NEG = -2.0e9


def flash_mha_check_rows(Sq: int, Sk: int, window) -> None:
    """Refuse inputs in which some query row sees no key. Row q sees the
    keys kpos < Sk with q - kpos < window (and kpos <= q when causal), so
    without a window every row sees key 0, and with one the last row sees
    a key iff Sq < Sk + window (window >= 1). What such a row would return
    is not defined: the reference's CPU path gives the mean of v, the
    Pallas kernel 0 or a mean depending on its blocks."""
    if Sk < 1:
        raise ValueError("flash_mha needs at least one key")
    if window is not None and (window < 1 or Sq >= Sk + window):
        raise ValueError(f"flash_mha: window {window} with Sq={Sq}, Sk={Sk} leaves query rows "
                         f"that see no key (needs window >= 1 and Sq < Sk + window)")


def flash_mha_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window=None,
) -> torch.Tensor:
    """Flash attention forward in f32 -> (B, Sq, Hq, D) f32. q, k and v are
    cast to f32; ``s = q . k * (1 / sqrt(D))``; keys past Sk, in the future
    (``causal``: kpos <= qpos, positions from 0 on both sides) or outside
    the ``window`` (qpos - kpos < window) score BIG_NEG; a running max,
    denominator and accumulator over kv chunks; ``acc / max(l, 1e-30)``.
    Query and kv chunks of 512 rows (zero-padded, padded keys masked) and
    GQA by repeating kv heads, as the reference's CPU path
    (``_attn_chunk`` / ``flash_attention``) orders its sums at its default
    chunks. v's head dim must equal the key's, as in ``flash_mha_pallas``
    (whose v block takes the key's width); every query row must see a key
    (:func:`flash_mha_check_rows`)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    flash_mha_check_rows(Sq, Sk, window)
    if Dv != D or k.shape != (B, Sk, Hkv, D):
        raise ValueError(f"flash_mha: v's head dim {Dv} must equal the query's and key's {D}; "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hq % Hkv:
        raise ValueError(f"flash_mha: Hq={Hq} not a multiple of Hkv={Hkv}")
    groups = Hq // Hkv
    scale = 1.0 / (D**0.5)
    qc, kc = min(512, Sq), min(512, Sk)
    pq, pk = -Sq % qc, -Sk % kc
    dev = q.device
    qf = torch.nn.functional.pad(q.to(torch.float32), (0, 0, 0, 0, 0, pq))
    kf = torch.nn.functional.pad(k.to(torch.float32), (0, 0, 0, 0, 0, pk))
    vf = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, 0, 0, pk))
    if groups > 1:
        kf = torch.repeat_interleave(kf, groups, dim=2)
        vf = torch.repeat_interleave(vf, groups, dim=2)
    qpos = torch.arange(Sq + pq, device=dev)
    kpos = torch.arange(Sk + pk, device=dev)
    neg = torch.tensor(BIG_NEG, dtype=torch.float32, device=dev)
    outs = []
    for i in range(0, Sq + pq, qc):
        qb, qp = qf[:, i:i + qc], qpos[i:i + qc]
        m = torch.full((B, Hq, qc), BIG_NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hq, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hq, qc, D), dtype=torch.float32, device=dev)
        for j in range(0, Sk + pk, kc):
            kp = kpos[j:j + kc]
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kf[:, j:j + kc]) * scale
            mask = (kp < Sk)[None, :].expand(qc, kc)
            if causal:
                mask = mask & (kp[None, :] <= qp[:, None])
            if window is not None:
                mask = mask & ((qp[:, None] - kp[None, :]) < window)
            s = torch.where(mask[None, None], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vf[:, j:j + kc])
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2))
    return torch.cat(outs, dim=1)[:, :Sq]


def qkv_decode_plain(
    q: torch.Tensor,  # (B, Hq, D), any float dtype
    k_q: torch.Tensor,  # (B, S, Hkv, D/r) int8 storage
    k_s: torch.Tensor,  # (B, S, Hkv) f32 per-(token, head) scales
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    pos: int,
    *,
    bits: int = 8,
    bs: int = 512,
) -> torch.Tensor:
    """Decode attention over a dense int8 / packed int4 cache, the function
    of ``repro.kernels.qkv_decode.qkv_decode_pallas`` step for step: blocks
    of ``min(bs, S)`` keys (S must be a multiple: the Pallas kernel asserts
    it, this raises), each dequantized in f32 (``code * scale``, no bf16
    rounding), ``s = q . k * (1 / sqrt(D))``, keys past the scalar ``pos``
    at BIG_NEG, and the running softmax from m = BIG_NEG, l = 0, acc = 0;
    out = ``acc / max(l, 1e-30)``. With pos < 0 every score is BIG_NEG and
    the result is the mean of v over all S keys. GQA: query head h reads kv
    head h // (Hq / Hkv). Returns (B, Hq, D) f32."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_q.shape
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"qkv_decode: Hq={Hq} not a multiple of Hkv={Hkv}")
    bs_ = min(bs, S)
    if bs_ < 1 or S % bs_:
        raise ValueError(f"qkv_decode: S={S} is not a multiple of the key block {bs_}")
    G = Hq // Hkv
    dev = q.device
    scale = 1.0 / (D**0.5)
    qf = q.to(torch.float32).reshape(B, Hkv, G, D)
    neg = torch.tensor(BIG_NEG, dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, G), BIG_NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=dev)
    for j in range(0, S, bs_):
        kc, vc = k_q[:, j:j + bs_], v_q[:, j:j + bs_]
        if bits < 8:
            kc, vc = P.unpack(kc, bits, signed=True), P.unpack(vc, bits, signed=True)
        kf = kc.to(torch.float32) * k_s[:, j:j + bs_, :, None]  # (B, bs, Hkv, D)
        vf = vc.to(torch.float32) * v_s[:, j:j + bs_, :, None]
        s = torch.einsum("bhgd,bshd->bhgs", qf, kf) * scale
        kpos = torch.arange(j, j + bs_, device=dev)
        s = torch.where(kpos <= pos, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgs,bshd->bhgd", p, vf)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(B, Hq, D)
