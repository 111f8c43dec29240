"""Plain PyTorch oracles for the packed kernels (counterpart of
``repro.kernels.ref``): the matmul, the standalone QntPack and the paper's
Reference-Layer conv (bit-exact ground truth), the weight-only dequant
matmul (the f32 twin of ``repro.kernels.wdqmm.wdqmm_ref``), the
whole-sequence flash attention (the function of
``repro.kernels.flash.flash_mha_pallas``, in the order of the reference's
CPU path ``repro.models.attention.flash_attention``) and decode attention
over a dense quantized cache (``repro.kernels.qkv_decode.qkv_decode_pallas``,
step for step). Two more repeat a CUDA kernel's order of work for the tests:
``qkv_decode_split_ref`` (the split key walk and its merge) and
``conv2d_igemm_ref`` (the implicit GEMM's addressing).

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
    offset-binary (q + 2^(b-1)), recovered before accumulating.

    With a leading expert axis, ``x_p`` (E, M, K/rx) and ``w_p`` (E, N, K/rw)
    (the reference's ``mpmm`` under ``jax.vmap``), it is applied expert by
    expert, each with ``out_scale[e]`` (an (E,) vector, or one scalar for
    all), and returns (E, M, ...)."""
    if x_p.dim() == 3:
        scale = torch.as_tensor(out_scale, dtype=torch.float32, device=x_p.device).reshape(-1)
        return torch.stack([
            mpmm_ref(x_p[e], w_p[e], rq, x_bits=x_bits, w_bits=w_bits, y_bits=y_bits,
                     x_signed=x_signed, out_kind=out_kind,
                     out_scale=scale[e if scale.numel() > 1 else 0])
            for e in range(x_p.shape[0])])
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


def qkv_decode_split_ref(
    q: torch.Tensor,  # (B, Hq, D), any float dtype
    k_q: torch.Tensor,  # (B, S, Hkv, D/r) int8 storage
    k_s: torch.Tensor,  # (B, S, Hkv) f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    pos: int,
    *,
    bits: int = 8,
    keys_per_split: int,
    skip_empty: bool = True,
) -> torch.Tensor:
    """The CUDA kernel's order of work for :func:`qkv_decode_plain`'s
    function: the keys in runs of ``keys_per_split`` (the last one ragged),
    each a softmax from a fresh state over its own keys (f32 dequantization,
    ``s = q . k * (1 / sqrt(D))``, keys past ``pos`` at BIG_NEG) to a
    partial (m, l, acc); the partials of the runs that hold a visible key
    (every run when ``pos < 0``, or when ``skip_empty`` is False) merge in
    run order, M = max m, l = sum l * exp(m - M), acc = sum acc * exp(m -
    M), then acc / max(l, 1e-30). Only tests use it. Returns (B, Hq, D)
    f32."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_q.shape
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"qkv_decode: Hq={Hq} not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    dev = q.device
    scale = 1.0 / (D**0.5)
    qf = q.to(torch.float32).reshape(B, Hkv, G, D)
    neg = torch.tensor(BIG_NEG, dtype=torch.float32, device=dev)
    M = torch.full((B, Hkv, G), BIG_NEG, dtype=torch.float32, device=dev)
    parts = []
    for j in range(0, S, keys_per_split):
        n = min(keys_per_split, S - j)
        kc, vc = k_q[:, j:j + n], v_q[:, j:j + n]
        if bits < 8:
            kc, vc = P.unpack(kc, bits, signed=True), P.unpack(vc, bits, signed=True)
        kf = kc.to(torch.float32) * k_s[:, j:j + n, :, None]
        vf = vc.to(torch.float32) * v_s[:, j:j + n, :, None]
        s = torch.einsum("bhgd,bshd->bhgs", qf, kf) * scale
        s = torch.where(torch.arange(j, j + n, device=dev) <= pos, s, neg)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        take = pos < 0 or j <= pos or not skip_empty
        parts.append((take, m, p.sum(dim=-1), torch.einsum("bhgs,bshd->bhgd", p, vf)))
        if take:
            M = torch.maximum(M, m)
    l = torch.zeros_like(M)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=dev)
    for take, m, ls, accs in parts:
        if take:
            e = torch.exp(m - M)
            l = l + ls * e
            acc = acc + accs * e[..., None]
    return (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(B, Hq, D)


def conv2d_igemm_ref(
    x_p: torch.Tensor,  # (H, W, C/rx) packed unsigned HWC ifmap
    w_p: torch.Tensor,  # (Cout, 9C/rw) packed signed weights, (dy, dx, c) order
    rq: Q.RequantParams,
    *,
    x_bits: int,
    w_bits: int,
    y_bits: int,
    cout_tile: int = 16,
    rows_per_block: int = 2,
    segment: int = 16,
) -> torch.Tensor:
    """The CUDA conv2d kernel's addressing on the CPU: blocks of
    ``rows_per_block`` output rows x ``segment`` pixels x ``cout_tile``
    channels; channels padded with zeros to Cp = C rounded up to 32 on both
    operands, so K is 9 Cp in whole k32 steps; input rows staged (zeros at
    the border and past the ifmap) into a ring of three slots, the band's
    first rows h-1..h+1 together and then one row a row into the slot of row
    h - 2; each m16 tile of pixels summed tap by tap and k32 step by step
    from rows p + g + dx of its slot; then requant and pack. Integer sums, so
    it equals :func:`conv2d_ref` bit for bit when the addressing is right.
    Only tests use it. Returns (H, W, Cout/ry) int8."""
    H, W, _ = x_p.shape
    x = P.unpack(x_p, x_bits, signed=False).to(torch.int64)  # (H, W, C)
    C = x.shape[2]
    Cout = w_p.shape[0]
    Cp = -(-C // 32) * 32
    ct = cout_tile
    nct = -(-Cout // ct)
    w = P.unpack(w_p, w_bits, signed=True).to(torch.int64).reshape(Cout, 9, C)
    wpad = torch.zeros((nct * ct, 9, Cp), dtype=torch.int64)
    wpad[:Cout, :, :C] = w
    phi = torch.zeros((H, W, nct * ct), dtype=torch.int64)
    for h0 in range(0, H, rows_per_block):
        for w0 in range(0, W, segment):
            for n0 in range(0, nct * ct, ct):
                ring = [None] * 3

                def stage(ih):
                    row = torch.zeros((-(-segment // 16) * 16 + 2, Cp), dtype=torch.int64)
                    if 0 <= ih < H:
                        lo, hi = max(w0 - 1, 0), min(w0 + segment + 1, W)
                        row[lo - (w0 - 1):hi - (w0 - 1), :C] = x[ih, lo:hi]
                    ring[(ih - h0 + 1) % 3] = row

                for ih in (h0 - 1, h0, h0 + 1):
                    stage(ih)
                for h in range(h0, min(H, h0 + rows_per_block)):
                    if h > h0:
                        stage(h + 1)
                    for p0 in range(0, segment, 16):
                        acc = torch.zeros((16, ct), dtype=torch.int64)
                        for tap in range(9):
                            dy, dx = divmod(tap, 3)
                            a = ring[(h - 1 + dy - h0 + 1) % 3][p0 + dx:p0 + dx + 16]
                            for k in range(0, Cp, 32):
                                acc += a[:, k:k + 32] @ wpad[n0:n0 + ct, tap, k:k + 32].T
                        n = min(16, segment - p0, W - w0 - p0)
                        if n > 0:
                            phi[h, w0 + p0:w0 + p0 + n, n0:n0 + ct] = acc[:n]
    return P.pack(Q.requant(phi[..., :Cout].to(torch.int32), rq), y_bits)
