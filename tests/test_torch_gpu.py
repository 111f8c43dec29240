"""PyTorch port on the card (marker ``gpu``): each hand-written CUDA kernel
against its plain PyTorch version, and the serving engine on CUDA against
the same engine on the CPU. These tests skip on a host without CUDA; on the
card run ``python -m pytest -m gpu tests/test_torch_gpu.py``. The file
imports no JAX, so it runs where only PyTorch is installed.

Tolerances: mpmm, conv2d and qntpack are integer kernels and paged_gather,
paged_scatter and paged_copy copy kernels, all bit-exact;
paged_attn and paged_mla_attn follow the plain version's page-blocked
softmax but sum inside their dots in another order, so atol = rtol = 1e-5
(the reference's own fused-vs-twin bound); wdqmm sums the plain version's
f32 products in another order, so |kernel - plain| <= TOL * sum_k |x w|
(TOL = 2^-20, ``kernels/wdqmm.py``). A weight-only engine on the card may
then pick the other token where two bf16 logits tie; its streams must equal
the CPU run's, or differ first at such a tie. flash_mha follows the plain
version's running softmax over other tiles (64 keys against chunks of 512)
and sums its dots in another order, so atol = rtol = 1e-5 (``kernels/flash.py``
``TOL``), each call twice bit-identical; the whole-sequence ``forward`` and
``prefill_step`` on the card then stay within 0.05 of the CPU's logits (a
bf16 step at logits of 4-8: a rounding of the attention output can flip one
8-bit activation code of the output projection), argmax agreeing unless the
CPU's two best are within that bound. qkv_decode follows the plain
version's running softmax over other tiles (64 keys against blocks of
``bs``), so atol = rtol = 1e-5 (``kernels/qkv_decode.py`` ``TOL``), each
call twice bit-identical. The sampler on the card draws the CPU's tokens
from the same logits (the keys and uniforms are integer arithmetic; CUDA's
``log`` / ``exp`` and sums may differ by f32 ulps), except where the CPU's
two best perturbed scores, or a nucleus cut, lie within 4 ulps.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core import pack as P  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.core.policy import (  # noqa: E402
    BF16,
    PERMUTATIONS,
    LayerPrecision,
    PrecisionPolicy,
    get_policy,
)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import paged_attn as PA  # noqa: E402
from repro_torch.kernels import qkv_decode as QD  # noqa: E402
from repro_torch.kernels.flash import TOL as FLASH_TOL  # noqa: E402
from repro_torch.kernels.paged_attn import PAGES_PER_SPLIT  # noqa: E402
from repro_torch.kernels.ref import conv2d_ref, im2col  # noqa: E402
from repro_torch.kernels.wdqmm import TOL as WDQMM_TOL  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import Request, SamplingParams, ServeEngine  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


def _operands(g, dev, M_, N, K, xb, wb):
    x = torch.randint(0, 1 << xb, (M_, K), generator=g, dtype=torch.int32).to(torch.uint8)
    w = torch.randint(-(1 << (wb - 1)), 1 << (wb - 1), (N, K), generator=g,
                      dtype=torch.int32).to(torch.int8)
    return P.pack(x, xb).to(dev), P.pack(w, wb).to(dev)


@pytest.mark.parametrize("shape", [(19, 40, 96), (3, 24, 44), (33, 8, 4112)])
def test_mpmm_kernel_bit_exact_all_cells(dev, shape):
    """Every (x, w, y) cell and output kind; K % 16 != 0 takes the scalar
    path, K > 2048 crosses shared-memory chunks, M > 16 several row tiles."""
    M_, N, K = shape
    g = torch.Generator().manual_seed(K)
    for xb, wb, yb in PERMUTATIONS:
        if K % (8 // xb) or K % (8 // wb):
            continue
        x_p, w_p = _operands(g, dev, M_, N, K, xb, wb)
        rq = Q.make_requant_params(y_bits=yb, eps_phi=2.0**-9, eps_y=1.0, lam=2.0)
        for kind in ("packed", "int32", "f32"):
            if kind == "packed" and N % (8 // yb):
                continue
            for signed in (False, True):
                kw = dict(x_bits=xb, w_bits=wb, y_bits=yb, x_signed=signed, out_kind=kind,
                          out_scale=torch.tensor(0.01, device=dev))
                a = ops.mpmm(x_p, w_p, rq, impl="cuda", **kw)
                b = ops.mpmm(x_p, w_p, rq, impl="torch", **kw)
                assert torch.equal(a, b), (xb, wb, yb, kind, signed)
    assert build.LAUNCHES["mpmm"] > 0


#: paged_attn's card shapes (D, page size, G, pages a slot): every head dim,
#: page size and group the kernel must take; the 40-page table gives the
#: merge ten splits
PAGED_SHAPES = [(16, 16, 2, 14), (64, 8, 1, 14), (80, 5, 8, 14), (128, 16, 2, 14),
                (128, 4, 8, 14), (128, 16, 2, 40)]
#: the dense slot layout (B 3, S 48, D 64, G 4) through its identity-table
#: view at bs == ps == 16
DENSE = "dense"
WINDOWS = ["nowin", "split", "subpage"]


def _paged_case(g, dev, bits, D, ps, G, Hkv=2, pos=None, nb=3 * PAGES_PER_SPLIT + 2):
    """A shuffled pool of nb pages a slot (more than three splits, the last
    partial); slots at 0, at each side of the first split boundary and at
    the last row."""
    if pos is None:
        pos = [0, PAGES_PER_SPLIT * ps - 1, PAGES_PER_SPLIT * ps, nb * ps - 1]
    B = len(pos)
    P_ = B * nb + 1
    q = torch.randn((B, G * Hkv, D), generator=g).to(dev)
    kq, ks = A.kv_quantize(torch.randn((P_, ps, Hkv, D), generator=g).to(dev), bits)
    vq, vs = A.kv_quantize(torch.randn((P_, ps, Hkv, D), generator=g).to(dev), bits)
    bt = (torch.randperm(P_ - 1, generator=g)[: B * nb] + 1).reshape(B, nb).to(torch.int32)
    return q, kq, ks, vq, vs, torch.tensor(pos, dtype=torch.int32, device=dev), bt.to(dev)


def _dense_case(dev, bits):
    """Dense (B, S, Hkv, D/r) stripes, slots at 0, 21 and S - 1."""
    g = torch.Generator().manual_seed(3)
    B, S, HQ, HKV, D = 3, 48, 8, 2, 64
    q = torch.randn((B, HQ, D), generator=g).to(dev)
    kq, ks = A.kv_quantize(torch.randn((B, S, HKV, D), generator=g).to(dev), bits)
    vq, vs = A.kv_quantize(torch.randn((B, S, HKV, D), generator=g).to(dev), bits)
    pos = torch.tensor([0, 21, S - 1], dtype=torch.int32, device=dev)
    return q, kq, ks, vq, vs, pos


def _window(kind, ps):
    """None; a window that crosses a split boundary for the slots at
    PAGES_PER_SPLIT * ps and at the last row; or one shorter than a page,
    so that it starts inside one."""
    return {"nowin": None, "split": PAGES_PER_SPLIT * ps + 3, "subpage": ps // 2}[kind]


@pytest.mark.parametrize("shape", PAGED_SHAPES + [DENSE],
                         ids=lambda s: s if s == DENSE else "D{}_ps{}_G{}_nb{}".format(*s))
@pytest.mark.parametrize("window_kind", WINDOWS)
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_paged_attn_kernel_vs_plain(dev, bits, window_kind, shape):
    """The split kernel against the plain version's page-blocked softmax
    (and, on a pool, its split order ``paged_attn_split_ref``), atol = rtol
    = 1e-5; D 80 at kv4 (40-byte rows) stages through the narrow path."""
    if shape == DENSE:
        ps = 16
        args, kw = _dense_case(dev, bits), dict(bs=ps)
    else:
        D, ps, G, nb = shape
        g = torch.Generator().manual_seed(D * 100 + ps * 10 + G + (bits or 0))
        *args, bt = _paged_case(g, dev, bits, D, ps, G, nb=nb)
        kw = dict(block_table=bt)
        if (D, bits) == (80, 4):
            assert PA._copy_width(args[1].shape[-1], args[1], args[3]) == 8
    window = _window(window_kind, ps)
    a = ops.paged_attn(*args, bits=bits, window=window, impl="cuda", **kw)
    b = ops.paged_attn(*args, bits=bits, window=window, impl="torch", **kw)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    if shape != DENSE:
        c = PA.paged_attn_split_ref(*args, bt, bits=bits, window=window)
        torch.testing.assert_close(a, c, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_paged_attn_calls_bit_identical(dev, bits):
    """Two calls give the same bits (fixed splits, a fixed merge order, no
    atomics); so do the narrow staging paths over a pool off 16-byte
    alignment (8, 4 and 1 bytes)."""
    g = torch.Generator().manual_seed(41)
    q, kq, ks, vq, vs, pos, bt = _paged_case(g, dev, bits, 128, 16, 2)
    call = lambda k, v: ops.paged_attn(q, k, ks, v, vs, pos, bits=bits,  # noqa: E731
                                       block_table=bt, window=_window("split", 16), impl="cuda")
    a = call(kq, vq)
    assert torch.equal(a, call(kq, vq))
    for off, vb in ((8, 8), (4, 4), (2, 1)):
        shifted = [_offset(t, off) for t in (kq, vq)]
        assert PA._copy_width(kq.shape[-1] * kq.element_size(), *shifted) == vb
        assert torch.equal(a, call(*shifted)), (off, vb)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_paged_attn_slot_independent_of_batch(dev, bits):
    """A slot's output is a function of its own rows: the same bits when the
    other slots' pos change and when it is served alone or in a larger
    batch."""
    g = torch.Generator().manual_seed(43)
    q, kq, ks, vq, vs, pos, bt = _paged_case(g, dev, bits, 128, 16, 2)
    call = lambda q_, p_, b_: ops.paged_attn(q_, kq, ks, vq, vs, p_, bits=bits,  # noqa: E731
                                             block_table=b_, impl="cuda")
    a = call(q, pos, bt)
    other = pos.clone()
    other[0], other[2] = int(pos[3]) - 1, 5
    assert torch.equal(a[[1, 3]], call(q, other, bt)[[1, 3]])
    for b in range(len(pos)):
        assert torch.equal(a[b:b + 1], call(q[b:b + 1], pos[b:b + 1], bt[b:b + 1])), b
    big = call(q.repeat(3, 1, 1), pos.repeat(3), bt.repeat(3, 1))
    assert torch.equal(big, a.repeat(3, 1, 1))


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_paged_attn_slot_view_equals_pool(dev, bits):
    """The dense slot layout through the identity-table view and the same
    rows in a shuffled pool give the same bits at bs == ps."""
    g = torch.Generator().manual_seed(47)
    ps, nb = 16, 3 * PAGES_PER_SPLIT + 2
    q, kq, ks, vq, vs, pos, bt = _paged_case(g, dev, bits, 128, ps, 2, nb=nb)
    dense = lambda x: None if x is None else x[bt.long()].reshape(  # noqa: E731
        len(pos), nb * ps, *x.shape[2:])
    for window in (_window(kind, ps) for kind in WINDOWS):
        a = ops.paged_attn(q, kq, ks, vq, vs, pos, bits=bits, block_table=bt, window=window,
                           impl="cuda")
        d = ops.paged_attn(q, dense(kq), dense(ks), dense(vq), dense(vs), pos, bits=bits,
                           window=window, bs=ps, impl="cuda")
        assert torch.equal(a, d)


def _mla_inputs(g, dev, bits, C, dr, B=3, H=18, ps=16, nb=4):
    P_ = B * nb + 1
    q_lat = torch.randn((B, H, C), generator=g).to(dev)
    q_rope = torch.randn((B, H, dr), generator=g).to(dev)
    cq, cs = A.kv_quantize(torch.randn((P_, ps, 1, C), generator=g).to(dev), bits)
    r = torch.randn((P_, ps, 1, dr), generator=g).to(torch.bfloat16).to(dev)
    bt = (torch.randperm(P_ - 1, generator=g)[: B * nb] + 1).reshape(B, nb).to(torch.int32)
    pos = torch.tensor([5, 37, nb * ps - 1], dtype=torch.int32, device=dev)
    return q_lat, q_rope, cq, cs, r, pos, bt.to(dev), dict(bits=bits, scale=1.0 / (C + dr) ** 0.5)


def _offset(t, nbytes):
    """The same values in a buffer ``nbytes`` past 16-byte alignment."""
    flat = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8, device=t.device)
    out = flat[nbytes: nbytes + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


def _misaligned(t):
    """The same values in a buffer one element off 16-byte alignment."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_paged_mla_attn_kernel_vs_plain(dev, bits):
    """H = 18 heads (a partial group of the kernel's 4 per block), a
    shuffled block table, slot 0 with its last pages masked and slot 1
    mid-page; then the dense slot layout through the identity-table view.
    Pools off 16-byte alignment take the scalar staging, bit-identical to
    the vector staging; so do rows that are not whole 16-byte vectors
    (C = 16 at kv4 is 8 bytes, dr = 4 rope rows are 8 bytes), held against
    the plain version."""
    g = torch.Generator().manual_seed(5)
    B, nb, ps = 3, 4, 16
    q_lat, q_rope, cq, cs, r, pos, bt, kw = _mla_inputs(g, dev, bits, C=64, dr=16)
    a = ops.paged_mla_attn(q_lat, q_rope, cq, cs, r, pos, block_table=bt, impl="cuda", **kw)
    b = ops.paged_mla_attn(q_lat, q_rope, cq, cs, r, pos, block_table=bt, impl="torch", **kw)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)

    def dense(x):
        return None if x is None else x[bt.long()].reshape(B, nb * ps, *x.shape[2:])

    d = ops.paged_mla_attn(q_lat, q_rope, dense(cq), dense(cs), dense(r), pos, impl="cuda", **kw)
    torch.testing.assert_close(d, b, atol=1e-5, rtol=1e-5)
    s = ops.paged_mla_attn(q_lat, q_rope, _misaligned(cq), cs, _misaligned(r), pos,
                           block_table=bt, impl="cuda", **kw)
    assert torch.equal(s, a)
    C, dr = {None: (12, 4), 8: (16, 4), 4: (16, 16)}[bits]
    q_lat, q_rope, cq, cs, r, pos, bt, kw = _mla_inputs(g, dev, bits, C=C, dr=dr)
    a = ops.paged_mla_attn(q_lat, q_rope, cq, cs, r, pos, block_table=bt, impl="cuda", **kw)
    b = ops.paged_mla_attn(q_lat, q_rope, cq, cs, r, pos, block_table=bt, impl="torch", **kw)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert build.LAUNCHES["paged_mla_attn"] >= 4


def _first_difference(got: dict, want: dict) -> str:
    for rid in sorted(want):
        for i, (x, y) in enumerate(zip(got.get(rid, []), want[rid])):
            if x != y:
                return f"request {rid} token {i}: {x} != {y}"
    return "streams of different lengths"


def _mla_engine_streams(dev, policy_name):
    """Reduced DeepSeek-V3 (two MLA-dense layers) on the CPU (plain
    versions, paged cache) and on the card (slot and paged caches), fused
    and unfused; the card runs' launch counts are checked as they go."""
    cfg = dataclasses.replace(configs.reduced(configs.get_arch("deepseek-v3-671b")),
                              dense_layers=2)
    policy = get_policy(policy_name)
    params = M.init_params(torch.Generator().manual_seed(3), cfg, policy, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=n).astype(np.int32) for n in (3, 9, 5, 2, 7)]
    outs = {}
    for fused in (True, False):
        for device, cache in (("cpu", "paged"), ("cuda", "slot"), ("cuda", "paged")):
            build.reset_launches()
            eng = ServeEngine(params if device == "cpu" else _to(params, dev), cfg, policy,
                              n_slots=2, s_max=32, prefill_chunk=4, cache=cache,
                              page_size=16 if cache == "paged" else None, fused_attn=fused,
                              device=device)
            outs[fused, device, cache] = eng.run(
                [Request(rid=i, prompt=pr, max_new=6) for i, pr in enumerate(prompts)])
            if device == "cuda":
                assert build.LAUNCHES["mpmm"] > 0
                assert (build.LAUNCHES["paged_mla_attn"] > 0) == fused
                assert (build.LAUNCHES["paged_scatter"] > 0) == (cache == "paged")
                assert (build.LAUNCHES["paged_gather"] > 0) == (cache == "paged" and not fused)
    return outs


def test_mla_engine_slot_and_paged_streams_identical(dev):
    """Reduced DeepSeek-V3 (two MLA-dense layers), w4a8, kv8, on the card:
    greedy streams identical on slot and paged caches, fused (through
    paged_mla_attn) and unfused (paged: through paged_gather), and equal to
    the same engine's CPU run (plain versions) on both legs."""
    outs = _mla_engine_streams(dev, "w4a8")
    for fused in (True, False):
        cpu = outs[fused, "cpu", "paged"]
        assert all(len(t) == 6 for t in cpu.values())
        for cache in ("slot", "paged"):
            got = outs[fused, "cuda", cache]
            assert got == cpu, (fused, cache, _first_difference(got, cpu))


def test_mla_engine_kv4_narrow_latent_rows(dev):
    """The same under w4a8kv4: the reduced config's 16-wide latent rows are
    8 bytes at kv4, so paged_mla_attn stages them one element at a time; the
    fused card streams equal the paged ones and the CPU run's."""
    outs = _mla_engine_streams(dev, "w4a8kv4")
    for fused in (True, False):
        cpu = outs[fused, "cpu", "paged"]
        for cache in ("slot", "paged"):
            got = outs[fused, "cuda", cache]
            assert got == cpu, (fused, cache, _first_difference(got, cpu))


def test_paged_scatter_kernel_bit_exact(dev):
    g = torch.Generator().manual_seed(4)
    for dtype in (torch.int8, torch.float32, torch.bfloat16):
        pool = (torch.randn((9, 4, 2, 5), generator=g) * 30).to(dtype).to(dev)
        new = (torch.randn((3, 6, 2, 5), generator=g) * 30).to(dtype).to(dev)
        bt = torch.tensor([[3, 5], [1, 0], [7, 2]], dtype=torch.int32, device=dev)
        pos = torch.tensor([1, 2, 5], dtype=torch.int32, device=dev)  # rows past the table
        a = ops.paged_scatter(pool.clone(), new, pos, bt, impl="cuda")
        b = ops.paged_scatter(pool.clone(), new, pos, bt, impl="torch")
        assert torch.equal(a[1:], b[1:])  # page 0 is scratch


def _conv_rq(x_p, w_p, xb, wb, yb):
    """Requant parameters that spread this input's accumulators over the
    output range."""
    cols = im2col(x_p, xb).double()
    phi = cols @ P.unpack(w_p, wb, signed=True).double().T
    levels = 1 << yb
    r = levels / 2 / (float(phi.std()) + 1.0)
    r = min(r, 1.0) if yb == 8 else r
    return Q.make_requant_params(y_bits=yb, eps_phi=r, eps_y=1.0,
                                 lam=levels / 2 / r - float(phi.mean()))


@pytest.mark.parametrize("shape", [(16, 16, 32, 64), (5, 7, 12, 68), (3, 9, 13, 66)])
def test_conv2d_kernel_bit_exact_all_cells(dev, shape):
    """Every (x, w, y) cell at the paper's Reference Layer and at ragged
    shapes: a partial Cout tile, channels padded in shared memory, W not a
    power of two; the border taps carry the u8 offset fold."""
    H, W, C, Cout = shape
    g = torch.Generator().manual_seed(H * W + C)
    n = 0
    for xb, wb, yb in PERMUTATIONS:
        if C % (8 // xb) or (9 * C) % (8 // wb) or Cout % (8 // yb):
            continue
        x = torch.randint(0, 1 << xb, (H, W, C), generator=g, dtype=torch.int32)
        w = torch.randint(-(1 << (wb - 1)), 1 << (wb - 1), (Cout, 9 * C), generator=g,
                          dtype=torch.int32)
        x_p, w_p = P.pack(x.to(torch.uint8), xb).to(dev), P.pack(w.to(torch.int8), wb).to(dev)
        rq = _conv_rq(x_p, w_p, xb, wb, yb)
        bits = dict(x_bits=xb, w_bits=wb, y_bits=yb)
        a = ops.conv2d(x_p, w_p, rq, impl="cuda", **bits)
        b = conv2d_ref(x_p, w_p, rq, **bits)
        assert torch.equal(a, b), (xb, wb, yb)
        assert torch.equal(a.cpu(), conv2d_ref(x_p.cpu(), w_p.cpu(), rq, **bits))
        n += 1
    assert n > 0 and build.LAUNCHES["conv2d"] >= n


@pytest.mark.parametrize("y_bits", [8, 4, 2])
def test_qntpack_kernel_bit_exact(dev, y_bits):
    """The Tab. 1 shape (M = 256, N = 64), accumulators at the int32 edges
    included, so that ``acc + bias`` wraps."""
    g = torch.Generator().manual_seed(y_bits)
    phi = torch.randint(-(1 << 20), 1 << 20, (256, 64), generator=g, dtype=torch.int32)
    phi[0] = (1 << 31) - 1 - torch.arange(64, dtype=torch.int32)
    phi[1] = -(1 << 31) + torch.arange(64, dtype=torch.int32)
    rq = Q.make_requant_params(y_bits=y_bits, eps_phi=(1 << y_bits) / 2.0**21, eps_y=1.0,
                               lam=float(1 << 20))
    a = ops.qntpack(phi.to(dev), rq, y_bits=y_bits, impl="cuda")
    b = ops.qntpack(phi, rq, y_bits=y_bits, impl="torch")
    assert torch.equal(a.cpu(), b)
    assert len(torch.unique(b)) > 2


@pytest.mark.parametrize("leaf", ["int8", "int4", "bf16", "f32", "odd"])
def test_paged_gather_kernel_bit_exact(dev, leaf):
    """Every cache leaf at stored width (16-byte copies), a page of 15 bytes
    (the byte path), page ids past the pool and negative ones (clamped as
    the plain version does)."""
    g = torch.Generator().manual_seed(len(leaf))
    tail = {"int8": (2, 8), "int4": (2, 4), "bf16": (2, 8), "f32": (2,), "odd": (3, 5)}[leaf]
    pool = (torch.randn((9, 4, *tail), generator=g) * 40).clamp(-100, 100)
    pool = pool.to({"bf16": torch.bfloat16, "f32": torch.float32}.get(leaf, torch.int8))
    if leaf == "odd":
        pool = pool[:, 0].contiguous()  # (9, 3, 5): 15 bytes a page
    bt = torch.tensor([[3, 5, 0, 8], [6, 12, -1, 1]], dtype=torch.int32)
    a = ops.paged_gather(pool.to(dev), bt.to(dev), impl="cuda")
    b = ops.paged_gather(pool, bt, impl="torch")
    assert torch.equal(a.cpu(), b)
    assert build.LAUNCHES["paged_gather"] > 0


@pytest.mark.parametrize("leaf", ["int8", "f32", "bf16", "odd"])
def test_paged_copy_kernel_bit_exact(dev, leaf):
    """Whole-page clones on 16-byte pages and on 15-byte pages (the byte
    path), disjoint (host ids: one launch), overlapping (a dst page read
    later as a src reads the original bits), self-copying and repeated
    sources, with host and device ids (two launches through the staging
    buffer), against the plain version."""
    g = torch.Generator().manual_seed(len(leaf))
    shape = {"int8": (9, 4, 2, 8), "f32": (9, 4, 2), "bf16": (9, 4, 2, 8), "odd": (9, 3, 5)}[leaf]
    pool = (torch.randn(shape, generator=g) * 40).clamp(-100, 100)
    pool = pool.to({"bf16": torch.bfloat16, "f32": torch.float32}.get(leaf, torch.int8))
    cases = [([3, 1], [5, 6]), ([1, 2], [2, 3]), ([4, 2, 5], [4, 1, 2]), ([3, 3], [0, 6]),
             ([9, -1, 2], [1, -2, 11])]
    for src, dst in cases:
        s, d = (torch.tensor(x, dtype=torch.int32) for x in (src, dst))
        want = ops.paged_copy(pool.clone(), s, d, impl="torch")
        for ids in ((s, d), (s.to(dev), d.to(dev))):
            build.reset_launches()
            got = ops.paged_copy(pool.to(dev), *ids, impl="cuda")
            assert torch.equal(got.cpu(), want), (leaf, src, dst)
            direct = ids[0].device.type == "cpu" and not set(src) & set(dst)
            assert build.LAUNCHES["paged_copy"] == (1 if direct else 2)


def _index_page_bytes(cache) -> dict:
    """Every page the prefix index pins -> its bytes on every cache leaf."""
    pages = []

    def walk(node):
        for ch in node.children.values():
            pages.append(ch.page)
            walk(ch)

    walk(cache._root)
    return {p: [a[p].clone() for layer in cache.caches for a in layer.values()] for p in pages}


def _prefix_requests(vocab):
    """Two sharers diverging mid-page, an exact duplicate (the S-1 cap), a
    cold prompt and a shorter sharer (tests/test_prefix.py's stream)."""
    rng = np.random.RandomState(0)
    shared = rng.randint(1, vocab, size=10).astype(np.int32)
    u = [rng.randint(1, vocab, size=5).astype(np.int32) for _ in range(3)]
    prompts = [np.concatenate([shared, u[0]]), np.concatenate([shared, u[1]]),
               np.concatenate([shared, u[0]]), rng.randint(1, vocab, size=15).astype(np.int32),
               shared[:8].copy()]
    return [Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v3-671b"])
def test_prefix_engine_on_cuda_matches_cold_paged_and_cpu(dev, arch):
    """Reduced internlm2 and reduced DeepSeek-V3 (two MLA-dense layers),
    w4a8: the prefix engine on the card clones pages through the paged_copy
    kernel, and its streams equal the card's cold paged streams and the CPU
    prefix run's."""
    cfg = configs.reduced(configs.get_arch(arch))
    if arch == "deepseek-v3-671b":
        cfg = dataclasses.replace(cfg, dense_layers=2)
    policy = get_policy("w4a8")
    params = M.init_params(torch.Generator().manual_seed(1), cfg, policy, device="cpu")
    kw = dict(n_slots=2, s_max=32, prefill_chunk=4, page_size=4)
    outs, metrics = {}, {}
    for device, cache in (("cpu", "prefix"), ("cuda", "paged"), ("cuda", "prefix")):
        build.reset_launches()
        eng = ServeEngine(params if device == "cpu" else _to(params, dev), cfg, policy,
                          cache=cache, device=device, **kw)
        outs[device, cache] = eng.run(_prefix_requests(cfg.vocab))
        metrics[device, cache] = eng.metrics()
        if device == "cuda":
            assert (build.LAUNCHES["paged_copy"] > 0) == (cache == "prefix")
            assert build.LAUNCHES["paged_scatter"] > 0
    assert outs["cuda", "prefix"] == outs["cuda", "paged"] == outs["cpu", "prefix"]
    m = metrics["cuda", "prefix"]
    assert m["cache/cow_copies"] >= 1 and m["cache/prefix_hit_rate"] > 0
    assert {k: v for k, v in m.items() if k.startswith("cache/")} == {
        k: v for k, v in metrics["cpu", "prefix"].items() if k.startswith("cache/")}


def test_shared_page_content_survives_sharer_completion(dev):
    """On the card: a sharer's prefill gathers and scatters back its whole
    row, shared pages included, and leaves every byte of the pages the index
    pins unchanged; the longer sharer's stream equals the cold paged one."""
    from repro_torch.serve import SamplingParams

    cfg = configs.reduced(configs.get_arch("internlm2-1.8b"))
    policy = get_policy("w4a8")
    params = _to(M.init_params(torch.Generator().manual_seed(3), cfg, policy, device="cpu"), dev)
    rng = np.random.RandomState(7)
    shared = rng.randint(1, cfg.vocab, size=9).astype(np.int32)
    long_p = np.concatenate([shared, rng.randint(1, cfg.vocab, size=4)])
    kw = dict(n_slots=2, s_max=24, prefill_chunk=4, page_size=4, device=dev)
    cold = ServeEngine(params, cfg, policy, cache="paged", **kw)
    want = cold.run([Request(rid=0, prompt=long_p.copy(), max_new=6),
                     Request(rid=1, prompt=shared.copy(), max_new=1)])
    eng = ServeEngine(params, cfg, policy, cache="prefix", **kw)
    h0 = eng.submit(long_p.copy(), SamplingParams(max_new=6), rid=0)
    eng.step()
    before = _index_page_bytes(eng.cache)
    assert len(before) == 3
    h1 = eng.submit(shared.copy(), SamplingParams(max_new=1), rid=1)
    eng.step()
    assert eng.metrics()["cache/tokens_matched"] == 8
    after = _index_page_bytes(eng.cache)
    for p, leaves in before.items():
        assert all(torch.equal(a, b) for a, b in zip(leaves, after[p], strict=True)), p
    eng.drain()
    assert {0: h0.result(), 1: h1.result()} == want


def test_engine_on_cuda_matches_cpu_and_launches_every_kernel(dev):
    """Reduced internlm2-1.8b, w4a8, kv8: greedy streams on CUDA (kernels)
    equal the CPU run (plain versions), on slot and paged caches."""
    cfg = configs.reduced(configs.get_arch("internlm2-1.8b"))
    policy = get_policy("w4a8")
    params = M.init_params(torch.Generator().manual_seed(3), cfg, policy, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=n).astype(np.int32) for n in (3, 9, 5, 2, 7)]
    outs = {}
    for device in ("cpu", "cuda"):
        p = params if device == "cpu" else _to(params, dev)
        for cache in ("slot", "paged"):
            build.reset_launches()
            eng = ServeEngine(p, cfg, policy, n_slots=2, s_max=32, prefill_chunk=4,
                              cache=cache, page_size=16 if cache == "paged" else None,
                              device=device)
            outs[device, cache] = eng.run(
                [Request(rid=i, prompt=pr, max_new=6) for i, pr in enumerate(prompts)])
            if device == "cuda":
                assert build.LAUNCHES["mpmm"] > 0 and build.LAUNCHES["paged_attn"] > 0
                assert (build.LAUNCHES["paged_scatter"] > 0) == (cache == "paged")
    assert outs["cuda", "slot"] == outs["cuda", "paged"] == outs["cpu", "slot"]


def test_unfused_paged_engine_on_cuda_matches_cpu(dev):
    """``fused_attn=False`` on the paged cache reads every pool leaf through
    the paged_gather kernel; its streams equal the CPU run's and the unfused
    slot streams."""
    cfg = configs.reduced(configs.get_arch("internlm2-1.8b"))
    policy = get_policy("w4a8")
    params = M.init_params(torch.Generator().manual_seed(3), cfg, policy, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=n).astype(np.int32) for n in (3, 9, 5, 2, 7)]
    outs = {}
    for device, cache in (("cpu", "paged"), ("cuda", "slot"), ("cuda", "paged")):
        p = params if device == "cpu" else _to(params, dev)
        build.reset_launches()
        eng = ServeEngine(p, cfg, policy, n_slots=2, s_max=32, prefill_chunk=4, cache=cache,
                          page_size=16 if cache == "paged" else None, fused_attn=False,
                          device=device)
        outs[device, cache] = eng.run(
            [Request(rid=i, prompt=pr, max_new=6) for i, pr in enumerate(prompts)])
        if device == "cuda":
            assert (build.LAUNCHES["paged_gather"] > 0) == (cache == "paged")
            assert build.LAUNCHES["paged_attn"] == 0
    assert outs["cuda", "paged"] == outs["cuda", "slot"] == outs["cpu", "paged"]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ------------------------------------------------------------------ wdqmm


def _wdqmm_operands(g, dev, M_, N, K, wb, dtype):
    x = torch.randn((M_, K), generator=g).to(dtype).to(dev)
    w = torch.randint(-(1 << (wb - 1)), 1 << (wb - 1), (N, K), generator=g,
                      dtype=torch.int32).to(torch.int8)
    eps = torch.tensor(0.0173, device=dev)
    return x, P.pack(w, wb).to(dev), eps, w.to(dev)


def _wdqmm_bound(x, w, eps):
    return WDQMM_TOL * (x.double().abs() @ (w.double() * float(eps)).abs().T)


@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_wdqmm_kernel_vs_plain(dev, w_bits):
    """M = 1, 4, 16 and 17 (two row tiles), a ragged N, K = 2048 and 4160
    (vector path, several staged chunks), K = 44 (scalar path), N past
    4096 and 16384 (the launcher's wider warps), bf16 and f32 activations;
    then a misaligned weight view (scalar path) and a misaligned activation
    view (vector path, staged one value at a time): every output within
    WDQMM_TOL * sum_k |x w| of the plain version."""
    g = torch.Generator().manual_seed(w_bits)
    for M_ in (1, 4, 16, 17):
        for N, K in ((37, 2048), (40, 4160), (21, 44), (4100, 256), (16390, 64)):
            for dtype in (torch.bfloat16, torch.float32):
                x, w_p, eps, w = _wdqmm_operands(g, dev, M_, N, K, w_bits, dtype)
                a = ops.wdqmm(x, w_p, eps, w_bits=w_bits, impl="cuda")
                b = ops.wdqmm(x, w_p, eps, w_bits=w_bits, impl="torch")
                assert a.dtype == torch.float32 and a.shape == (M_, N)
                assert ((a - b).double().abs() <= _wdqmm_bound(x, w, eps)).all(), (M_, N, K)
    x, w_p, eps, w = _wdqmm_operands(g, dev, 5, 33, 2048, w_bits, torch.bfloat16)
    want = ops.wdqmm(x, w_p, eps, w_bits=w_bits, impl="torch")
    for xx, ww in ((x, _misaligned(w_p)), (_misaligned(x), w_p)):
        got = ops.wdqmm(xx, ww, eps, w_bits=w_bits, impl="cuda")
        assert ((got - want).double().abs() <= _wdqmm_bound(x, w, eps)).all()
    assert build.LAUNCHES["wdqmm"] > 0


@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_wdqmm_kernel_deterministic_and_row_independent(dev, w_bits):
    """On the vector path (aligned weights) and on the scalar path (a
    misaligned weight view), each with its own fixed order: the same call
    twice gives the same bits, and a row gives the same bits alone, in a
    decode-sized call (M = 4), in a prefill chunk (M = 16) and from a
    misaligned copy of the activations."""
    g = torch.Generator().manual_seed(10 + w_bits)
    for N in (200, 5000, 17000):  # the launcher's 1, 2 and 4 columns a warp
        x, w_p, eps, _ = _wdqmm_operands(g, dev, 16, N, 2048, w_bits, torch.bfloat16)
        for w_view in (w_p, _misaligned(w_p)):
            def run(xx):
                return ops.wdqmm(xx, w_view, eps, w_bits=w_bits, impl="cuda")

            y16 = run(x)
            assert torch.equal(y16, run(x))
            assert torch.equal(y16[:4], run(x[:4]))
            assert torch.equal(y16[9:10], run(x[9:10]))
            assert torch.equal(y16, run(_misaligned(x)))


def _wo_policy(name):
    """Weight-only w4 everywhere, or the mixed policy: attention through
    mpmm at (8, 4, 8), FFN and head weight-only w2. Routers bf16, kv8."""
    if name == "w4only":
        return PrecisionPolicy(name=name, default=LayerPrecision(None, 4, None),
                               per_class={"router": BF16}, kv_cache_bits=8)
    return PrecisionPolicy(name=name, default=LayerPrecision(None, 2, None),
                           per_class={"attn_qkv": LayerPrecision(8, 4, 8),
                                      "attn_out": LayerPrecision(8, 4, 8), "router": BF16},
                           kv_cache_bits=8)


def replay_to_first_tie(prefill, decode, prompt, want, got, atol=0.05):
    """Replay the expected stream ``want`` of one request through two
    models, the expected one and the one under test: ``prefill(toks, pos,
    kw)`` takes a (1, 4) int32 chunk of the prompt into slot 0 (``kw`` holds
    ``last_idx`` and ``head`` on the last chunk) and ``decode(toks, pos)`` one
    (1, 1) token; each returns both models' logits as flat f32 numpy arrays.
    The logits agree within ``atol`` at every step, and at the first step
    where ``got`` parts from ``want`` the expected model's logits of the two
    chosen tokens are within ``atol``: a tie that the two f32 sums break
    differently. Returns that step."""
    pos = 0
    for off in range(0, len(prompt), 4):
        n = min(4, len(prompt) - off)
        toks = np.zeros((1, 4), np.int32)
        toks[0, :n] = prompt[off:off + n]
        kw = dict(last_idx=n - 1, head=True) if off + n >= len(prompt) else {}
        r, g = prefill(toks, pos, kw)
        pos += n
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, r, atol=atol, rtol=0)
        if a != b:
            assert abs(float(r[a] - r[b])) <= atol, (i, a, b, r[a], r[b])
            return i
        r, g = decode(np.array([[a]], np.int32), pos)
        pos += 1
    raise AssertionError("the streams did not differ")


def _first_tie(params, cparams, cfg, policy, prompt, want, got, dev):
    """The CPU stream's tokens through the CPU (plain versions) and the card
    (kernels) models, to the first tie (``replay_to_first_tie``)."""
    caches = {d: M.init_cache(cfg, policy, 1, 32, device=d) for d in ("cpu", dev)}
    ps = {"cpu": params, dev: cparams}

    def both(step):
        return tuple(step(d).float().cpu().numpy().ravel() for d in ps)

    def prefill(toks, pos, kw):
        return both(lambda d: M.prefill_into_slot(ps[d], torch.from_numpy(toks).to(d), 0, pos,
                                                  caches[d], cfg, policy, **kw))

    def decode(toks, pos):
        return both(lambda d: M.decode_step(
            ps[d], torch.from_numpy(toks).to(d),
            torch.tensor([pos], dtype=torch.int32, device=d), caches[d], cfg, policy,
            fused_attn=True))

    replay_to_first_tie(prefill, decode, prompt, want, got)


@pytest.mark.parametrize("policy_name", ["w4only", "mixed"])
def test_weight_only_engine_on_cuda_matches_cpu(dev, policy_name):
    """Reduced internlm2-1.8b under a weight-only policy (and the mixed one):
    the card's slot and paged streams are identical (one kernel, one sum
    order), wdqmm launched (mpmm only in the mixed policy), and equal to the
    CPU run's, or first different at a tie of the CPU logits."""
    cfg = configs.reduced(configs.get_arch("internlm2-1.8b"))
    policy = _wo_policy(policy_name)
    params = M.init_params(torch.Generator().manual_seed(3), cfg, policy, device="cpu")
    cparams = _to(params, dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=n).astype(np.int32) for n in (3, 9, 5, 2, 7)]
    outs = {}
    for device, cache in (("cpu", "paged"), ("cuda", "slot"), ("cuda", "paged")):
        build.reset_launches()
        eng = ServeEngine(params if device == "cpu" else cparams, cfg, policy, n_slots=2,
                          s_max=32, prefill_chunk=4, cache=cache,
                          page_size=16 if cache == "paged" else None, device=device)
        outs[device, cache] = eng.run(
            [Request(rid=i, prompt=pr, max_new=6) for i, pr in enumerate(prompts)])
        if device == "cuda":
            assert build.LAUNCHES["wdqmm"] > 0 and build.LAUNCHES["paged_attn"] > 0
            assert (build.LAUNCHES["mpmm"] > 0) == (policy_name == "mixed")
    assert outs["cuda", "slot"] == outs["cuda", "paged"]
    want, got = outs["cpu", "paged"], outs["cuda", "paged"]
    for rid, pr in enumerate(prompts):
        if got[rid] != want[rid]:
            _first_tie(params, cparams, cfg, policy, pr, want[rid], got[rid], dev)


# -------------------------------------------------------------- flash_mha

#: (B, Sq, Sk, Hq, Hkv, D, dtype, layout, causal, window): the reference
#: test's shapes, internlm2's full shape, ragged Sq != Sk both ways, operands
#: read through (B, H, S, D) strides, a window without causality, GQA 2
#: over two q tiles, windows whose last row sees one key (Sq = Sk + window - 1);
#: then bf16 at D 16 (the tensor-core P . V of the reduced configs), causal,
#: windowed over three q tiles, and windowed without causality
FLASH_CASES = [
    (2, 35, 35, 2, 2, 16, torch.float32, "bshd", True, None),
    (2, 35, 35, 4, 2, 16, torch.float32, "bshd", True, None),
    (2, 35, 35, 2, 2, 16, torch.float32, "bshd", False, None),
    (2, 35, 35, 2, 2, 16, torch.float32, "bshd", True, 10),
    (4, 512, 512, 16, 8, 128, torch.bfloat16, "bshd", True, None),
    (2, 100, 300, 16, 8, 128, torch.bfloat16, "bshd", True, None),
    (2, 300, 100, 16, 8, 128, torch.bfloat16, "bshd", True, None),
    (2, 200, 200, 16, 8, 128, torch.bfloat16, "bhsd", True, 70),
    (1, 70, 90, 4, 1, 16, torch.float32, "bhsd", False, 20),
    (3, 65, 65, 6, 3, 128, torch.bfloat16, "bshd", True, None),
    (2, 300, 100, 16, 8, 128, torch.bfloat16, "bshd", True, 201),
    (1, 60, 30, 4, 1, 16, torch.float32, "bshd", False, 31),
    (2, 35, 35, 4, 2, 16, torch.bfloat16, "bshd", True, None),
    (2, 130, 130, 2, 1, 16, torch.bfloat16, "bhsd", True, 10),
    (1, 60, 30, 4, 1, 16, torch.bfloat16, "bshd", False, 31),
]


def _flash_operands(g, dev, B, Sq, Sk, Hq, Hkv, D, dtype, layout):
    def one(S, H):
        if layout == "bhsd":
            return torch.randn((B, H, S, D), generator=g).to(dtype).to(dev).transpose(1, 2)
        return torch.randn((B, S, H, D), generator=g).to(dtype).to(dev)

    return one(Sq, Hq), one(Sk, Hkv), one(Sk, Hkv)


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_flash_mha_kernel_vs_plain(dev, case):
    """Every case within FLASH_TOL of the plain version, the same call twice
    bit-identical, one launch a call."""
    *shape, causal, window = case
    g = torch.Generator().manual_seed(sum(shape[:6]))
    q, k, v = _flash_operands(g, dev, *shape)
    n0 = build.LAUNCHES["flash_mha"]
    a = ops.flash_mha(q, k, v, causal=causal, window=window, impl="cuda")
    again = ops.flash_mha(q, k, v, causal=causal, window=window, impl="cuda")
    b = ops.flash_mha(q, k, v, causal=causal, window=window, impl="torch")
    assert build.LAUNCHES["flash_mha"] - n0 == 2
    assert a.dtype == torch.float32 and a.shape == q.shape and a.is_contiguous()
    assert torch.equal(a, again)
    torch.testing.assert_close(a, b, atol=FLASH_TOL, rtol=FLASH_TOL)


def test_flash_mha_bf16_at_model_scale(dev):
    """internlm2's full shape at the model's sizes (q and k scaled so that
    scores reach about +-20, v to about 14, as its own layers give them):
    within FLASH_TOL of the plain version, twice bit-identical. The kernel
    rounds the scores as the plain version does (one f32 FMA chain over d)
    and splits each probability exactly into three bf16 parts for P . V."""
    g = torch.Generator().manual_seed(22)
    B, S, Hq, Hkv, D = 4, 512, 16, 8, 128
    q, k, v = (torch.randn(shape, generator=g).mul(x).to(torch.bfloat16).to(dev)
               for shape, x in (((B, S, Hq, D), 2.0), ((B, S, Hkv, D), 2.0),
                                ((B, S, Hkv, D), 2.8)))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float().repeat_interleave(2, dim=2))
    assert float(s.abs().max()) / D**0.5 > 15 and float(v.float().abs().max()) > 12
    # the plain version's scores on the card are the CPU's (one FMA chain over
    # d, tests/test_torch_flash.py), which the kernel's score loop repeats
    qc, kc = q[:1].cpu().float(), k[:1].cpu().float().repeat_interleave(2, dim=2)
    assert torch.equal(s[:1].cpu(), torch.einsum("bqhd,bkhd->bhqk", qc, kc))
    a = ops.flash_mha(q, k, v, causal=True, impl="cuda")
    again = ops.flash_mha(q, k, v, causal=True, impl="cuda")
    b = ops.flash_mha(q, k, v, causal=True, impl="torch")
    assert torch.equal(a, again)
    torch.testing.assert_close(a, b, atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.parametrize("which", ["q", "k", "v", "qkv"])
@pytest.mark.parametrize("D", [16, 128])
def test_flash_mha_bf16_narrow_rows(dev, which, D):
    """Operands whose rows start 4 bytes past a 16-byte boundary take the
    kernel's 4-byte staging path: within FLASH_TOL of the plain version,
    twice bit-identical, and bit-identical to the 16-byte path on the same
    values (both stage the same bytes)."""
    g = torch.Generator().manual_seed(D)
    Hq, Hkv = (16, 8) if D == 128 else (4, 2)
    q, k, v = _flash_operands(g, dev, 2, 150, 150, Hq, Hkv, D, torch.bfloat16, "bshd")
    wide = ops.flash_mha(q, k, v, causal=True, window=70, impl="cuda")
    q2, k2, v2 = (_offset(t, 4) if name in which else t for name, t in zip("qkv", (q, k, v)))
    assert any(t.data_ptr() % 16 == 4 for t in (q2, k2, v2))
    a = ops.flash_mha(q2, k2, v2, causal=True, window=70, impl="cuda")
    again = ops.flash_mha(q2, k2, v2, causal=True, window=70, impl="cuda")
    b = ops.flash_mha(q2, k2, v2, causal=True, window=70, impl="torch")
    assert torch.equal(a, again) and torch.equal(a, wide)
    torch.testing.assert_close(a, b, atol=FLASH_TOL, rtol=FLASH_TOL)


def test_flash_mha_rows_do_not_depend_on_sq(dev):
    """A query row's bits depend on its position and the keys, not on how
    many rows the call holds: the first 100 rows of an Sq = 300 call equal an
    Sq = 100 call's (causal and windowed)."""
    g = torch.Generator().manual_seed(1)
    q, k, v = _flash_operands(g, dev, 2, 300, 300, 16, 8, 128, torch.bfloat16, "bshd")
    for window in (None, 50):
        full = ops.flash_mha(q, k, v, causal=True, window=window, impl="cuda")
        part = ops.flash_mha(q[:, :100], k, v, causal=True, window=window, impl="cuda")
        assert torch.equal(full[:, :100], part)


def test_flash_mha_refuses_what_it_cannot_take(dev):
    """A head width it is not built for, mixed dtypes, a head dim that is
    not contiguous, bf16 rows off 4-byte boundaries and a window that
    leaves query rows with no key raise (no fallback to the plain
    version)."""
    g = torch.Generator().manual_seed(2)
    q, k, v = _flash_operands(g, dev, 1, 8, 8, 2, 2, 16, torch.float32, "bshd")
    with pytest.raises(ValueError, match="head dim 24"):
        ops.flash_mha(*_flash_operands(g, dev, 1, 8, 8, 2, 1, 24, torch.float32, "bshd"),
                      impl="cuda")
    with pytest.raises(TypeError):
        ops.flash_mha(q, k.to(torch.bfloat16), v, impl="cuda")
    v_t = torch.randn((1, 8, 16, 2), generator=g).to(dev).transpose(2, 3)  # d strided
    with pytest.raises(ValueError, match="contiguous along the head dim"):
        ops.flash_mha(q, k, v_t, impl="cuda")
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    odd = _misaligned(kb)  # bf16 rows one element off a 4-byte boundary
    with pytest.raises(ValueError, match="4-byte boundaries"):
        ops.flash_mha(qb, odd, vb, impl="cuda")
    n0 = build.LAUNCHES["flash_mha"]
    with pytest.raises(ValueError, match="see no key"):
        ops.flash_mha(*_flash_operands(g, dev, 2, 300, 100, 16, 8, 128, torch.bfloat16, "bshd"),
                      causal=True, window=50, impl="cuda")
    assert build.LAUNCHES["flash_mha"] == n0


def test_forward_and_prefill_step_on_cuda_match_cpu(dev):
    """Reduced internlm2-1.8b, w4a8, kv8: ``prefill_step`` and
    ``forward(mode="serve")`` on the card launch flash_mha once a layer,
    forward's last position equals prefill_step's logits bit for bit, and
    both stay within 0.05 of the CPU run (plain versions); then six greedy
    fused decode steps from the prefilled caches, fed the CPU's tokens, stay
    within the same bound. Argmax agrees wherever the CPU's two best logits
    are more than 0.05 apart."""
    cfg = configs.reduced(configs.get_arch("internlm2-1.8b"))
    policy = get_policy("w4a8")
    params = M.init_params(torch.Generator().manual_seed(3), cfg, policy, device="cpu")
    cparams = _to(params, dev)
    toks = torch.from_numpy(np.random.RandomState(4).randint(1, cfg.vocab, size=(2, 40))
                            .astype(np.int32))
    out = {}
    for d, p in (("cpu", params), (dev, cparams)):
        caches = M.init_cache(cfg, policy, 2, 64, device=d)
        build.reset_launches()
        pre, _ = M.prefill_step(p, {"tokens": toks.to(d)}, caches, cfg, policy)
        n_pre = build.LAUNCHES["flash_mha"]
        full, _ = M.forward(p, {"tokens": toks.to(d)}, cfg, policy)
        if d == dev:
            assert n_pre == build.LAUNCHES["flash_mha"] - n_pre == cfg.n_layers
        assert torch.equal(full[:, -1:], pre)
        out[str(d)] = (pre, full, caches)

    def check(a, b, what):
        a, b = a.float().cpu(), b.float()
        assert float((a - b).abs().max()) <= 0.05, what
        top2 = b.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 0.05
        assert torch.equal(a.argmax(-1)[clear], b.argmax(-1)[clear]), what

    (pre_c, full_c, caches_c), (pre_g, full_g, caches_g) = out["cpu"], out[str(dev)]
    check(pre_g, pre_c, "prefill_step")
    check(full_g, full_c, "forward")
    logits = pre_c
    for i in range(6):
        t = logits.float().argmax(-1).to(torch.int32)
        pos = torch.full((2,), 40 + i, dtype=torch.int32)
        logits = M.decode_step(params, t, pos, caches_c, cfg, policy, fused_attn=True)
        got = M.decode_step(cparams, t.to(dev), pos.to(dev), caches_g, cfg, policy,
                            fused_attn=True)
        check(got, logits, f"decode step {i}")


# ------------------------------------------------------------- qkv_decode

#: (B, S, Hq, Hkv, D, bits, pos, bs): the reference test's shapes and pos
#: edges, then internlm2's full shape at kv8 and kv4
QKV_CASES = ([(2, 32, 2 * gqa, 2, 16, bits, pos, bs)
              for bits, gqa, pos, bs in ((8, 1, 30, 8), (8, 2, 12, 8), (4, 1, 31, 8),
                                         (8, 2, -1, 8), (4, 2, 0, 32), (8, 1, 8, 8))]
             + [(4, 1024, 16, 8, 128, bits, pos, 512) for bits in (8, 4)
                for pos in (0, 511, 1023, -1)]
             + [(3, 100, 16, 8, 128, 8, 70, 100)])  # S not a multiple of the kernel's tile


def _qkv_operands(g, dev, B, S, Hq, Hkv, D, bits):
    kq, ks = A.kv_quantize(torch.randn((B, S, Hkv, D), generator=g), bits)
    vq, vs = A.kv_quantize(torch.randn((B, S, Hkv, D), generator=g), bits)
    q = torch.randn((B, Hq, D), generator=g)
    return tuple(t.to(dev) for t in (q, kq, ks, vq, vs))


@pytest.mark.parametrize("case", QKV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_qkv_decode_kernel_vs_plain(dev, case):
    """Within QKV_TOL of the plain version, the same call twice
    bit-identical, one launch a call."""
    B, S, Hq, Hkv, D, bits, pos, bs = case
    g = torch.Generator().manual_seed(B * S + D + bits)
    q, kq, ks, vq, vs = _qkv_operands(g, dev, B, S, Hq, Hkv, D, bits)
    n0 = build.LAUNCHES["qkv_decode"]
    a = QD.qkv_decode(q, kq, ks, vq, vs, pos, bits=bits, bs=bs)
    again = QD.qkv_decode(q, kq, ks, vq, vs, pos, bits=bits, bs=bs)
    b = QD.qkv_decode_plain(q, kq, ks, vq, vs, pos, bits=bits, bs=bs)
    assert build.LAUNCHES["qkv_decode"] - n0 == 2
    assert a.dtype == torch.float32 and a.shape == q.shape
    assert torch.equal(a, again)
    torch.testing.assert_close(a, b, atol=QD.TOL, rtol=QD.TOL)


def test_qkv_decode_refuses_what_it_cannot_take(dev):
    """A head width it is not built for, a cache off 16-byte alignment and
    S % bs raise; nothing falls back to the plain version."""
    g = torch.Generator().manual_seed(5)
    q, kq, ks, vq, vs = _qkv_operands(g, dev, 2, 32, 4, 2, 32, 8)
    n0 = build.LAUNCHES["qkv_decode"]
    with pytest.raises(ValueError, match="head dim 32"):
        QD.qkv_decode(q, kq, ks, vq, vs, 3)
    q, kq, ks, vq, vs = _qkv_operands(g, dev, 2, 32, 4, 2, 16, 8)
    with pytest.raises(ValueError, match="16-byte boundary"):
        QD.qkv_decode(q, _misaligned(kq), ks, vq, vs, 3)
    with pytest.raises(ValueError, match="multiple of the key block"):
        QD.qkv_decode(q, kq, ks, vq, vs, 3, bs=12)
    assert build.LAUNCHES["qkv_decode"] == n0


# ----------------------------------------------------------------- sampler


def _cpu_near_tie(lg_row, t, k, p, seed, ctr, near=4) -> bool:
    """Replay one lane's sampling steps on the CPU: True where the two best
    perturbed scores, or some token's exclusive cumulative probability and
    ``p``, lie within ``near`` f32 ulps."""
    def ulps(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))

    lg = torch.from_numpy(lg_row) / max(float(t), 1e-6)
    order = torch.argsort(-lg, stable=True)
    kth = lg[order[min(max(k - 1, 0), lg.numel() - 1)]]
    lg = torch.where((k > 0) & (lg < kth), torch.tensor(float("-inf")), lg)
    e = torch.exp(lg - lg.max())
    sp = (e / e.sum())[order]
    excl = (torch.cumsum(sp, 0) - sp).numpy()
    if p < 1.0 and (ulps(excl, np.float32(p)) <= near).any():
        return True
    keep = torch.zeros_like(lg, dtype=torch.bool).scatter(0, order, torch.from_numpy(excl < p))
    key = prng.fold_in(prng.prng_key(int(seed)), int(ctr))
    scores = (prng.gumbel(key, lg.numel()) + torch.where(keep, lg, torch.tensor(float("-inf"))))
    a, b = np.sort(scores.numpy()[np.isfinite(scores.numpy())])[-2:]
    return bool(ulps(a, b) <= near)


@pytest.mark.parametrize("V", [1000, 92544])
def test_sampler_on_cuda_matches_cpu(dev, V):
    """seed x counter x temperature x top-k x top-p over four logit rows
    (ties included; V = 92544 is internlm2's padded vocabulary): the card's
    tokens equal the CPU's except at replayed near ties."""
    import itertools

    rng = np.random.RandomState(5)
    rows = (rng.randn(4, V) * 3).astype(np.float32)
    rows[1, :50] = rows[1].max() + 1.0
    rows[2] = np.round(rows[2])
    rows[3] = torch.from_numpy(rows[3]).to(torch.bfloat16).float().numpy()
    grid = list(itertools.product(range(4), (0, 1, 2**31, 2**32 - 1), (0, 1, 7, 2**31 - 1),
                                  (0.5, 1.0, 2.0), (0, 1, 16), (0.5, 0.95, 1.0)))
    for lo in range(0, len(grid), 1296):
        part = grid[lo:lo + 1296]
        logits = np.stack([rows[r] for r, *_ in part])
        lanes = (np.array([x[3] for x in part], np.float32), np.array([x[4] for x in part]),
                 np.array([x[5] for x in part], np.float32), np.array([x[1] for x in part]),
                 np.array([x[2] for x in part]))
        cpu = M.sample_tokens(torch.from_numpy(logits), *lanes).numpy()
        gpu = M.sample_tokens(torch.from_numpy(logits).to(dev), *lanes).cpu().numpy()
        for i in np.flatnonzero(cpu != gpu):
            r, seed, ctr, t, k, p = part[i]
            assert _cpu_near_tie(rows[r], t, k, p, seed, ctr), part[i]


def _record_top_ties(monkeypatch, eng) -> dict:
    """While ``eng`` runs, record for each token a request draws whether the
    two best logits it was drawn from tie: {(rid, index): bool}."""
    ties, orig = {}, M.sample_tokens

    def wrapped(logits, temps, *a, **kw):
        top = logits.float().topk(2, dim=-1).values.cpu()
        if logits.shape[0] == 1:  # admission: the request that has no token yet
            lanes = [next(r for r in eng.slot_req if r is not None and not r.out)]
        else:
            lanes = eng.slot_req
        for r, (a_, b_) in zip(lanes, top.tolist()):
            if r is not None:
                ties[r.rid, len(r.out)] = a_ == b_
        return orig(logits, temps, *a, **kw)

    monkeypatch.setattr(M, "sample_tokens", wrapped)
    return ties


def _parts_only_at_ties(got, greedy, ties) -> bool:
    """Each stream equals its greedy stream, or first differs at a token
    whose two best logits tie."""
    for rid, (a, b) in enumerate(zip(got, greedy)):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is not None and not ties[rid, i]:
            return False
    return True


def test_sampled_engine_on_cuda_streams_across_caches(dev, monkeypatch):
    """Reduced internlm2-1.8b, w4a8, kv8, on the card: sampled streams equal
    run to run and on the slot, paged and prefix caches; a greedy request
    beside sampled ones equals its greedy stream in an all-greedy batch;
    top-k 1 is greedy (where the two best logits tie, top-k 1 keeps both
    and may draw the other: such a step is replayed and must be a tie)."""
    cfg = configs.reduced(configs.get_arch("internlm2-1.8b"))
    policy = get_policy("w4a8")
    params = _to(M.init_params(torch.Generator().manual_seed(3), cfg, policy, device="cpu"), dev)
    rng = np.random.RandomState(2)
    shared = rng.randint(1, cfg.vocab, size=8)
    prompts = [np.concatenate([shared, rng.randint(1, cfg.vocab, size=n)]).astype(np.int32)
               for n in (3, 5, 2)] + [rng.randint(1, cfg.vocab, size=7).astype(np.int32)]

    def engine(cache):
        return ServeEngine(params, cfg, policy, n_slots=2, s_max=32, prefill_chunk=4,
                           cache=cache, page_size=4 if cache != "slot" else None, device=dev)

    def run(eng, sp):
        hs = [eng.submit(p.copy(), sp(i)) for i, p in enumerate(prompts)]
        eng.drain()
        return [h.result() for h in hs]

    def sampled(i):
        if i == 3:
            return SamplingParams(max_new=6)
        return SamplingParams(temperature=0.8, top_k=40, top_p=0.95, seed=1000 + i, max_new=6)

    build.reset_launches()
    slot = run(engine("slot"), sampled)
    assert build.LAUNCHES["mpmm"] > 0 and build.LAUNCHES["paged_attn"] > 0
    assert slot == run(engine("slot"), sampled) == run(engine("paged"), sampled) == run(
        engine("prefix"), sampled)
    geng = engine("slot")
    ties = _record_top_ties(monkeypatch, geng)
    greedy = run(geng, lambda i: SamplingParams(max_new=6))
    monkeypatch.undo()
    assert slot[3] == greedy[3] and slot[:3] != greedy[:3]
    topk1 = run(engine("paged"),
                lambda i: SamplingParams(temperature=0.8, top_k=1, seed=i, max_new=6))
    assert _parts_only_at_ties(topk1, greedy, ties)
