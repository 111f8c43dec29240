"""PyTorch port on the card (marker ``gpu``): each hand-written CUDA kernel
against its plain PyTorch version, and the serving engine on CUDA against
the same engine on the CPU. These tests skip on a host without CUDA; on the
card run ``python -m pytest -m gpu tests/test_torch_gpu.py``. The file
imports no JAX, so it runs where only PyTorch is installed.

Tolerances: mpmm, conv2d and qntpack are integer kernels and paged_gather
and paged_scatter copy kernels, all bit-exact;
paged_attn and paged_mla_attn follow the plain version's page-blocked
softmax but sum inside their dots in another order, so atol = rtol = 1e-5
(the reference's own fused-vs-twin bound).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core import pack as P  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.core.policy import PERMUTATIONS, get_policy  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.ref import conv2d_ref, im2col  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

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


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("window", [None, 8])
def test_paged_attn_kernel_vs_plain(dev, bits, window):
    g = torch.Generator().manual_seed(3)
    B, S, HQ, HKV, D, ps = 3, 48, 8, 2, 64, 16
    q = torch.randn((B, HQ, D), generator=g).to(dev)
    kq, ks = A.kv_quantize(torch.randn((B, S, HKV, D), generator=g).to(dev), bits)
    vq, vs = A.kv_quantize(torch.randn((B, S, HKV, D), generator=g).to(dev), bits)
    pos = torch.tensor([0, 21, S - 1], dtype=torch.int32, device=dev)
    a = ops.paged_attn(q, kq, ks, vq, vs, pos, bits=bits, window=window, impl="cuda", bs=ps)
    b = ops.paged_attn(q, kq, ks, vq, vs, pos, bits=bits, window=window, impl="torch", bs=ps)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_paged_mla_attn_kernel_vs_plain(dev, bits):
    """H = 18 heads (a partial group of the kernel's 4 per block), a
    shuffled block table, slot 0 with its last pages masked and slot 1
    mid-page; then the dense slot layout through the identity-table view.
    Latent rows that are not whole 16-byte vectors are refused."""
    g = torch.Generator().manual_seed(5)
    B, H, C, dr, ps, nb = 3, 18, 64, 16, 16, 4
    P_ = B * nb + 1
    q_lat = torch.randn((B, H, C), generator=g).to(dev)
    q_rope = torch.randn((B, H, dr), generator=g).to(dev)
    cq, cs = A.kv_quantize(torch.randn((P_, ps, 1, C), generator=g).to(dev), bits)
    r = torch.randn((P_, ps, 1, dr), generator=g).to(torch.bfloat16).to(dev)
    bt = (torch.randperm(P_ - 1, generator=g)[: B * nb] + 1).reshape(B, nb).to(torch.int32)
    bt = bt.to(dev)
    pos = torch.tensor([5, 37, nb * ps - 1], dtype=torch.int32, device=dev)
    kw = dict(bits=bits, scale=1.0 / (C + dr) ** 0.5)
    a = ops.paged_mla_attn(q_lat, q_rope, cq, cs, r, pos, block_table=bt, impl="cuda", **kw)
    b = ops.paged_mla_attn(q_lat, q_rope, cq, cs, r, pos, block_table=bt, impl="torch", **kw)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)

    def dense(x):
        return None if x is None else x[bt.long()].reshape(B, nb * ps, *x.shape[2:])

    a = ops.paged_mla_attn(q_lat, q_rope, dense(cq), dense(cs), dense(r), pos, impl="cuda", **kw)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert build.LAUNCHES["paged_mla_attn"] > 0
    if bits == 4:  # 16 int4 values are 8 bytes: half a vector
        with pytest.raises(ValueError, match="16-byte"):
            ops.paged_mla_attn(q_lat[..., :16].contiguous(), q_rope, cq[..., :8].contiguous(),
                               cs, r, pos, block_table=bt, impl="cuda", **kw)


def test_mla_engine_slot_and_paged_streams_identical(dev):
    """Reduced DeepSeek-V3 (two MLA-dense layers), w4a8, kv8, on the card:
    greedy streams identical on slot and paged caches, fused (through
    paged_mla_attn) and unfused (paged: through paged_gather)."""
    cfg = dataclasses.replace(configs.reduced(configs.get_arch("deepseek-v3-671b")),
                              dense_layers=2)
    policy = get_policy("w4a8")
    params = _to(M.init_params(torch.Generator().manual_seed(3), cfg, policy, device="cpu"), dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, size=n).astype(np.int32) for n in (3, 9, 5, 2, 7)]
    outs = {}
    for fused in (True, False):
        for cache in ("slot", "paged"):
            build.reset_launches()
            eng = ServeEngine(params, cfg, policy, n_slots=2, s_max=32, prefill_chunk=4,
                              cache=cache, page_size=16 if cache == "paged" else None,
                              fused_attn=fused, device=dev)
            outs[fused, cache] = eng.run(
                [Request(rid=i, prompt=pr, max_new=6) for i, pr in enumerate(prompts)])
            assert build.LAUNCHES["mpmm"] > 0
            assert (build.LAUNCHES["paged_mla_attn"] > 0) == fused
            assert (build.LAUNCHES["paged_scatter"] > 0) == (cache == "paged")
            assert (build.LAUNCHES["paged_gather"] > 0) == (cache == "paged" and not fused)
        assert outs[fused, "slot"] == outs[fused, "paged"]
        assert all(len(t) == 6 for t in outs[fused, "slot"].values())


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
