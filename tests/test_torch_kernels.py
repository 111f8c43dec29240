"""PyTorch port, kernel layer: the plain versions of the serving path's
kernels against the JAX reference, and the dispatch rules (conv2d and
qntpack: tests/test_torch_conv.py).

  * mpmm: bit-exact with ``repro.kernels.ref.mpmm_ref`` over 27 cells x 3
    output kinds x ``x_signed`` (integer accumulation is exact);
  * paged_scatter: bit-exact with ``paged_scatter_ref``, rows past the table
    included (the scratch page 0, which several rows may hit, is excluded);
  * paged_gather: bit-exact with ``paged_gather_ref`` and the Pallas kernel
    (interpret mode) on int8, packed int4, bf16 and f32 leaves, a page id
    past the pool included (both clamp it onto the last page);
  * paged_attn: against ``ops.paged_attn`` with ``impl="jnp"`` and with
    ``impl="pallas"`` (interpret mode) on every KV cell, atol = rtol = 1e-5:
    the reference's own fused-vs-oracle bound (tests/test_paged_attn.py),
    since float sums inside the dots are taken in another order;
  * the dense slot layout viewed as a pool is bit-exact with the pool.

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py
(marker ``gpu``) and ``python3 chip_smoke.py`` hold every kernel against its
plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import quant as RQ  # noqa: E402
from repro.core.policy import PERMUTATIONS  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels import tuning  # noqa: E402
from repro.kernels.paged_gather import paged_gather_pallas  # noqa: E402
from repro.kernels.paged_gather import paged_gather_ref as jax_gather  # noqa: E402
from repro.kernels.paged_gather import paged_scatter_ref as jax_scatter  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.kernels import build, dispatch, ops  # noqa: E402
from repro_torch.kernels.paged_gather import paged_gather_ref, paged_scatter_ref  # noqa: E402
from repro_torch.kernels.ref import mpmm_ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _packed_operands(rng, M, N, K, xb, wb):
    x = rng.randint(0, 1 << xb, size=(M, K)).astype(np.uint8)
    w = rng.randint(-(1 << (wb - 1)), 1 << (wb - 1), size=(N, K)).astype(np.int8)
    from repro.core import pack as RP

    return (np.array(RP.pack(jnp.asarray(x), xb), copy=True),
            np.array(RP.pack(jnp.asarray(w), wb), copy=True))


@pytest.mark.parametrize("cell", PERMUTATIONS, ids=lambda c: "x{}w{}y{}".format(*c))
def test_mpmm_ref_bit_exact_all_cells(cell):
    xb, wb, yb = cell
    rng = np.random.RandomState(sum(cell))
    M, N, K = 5, 24, 64
    x_p, w_p = _packed_operands(rng, M, N, K, xb, wb)
    kw = dict(y_bits=yb, eps_phi=2.0**-9, eps_y=1.0, lam=3.0)
    rq_r, rq_t = RQ.make_requant_params(**kw), TQ.make_requant_params(**kw)
    scale = np.float32(0.0123)
    for kind in ("packed", "int32", "f32"):
        for signed in (False, True):
            ref = rref.mpmm_ref(jnp.asarray(x_p), jnp.asarray(w_p), rq_r, x_bits=xb, w_bits=wb,
                                y_bits=yb, x_signed=signed, out_kind=kind,
                                out_scale=jnp.float32(scale))
            got = mpmm_ref(torch.from_numpy(x_p), torch.from_numpy(w_p), rq_t, x_bits=xb,
                           w_bits=wb, y_bits=yb, x_signed=signed, out_kind=kind,
                           out_scale=torch.tensor(scale))
            assert str(got.dtype).split(".")[-1] == str(np.asarray(ref).dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
            # the public entry point routes CPU tensors to the plain version
            via_ops = ops.mpmm(torch.from_numpy(x_p), torch.from_numpy(w_p), rq_t, x_bits=xb,
                               w_bits=wb, y_bits=yb, x_signed=signed, out_kind=kind,
                               out_scale=torch.tensor(scale))
            assert torch.equal(via_ops, got)


def _gqa_case(seed, bits, B=2, S=32, HQ=4, HKV=2, D=16):
    ks = jax.random.split(jax.random.key(seed), 3)
    q = jax.random.normal(ks[0], (B, HQ, D), jnp.float32)
    kf = jax.random.normal(ks[1], (B, S, HKV, D), jnp.bfloat16)
    vf = jax.random.normal(ks[2], (B, S, HKV, D), jnp.bfloat16)
    pos = jnp.array([13, S - 1], jnp.int32)
    kq, k_s = RA.kv_quantize(kf, bits)
    vq, v_s = RA.kv_quantize(vf, bits)
    return q, kq, k_s, vq, v_s, pos


def _t(a):
    return None if a is None else bridge.to_tensor(np.asarray(a), device="cpu")


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_paged_attn_plain_vs_reference(bits, window, impl):
    q, kq, k_s, vq, v_s, pos = _gqa_case(7 + (bits or 0), bits)
    ref = np.asarray(rops.paged_attn(q, kq, k_s, vq, v_s, pos, bits=bits, window=window,
                                     impl=impl))
    got = ops.paged_attn(_t(q), _t(kq), _t(k_s), _t(vq), _t(v_s), _t(pos), bits=bits,
                         window=window)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_paged_attn_dense_vs_pool_bit_exact(bits):
    """The dense slot layout IS the paged layout with an identity block
    table: at bs == page_size the two calls are bit-identical."""
    q, kq, k_s, vq, v_s, pos = (_t(a) for a in _gqa_case(11 + (bits or 0), bits))
    B, S, ps = 2, 32, 16
    nb = S // ps
    pool = lambda a: None if a is None else a.reshape(B * nb, ps, *a.shape[2:])  # noqa: E731
    bt = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    dense = ops.paged_attn(q, kq, k_s, vq, v_s, pos, bits=bits, bs=ps)
    paged = ops.paged_attn(q, pool(kq), pool(k_s), pool(vq), pool(v_s), pos, bits=bits,
                           block_table=bt)
    assert torch.equal(dense, paged)


def test_slot_view_block_size_is_16_on_both_sides():
    """The reference resolves the slot view's block size through its tuning
    cache; at the serving fixture's shape it is the static 16, as in the
    port."""
    S, HQ, D = 32, 4, 16
    t = tuning.resolve_tiles("paged_attn", perm=tuning.perm_key(w_bits=8),
                             shape=tuning.shape_key(S, HQ, D), overrides={"bs": None})
    assert rops._snap_divisor(t["bs"], S) == 16
    assert ops._snap_divisor(ops.PAGED_ATTN_BS, S) == 16


@pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("s_new", [1, 5])
def test_paged_scatter_plain_vs_reference(dtype, s_new):
    rng = np.random.RandomState(s_new)
    P_, ps, F, B, nb = 9, 4, 6, 3, 2
    jdt = {"int8": jnp.int8, "float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    pool = jnp.asarray(rng.randint(-50, 50, size=(P_, ps, 2, F // 2))).astype(jdt)
    new = jnp.asarray(rng.randint(-50, 50, size=(B, s_new, 2, F // 2))).astype(jdt)
    bt = jnp.asarray(np.array([[3, 5], [1, 0], [7, 2]], np.int32))  # slot 1: unallocated block
    pos = jnp.asarray(np.array([2, 3, 6], np.int32))  # slot 2's tail runs past its table
    ref = np.asarray(jax_scatter(pool, new, pos, bt)).astype(np.float32)
    got = paged_scatter_ref(_t(pool), _t(new), _t(pos), _t(bt))
    got_np = bridge.to_numpy(got).astype(np.float32)
    np.testing.assert_array_equal(got_np[1:], ref[1:])  # page 0 is scratch
    via_ops = ops.paged_scatter(_t(pool), _t(new), _t(pos), _t(bt))
    np.testing.assert_array_equal(bridge.to_numpy(via_ops).astype(np.float32)[1:], ref[1:])


def _gather_pool(rng, leaf, P_, ps):
    """A page pool of one cache leaf: (P, ps, Hkv, D/r) values, or (P, ps,
    Hkv) f32 scales."""
    if leaf == "int8":
        return jnp.asarray(rng.randint(-128, 128, size=(P_, ps, 2, 8)).astype(np.int8))
    if leaf == "int4":  # two signed nibbles per byte, as kv_quantize packs them
        from repro.core import pack as RP

        q = rng.randint(-8, 8, size=(P_, ps, 2, 8)).astype(np.int8)
        return RP.pack(jnp.asarray(q), 4)
    if leaf == "bf16":
        return jnp.asarray(rng.randn(P_, ps, 2, 8)).astype(jnp.bfloat16)
    return jnp.asarray(rng.rand(P_, ps, 2).astype(np.float32))


@pytest.mark.parametrize("leaf", ["int8", "int4", "bf16", "f32"])
def test_paged_gather_plain_vs_reference(leaf):
    rng = np.random.RandomState(len(leaf))
    P_, ps = 7, 4
    pool = _gather_pool(rng, leaf, P_, ps)
    # slot 1's second entry is past the pool: the twins clamp it to page P-1
    bt = jnp.asarray(np.array([[3, 5, 0], [6, P_ + 2, 1]], np.int32))
    ref = np.asarray(jax_gather(pool, bt))
    np.testing.assert_array_equal(np.asarray(paged_gather_pallas(pool, bt)), ref)
    got = paged_gather_ref(_t(pool), _t(bt))
    assert tuple(got.shape) == ref.shape == (2, 3 * ps, *pool.shape[2:])
    np.testing.assert_array_equal(bridge.to_numpy(got), ref)
    np.testing.assert_array_equal(bridge.to_numpy(got[1, ps:2 * ps]), np.asarray(pool[P_ - 1]))
    assert torch.equal(ops.paged_gather(_t(pool), _t(bt)), got)


def test_paged_gather_negative_ids_follow_the_jnp_twin():
    """``pool[block_table]`` counts a negative id from the end, then clamps
    (the Pallas twin would clamp -1 to page 0; the engine writes neither)."""
    pool = jnp.arange(5 * 2 * 3, dtype=jnp.float32).reshape(5, 2, 3)
    bt = jnp.asarray(np.array([[-1, -7, 2]], np.int32))
    ref = np.asarray(jax_gather(pool, bt))
    got = paged_gather_ref(_t(pool), _t(bt))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got[0, :2].numpy(), np.asarray(pool[4]))
    np.testing.assert_array_equal(got[0, 2:4].numpy(), np.asarray(pool[0]))


def test_dispatch_auto_follows_the_device():
    assert dispatch.resolve_impl("auto", torch.device("cpu")) == "torch"
    assert dispatch.resolve_impl("auto", torch.device("cuda", 0)) == "cuda"
    assert dispatch.resolve_impl("torch", torch.device("cuda", 0)) == "torch"
    with pytest.raises(ValueError):
        dispatch.resolve_impl("cuda", torch.device("cpu"))
    with pytest.raises(ValueError):
        ops.mpmm(torch.zeros((1, 4), dtype=torch.int8), torch.zeros((2, 4), dtype=torch.int8),
                 None, x_bits=8, w_bits=8, y_bits=8, impl="cuda")


def test_dispatch_registry_covers_the_port_and_counts():
    assert len(dispatch.coverage("mpmm", "cuda")) == 27
    assert len(dispatch.coverage("mpmm", "torch")) == 27
    assert {c[1] for c in dispatch.coverage("paged_attn", "cuda")} == {None, 8, 4}
    dispatch.validate_coverage()
    key = dispatch.KernelKey("paged_scatter", None, None, None, "torch")
    before = dispatch.DISPATCH_COUNTS[key]
    pool = torch.zeros((3, 2, 4))
    ops.paged_scatter(pool, torch.ones((1, 1, 4)), torch.tensor([1], dtype=torch.int32),
                      torch.tensor([[2]], dtype=torch.int32))
    assert dispatch.DISPATCH_COUNTS[key] == before + 1
    assert pool[2, 1].tolist() == [1.0] * 4 and pool[:2].abs().sum() == 0
    # the plain versions never count as kernel launches
    assert build.LAUNCHES["paged_scatter"] == 0


def test_weight_only_policy_is_refused_up_front():
    from repro_torch.core.policy import LayerPrecision, PrecisionPolicy

    wo = PrecisionPolicy(name="w4only", default=LayerPrecision(None, 4, None))
    with pytest.raises(KeyError):
        dispatch.ensure_policy_supported(wo)


def test_dispatch_covers_conv_qntpack_and_gather():
    """conv2d on all 27 cells, qntpack on every output width, paged_gather
    as one cell, on both implementations; a missing cell fails the gate."""
    for impl in dispatch.IMPLS:
        assert dispatch.coverage("conv2d", impl) == set(PERMUTATIONS)
        assert {c[2] for c in dispatch.coverage("qntpack", impl)} == {8, 4, 2}
        assert dispatch.coverage("paged_gather", impl) == {(None, None, None)}
    key = dispatch.KernelKey("paged_gather", None, None, None, "cuda")
    entry = dispatch._REGISTRY.pop(key)
    try:
        with pytest.raises(RuntimeError, match="paged_gather@cuda"):
            dispatch.validate_coverage()
    finally:
        dispatch._REGISTRY[key] = entry
    dispatch.validate_coverage()
    assert dispatch.lookup("conv2d", device=torch.device("cuda", 0), x_bits=2, w_bits=8,
                           y_bits=4).name == "conv3x3_u2_i8_u4"
    assert dispatch.lookup("qntpack", device=torch.device("cpu"), y_bits=2).name == \
        "qntpack_u2_ref"
