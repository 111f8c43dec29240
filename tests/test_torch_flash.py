"""PyTorch port, whole-sequence attention: the plain ``flash_mha_ref``
against the reference's Pallas kernel (interpret mode) and pure-JAX
``flash_attention``, then ``forward(mode="serve")`` and ``prefill_step`` on
``reduced(internlm2-1.8b)`` under w4a8 with an 8-bit KV cache against the
reference run op by op (``jax.disable_jit()``). No GPU needed: on CPU
tensors the wrapper runs the plain version.

Tolerances and why:
  * ``flash_mha_ref`` vs ``flash_mha_pallas`` and vs the reference's
    ``flash_attention``: atol = rtol = 1e-5 (``kernels/flash.py`` ``TOL``).
    The scores are bit-equal (both sum q . k in one f32 chain over d), but
    XLA's CPU ``exp`` differs from PyTorch's in the last f32 bits on about
    one value in ten, and the row sums and the P . V product sum in another
    order (ROADMAP Queue 3 item 4); the outputs stay within a few f32 ulps;
  * the model: logits, every cache byte and 8 greedy decode steps
    bit-identical to the reference op by op. The attention output is cast to
    bf16 before the output projection, which absorbs the f32 ulps above on
    these fixtures; where a fixture would part, a bf16 step is the most one
    attention value could move.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.kernels.flash import flash_mha_pallas  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.kernels.flash import TOL  # noqa: E402
from repro_torch.kernels.ref import BIG_NEG, flash_mha_ref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TINY = configs.reduced(configs.get_arch("internlm2-1.8b"))
TTINY = tconfigs.reduced(tconfigs.get_arch("internlm2-1.8b"))
POLICY = get_policy("w4a8")
TPOLICY = tget_policy("w4a8")
B, S, S_MAX, N_DECODE = 2, 11, 32, 8


def _qkv(seed, Bq, Sq, Sk, Hkv, gqa, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(Bq, Sq, Hkv * gqa, D).astype(np.float32),
            rng.randn(Bq, Sk, Hkv, D).astype(np.float32),
            rng.randn(Bq, Sk, Hkv, D).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------ (a) the kernel


@pytest.mark.parametrize("causal,window,gqa,bq,bk,Sq,Sk", [
    (True, None, 1, 8, 8, 35, 35),
    (True, None, 2, 8, 16, 35, 35),
    (False, None, 1, 16, 8, 35, 35),
    (True, 10, 1, 8, 8, 35, 35),
    (True, None, 2, 8, 16, 20, 47),  # ragged: Sq != Sk, neither a block multiple
    (True, 11, 1, 8, 8, 40, 30),  # Sq = Sk + window - 1: the last row sees one key
    (False, 11, 1, 8, 8, 40, 30),  # the same without causality
], ids=["causal", "gqa2", "full", "window10", "ragged", "window_edge", "full_window_edge"])
def test_flash_mha_ref_matches_pallas_kernel(causal, window, gqa, bq, bk, Sq, Sk):
    """The plain version against ``flash_mha_pallas`` in interpret mode on
    the reference test's shapes (tests/test_ssm_attn.py) and a ragged case;
    ``ops.flash_mha`` on CPU tensors is the plain version."""
    q, k, v = _qkv(7, 2, Sq, Sk, 2, gqa, 16)
    want = np.asarray(flash_mha_pallas(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)),
        causal=causal, window=window, bq=bq, bk=bk, interpret=True)).transpose(0, 2, 1, 3)
    got = flash_mha_ref(*_t(q, k, v), causal=causal, window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert torch.equal(ops.flash_mha(*_t(q, k, v), causal=causal, window=window), got)


def test_flash_mha_dispatch_cells_and_refusals():
    """One flash_mha cell per implementation, inside the import-time
    coverage gate; ``impl='cuda'`` on CPU tensors and a value head that
    differs from the key's are refused."""
    for impl in dispatch.IMPLS:
        assert dispatch.coverage("flash_mha", impl) == {(None, None, None)}
    key = dispatch.KernelKey("flash_mha", None, None, None, "cuda")
    entry = dispatch._REGISTRY.pop(key)
    try:
        with pytest.raises(RuntimeError, match="flash_mha@cuda"):
            dispatch.validate_coverage()
    finally:
        dispatch._REGISTRY[key] = entry
    dispatch.validate_coverage()
    q, k, v = _t(*_qkv(1, 1, 4, 4, 1, 1, 16))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.flash_mha(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_mha(q, k, v[..., :8])


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (300, 100, True, 50), (40, 30, False, 10), (8, 8, True, 0),
], ids=["causal", "full", "window0"])
def test_flash_mha_refuses_rows_that_see_no_key(Sq, Sk, causal, window):
    """A window that leaves a query row with no visible key (Sq >= Sk +
    window, or window < 1) is refused by the plain version and the op: what
    such a row returns is not defined (the reference's CPU path and its
    Pallas kernel disagree). The window_edge cases above take the largest
    Sq a window allows."""
    q, k, v = _t(*_qkv(2, 1, Sq, Sk, 1, 1, 16))
    with pytest.raises(ValueError, match="see no key"):
        flash_mha_ref(q, k, v, causal=causal, window=window)
    with pytest.raises(ValueError, match="see no key"):
        ops.flash_mha(q, k, v, causal=causal, window=window)


# ------------------------------------------- (a2) the bf16 kernel's arithmetic


def _kernel_emulation(q, k, v, *, causal=True, window=None, parts=3):
    """The CUDA kernel's arithmetic on bf16 operands, in torch on the CPU:
    the scores as the plain version rounds them (one f32 FMA chain over d,
    then * scale), a running softmax over tiles of 64 keys, and P . V per
    tile as the kernel's tensor-core products take it: each f32 p split
    into bf16 hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid)
    (``parts=2`` keeps mid and hi), every product with the bf16 v formed in
    f32 (exact), summed per 16 keys and added to the tile's f32 accumulator
    in the fixed order lo, mid, hi; then acc = acc * alpha + pv. Returns
    the output (B, Sq, Hq, D) and the largest |pv - exact| / (2^-20 * sum p
    |v|) over every tile's accumulator (exact: the same p and v in f64)."""
    B, Sq, Hq, D = q.shape
    Sk, G = k.shape[1], Hq // k.shape[2]
    kr, vr = (t.float().repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * (1.0 / D**0.5)
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None]
    valid = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        valid &= kpos <= qpos
    if window is not None:
        valid &= qpos - kpos < window
    s = torch.where(valid, s, torch.tensor(BIG_NEG))
    vt = vr.transpose(1, 2)
    m = torch.full((B, Hq, Sq), BIG_NEG)
    l = torch.zeros(B, Hq, Sq)
    acc = torch.zeros(B, Hq, Sq, D)
    worst = 0.0
    for k0 in range(0, Sk, 64):
        st, vj = s[..., k0:k0 + 64], vt[:, :, k0:k0 + 64]
        mx = torch.maximum(m, st.amax(-1))
        p = torch.exp(st - mx[..., None])
        alpha = torch.exp(m - mx)
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        mid = (p - hi).bfloat16().float()
        lo = (p - hi - mid).bfloat16().float()
        pv = torch.zeros_like(acc)
        for c0 in range(0, st.shape[-1], 16):
            for x in ((lo, mid, hi) if parts == 3 else (mid, hi)):
                pv = pv + x[..., c0:c0 + 16] @ vj[..., c0:c0 + 16, :]
        exact = p.double() @ vj.double()
        bound = 2.0**-20 * (p.double() @ vj.double().abs())
        seen = bound > 0
        worst = max(worst, float(((pv.double() - exact).abs()[seen] / bound[seen]).max()))
        acc = acc * alpha[..., None] + pv
        m = mx
    return (acc / l.clamp(min=1e-30)[..., None]).transpose(1, 2), worst


def _model_scale(seed, B, S, Hq, Hkv, D=128):
    """bf16 q, k and v at the sizes internlm2's own layers give flash_mha
    at full width: scores up to about +-20, |v| up to about 14."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, S, h, D).astype(np.float32) * x).to(torch.bfloat16)
            for h, x in ((Hq, 2.0), (Hkv, 2.0), (Hkv, 2.8))]


def _over_tol(a, b):
    """The largest |a - b| / (TOL * (1 + |b|)): at most 1 within atol = rtol = TOL."""
    return float(((a.double() - b.double()).abs() / (TOL * (1 + b.double().abs()))).max())


@pytest.mark.parametrize("causal,window,gqa,Sq,Sk", [
    (True, None, 1, 35, 35), (True, None, 2, 35, 35), (False, None, 1, 35, 35),
    (True, 10, 1, 35, 35), (True, None, 2, 20, 47), (True, 11, 1, 40, 30),
    (False, 11, 1, 40, 30),
], ids=["causal", "gqa2", "full", "window10", "ragged", "window_edge", "full_window_edge"])
def test_kernel_pv_split_matches_plain_reduced(causal, window, gqa, Sq, Sk):
    """The kernel's P . V arithmetic (three bf16 parts a probability) on
    bf16 operands at the reference test's widths: within TOL of
    ``flash_mha_ref``, and every tile's accumulator within 2^-20 * sum p|v|
    of the exact sum."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(7, 2, Sq, Sk, 2, gqa, 16))
    want = flash_mha_ref(q, k, v, causal=causal, window=window)
    got, worst = _kernel_emulation(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    assert worst <= 1.0


def test_kernel_pv_split_at_model_scale():
    """At the model's scale (B 2, S 512, 8 / 4 heads, D 128, scores up to
    ~20, |v| up to ~14) three parts keep the output within TOL of the plain
    version and each tile's accumulator within 2^-20 * sum p|v| of the
    exact sum. Two parts (hi and mid) drop up to 2^-16 of each term: the
    accumulators pass that bound and the output parts from the plain
    version by more than TOL. Hence three."""
    q, k, v = _model_scale(0, 2, 512, 8, 4)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float().repeat_interleave(2, dim=2))
    assert 18 < float(s.abs().max()) / 128**0.5 < 24 and 12 < float(v.float().abs().max()) < 16
    want = flash_mha_ref(q, k, v, causal=True)
    got, worst = _kernel_emulation(q, k, v)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    assert worst <= 1.0
    got2, worst2 = _kernel_emulation(q, k, v, parts=2)
    assert worst2 > 1.0 and _over_tol(got2, want) > 1.0


def test_scores_must_round_as_the_plain_version_does():
    """Why the kernel's q . k is an f32 FMA chain over d and not a bf16
    tensor-core product. The plain version's einsum is that chain, bit for
    bit. At the model's scale (internlm2's full shape, 4 x 512, 16 / 8
    heads), with the softmax and P . V exact (f64) on top: the chain's
    scores stay within a third of TOL of the plain version; scores summed
    16 products at a time and rounded to f32 once a step (what an m16n8k16
    product at best does, its sums rounded to nearest) part from it by more
    than TOL: an ulp of a score at |s| ~ 20 moves an output by about TOL."""
    q, k, v = _model_scale(1, 4, 512, 16, 8)
    B, S, Hq, D = q.shape
    kr = k.double().repeat_interleave(2, dim=2)
    chain = torch.zeros(1, 2, S, S)
    for d in range(D):  # f32 FMA chain: the f64 product is exact, one rounding a step
        chain = (chain.double() + q[:1, :, :2, d].double().transpose(1, 2)[..., None]
                 * kr[:1, :, :2, d].transpose(1, 2)[..., None, :]).float()
    plain_s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float())
    assert torch.equal(plain_s[:1, :2], chain)
    tiled = torch.zeros(B, Hq, S, S)
    for d0 in range(0, D, 16):
        tiled = (tiled.double() + torch.einsum("bqhd,bkhd->bhqk", q[..., d0:d0 + 16].double(),
                                               kr[..., d0:d0 + 16])).float()
    causal = torch.arange(S)[None] <= torch.arange(S)[:, None]

    def attend(scores):  # exact softmax and P . V over f32 scores
        s = torch.where(causal, (scores * (1.0 / D**0.5)).double(), float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                            v.double().repeat_interleave(2, dim=2))

    want = flash_mha_ref(q, k, v, causal=True)
    assert _over_tol(attend(plain_s), want) < 1 / 3
    assert _over_tol(attend(tiled), want) > 1.0


# ------------------------------------------------ (b) the attention function


@pytest.mark.parametrize("causal,window,gqa,chunk", [
    (True, None, 1, 512), (True, None, 3, 512), (False, None, 1, 512), (True, 7, 1, 512),
    (True, None, 3, 16),
], ids=["causal", "gqa3", "full", "window7", "gqa3-chunk16"])
def test_flash_attention_matches_reference(causal, window, gqa, chunk):
    """The plain version (f32) against the reference's pure-JAX
    ``flash_attention`` on tests/test_ssm_attn.py's shapes (B 2, S 37, Hkv 2,
    D 16), the reference at its default chunks of 512 or at chunks of 16
    (three and a ragged one; the port's order stays that of 512), within
    TOL; the port's ``flash_attention`` (bf16 in, bf16 out, as the model
    calls it) bit-identical to the reference's at its defaults."""
    q, k, v = _qkv(3, 2, 37, 37, 2, gqa, 16)
    with jax.disable_jit():
        want = np.asarray(RA.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
            q_chunk=chunk, kv_chunk=chunk))
    got = flash_mha_ref(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    with jax.disable_jit():
        want_b = RA.flash_attention(qb, kb, vb, causal=causal, window=window)
    got_b = TA.flash_attention(*(bridge.to_tensor(np.asarray(a), device="cpu")
                                 for a in (qb, kb, vb)), causal=causal, window=window)
    assert got_b.dtype == torch.bfloat16
    # the cast to bf16 absorbs the f32 ulps above on this fixture
    np.testing.assert_array_equal(got_b.float().numpy(), np.asarray(want_b, np.float32))


def test_flash_attention_refuses_a_narrower_value_head():
    """The reference's CPU path takes d_v != d (MLA's 128 against 192);
    flash_mha_pallas, and so the port's kernel and its plain version, do not."""
    rng = np.random.RandomState(4)
    q = rng.randn(1, 12, 2, 24).astype(np.float32)
    k = rng.randn(1, 12, 2, 24).astype(np.float32)
    v = rng.randn(1, 12, 2, 16).astype(np.float32)
    assert RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)).shape == \
        (1, 12, 2, 16)
    with pytest.raises(ValueError, match="head dim"):
        TA.flash_attention(*_t(q, k, v))


# ------------------------------------------------------------- (c) the model


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    jp = RM.init_params(jax.random.key(3), TINY, POLICY, mode="serve")
    return jp, bridge.params_from_reference(_np(jp), device="cpu")


@pytest.fixture(scope="module")
def tokens():
    return np.random.RandomState(17).randint(1, TINY.vocab, size=(B, S)).astype(np.int32)


def test_forward_serve_matches_reference(params, tokens):
    """Whole-sequence scoring: logits (B, S, V) bit-identical to the
    reference's ``forward(mode="serve")`` op by op, and the aux the same."""
    jp, tp = params
    with jax.disable_jit():
        ref, raux = RM.forward(jp, {"tokens": jnp.asarray(tokens)}, TINY, POLICY, mode="serve",
                               impl="jnp")
    got, aux = TM.forward(tp, {"tokens": torch.from_numpy(tokens)}, TTINY, TPOLICY, mode="serve")
    assert tuple(got.shape) == (B, S, TINY.vocab_padded) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(ref))
    assert float(aux["moe_aux"]) == float(raux["moe_aux"]) == 0.0
    with pytest.raises(NotImplementedError, match="serve mode"):
        TM.forward(tp, {"tokens": torch.from_numpy(tokens)}, TTINY, TPOLICY, mode="train")


def test_prefill_step_then_greedy_decode_matches_reference(params, tokens):
    """Whole-prompt prefill into the dense slot cache: last-token logits and
    every cache byte bit-identical to the reference's ``prefill_step`` op by
    op, and equal to the last position of ``forward`` (the reference's own
    difference is 0.0 too); then N_DECODE greedy fused decode steps from
    that cache, logits bit-identical at every step."""
    jp, tp = params
    jc = RM.init_cache(TINY, POLICY, B, S_MAX)
    tc = TM.init_cache(TTINY, TPOLICY, B, S_MAX, device="cpu")
    with jax.disable_jit():
        ref, jc = RM.prefill_step(jp, {"tokens": jnp.asarray(tokens)}, jc, TINY, POLICY,
                                  impl="jnp")
        ref_fwd, _ = RM.forward(jp, {"tokens": jnp.asarray(tokens)}, TINY, POLICY,
                                mode="serve", impl="jnp")
    got, tc2 = TM.prefill_step(tp, {"tokens": torch.from_numpy(tokens)}, tc, TTINY, TPOLICY)
    assert tc2 is tc
    assert tuple(got.shape) == (B, 1, TINY.vocab_padded) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(ref))
    np.testing.assert_array_equal(_f32(ref_fwd)[:, -1:], _f32(ref))
    fwd, _ = TM.forward(tp, {"tokens": torch.from_numpy(tokens)}, TTINY, TPOLICY)
    assert torch.equal(fwd[:, -1:], got)
    want = bridge.caches_to_numpy(bridge.caches_from_reference(_np(jc), device="cpu"))
    for r, g in zip(want, bridge.caches_to_numpy(tc), strict=True):
        assert sorted(r) == sorted(g)
        for name in r:
            np.testing.assert_array_equal(g[name].view(np.uint8), r[name].view(np.uint8),
                                          err_msg=name)
    toks = np.asarray(_f32(got).argmax(-1)).astype(np.int32)
    for i in range(N_DECODE):
        pv = np.full((B,), S + i, np.int32)
        with jax.disable_jit():
            ref, jc = RM.decode_step(jp, jnp.asarray(toks), jnp.asarray(pv), jc, TINY, POLICY,
                                     impl="jnp", fused_attn=True)
        got = TM.decode_step(tp, torch.from_numpy(toks), torch.from_numpy(pv), tc, TTINY,
                             TPOLICY, fused_attn=True)
        np.testing.assert_array_equal(_f32(got), _f32(ref), err_msg=f"decode step {i}")
        toks = np.asarray(_f32(got).argmax(-1)).astype(np.int32)


# ---------------------------------------------------------- (d) what raises


def test_whole_sequence_prefill_over_a_paged_cache_raises(params):
    """A paged cache with S > 1 outside ``attend_cached``: both the
    reference's ``attn_apply`` and the port's refuse it."""
    jp, tp = params
    x = np.random.RandomState(2).randn(1, 4, TINY.d_model).astype(np.float32)
    pos = np.arange(4, dtype=np.int32)[None]
    bt = np.array([[1, 2]], np.int32)
    jc = RM.init_paged_cache(TINY, POLICY, 3, 16)
    tc = TM.init_paged_cache(TTINY, TPOLICY, 3, 16, device="cpu")
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    with pytest.raises(NotImplementedError, match="paged cache"):
        RA.attn_apply(jblk["attn"], jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
                      TINY.attn_cfg, POLICY, mode="serve", impl="jnp",
                      cache=jax.tree.map(lambda a: a[0], jc[0]["self"]),
                      cache_pos=jnp.int32(0), block_table=jnp.asarray(bt))
    with pytest.raises(NotImplementedError, match="paged cache"):
        TA.attn_apply(tp["layers"][0]["attn"], torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(pos), TTINY.attn_cfg, TPOLICY, cache=tc[0],
                      cache_pos=0, block_table=torch.from_numpy(bt))


def test_whole_sequence_mla_raises():
    """DeepSeek-V3's MLA layers: ``forward`` and ``prefill_step`` raise,
    naming the value head that differs from the query/key head."""
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch("deepseek-v3-671b")),
                              dense_layers=2)
    p = TM.init_params(torch.Generator().manual_seed(0), cfg, TPOLICY, device="cpu")
    toks = {"tokens": torch.ones((1, 5), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="d_v = 16"):
        TM.forward(p, toks, cfg, TPOLICY)
    caches = TM.init_cache(cfg, TPOLICY, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="d_v = 16"):
        TM.prefill_step(p, toks, caches, cfg, TPOLICY)
