"""PyTorch port, model layer: ``reduced(internlm2-1.8b)`` under w4a8 with an
8-bit KV cache, same weights through the bridge, against the JAX reference.

Tolerances and why:
  * against the reference executed op by op (``jax.disable_jit()``), every
    cache byte and every logit is bit-identical (tolerance 0): the port
    rounds to bf16 exactly where the reference program does;
  * against the JITTED reference the logits differ by a few bf16 steps:
    XLA's CPU compiler keeps some bf16 products in f32 inside a fusion (it
    allows excess precision), e.g. ``silu(gate) * up`` feeds the down
    projection's quantizer unrounded, so an 8-bit activation code can flip.
    The bound below holds that gap (logits here reach magnitude ~8; a
    flipped activation code moves a logit by a fraction of one); see
    ROADMAP Queue 3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TINY = configs.reduced(configs.get_arch("internlm2-1.8b"))
POLICY = get_policy("w4a8")
TTINY = tconfigs.reduced(tconfigs.get_arch("internlm2-1.8b"))
TPOLICY = tget_policy("w4a8")
JIT_LOGIT_ATOL = 1.0
B, S_MAX, PS = 2, 32, 16


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


@pytest.fixture(scope="module")
def params():
    jp = RM.init_params(jax.random.key(3), TINY, POLICY, mode="serve")
    return jp, bridge.params_from_reference(_np(jp), device="cpu")


def _assert_caches_equal(jc, tc):
    ref = bridge.caches_to_numpy(bridge.caches_from_reference(_np(jc), device="cpu"))
    got = bridge.caches_to_numpy(tc)
    assert len(ref) == len(got) == TINY.n_layers
    for r, g in zip(ref, got):
        assert sorted(r) == sorted(g)
        for k in r:
            np.testing.assert_array_equal(g[k].view(np.uint8), r[k].view(np.uint8), err_msg=k)


def _f32(a):
    return np.asarray(a).astype(np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def test_configs_and_params_mirror_the_reference(params):
    jp, tp = params
    assert TTINY.n_layers == TINY.n_layers and TTINY.vocab_padded == TINY.vocab_padded
    assert (TTINY.d_model, TTINY.n_heads, TTINY.kv_heads, TTINY.head_dim, TTINY.d_ff) == \
        (TINY.d_model, TINY.n_heads, TINY.kv_heads, TINY.head_dim, TINY.d_ff)
    full_r, full_t = configs.get_arch("internlm2-1.8b"), tconfigs.get_arch("internlm2-1.8b")
    assert full_t.vocab_padded == full_r.vocab_padded == 92672
    assert full_t.head_dim == full_r.head_dim == 128
    # the port's own placeholder init has the reference's shapes and dtypes
    gen = torch.Generator().manual_seed(0)
    own = TM.init_params(gen, TTINY, TPOLICY, device="cpu")
    for name in ("embed", "head", "final_norm"):
        for k, v in tp[name].items():
            assert tuple(own[name][k].shape) == tuple(v.shape) and own[name][k].dtype == v.dtype
    assert len(own["layers"]) == len(tp["layers"]) == TINY.n_layers
    for lo, lb in zip(own["layers"], tp["layers"]):
        flat_o = jax.tree_util.tree_leaves_with_path(lo)
        flat_b = jax.tree_util.tree_leaves_with_path(lb)
        assert [(p, tuple(a.shape), a.dtype) for p, a in flat_o] == \
            [(p, tuple(a.shape), a.dtype) for p, a in flat_b]


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_chunked_prefill_and_decode_match_reference(params, paged):
    """Prefill one prompt in chunks of 4 (right-padded final chunk) into
    slot 1, then one fused decode step for both slots: caches and logits
    bit-identical to the reference run op by op, and within the stated
    bound of the jitted reference."""
    jp, tp = params
    prompt = np.random.RandomState(5).randint(1, TINY.vocab, size=9).astype(np.int32)
    nb = S_MAX // PS
    if paged:
        jc = RM.init_paged_cache(TINY, POLICY, B * nb + 1, PS)
        tc = TM.init_paged_cache(TTINY, TPOLICY, B * nb + 1, PS, device="cpu")
        bt = np.zeros((B, nb), np.int32)
        bt[1] = [3, 1]  # slot 1's pages; slot 0 stays on the scratch page
    else:
        jc = RM.init_cache(TINY, POLICY, B, S_MAX)
        tc = TM.init_cache(TTINY, TPOLICY, B, S_MAX, device="cpu")
    jc_jit = jc

    def ref_prefill(toks, pos, c, last_idx, head):
        kw = dict(last_idx=last_idx, head=head, impl="jnp")
        if paged:
            return RM.prefill_into_pages(jp, toks, jnp.asarray(bt[1]), pos, c, TINY, POLICY,
                                         page_size=PS, **kw)
        return RM.prefill_into_slot(jp, toks, jnp.int32(1), pos, c, TINY, POLICY, **kw)

    jit_mid = jax.jit(lambda t, p, c: ref_prefill(t, p, c, None, False))
    jit_last = jax.jit(lambda t, p, c, li: ref_prefill(t, p, c, li, True))
    pos = 0
    for off in range(0, len(prompt), 4):
        n = min(4, len(prompt) - off)
        toks = np.zeros((1, 4), np.int32)
        toks[0, :n] = prompt[off:off + n]
        last = off + n >= len(prompt)
        args = (jnp.asarray(toks), jnp.int32(pos))
        if paged:
            got = TM.prefill_into_pages(tp, torch.from_numpy(toks), torch.from_numpy(bt[1]),
                                        pos, tc, TTINY, TPOLICY, page_size=PS,
                                        last_idx=n - 1 if last else None, head=last)
        else:
            got = TM.prefill_into_slot(tp, torch.from_numpy(toks), 1, pos, tc, TTINY, TPOLICY,
                                       last_idx=n - 1 if last else None, head=last)
        with jax.disable_jit():
            ref, jc = ref_prefill(*args, jc, jnp.int32(n - 1) if last else None, last)
        if last:
            ref_jit, jc_jit = jit_last(*args, jc_jit, jnp.int32(n - 1))
        else:
            ref_jit, jc_jit = jit_mid(*args, jc_jit)
        pos += n
        _assert_caches_equal(jc, tc)
        if last:
            assert tuple(got.shape) == (1, 1, TINY.vocab_padded)
            np.testing.assert_array_equal(_f32(got), _f32(ref))
            np.testing.assert_allclose(_f32(got), _f32(ref_jit), atol=JIT_LOGIT_ATOL, rtol=0)
        else:
            assert got is None and ref is None

    toks = np.array([[5], [7]], np.int32)
    pv = np.array([3, pos], np.int32)
    bts = dict(block_tables=jnp.asarray(bt)) if paged else {}
    ref_fn = lambda c: RM.decode_step(jp, jnp.asarray(toks), jnp.asarray(pv), c,  # noqa: E731
                                      TINY, POLICY, impl="jnp", fused_attn=True, **bts)
    with jax.disable_jit():
        ref, jc = ref_fn(jc)
    ref_jit, _ = jax.jit(ref_fn)(jc_jit)
    got = TM.decode_step(tp, torch.from_numpy(toks), torch.from_numpy(pv), tc, TTINY, TPOLICY,
                         fused_attn=True,
                         block_tables=torch.from_numpy(bt) if paged else None)
    assert tuple(got.shape) == (B, 1, TINY.vocab_padded) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(ref))
    np.testing.assert_allclose(_f32(got), _f32(ref_jit), atol=JIT_LOGIT_ATOL, rtol=0)
    if not paged:  # slot 0's garbage write at pos 3 lands in both the same way
        _assert_caches_equal(jc, tc)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_greedy_decode_loop_bit_exact(params, fused):
    """Six decode steps on the dense cache, each feeding its greedy token to
    the next, through the paged_attn kernel (fused) or the one-pass softmax
    over the dequantized cache (unfused): logits bit-identical to the
    reference op by op."""
    jp, tp = params
    rng = np.random.RandomState(9)
    jc = RM.init_cache(TINY, POLICY, B, S_MAX)
    tc = TM.init_cache(TTINY, TPOLICY, B, S_MAX, device="cpu")
    toks = rng.randint(1, TINY.vocab, size=(B, 1)).astype(np.int32)
    for p in range(6):
        pv = np.array([p, p], np.int32)
        with jax.disable_jit():
            ref, jc = RM.decode_step(jp, jnp.asarray(toks), jnp.asarray(pv), jc, TINY, POLICY,
                                     impl="jnp", fused_attn=fused)
        got = TM.decode_step(tp, torch.from_numpy(toks), torch.from_numpy(pv), tc, TTINY,
                             TPOLICY, fused_attn=fused)
        np.testing.assert_array_equal(_f32(got), _f32(ref))
        toks = np.asarray(got.float().argmax(-1)).astype(np.int32)


def test_unfused_paged_decode_bit_exact(params):
    """Six unfused decode steps on a paged cache (each slot on its own
    shuffled pages; the read gathers every pool leaf through the block
    table at stored width, then dequantizes): logits and pools
    bit-identical to the reference's ``decode_step(..., fused_attn=False)``
    run op by op, and logits identical to the port's unfused dense-cache
    steps, which hold the same logical rows."""
    jp, tp = params
    rng = np.random.RandomState(13)
    nb = S_MAX // PS
    bt = np.array([[3, 1], [2, 4]], np.int32)
    jc = RM.init_paged_cache(TINY, POLICY, B * nb + 1, PS)
    tc = TM.init_paged_cache(TTINY, TPOLICY, B * nb + 1, PS, device="cpu")
    dc = TM.init_cache(TTINY, TPOLICY, B, S_MAX, device="cpu")
    toks = rng.randint(1, TINY.vocab, size=(B, 1)).astype(np.int32)
    for p in range(6):
        pv = np.array([p, p + 11], np.int32)  # slot 1 crosses into its second page
        with jax.disable_jit():
            ref, jc = RM.decode_step(jp, jnp.asarray(toks), jnp.asarray(pv), jc, TINY, POLICY,
                                     impl="jnp", block_tables=jnp.asarray(bt),
                                     fused_attn=False)
        got = TM.decode_step(tp, torch.from_numpy(toks), torch.from_numpy(pv), tc, TTINY,
                             TPOLICY, block_tables=torch.from_numpy(bt), fused_attn=False)
        dense = TM.decode_step(tp, torch.from_numpy(toks), torch.from_numpy(pv), dc, TTINY,
                               TPOLICY, fused_attn=False)
        np.testing.assert_array_equal(_f32(got), _f32(ref))
        assert torch.equal(got, dense)
        toks = np.asarray(got.float().argmax(-1)).astype(np.int32)
    _assert_caches_equal(jc, tc)


MLA_TINY = dataclasses.replace(configs.reduced(configs.get_arch("deepseek-v3-671b")),
                               dense_layers=2)
MLA_TTINY = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch("deepseek-v3-671b")),
                                dense_layers=2)


def _shapes(tree):
    return [(p, tuple(a.shape), a.dtype) for p, a in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("part", ["mla_params", "mtp_params", "mla_caches", "mla_pool"])
def test_bridge_round_trip_mla(part):
    """The bridge on the expert-free reduced DeepSeek-V3: the scan group of
    ``mla_dense`` layers unstacks into per-layer trees, the MTP params cross
    as single trees, the MLA cache groups (``c`` / ``c_s`` / ``r``, no
    ``"self"`` level) unstack per layer; every leaf byte-identical to the
    reference's, every tree shaped like the port's own init."""
    if part.endswith("params"):
        jp = _np(RM.init_params(jax.random.key(4), MLA_TINY, POLICY, mode="serve"))
        tp = bridge.params_from_reference(jp, device="cpu")
        own = TM.init_params(torch.Generator().manual_seed(0), MLA_TTINY, TPOLICY, device="cpu")
        if part == "mla_params":
            (group,) = jp["blocks"]
            assert len(tp["layers"]) == len(own["layers"]) == 2
            pairs = [(jax.tree.map(lambda a, i=i: a[i], group), tp["layers"][i], own["layers"][i])
                     for i in range(2)]
            assert sorted(tp["layers"][0]["attn"]) == ["kv_norm", "q_norm", "wkv_a", "wkv_b",
                                                       "wo", "wq_a", "wq_b"]
        else:
            pairs = [(jp[k], tp[k], own[k]) for k in ("mtp_block", "mtp_proj", "mtp_norm")]
        for ref, got, mine in pairs:
            assert _shapes(got) == _shapes(mine)
            for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                                    jax.tree_util.tree_leaves(got)):
                np.testing.assert_array_equal(bridge.to_numpy(g).reshape(-1).view(np.uint8),
                                              np.asarray(r).reshape(-1).view(np.uint8),
                                              err_msg=str(path))
        return
    rng = np.random.RandomState(6)
    if part == "mla_caches":
        jc = RM.init_cache(MLA_TINY, POLICY, B, S_MAX)
        own = TM.init_cache(MLA_TTINY, TPOLICY, B, S_MAX, device="cpu")
    else:
        jc = RM.init_paged_cache(MLA_TINY, POLICY, 5, PS)
        own = TM.init_paged_cache(MLA_TTINY, TPOLICY, 5, PS, device="cpu")
    jc = jax.tree.map(lambda a: (rng.randn(*a.shape) * 40).clip(-100, 100).astype(a.dtype), _np(jc))
    (group,) = jc
    assert sorted(group) == ["c", "c_s", "r"]
    tc = bridge.caches_from_reference(jc, device="cpu")
    assert _shapes(tc) == _shapes(own)
    got = bridge.caches_to_numpy(tc)
    for i in range(2):
        for k in ("c", "c_s", "r"):
            np.testing.assert_array_equal(got[i][k].view(np.uint8), group[k][i].view(np.uint8))


def test_sample_tokens_greedy_first_maximum():
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]])
    got = TM.sample_tokens(logits, np.zeros(2, np.float32))
    ref = RM.sample_tokens(jnp.asarray(logits.numpy()), jnp.zeros(2), jnp.zeros(2, jnp.int32),
                           jnp.ones(2), jnp.zeros(2, jnp.uint32), jnp.zeros(2, jnp.int32))
    assert got.tolist() == np.asarray(ref).tolist() == [1, 0]
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        TM.sample_tokens(logits, np.array([0.0, 0.7], np.float32))


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError):
        TM.init_params(torch.Generator(), TTINY.__class__(
            name="x", family="moe", n_layers=1, d_model=8, n_heads=2, kv_heads=2, d_ff=8,
            vocab=16), TPOLICY, device="cpu")
