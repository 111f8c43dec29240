"""PyTorch port, MLA slice: DeepSeek-V3's Multi-head Latent Attention layers
against the JAX reference on the CPU, on the expert-free reduced config
``dataclasses.replace(reduced(get_arch("deepseek-v3-671b")), dense_layers=2)``
(two ``mla_dense`` layers; the reference's ``reduced()`` alone leaves an
``mla_moe`` layer), same weights through the bridge, inputs from numpy
seeds.

Tolerances and why:
  * ``paged_mla_attn``'s plain version against the reference twin and the
    Pallas kernel (interpret mode): atol 1e-6, the reference's own
    kernel-vs-twin bound (tests/test_paged_attn.py). Both run the same
    page-blocked softmax; XLA's CPU dot sums a contraction over the LAST
    axis of both operands (``q . c^T``) in two interleaved FMA chains
    (even and odd indices), PyTorch's in another order, so the f32 scores
    differ in their last bits;
  * ``mla_apply``: the cache rows it writes are bit-identical (they come
    from the projections, integer kernels and elementwise ops). Its output
    holds ``MLA_OUT_ATOL``: the absorbed branches contract ``q_lat . c^T``,
    ``q_rope . r^T`` and ``ctx . W_uv^T`` over the last axis of both
    operands, where the two frameworks sum in another order (above), so
    the f32 context can differ by a few ulp; that moves the bf16 attention
    output by at most one bf16 step, which can flip one 8-bit activation
    code of the ``wo`` input (a code moves the output by eps_x * |w|, here
    below 0.02);
  * model logits hold ``LOGIT_ATOL`` for the same reason (logits reach
    magnitude ~4 here; one flipped activation code moves a logit by a small
    fraction of one), and their argmax is equal;
  * on the inputs below the ``mla_apply`` outputs and the logits come out
    bit-identical; the bounds are what the summation order allows;
  * greedy token streams of the serving engine are identical to the
    reference engine's, on slot and paged caches, fused and unfused, under
    ``w4a8``, ``w4a8kv4`` and ``bf16``.

The reference runs op by op (``jax.disable_jit()``): its jitted build drops
bf16 roundings inside fusions (ROADMAP Queue 3, tests/test_torch_model.py).
The CUDA kernel itself runs on the card: tests/test_torch_gpu.py and
``python3 chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.kernels import tuning  # noqa: E402
from repro.kernels.paged_attn import paged_mla_attn_pallas  # noqa: E402
from repro.kernels.paged_attn import paged_mla_attn_ref as jax_mla_ref  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro.serve import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.kernels import build, dispatch, ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import PagedKVCache, Request, ServeEngine, SlotCache  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "deepseek-v3-671b"
TINY = dataclasses.replace(configs.reduced(configs.get_arch(ARCH)), dense_layers=2)
TTINY = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch(ARCH)), dense_layers=2)
POLICY = get_policy("w4a8")
TPOLICY = tget_policy("w4a8")
KERNEL_ATOL = 1e-6
MLA_OUT_ATOL = 0.02
LOGIT_ATOL = 0.05
B, S_MAX, PS = 2, 32, 16
KV_BITS = (None, 8, 4)


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _t(tree):
    """A numpy (or jax) tree -> CPU tensors (None stays None)."""
    return jax.tree.map(lambda a: bridge.to_tensor(np.asarray(a), device="cpu"), tree)


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a).astype(np.float32)


def _bytes_equal(ref: dict, got: dict):
    assert sorted(ref) == sorted(got)
    for k in ref:
        r, g = np.asarray(ref[k]), bridge.to_numpy(got[k])
        np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8), err_msg=k)


@pytest.fixture(scope="module")
def params():
    jp = RM.init_params(jax.random.key(3), TINY, POLICY, mode="serve")
    return jp, bridge.params_from_reference(_np(jp), device="cpu")


# ------------------------------------------------------------- configs


def test_config_mirrors_the_reference():
    """The port's DeepSeek-V3 config and its reduced form hold the
    reference's fields, and both build three / two MLA-dense layers."""
    full_r, full_t = configs.get_arch(ARCH), tconfigs.get_arch(ARCH)
    for name in ("n_layers", "d_model", "n_heads", "kv_heads", "d_ff", "vocab", "head_dim",
                 "n_experts", "top_k", "moe_d_ff", "n_shared", "shared_d_ff", "dense_layers",
                 "mla", "q_lora", "kv_lora", "d_nope", "d_rope", "d_v", "mtp", "family"):
        assert getattr(full_t, name) == getattr(full_r, name), name
        assert getattr(TTINY, name) == getattr(TINY, name), name
    assert full_t.mla_cfg.__dict__ == full_r.mla_cfg.__dict__
    assert full_t.vocab_padded == full_r.vocab_padded == 129280
    cut = dataclasses.replace(full_t, n_layers=3)
    assert TM._layer_kinds(cut) == RM._layer_kinds(dataclasses.replace(full_r, n_layers=3)) \
        == ["mla_dense"] * 3
    assert TM._layer_kinds(TTINY) == RM._layer_kinds(TINY) == ["mla_dense"] * 2
    assert "mla_moe" in TM.PREFILL_CHUNKABLE_FAMILIES and "mla_moe" in TM.PAGEABLE_FAMILIES


def test_moe_layers_raise_never_substitute():
    """A config with an ``mla_moe`` layer (the reference's ``reduced()``
    alone) raises NotImplementedError at every constructor; no dense MLP
    stands in for the experts."""
    cfg = tconfigs.reduced(tconfigs.get_arch(ARCH))
    assert TM._layer_kinds(cfg) == ["mla_dense", "mla_moe"]
    for make in (lambda: TM.init_params(torch.Generator(), cfg, TPOLICY, device="cpu"),
                 lambda: TM.init_cache(cfg, TPOLICY, 1, 16, device="cpu"),
                 lambda: TM.init_paged_cache(cfg, TPOLICY, 3, 16, device="cpu"),
                 lambda: SlotCache(cfg, TPOLICY, n_slots=1, s_max=16, device="cpu"),
                 lambda: PagedKVCache(cfg, TPOLICY, n_slots=1, s_max=16, device="cpu")):
        with pytest.raises(NotImplementedError, match="mla_moe"):
            make()
    if not torch.cuda.is_available():  # device=None means CUDA here too
        with pytest.raises(RuntimeError, match="CUDA"):
            TM.init_params(torch.Generator(), TTINY, TPOLICY)


# -------------------------------------------------------------- kernel


def _mla_case(seed, bits, H=4, C=16, dr=8):
    """Latent pages of 2 slots x 2 blocks in a shuffled pool of 5 pages
    (page 0 unused), slot 0's second page past its position (masked)."""
    rng = np.random.RandomState(seed)
    P_ = B * 2 + 1
    q_lat = rng.randn(B, H, C).astype(np.float32)
    q_rope = rng.randn(B, H, dr).astype(np.float32)
    c_f = jnp.asarray(rng.randn(P_, PS, 1, C).astype(np.float32)).astype(jnp.bfloat16)
    r = jnp.asarray(rng.randn(P_, PS, 1, dr).astype(np.float32)).astype(jnp.bfloat16)
    cq, c_s = RA.kv_quantize(c_f, bits)
    bt = np.array([[3, 1], [2, 4]], np.int32)
    pos = np.array([9, 2 * PS - 1], np.int32)
    scale = 1.0 / ((C + dr) ** 0.5)
    return q_lat, q_rope, _np(cq), None if c_s is None else _np(c_s), _np(r), pos, bt, scale


@pytest.mark.parametrize("bits", KV_BITS, ids=["bf16", "kv8", "kv4"])
def test_paged_mla_attn_plain_vs_reference(bits):
    """The plain version against the reference twin and the Pallas kernel
    (interpret mode): within 1e-6 (see the module docstring)."""
    q_lat, q_rope, cq, c_s, r, pos, bt, scale = _mla_case(29 + (bits or 0), bits)
    jargs = [jnp.asarray(a) if a is not None else None
             for a in (q_lat, q_rope, cq, c_s, r, pos, bt)]
    twin = np.asarray(jax_mla_ref(*jargs, bits=bits, scale=scale))
    pallas = np.asarray(paged_mla_attn_pallas(*jargs, bits=bits, scale=scale, interpret=True))
    t = [None if a is None else bridge.to_tensor(a, device="cpu")
         for a in (q_lat, q_rope, cq, c_s, r, pos, bt)]
    got = ops.paged_mla_attn(*t[:6], bits=bits, scale=scale, block_table=t[6])
    assert tuple(got.shape) == (B, 4, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), twin, atol=KERNEL_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=KERNEL_ATOL, rtol=0)
    # rows past pos (slot 0's whole second page) never reach the output
    trash = [a.clone() if a is not None else None for a in t]
    trash[2][1] = 7 if bits is not None else 100.0
    assert torch.equal(ops.paged_mla_attn(*trash[:6], bits=bits, scale=scale,
                                          block_table=t[6])[0], got[0])


@pytest.mark.parametrize("bits", KV_BITS, ids=["bf16", "kv8", "kv4"])
def test_paged_mla_attn_dense_view_is_the_pool(bits):
    """The dense slot layout IS the paged layout with an identity table: at
    bs == page_size the two calls are bit-identical; the slot view's block
    size is 16 on both sides."""
    *arrays, scale = _mla_case(31 + (bits or 0), bits)
    q_lat, q_rope, cq, c_s, r, pos, bt = (
        None if a is None else bridge.to_tensor(a, device="cpu") for a in arrays)

    def dense(a):
        return None if a is None else a[bt.long()].reshape(B, 2 * PS, *a.shape[2:])

    via_pool = ops.paged_mla_attn(q_lat, q_rope, cq, c_s, r, pos, bits=bits, scale=scale,
                                  block_table=bt)
    via_dense = ops.paged_mla_attn(q_lat, q_rope, dense(cq), dense(c_s), dense(r), pos,
                                   bits=bits, scale=scale)
    assert torch.equal(via_pool, via_dense)
    t = tuning.resolve_tiles("paged_attn", perm=tuning.perm_key(w_bits=bits),
                             shape=tuning.shape_key(S_MAX, 4, 16), overrides={"bs": None})
    from repro.kernels import ops as rops

    assert rops._snap_divisor(t["bs"], S_MAX) == ops._snap_divisor(ops.PAGED_ATTN_BS, S_MAX) == 16


def test_dispatch_covers_paged_mla_attn():
    for impl in dispatch.IMPLS:
        assert {c[1] for c in dispatch.coverage("paged_mla_attn", impl)} == {None, 8, 4}
    key = dispatch.KernelKey("paged_mla_attn", None, 4, None, "cuda")
    entry = dispatch._REGISTRY.pop(key)
    try:
        with pytest.raises(RuntimeError, match=r"paged_mla_attn\[kv=4\]@cuda"):
            dispatch.validate_coverage()
    finally:
        dispatch._REGISTRY[key] = entry
    dispatch.validate_coverage()
    assert dispatch.lookup("paged_mla_attn", device=torch.device("cuda", 0),
                           w_bits=8).name == "paged_mla_attn_kv8"
    assert "paged_mla_attn" in build.SOURCES


# ------------------------------------------------------------ mla_apply


def _latent_cache(rng, policy, n, rows):
    """A random latent cache of ``n`` rows-by-``rows`` (numpy leaves, the
    reference's dtypes), quantized by the reference."""
    cfg = TINY.mla_cfg
    c_f = jnp.asarray(rng.randn(n, rows, 1, cfg.kv_lora).astype(np.float32)).astype(jnp.bfloat16)
    cq, c_s = RA.kv_quantize(c_f, policy.kv_cache_bits)
    r = jnp.asarray(rng.randn(n, rows, 1, cfg.d_rope).astype(np.float32)).astype(jnp.bfloat16)
    out = {"c": cq, "r": r}
    if c_s is not None:
        out["c_s"] = c_s
    return _np(out)


@pytest.mark.parametrize("branch", ["fused_dense", "fused_paged", "chunk", "unfused_paged"])
def test_mla_apply_branches_match_reference(params, branch):
    """Each serve branch of ``mla_apply`` from the same weights, inputs and
    cache: fused single-token decode (dense and paged cache), the absorbed
    ``attend_cached`` chunk (dense), unfused decode over the paged cache
    (gathered through paged_gather). Caches bit-identical, output within
    MLA_OUT_ATOL of the reference run op by op."""
    jp, tp = params
    rng = np.random.RandomState(len(branch))
    paged = branch.endswith("paged")
    S = 4 if branch == "chunk" else 1
    if paged:
        bt = np.array([[3, 1], [2, 4]], np.int32)
        cache = _latent_cache(rng, POLICY, B * 2 + 1, PS)
    else:
        bt = None
        cache = _latent_cache(rng, POLICY, B, S_MAX)
    x = jnp.asarray(rng.randn(B, S, TINY.d_model).astype(np.float32)).astype(jnp.bfloat16)
    cache_pos = np.array([5, 20], np.int32)
    pos = cache_pos[:, None] + np.arange(S, dtype=np.int32)[None]
    jattn = jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"])  # layer 0
    kw = dict(attend_cached=branch == "chunk", fused=branch.startswith("fused"))
    with jax.disable_jit():
        ref, ref_cache = RA.mla_apply(
            jattn, x, jnp.asarray(pos), TINY.mla_cfg, POLICY, mode="serve", impl="jnp",
            cache=jax.tree.map(jnp.asarray, cache), cache_pos=jnp.asarray(cache_pos),
            block_table=None if bt is None else jnp.asarray(bt), **kw)
    tcache = _t(cache)
    got, got_cache = TA.mla_apply(
        tp["layers"][0]["attn"], _t(_np(x)), torch.from_numpy(pos), TTINY.mla_cfg, TPOLICY,
        cache=tcache, cache_pos=torch.from_numpy(cache_pos),
        block_table=None if bt is None else torch.from_numpy(bt), **kw)
    assert got_cache is tcache  # written in place
    _bytes_equal(_np(ref_cache), got_cache)
    assert tuple(got.shape) == (B, S, TINY.d_model) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=MLA_OUT_ATOL, rtol=0)


# ---------------------------------------------------------------- model


def _assert_caches_equal(jc, tc):
    ref = bridge.caches_from_reference(_np(jc), device="cpu")
    assert len(ref) == len(tc) == TINY.n_layers
    for r, g in zip(ref, tc):
        _bytes_equal({k: bridge.to_numpy(v) for k, v in r.items()}, g)


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_prefill_and_decode_logits_match_reference(params, paged):
    """``prefill_into_slot`` / ``prefill_into_pages`` in chunks of 4 (the
    last right-padded) into slot 1, then fused and unfused ``decode_step``
    for both slots: caches bit-identical, logits within LOGIT_ATOL of the
    reference run op by op, with the same argmax."""
    jp, tp = params
    prompt = np.random.RandomState(5).randint(1, TINY.vocab, size=9).astype(np.int32)
    nb = S_MAX // PS
    bt = np.array([[0, 0], [3, 1]], np.int32)  # slot 1's pages; slot 0 on scratch
    if paged:
        jc = RM.init_paged_cache(TINY, POLICY, B * nb + 1, PS)
        tc = TM.init_paged_cache(TTINY, TPOLICY, B * nb + 1, PS, device="cpu")
    else:
        jc = RM.init_cache(TINY, POLICY, B, S_MAX)
        tc = TM.init_cache(TTINY, TPOLICY, B, S_MAX, device="cpu")
    pos = 0
    for off in range(0, len(prompt), 4):
        n = min(4, len(prompt) - off)
        toks = np.zeros((1, 4), np.int32)
        toks[0, :n] = prompt[off:off + n]
        last = off + n >= len(prompt)
        kw = dict(last_idx=n - 1 if last else None, head=last)
        with jax.disable_jit():
            if paged:
                ref, jc = RM.prefill_into_pages(jp, jnp.asarray(toks), jnp.asarray(bt[1]), pos, jc,
                                                TINY, POLICY, page_size=PS, impl="jnp", **kw)
            else:
                ref, jc = RM.prefill_into_slot(jp, jnp.asarray(toks), jnp.int32(1), pos, jc,
                                               TINY, POLICY, impl="jnp", **kw)
        if paged:
            got = TM.prefill_into_pages(tp, torch.from_numpy(toks), torch.from_numpy(bt[1]), pos,
                                        tc, TTINY, TPOLICY, page_size=PS, **kw)
        else:
            got = TM.prefill_into_slot(tp, torch.from_numpy(toks), 1, pos, tc, TTINY, TPOLICY,
                                       **kw)
        pos += n
        _assert_caches_equal(jc, tc)
        if last:
            assert tuple(got.shape) == (1, 1, TINY.vocab_padded)
            np.testing.assert_allclose(_f32(got), _f32(ref), atol=LOGIT_ATOL, rtol=0)
            assert _f32(got).argmax() == _f32(ref).argmax()
        else:
            assert got is None and ref is None

    toks = np.array([[5], [7]], np.int32)
    pv = np.array([3, pos], np.int32)
    bts = dict(block_tables=jnp.asarray(bt)) if paged else {}
    tbts = dict(block_tables=torch.from_numpy(bt)) if paged else {}
    for fused in (True, False):
        jc_f, tc_f = jc, [{k: a.clone() for k, a in layer.items()} for layer in tc]
        with jax.disable_jit():
            ref, jc_f = RM.decode_step(jp, jnp.asarray(toks), jnp.asarray(pv), jc_f, TINY,
                                       POLICY, impl="jnp", fused_attn=fused, **bts)
        got = TM.decode_step(tp, torch.from_numpy(toks), torch.from_numpy(pv), tc_f, TTINY,
                             TPOLICY, fused_attn=fused, **tbts)
        assert tuple(got.shape) == (B, 1, TINY.vocab_padded) and got.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got), _f32(ref), atol=LOGIT_ATOL, rtol=0)
        assert (_f32(got).argmax(-1) == _f32(ref).argmax(-1)).all()
        if not paged:  # slot 0's write at pos 3 lands on the same row in both
            _assert_caches_equal(jc_f, tc_f)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_greedy_decode_loop_matches_reference(params, fused):
    """Eight decode steps on the dense cache, each feeding its greedy token
    to the next: logits within LOGIT_ATOL, the same tokens, caches
    bit-identical at the end."""
    jp, tp = params
    rng = np.random.RandomState(9)
    jc = RM.init_cache(TINY, POLICY, B, S_MAX)
    tc = TM.init_cache(TTINY, TPOLICY, B, S_MAX, device="cpu")
    toks = rng.randint(1, TINY.vocab, size=(B, 1)).astype(np.int32)
    for p in range(8):
        pv = np.array([p, p + 3], np.int32)
        with jax.disable_jit():
            ref, jc = RM.decode_step(jp, jnp.asarray(toks), jnp.asarray(pv), jc, TINY, POLICY,
                                     impl="jnp", fused_attn=fused)
        got = TM.decode_step(tp, torch.from_numpy(toks), torch.from_numpy(pv), tc, TTINY,
                             TPOLICY, fused_attn=fused)
        np.testing.assert_allclose(_f32(got), _f32(ref), atol=LOGIT_ATOL, rtol=0)
        toks = _f32(got).argmax(-1).astype(np.int32)
        assert (toks == _f32(ref).argmax(-1)).all()
    _assert_caches_equal(jc, tc)


# ------------------------------------------------------- cache managers


@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_cache_managers_recycle_mla_leaves(backend):
    """Reset, recycle and page draw treat the latent leaves (``c``, ``c_s``,
    ``r``) like K/V leaves: a released request's rows or pages come back
    zeroed on every leaf, and the byte count covers all three."""
    kw = dict(n_slots=2, s_max=32, device="cpu")
    if backend == "paged":
        c = PagedKVCache(TTINY, TPOLICY, page_size=8, n_pages=9, **kw)
    else:
        c = SlotCache(TTINY, TPOLICY, **kw)
    layer = c.caches[0]
    assert sorted(layer) == ["c", "c_s", "r"]
    assert tuple(layer["c"].shape[2:]) == (1, TTINY.kv_lora)  # int8 at kv8
    s = c.acquire(20)
    c.prepare(s, 9)
    rows = (torch.from_numpy(c.block_tables[s, :2]).long() if backend == "paged"
            else torch.tensor([s]))
    for a in layer.values():
        a[rows] = 3
    c.advance(s, 9)
    c.release(s)
    if backend == "slot":
        assert c.acquire(4) == s  # recycled on reacquire
    assert all(int(a.float().abs().sum()) == 0 for a in layer.values())
    per_row = TTINY.kv_lora + 4 + 2 * TTINY.d_rope  # int8 latent, f32 scale, bf16 rope key
    assert c.stats()["kv_bytes_per_token"] == TTINY.n_layers * per_row


# --------------------------------------------------------------- engine

LENGTHS = (3, 9, 5, 2, 7)  # tests/test_serve.py: more requests than slots
ENGINE = dict(n_slots=2, s_max=32, prefill_chunk=4)
POLICIES = ("w4a8", "w4a8kv4", "bf16")


def _requests(cls):
    rng = np.random.RandomState(0)
    return [cls(rid=i, prompt=rng.randint(1, TINY.vocab, size=n).astype(np.int32), max_new=4)
            for i, n in enumerate(LENGTHS)]


@pytest.fixture(scope="module")
def engine_runs():
    """Per policy, lazily: the reference engine (run op by op) and the
    port's engine on slot and paged caches, fused and unfused."""
    runs: dict = {}

    def get(policy_name):
        if policy_name not in runs:
            pol, tpol = get_policy(policy_name), tget_policy(policy_name)
            jp = RM.init_params(jax.random.key(3), TINY, pol, mode="serve")
            tp = bridge.params_from_reference(_np(jp), device="cpu")
            out = {}
            for cache in ("slot", "paged"):
                ps = dict(page_size=16) if cache == "paged" else {}
                for fused in (True, False):
                    ref = RServeEngine(jp, TINY, pol, impl="jnp", prefill="chunked", cache=cache,
                                       fused_attn=fused, **ENGINE, **ps)
                    with jax.disable_jit():
                        ref_out = ref.run(_requests(RRequest))
                    port = ServeEngine(tp, TTINY, tpol, cache=cache, fused_attn=fused,
                                       device="cpu", **ENGINE, **ps)
                    out[cache, fused] = (ref_out, port.run(_requests(Request)), port.metrics())
            runs[policy_name] = out
        return runs[policy_name]

    return get


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("cache", ["slot", "paged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_greedy_streams_identical_to_reference(engine_runs, policy, cache, fused):
    ref_out, port_out, m = engine_runs(policy)[cache, fused]
    assert port_out == ref_out
    assert sorted(port_out) == list(range(len(LENGTHS)))
    assert all(len(v) == 4 for v in port_out.values())
    assert m["fused_attn"] is fused
    assert ("kernels/mpmm_calls" in m) == (policy != "bf16")  # bf16 layers run unquantized
    if fused:
        assert m["kernels/paged_mla_attn_calls"] > 0
    else:
        assert "kernels/paged_mla_attn_calls" not in m
        assert ("kernels/paged_gather_calls" in m) == (cache == "paged")
    if cache == "paged":
        assert m["kernels/paged_scatter_calls"] > 0


@pytest.mark.parametrize("policy", POLICIES)
def test_slot_and_paged_streams_identical(engine_runs, policy):
    runs = engine_runs(policy)
    for fused in (True, False):
        assert runs["slot", fused][1] == runs["paged", fused][1], fused
