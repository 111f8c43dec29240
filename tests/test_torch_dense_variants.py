"""PyTorch port, the dense variants: ``h2o-danube-1.8b`` (sliding window,
head_dim 80 at full width), ``qwen1.5-4b`` (q/k/v biases) and
``stablelm-3b`` (LayerNorm, ``rope_pct`` 0.25 carried but never read),
each ``reduced(...)`` from both registries under w4a8 with an 8-bit KV
cache, the same weights through the bridge, against the JAX reference run
op by op (``jax.disable_jit()``).

The reference's placeholder init leaves the norms at scale 1, bias 0 and
the q/k/v biases at 0, so every norm and bias leaf is redrawn here (seeded
numpy, on both sides through the bridge): a leaf the port dropped or
misplaced would change the logits. The reduced danube keeps its window at
8 (``configs.reduced`` sets ``window=8`` for a windowed config in both
registries), so the prompts here (9 to 14 tokens) slide it.

Tolerance 0 throughout: logits and cache bytes bit-identical, as for
internlm2 in tests/test_torch_model.py and tests/test_torch_flash.py. Greedy
streams on the slot and paged caches are in
tests/test_torch_dense_variants_serve.py (another worker under
``--dist loadfile``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro import configs  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("h2o-danube-1.8b", "qwen1.5-4b", "stablelm-3b")
POLICY = get_policy("w4a8")
TPOLICY = tget_policy("w4a8")
B, S_MAX, PS = 2, 32, 16
#: published head widths (d_model / n_heads) and padded vocabularies
FULL = {"h2o-danube-1.8b": (80, 32000), "qwen1.5-4b": (128, 152064),
        "stablelm-3b": (80, 50432)}


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a).astype(np.float32)


def redraw_norms_and_biases(tree, seed: int):
    """Every norm ``scale`` / ``bias`` and linear ``b`` leaf of a numpy
    params tree redrawn from ``seed`` (scales around 1, biases around 0);
    the rest as it is. Returns the new tree and the number of leaves
    redrawn."""
    rng = np.random.RandomState(seed)
    n = [0]

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        if key in ("scale", "bias", "b") and node.dtype == np.float32:
            n[0] += 1
            base = 1.0 if key == "scale" else 0.0
            return (base + 0.2 * rng.standard_normal(node.shape)).astype(np.float32)
        return node

    return walk(tree, None), n[0]


def ref_params(name: str, seed: int = 3):
    """(reference config, port config, reference params with redrawn norms
    and biases, the port's params through the bridge)."""
    cfg = configs.reduced(configs.get_arch(name))
    tcfg = tconfigs.reduced(tconfigs.get_arch(name))
    jp = _np(jax.jit(lambda k: RM.init_params(k, cfg, POLICY, mode="serve"))(
        jax.random.key(seed)))
    jp, n = redraw_norms_and_biases(jp, seed)
    assert n > 0
    jp = jax.tree.map(jnp.asarray, jp)
    return cfg, tcfg, jp, bridge.params_from_reference(_np(jp), device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def variant(request):
    return (request.param, *ref_params(request.param))


@pytest.mark.parametrize("name", ARCHS)
def test_configs_mirror_the_reference(name):
    """Every field the port's ArchConfig has equals the reference's, at full
    width and reduced; the variants' own fields as published."""
    for full in (True, False):
        r, t = configs.get_arch(name), tconfigs.get_arch(name)
        if not full:
            r, t = configs.reduced(r), tconfigs.reduced(t)
        rf = dataclasses.asdict(r)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == rf[f.name], (name, full, f.name)
        assert t.vocab_padded == r.vocab_padded and t.head_dim == r.head_dim
    full_t = tconfigs.get_arch(name)
    assert (full_t.head_dim, full_t.vocab_padded) == FULL[name]
    red = tconfigs.reduced(full_t)
    assert red.head_dim == 16
    want = {"h2o-danube-1.8b": dict(window=8, qkv_bias=False, norm="rms", rope_pct=1.0),
            "qwen1.5-4b": dict(window=None, qkv_bias=True, norm="rms", rope_pct=1.0),
            "stablelm-3b": dict(window=None, qkv_bias=False, norm="layer", rope_pct=0.25)}[name]
    assert {k: getattr(red, k) for k in want} == want
    assert full_t.window == (4096 if name == "h2o-danube-1.8b" else None)


def test_params_carry_every_leaf_of_the_reference(variant):
    """The bridged tree has the reference's leaves, LayerNorm biases and
    q/k/v biases included, each shaped as the port's own init shapes it."""
    name, cfg, tcfg, jp, tp = variant
    own = TM.init_params(torch.Generator().manual_seed(0), tcfg, TPOLICY, device="cpu")
    flat_o = jax.tree_util.tree_leaves_with_path(own)
    flat_b = jax.tree_util.tree_leaves_with_path(tp)
    assert [(p, tuple(a.shape), a.dtype) for p, a in flat_o] == \
        [(p, tuple(a.shape), a.dtype) for p, a in flat_b]
    keys = {jax.tree_util.keystr(p) for p, _ in flat_b}
    if name == "stablelm-3b":
        assert "['layers'][0]['norm1']['bias']" in keys and "['final_norm']['bias']" in keys
    if name == "qwen1.5-4b":
        assert {f"['layers'][1]['attn']['{w}']['b']" for w in ("wq", "wk", "wv")} <= keys
        assert "['layers'][1]['attn']['wo']['b']" not in keys


def test_forward_serve_bit_exact(variant):
    """Whole-sequence scoring over 12 tokens (past danube's window of 8):
    logits bit-identical to the reference's ``forward(mode="serve")``."""
    _, cfg, tcfg, jp, tp = variant
    toks = np.random.RandomState(17).randint(1, cfg.vocab, size=(B, 12)).astype(np.int32)
    with jax.disable_jit():
        ref, _ = RM.forward(jp, {"tokens": jnp.asarray(toks)}, cfg, POLICY, mode="serve",
                            impl="jnp")
    got, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg, TPOLICY, mode="serve")
    assert tuple(got.shape) == (B, 12, cfg.vocab_padded)
    np.testing.assert_array_equal(_f32(got), _f32(ref))


def _assert_caches_equal(jc, tc):
    ref = bridge.caches_to_numpy(bridge.caches_from_reference(_np(jc), device="cpu"))
    got = bridge.caches_to_numpy(tc)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert sorted(r) == sorted(g)
        for k in r:
            np.testing.assert_array_equal(g[k].view(np.uint8), r[k].view(np.uint8), err_msg=k)


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_chunked_prefill_and_decode_bit_exact(variant, paged):
    """A 13-token prompt prefilled in chunks of 4 into slot 1 (right-padded
    last chunk), then four decode steps of both slots, alternately fused
    (paged_attn) and unfused (the one-pass softmax over the dequantized
    cache), each fed its greedy token: every logit and cache byte
    bit-identical to the reference op by op."""
    _, cfg, tcfg, jp, tp = variant
    prompt = np.random.RandomState(5).randint(1, cfg.vocab, size=13).astype(np.int32)
    nb = S_MAX // PS
    if paged:
        jc = RM.init_paged_cache(cfg, POLICY, B * nb + 1, PS)
        tc = TM.init_paged_cache(tcfg, TPOLICY, B * nb + 1, PS, device="cpu")
        bt = np.array([[2, 4], [3, 1]], np.int32)
    else:
        jc = RM.init_cache(cfg, POLICY, B, S_MAX)
        tc = TM.init_cache(tcfg, TPOLICY, B, S_MAX, device="cpu")
    pos = 0
    for off in range(0, len(prompt), 4):
        n = min(4, len(prompt) - off)
        toks = np.zeros((1, 4), np.int32)
        toks[0, :n] = prompt[off:off + n]
        last = off + n >= len(prompt)
        kw = dict(last_idx=n - 1 if last else None, head=last)
        with jax.disable_jit():
            if paged:
                ref, jc = RM.prefill_into_pages(jp, jnp.asarray(toks), jnp.asarray(bt[1]),
                                                jnp.int32(pos), jc, cfg, POLICY, page_size=PS,
                                                impl="jnp", **kw)
            else:
                ref, jc = RM.prefill_into_slot(jp, jnp.asarray(toks), jnp.int32(1),
                                               jnp.int32(pos), jc, cfg, POLICY, impl="jnp",
                                               **kw)
        if paged:
            got = TM.prefill_into_pages(tp, torch.from_numpy(toks), torch.from_numpy(bt[1]), pos,
                                        tc, tcfg, TPOLICY, page_size=PS, **kw)
        else:
            got = TM.prefill_into_slot(tp, torch.from_numpy(toks), 1, pos, tc, tcfg, TPOLICY,
                                       **kw)
        pos += n
        if last:
            np.testing.assert_array_equal(_f32(got), _f32(ref))
    _assert_caches_equal(jc, tc)
    toks = np.array([[5], [int(_f32(got).argmax())]], np.int32)
    bts = dict(block_tables=bt) if paged else {}
    for i in range(4):
        pv = np.array([i, pos + i], np.int32)
        fused = i % 2 == 0
        with jax.disable_jit():
            ref, jc = RM.decode_step(jp, jnp.asarray(toks), jnp.asarray(pv), jc, cfg, POLICY,
                                     impl="jnp", fused_attn=fused,
                                     **{k: jnp.asarray(v) for k, v in bts.items()})
        got = TM.decode_step(tp, torch.from_numpy(toks), torch.from_numpy(pv), tc, tcfg,
                             TPOLICY, fused_attn=fused,
                             **{k: torch.from_numpy(v) for k, v in bts.items()})
        np.testing.assert_array_equal(_f32(got), _f32(ref), err_msg=f"decode step {i}")
        toks = np.asarray(_f32(got).argmax(-1)).astype(np.int32)
    _assert_caches_equal(jc, tc)
