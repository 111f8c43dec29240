"""PyTorch port, the page movers' groups: ``ops.paged_scatter_leaves`` and
``ops.paged_gather_leaves`` move up to four cache leaves that share the
block table (and ``pos``) in one kernel launch. Their plain versions, leaf
by leaf, against the JAX reference (``repro.kernels.paged_gather``), and
the model's decode step through the groups against the single-leaf route.

Tolerance 0 throughout: the page movers copy bytes. The scatter's scratch
page 0, which several rows may hit, is excluded. Leaves: a reduced
internlm2 cache at kv8 and kv4 (int8 codes, packed int4, f32 scales) and
on bf16, and a reduced DeepSeek-V3 latent cache (c, c_s, r). The Pallas
gather clamps a negative id to page 0 where the jnp twin counts it from
the end (the port follows the twin), so negative ids are held to the twin
alone.

The CUDA kernels run only on the card: tests/test_torch_gpu.py (marker
``gpu``) and ``python3 chip_smoke.py`` hold them against these plain
versions there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro.kernels import paged_gather as RPG  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import build, dispatch, ops  # noqa: E402
from repro_torch.kernels.paged_gather import MAX_LEAVES  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LM = configs.reduced(configs.get_arch("internlm2-1.8b"))
MLA = dataclasses.replace(configs.reduced(configs.get_arch("deepseek-v3-671b")), dense_layers=2)
P_, PS, B, NB = 9, 4, 3, 2


def _leaf_specs(name):
    """(dtype, tail) of each leaf of one layer's cache, in the order the
    model passes them."""
    hkv, d = LM.kv_heads, LM.head_dim
    c, dr = MLA.kv_lora, MLA.d_rope
    return {
        "kv8": [("int8", (hkv, d)), ("int8", (hkv, d)), ("f32", (hkv,)), ("f32", (hkv,))],
        "kv4": [("int8", (hkv, d // 2)), ("int8", (hkv, d // 2)), ("f32", (hkv,)),
                ("f32", (hkv,))],
        "bf16": [("bf16", (hkv, d)), ("bf16", (hkv, d))],
        "mla_kv8": [("int8", (1, c)), ("f32", (1,)), ("bf16", (1, dr))],
    }[name]


LEAF_SETS = ["kv8", "kv4", "bf16", "mla_kv8"]


def _values(rng, dtype, shape):
    """Seeded values of one leaf as a JAX array (any byte for the int8 and
    packed int4 codes)."""
    if dtype == "int8":
        return jnp.asarray(rng.randint(-128, 128, size=shape).astype(np.int8))
    if dtype == "f32":
        return jnp.asarray(rng.rand(*shape).astype(np.float32))
    return jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jnp.bfloat16)


def _t(a):
    return bridge.to_tensor(np.asarray(a), device="cpu")


def _bytes(t):
    return bridge.to_numpy(t).view(np.uint8)


@pytest.mark.parametrize("s_new", [1, 5])
@pytest.mark.parametrize("leaves", LEAF_SETS)
def test_scatter_group_matches_the_jax_twins(leaves, s_new):
    """Every leaf of the group, bit-equal to ``paged_scatter_ref`` and to
    ``paged_scatter_pallas`` (interpret mode) and to the single-leaf op:
    slot 1 has an unallocated (0) entry, slot 2's rows run past its table."""
    rng = np.random.RandomState(len(leaves) + s_new)
    specs = _leaf_specs(leaves)
    pools = [_values(rng, dt, (P_, PS, *tail)) for dt, tail in specs]
    news = [_values(rng, dt, (B, s_new, *tail)) for dt, tail in specs]
    bt = jnp.asarray(np.array([[3, 5], [1, 0], [7, 2]], np.int32))
    pos = jnp.asarray(np.array([2, 3, 6], np.int32))
    got = ops.paged_scatter_leaves([_t(p) for p in pools], [_t(n) for n in news], _t(pos),
                                   _t(bt), impl="torch")
    assert len(got) == len(specs)
    for pool, new, g in zip(pools, news, got):
        ref = RPG.paged_scatter_ref(pool, new, pos, bt)
        pal = RPG.paged_scatter_pallas(pool, new, pos, bt, interpret=True)
        one = ops.paged_scatter(_t(pool), _t(new), _t(pos), _t(bt))
        np.testing.assert_array_equal(_bytes(g)[1:], np.asarray(ref).view(np.uint8)[1:])
        np.testing.assert_array_equal(_bytes(g)[1:], np.asarray(pal).view(np.uint8)[1:])
        np.testing.assert_array_equal(_bytes(g)[1:], _bytes(one)[1:])


@pytest.mark.parametrize("leaves", LEAF_SETS)
def test_gather_group_matches_the_jax_twins(leaves):
    """Every leaf of the group, bit-equal to ``paged_gather_ref``, to
    ``paged_gather_pallas`` (interpret mode) and to the single-leaf op; an
    unallocated (0) entry reads the scratch page, an id past the pool the
    last page."""
    rng = np.random.RandomState(len(leaves))
    specs = _leaf_specs(leaves)
    pools = [_values(rng, dt, (P_, PS, *tail)) for dt, tail in specs]
    bt = jnp.asarray(np.array([[3, 5, 0], [6, P_ + 2, 1]], np.int32))
    got = ops.paged_gather_leaves([_t(p) for p in pools], _t(bt), impl="torch")
    assert len(got) == len(specs)
    for pool, g in zip(pools, got):
        ref = np.asarray(RPG.paged_gather_ref(pool, bt))
        np.testing.assert_array_equal(np.asarray(RPG.paged_gather_pallas(pool, bt)), ref)
        assert tuple(g.shape) == ref.shape == (2, 3 * PS, *pool.shape[2:])
        np.testing.assert_array_equal(_bytes(g), ref.view(np.uint8))
        np.testing.assert_array_equal(_bytes(g[1, PS:2 * PS]),
                                      np.asarray(pool[P_ - 1]).view(np.uint8))
        assert torch.equal(ops.paged_gather(_t(pool), _t(bt)).view(torch.uint8),
                           g.view(torch.uint8))


@pytest.mark.parametrize("leaves", LEAF_SETS)
def test_gather_group_negative_ids_follow_the_jnp_twin(leaves):
    rng = np.random.RandomState(7 + len(leaves))
    specs = _leaf_specs(leaves)
    pools = [_values(rng, dt, (P_, PS, *tail)) for dt, tail in specs]
    bt = jnp.asarray(np.array([[-1, -P_ - 3, 2], [4, -2, P_]], np.int32))
    got = ops.paged_gather_leaves([_t(p) for p in pools], _t(bt), impl="torch")
    for pool, g in zip(pools, got):
        ref = np.asarray(RPG.paged_gather_ref(pool, bt))
        np.testing.assert_array_equal(_bytes(g), ref.view(np.uint8))
        np.testing.assert_array_equal(_bytes(g[0, :PS]), np.asarray(pool[P_ - 1]).view(np.uint8))
        np.testing.assert_array_equal(_bytes(g[0, PS:2 * PS]), np.asarray(pool[0]).view(np.uint8))


def test_groups_take_one_to_four_leaves():
    pool = torch.zeros((3, 2, 4))
    bt = torch.tensor([[2]], dtype=torch.int32)
    pos = torch.tensor([1], dtype=torch.int32)
    assert MAX_LEAVES == 4
    for n in range(1, MAX_LEAVES + 1):
        pools = [pool.clone() for _ in range(n)]
        news = [torch.full((1, 1, 4), float(i + 1)) for i in range(n)]
        out = ops.paged_scatter_leaves(pools, news, pos, bt)
        assert [o[2, 1].tolist() for o in out] == [[float(i + 1)] * 4 for i in range(n)]
        assert all(o is p for o, p in zip(out, pools))
        assert [tuple(g.shape) for g in ops.paged_gather_leaves(pools, bt)] == [(1, 2, 4)] * n
    # the CUDA wrappers refuse a group of five, or CPU tensors, before launching
    from repro_torch.kernels.paged_gather import (
        paged_gather_leaves_cuda,
        paged_scatter_leaves_cuda,
    )

    with pytest.raises(ValueError, match="1 to 4 leaves"):
        paged_gather_leaves_cuda([pool] * 5, bt)
    with pytest.raises(ValueError, match="1 to 4 leaves"):
        paged_scatter_leaves_cuda([pool] * 5, [pool[:1, :1]] * 5, pos, bt)
    with pytest.raises(ValueError, match="CUDA"):
        paged_gather_leaves_cuda([pool], bt)
    with pytest.raises(ValueError, match="CUDA"):
        paged_scatter_leaves_cuda([pool], [torch.ones((1, 1, 4))], pos, bt)
    assert build.LAUNCHES["paged_gather"] == build.LAUNCHES["paged_scatter"] == 0


def _single_leaf_route(monkeypatch):
    """Route the model's group calls leaf by leaf, each a group of one
    (what ``ops.paged_scatter`` / ``ops.paged_gather`` call)."""
    scatter, gather = ops.paged_scatter_leaves, ops.paged_gather_leaves

    def scatter_each(pools, news, pos, block_table, *, impl="auto"):
        return [scatter([p], [n], pos, block_table, impl=impl)[0] for p, n in zip(pools, news)]

    def gather_each(pools, block_table, *, impl="auto"):
        return [gather([p], block_table, impl=impl)[0] for p in pools]

    monkeypatch.setattr(ops, "paged_scatter_leaves", scatter_each)
    monkeypatch.setattr(ops, "paged_gather_leaves", gather_each)


def _dispatches(op):
    return dispatch.DISPATCH_COUNTS[dispatch.KernelKey(op, None, None, None, "torch")]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("arch,kv", [("internlm2", 8), ("internlm2", 4), ("internlm2", None),
                                     ("deepseek-v3", 8)])
def test_decode_steps_through_the_groups_equal_the_single_leaf_route(monkeypatch, arch, kv,
                                                                    fused):
    """Three paged decode steps (each slot on shuffled pages, slot 1 across
    a page boundary) through ``model.decode_step``: logits and every pool
    bit-identical to the same steps with each leaf moved alone. The groups
    dispatch one scatter a layer and step (and one gather on the unfused
    read), the single-leaf route one a leaf; no kernel launch is counted."""
    cfg = LM if arch == "internlm2" else MLA
    policy = dataclasses.replace(get_policy("w4a8"), kv_cache_bits=kv)
    params = M.init_params(torch.Generator().manual_seed(5), cfg, policy, device="cpu")
    rng = np.random.RandomState(11)
    n_leaves = len(M.init_cache(cfg, policy, 1, 1, device="cpu")[0])
    bt = torch.tensor([[3, 1], [2, 4]], dtype=torch.int32)
    toks0 = torch.from_numpy(rng.randint(1, cfg.vocab, size=(2, 1)).astype(np.int32))
    launches = dict(build.LAUNCHES)

    def run():
        caches = M.init_paged_cache(cfg, policy, 5, PS, device="cpu")
        toks, logits = toks0, []
        before = _dispatches("paged_scatter"), _dispatches("paged_gather")
        for p in range(3):
            pos = torch.tensor([p, p + 3], dtype=torch.int32)
            out = M.decode_step(params, toks, pos, caches, cfg, policy, impl="torch",
                                block_tables=bt, fused_attn=fused)
            logits.append(out)
            toks = out.float().argmax(-1).to(torch.int32)
        counts = (_dispatches("paged_scatter") - before[0], _dispatches("paged_gather") - before[1])
        return logits, caches, counts

    logits, caches, counts = run()
    with monkeypatch.context() as m:
        _single_leaf_route(m)
        one_logits, one_caches, one_counts = run()
    for a, b in zip(logits, one_logits):
        assert torch.equal(a, b)
    for layer, one in zip(caches, one_caches, strict=True):
        assert sorted(layer) == sorted(one) and len(layer) == n_leaves
        for k in layer:
            assert torch.equal(layer[k].view(torch.uint8), one[k].view(torch.uint8)), k
    steps = 3 * cfg.n_layers
    assert counts == (steps, 0 if fused else steps)
    assert one_counts == (n_leaves * steps, 0 if fused else n_leaves * steps)
    assert dict(build.LAUNCHES) == launches
