"""PyTorch port, the COW clone as one group: ``ops.paged_copy_leaves`` clones
pages on every cache leaf of every layer in one kernel launch.

  * its plain version, leaf by leaf, against the reference's tree map
    (``repro.serve.prefix._tree_copy``, the jnp twin under ``vmap`` over a
    layer axis) and ``paged_copy_pallas`` in interpret mode, on int8, packed
    int4, bf16 and f32 leaves, with disjoint, overlapping and self-copying
    ids; negative and out-of-range ids against the twin;
  * the wrapper's host-side plan, a pure function: the leaf table (its
    addresses, page bytes, staging offsets, chunk ranges, page counts and
    16-byte flags), the disjointness decision and the launches it implies,
    and the table cache;
  * a reduced prefix engine (internlm2 w4a8, DeepSeek-V3 w4a8 cut to its
    two MLA-dense layers): streams and ``cache/cow_copies`` equal to the
    reference prefix engine's run op by op, and one group call a COW clone
    over every leaf of every layer.

Tolerance 0 throughout: the copy moves bytes. The CUDA kernel runs only on
the card: tests/test_torch_gpu.py (marker ``gpu``) and
``python3 chip_smoke.py`` hold it against this plain version there.
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
from repro.kernels import paged_gather as RPG  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro.serve import ServeEngine as RServeEngine  # noqa: E402
from repro.serve.prefix import _tree_copy  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.kernels import build, dispatch, ops  # noqa: E402
from repro_torch.kernels import paged_gather as G  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

L, P_, PS = 3, 9, 4
#: one layer's leaves, (dtype, tail): int8 K codes, packed int4 V codes, f32
#: scales, a bf16 rope row, a 15-byte leaf (off the 16-byte path)
LEAVES = {"k": ("int8", (2, 8)), "v": ("int8", (2, 4)), "k_s": ("f32", (2,)),
          "r": ("bf16", (1, 8)), "odd": ("int8", (3, 5))}
IDS = [([3, 1], [5, 6]), ([1, 2], [2, 3]), ([4, 2, 5], [4, 1, 2]), ([3, 3], [0, 6]),
       ([7], [7])]


def _values(rng, dtype, shape):
    if dtype == "int8":
        return jnp.asarray(rng.randint(-128, 128, size=shape).astype(np.int8))
    if dtype == "f32":
        return jnp.asarray(rng.randn(*shape).astype(np.float32))
    return jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jnp.bfloat16)


def _caches(seed):
    """The reference's layout: each leaf (L, P, ps, ...), a layer axis first."""
    rng = np.random.RandomState(seed)
    return {k: _values(rng, dt, (L, P_, PS, *tail)) for k, (dt, tail) in LEAVES.items()}


def _port_leaves(caches):
    """The port's layout: a list of layers of (P, ps, ...) leaves, flattened
    in the prefix cache's order (layer by layer)."""
    return [bridge.to_tensor(np.asarray(caches[k][layer]), device="cpu")
            for layer in range(L) for k in caches]


def _bytes(x):
    return np.asarray(x if not isinstance(x, torch.Tensor) else bridge.to_numpy(x)).view(np.uint8)


@pytest.mark.parametrize("src,dst", IDS)
def test_group_ref_matches_the_tree_map_and_pallas(src, dst):
    """Every leaf of every layer bit-equal to the reference's ``_tree_copy``
    and to ``paged_copy_pallas`` (interpret mode) leaf by leaf, and to the
    single-leaf op."""
    caches = _caches(len(src) + 3 * src[0])
    s, d = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    want = _tree_copy(caches, jnp.asarray(s), jnp.asarray(d))
    pools = _port_leaves(caches)
    got = ops.paged_copy_leaves(pools, torch.from_numpy(s), torch.from_numpy(d))
    assert len(got) == L * len(LEAVES) and all(g is p for g, p in zip(got, pools))
    singles = [ops.paged_copy(p.clone(), torch.from_numpy(s), torch.from_numpy(d))
               for p in _port_leaves(caches)]
    i = 0
    for layer in range(L):
        for k in caches:
            pal = RPG.paged_copy_pallas(caches[k][layer], jnp.asarray(s), jnp.asarray(d),
                                        interpret=True)
            np.testing.assert_array_equal(_bytes(got[i]), _bytes(want[k][layer]))
            np.testing.assert_array_equal(_bytes(got[i]), _bytes(pal))
            np.testing.assert_array_equal(_bytes(got[i]), _bytes(singles[i]))
            i += 1


def test_group_ref_negative_and_out_of_range_ids_follow_the_twin():
    """A negative id counts from the end; a source past the pool clamps, a
    destination past it is dropped, as ``paged_copy_ref`` (jnp) does."""
    caches = _caches(17)
    s = np.asarray([-1, P_ + 4, 2], np.int32)
    d = np.asarray([1, -2, P_ + 1], np.int32)
    want = _tree_copy(caches, jnp.asarray(s), jnp.asarray(d))
    got = ops.paged_copy_leaves(_port_leaves(caches), torch.from_numpy(s), torch.from_numpy(d))
    i = 0
    for layer in range(L):
        for k in caches:
            np.testing.assert_array_equal(_bytes(got[i]), _bytes(want[k][layer]))
            np.testing.assert_array_equal(_bytes(got[i][1]), _bytes(caches[k][layer][P_ - 1]))
            i += 1


def test_copy_table_rows():
    """Five int64 words a leaf: address, page bytes, the staging offset (16-
    byte steps), chunk_begin | chunk_end << 32, pages | vec << 32."""
    leaves = [(1 << 40, 257, 16384), (1 << 40 | 512, 257, 512), (4096 + 3, 9, 15),
              (8192, 5, 4097), (12288 + 8, 7, 32), (16384, 3, 0)]
    rows, chunks, row_bytes = G.copy_table(leaves)
    assert G.COPY_CHUNK == 4096
    begins, ends = [r[3] & 0xFFFFFFFF for r in rows], [r[3] >> 32 for r in rows]
    assert [r[0] for r in rows] == [a for a, _, _ in leaves]
    assert [r[1] for r in rows] == [n for _, _, n in leaves]
    assert [r[4] & 0xFFFFFFFF for r in rows] == [p for _, p, _ in leaves]
    assert [r[4] >> 32 for r in rows] == [1, 1, 0, 0, 0, 1]
    assert begins == [0, 4, 5, 6, 8, 9] and ends == [4, 5, 6, 8, 9, 9]
    assert [r[2] for r in rows] == [0, 16384, 16896, 16912, 21024, 21056]
    assert (chunks, row_bytes) == (9, 21056)


def test_copy_table_of_an_internlm2_clone():
    """The prefix cache's set at internlm2-1.8b kv8: 24 layers of k, v (16 KB
    pages) and k_s, v_s (512 B): 240 chunks, 811,008 B a staging row."""
    cfg = tconfigs.get_arch("internlm2-1.8b")
    per_layer = [cfg.kv_heads * cfg.head_dim * 16] * 2 + [cfg.kv_heads * 4 * 16] * 2
    leaves = [((i + 1) << 24, 257, n) for i, n in enumerate(per_layer * cfg.n_layers)]
    rows, chunks, row_bytes = G.copy_table(leaves)
    assert per_layer == [16384, 16384, 512, 512]
    assert (len(rows), chunks, row_bytes) == (96, 240, 811_008)
    assert all(r[4] >> 32 == 1 for r in rows)


@pytest.mark.parametrize("src,dst,pages,want", [
    ([1], [2], [257], 1),  # a COW clone
    ([3, 3], [0, 6], [9], 1),  # repeated sources, disjoint
    ([9, -1, 2], [1, -2, 11], [9], 1),  # wrapped and clamped: {8, 2} against {1, 7, 11}
    ([1, 2], [2, 3], [9], 2),  # a dst page read later as a src
    ([7], [7], [9], 2),  # a self-copy
    ([-1], [4], [5, 9], 2),  # disjoint under 9 pages, not under 5 (-1 -> 4)
    ([5], [-4], [9], 2),  # -4 -> 5
    ([12], [1], [9], 1),  # 12 clamps to 8
    ([12], [8], [9], 2),
    (None, None, [9], 2),  # ids on the card
    (list(range(G.MAX_IDS)), list(range(100, 100 + G.MAX_IDS)), [200], 1),
    (list(range(G.MAX_IDS + 1)), list(range(100, 101 + G.MAX_IDS)), [200], 2),
])
def test_copy_launches(src, dst, pages, want):
    assert G.copy_launches(pages, src, dst) == want


def test_leaf_table_is_cached_by_its_key():
    """The first copy of a set builds its table; the same set again (by
    address, page count and page bytes) reuses it; another page count is
    another key. A full cache empties first."""
    G._TABLES.clear()
    pools = [torch.zeros((5, 4, 8), dtype=torch.int8), torch.zeros((5, 4), dtype=torch.float32)]
    dev = torch.device("cpu")
    a = G._leaf_table(dev, pools, [32, 16])
    assert G._leaf_table(dev, pools, [32, 16]) is a and len(G._TABLES) == 1
    rows, chunks, row_bytes = G.copy_table([(p.data_ptr(), 5, n) for p, n in zip(pools, (32, 16))])
    assert a[0].tolist() == rows and a[1:] == (chunks, row_bytes) == (2, 48)
    b = G._leaf_table(dev, [pools[0][:3]], [32])
    assert b is not a and len(G._TABLES) == 2
    for i in range(G.TABLES_KEPT):
        G._leaf_table(dev, [pools[0]], [i + 1])
    assert len(G._TABLES) <= G.TABLES_KEPT
    G._TABLES.clear()


def test_cuda_wrapper_refuses_before_launching():
    pool = torch.zeros((3, 2, 4))
    ids = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        G.paged_copy_leaves_cuda([pool], ids, ids)
    with pytest.raises(ValueError, match="at least one"):
        G.paged_copy_leaves_cuda([], ids, ids)
    assert build.LAUNCHES["paged_copy"] == 0


def _prefix_requests(cls, vocab):
    """tests/test_prefix.py's stream: two sharers diverging mid-page (a COW
    clone), an exact duplicate (the S-1 cap), a cold prompt and a shorter
    sharer."""
    rng = np.random.RandomState(0)
    shared = rng.randint(1, vocab, size=10).astype(np.int32)
    u = [rng.randint(1, vocab, size=5).astype(np.int32) for _ in range(3)]
    prompts = [np.concatenate([shared, u[0]]), np.concatenate([shared, u[1]]),
               np.concatenate([shared, u[0]]), rng.randint(1, vocab, size=15).astype(np.int32),
               shared[:8].copy()]
    return [cls(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v3-671b"])
def test_prefix_engine_clones_in_one_group_call(monkeypatch, arch):
    """Streams and ``cache/cow_copies`` equal to the reference prefix engine
    (op by op); every COW clone is one ``paged_copy_leaves`` call (one
    ``paged_copy`` dispatch) over every leaf of every layer, ids on the
    host."""
    rcfg, tcfg = configs.reduced(configs.get_arch(arch)), tconfigs.reduced(tconfigs.get_arch(arch))
    if arch == "deepseek-v3-671b":
        rcfg = dataclasses.replace(rcfg, dense_layers=2)
        tcfg = dataclasses.replace(tcfg, dense_layers=2)
    kw = dict(n_slots=2, s_max=32, prefill_chunk=4, page_size=4)
    jp = RM.init_params(jax.random.key(1), rcfg, get_policy("w4a8"), mode="serve")
    ref = RServeEngine(jp, rcfg, get_policy("w4a8"), impl="jnp", cache="prefix", **kw)
    with jax.disable_jit():
        ref_out = ref.run(_prefix_requests(RRequest, rcfg.vocab))
    tp = bridge.params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    eng = ServeEngine(tp, tcfg, tget_policy("w4a8"), cache="prefix", device="cpu", **kw)
    calls, group = [], ops.paged_copy_leaves

    def recording(pools, src, dst, *, impl="auto"):
        calls.append((len(pools), src.device.type, src.tolist(), dst.tolist()))
        return group(pools, src, dst, impl=impl)

    monkeypatch.setattr(ops, "paged_copy_leaves", recording)
    key = dispatch.KernelKey("paged_copy", None, None, None, "torch")
    before = dispatch.DISPATCH_COUNTS[key]
    out = eng.run(_prefix_requests(Request, tcfg.vocab))
    m, rm = eng.metrics(), ref.metrics()
    assert out == ref_out
    assert m["cache/cow_copies"] == rm["cache/cow_copies"] >= 1
    assert dispatch.DISPATCH_COUNTS[key] - before == len(calls) == m["cache/cow_copies"]
    n_leaves = sum(len(layer) for layer in eng.cache.caches)
    assert all(n == n_leaves and dev == "cpu" and len(s) == len(d) == 1 and s != d
               for n, dev, s, d in calls)
