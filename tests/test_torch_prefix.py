"""PyTorch port, prefix-sharing cache (``repro_torch.serve.prefix``) on the
CPU, against the reference ``PrefixCache`` (tests/test_prefix.py).

  * the four FAST_CELLS of tests/test_prefix.py (internlm2 bf16 / w4a8 /
    w4a8kv4, and DeepSeek-V3 w4a8 cut to its two MLA-dense layers, the
    reference's reduced config alone keeps an MoE layer the port refuses):
    the port's prefix streams equal the reference prefix engine's, run op
    by op (``jax.disable_jit()``) on the same weights (the bridge), and the
    port's cold paged streams; the ``cache/`` metrics equal the reference's;
  * the two cache managers in lockstep on one admission sequence: block
    tables, positions, refcounts, free list and page contents equal;
  * ports of the reference's behavioural tests, run on the port: prefill
    call reduction, completing one sharer keeps the shared pages, the
    shared page's bytes survive a sharer's prefill, COW leaves the source
    page frozen, a full match caps at S-1, LRU eviction frees cold leaves
    only and cannot starve a live reader, and the two Hypothesis churn
    tests (pool conservation, mid-decode cancellation);
  * ``paged_copy_ref`` against the reference twin on int8 / f32 / bf16
    pools, overlapping, self-copying, repeated and out-of-range ids.

The reference's stepwise-prefill case is left out: the port has no
stepwise prefill (``make_prefiller("stepwise")`` raises).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro import configs  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.kernels import paged_gather as RPG  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import PrefixCache as RPrefixCache  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro.serve import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.paged_gather import paged_copy_ref  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    CACHE_BACKENDS,
    PrefixCache,
    Request,
    SamplingParams,
    ServeEngine,
    make_cache,
)

from tests._hypothesis_compat import given, settings, st  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TINY = tconfigs.reduced(tconfigs.get_arch("internlm2-1.8b"))
POLICY = tget_policy("w4a8")
ENGINE = dict(n_slots=2, s_max=32, prefill_chunk=4, page_size=4)

#: tests/test_prefix.py's FAST_CELLS: attention family x kv_cache_bits
FAST_CELLS = [
    ("internlm2-1.8b", "bf16"),
    ("internlm2-1.8b", "w4a8"),
    ("internlm2-1.8b", "w4a8kv4"),
    ("deepseek-v3-671b", "w4a8"),
]


def _cfgs(arch):
    ref, port = configs.reduced(configs.get_arch(arch)), tconfigs.reduced(tconfigs.get_arch(arch))
    if arch == "deepseek-v3-671b":
        ref = dataclasses.replace(ref, dense_layers=2)
        port = dataclasses.replace(port, dense_layers=2)
    return ref, port


def _shared_prefix_requests(cls, vocab, *, shared_len=10, uniq_len=5, max_new=4, seed=0):
    """tests/test_prefix.py's stream: two sharers that diverge mid-page, an
    exact duplicate (the S-1 cap), an unrelated cold prompt and a shorter
    sharer (a partial-page match)."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, vocab, size=shared_len).astype(np.int32)
    u = [rng.randint(1, vocab, size=uniq_len).astype(np.int32) for _ in range(3)]
    prompts = [
        np.concatenate([shared, u[0]]),
        np.concatenate([shared, u[1]]),
        np.concatenate([shared, u[0]]),
        rng.randint(1, vocab, size=shared_len + uniq_len).astype(np.int32),
        shared[:shared_len - 2].copy(),
    ]
    return [cls(rid=i, prompt=p.astype(np.int32), max_new=max_new)
            for i, p in enumerate(prompts)]


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


@pytest.fixture(scope="module")
def cell_runs():
    """Per cell, lazily: the reference prefix engine (op by op) and the
    port's prefix and cold paged engines on the bridged weights."""
    runs: dict = {}

    def get(arch, pol_name):
        if (arch, pol_name) not in runs:
            rcfg, tcfg = _cfgs(arch)
            pol, tpol = get_policy(pol_name), tget_policy(pol_name)
            jp = RM.init_params(jax.random.key(1), rcfg, pol, mode="serve")
            tp = bridge.params_from_reference(_np(jp), device="cpu")
            ref = RServeEngine(jp, rcfg, pol, impl="jnp", cache="prefix", **ENGINE)
            with jax.disable_jit():
                ref_out = ref.run(_shared_prefix_requests(RRequest, rcfg.vocab))
            out = {"ref": (ref_out, ref.metrics())}
            for cache in ("prefix", "paged"):
                eng = ServeEngine(tp, tcfg, tpol, cache=cache, device="cpu", **ENGINE)
                out[cache] = (eng.run(_shared_prefix_requests(Request, tcfg.vocab)),
                              eng.metrics())
            runs[arch, pol_name] = out
        return runs[arch, pol_name]

    return get


@pytest.mark.parametrize("arch,pol", FAST_CELLS)
def test_prefix_streams_identical_to_reference_and_cold_paged(cell_runs, arch, pol):
    runs = cell_runs(arch, pol)
    ref_out, port_out, cold_out = runs["ref"][0], runs["prefix"][0], runs["paged"][0]
    assert port_out == ref_out
    assert port_out == cold_out
    assert all(len(v) == 4 for v in port_out.values())
    m = runs["prefix"][1]
    assert m["cache/prefix_hit_rate"] > 0.0
    assert m["cache/cow_copies"] >= 1
    assert m["prefill_jit_calls"] < runs["paged"][1]["prefill_jit_calls"]


@pytest.mark.parametrize("arch,pol", FAST_CELLS)
def test_cache_metrics_equal_reference(cell_runs, arch, pol):
    runs = cell_runs(arch, pol)
    mr, mp = runs["ref"][1], runs["prefix"][1]
    cr = {k: v for k, v in mr.items() if k.startswith("cache/")}
    cp = {k: v for k, v in mp.items() if k.startswith("cache/")}
    assert cp == cr
    assert cp["cache/backend"] == "prefix"
    assert sorted(mp) == sorted(mr)


# ------------------------------------------------------- managers in lockstep


def _fill(tree, rng):
    """Random contents for every leaf of the reference's cache tree."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return rng.randint(-100, 100, size=a.shape).astype(np.int8)
        if a.dtype.name == "bfloat16":
            return rng.randn(*a.shape).astype(ml_dtypes.bfloat16)
        return rng.rand(*a.shape).astype(a.dtype)
    return jax.tree.map(leaf, tree)


def _manager_state(c):
    return (c.pos.tolist(), c.block_tables.tolist(), c._alloc.tolist(), c._shared.tolist(),
            c._reserved.tolist(), c._ref.tolist(), list(c._free), c.pages_available(),
            c.hits, c.misses, c.tokens_matched, c.cow_copies, c.evictions, c.index_pages(),
            c.pages_shared())


def test_managers_in_lockstep_with_reference():
    """The same admissions, draws, releases and evictions on the reference
    and the port's PrefixCache leave the same block tables, positions,
    refcounts, free list, accounting and page contents (COW clones and
    last-reader zeroing included; the pool starts full of random bits)."""
    rcfg, tcfg = _cfgs("internlm2-1.8b")
    kw = dict(n_slots=3, s_max=24, page_size=4, n_pages=10)
    rc = RPrefixCache(rcfg, get_policy("w4a8"), **kw)
    tc = PrefixCache(tcfg, POLICY, device="cpu", **kw)
    init = _fill(_np(rc.caches), np.random.RandomState(0))
    rc.caches = jax.tree.map(jnp.array, init)
    tc.caches = bridge.caches_from_reference(init, device="cpu")

    def same():
        assert _manager_state(tc) == _manager_state(rc)
        want = bridge.caches_from_reference(_np(rc.caches), device="cpu")
        # page 0 is scratch: the reference zeroes it too, as the padding of
        # its fixed-length zeroing batches
        for lt, lr in zip(tc.caches, want, strict=True):
            for k in lr:
                assert torch.equal(lt[k][1:], lr[k][1:]), k

    def admit(prompt, need):
        slots = [c.acquire(need, prompt=prompt) for c in (rc, tc)]
        assert slots[0] == slots[1]
        s = slots[1]
        if s is not None:
            n = len(prompt) - int(tc.pos[s])
            for c in (rc, tc):
                c.prepare(s, n)
                c.advance(s, n)
                c.commit(s, prompt)
        same()
        return s

    def release(s):
        rc.release(s)
        tc.release(s)
        same()

    a = np.arange(1, 13, dtype=np.int32)  # 3 full pages
    b = a.copy()
    b[6] = 99  # diverges inside page 1
    s0 = admit(a, 14)
    s1 = admit(b, 14)  # 1 shared page, page 1 cloned at 2 rows
    s2 = admit(a.copy(), 14)  # the S-1 cap: 2 shared pages, page 2 cloned at 3 rows
    assert tc.cow_copies == 2 and tc.pages_shared() == 2
    release(s1)
    release(s0)
    c = np.arange(40, 56, dtype=np.int32)
    assert rc.can_admit(20, prompt=c) and tc.can_admit(20, prompt=c)
    admit(c, 20)  # draws on cold index leaves
    assert tc.evictions == 3
    release(s2)


# ------------------------------------------------------ behaviour, on the port


@pytest.fixture(scope="module")
def params():
    return TM.init_params(torch.Generator().manual_seed(3), TINY, POLICY, device="cpu")


def test_make_cache_and_engine_take_prefix(params):
    assert CACHE_BACKENDS["prefix"] is PrefixCache
    cache = make_cache("prefix", TINY, POLICY, 2, 16, page_size=4, device="cpu")
    assert isinstance(cache, PrefixCache) and cache.paged
    eng = ServeEngine(params, TINY, POLICY, n_slots=2, s_max=16, cache="prefix", page_size=4,
                      device="cpu")
    assert isinstance(eng.cache, PrefixCache)
    assert eng.metrics()["cache/backend"] == "prefix"


def test_prefix_prefill_call_reduction(params):
    """Prefill calls drop from O(S/chunk) to O(S_new/chunk): on a
    share-heavy stream the prefix engine spends >= 2x fewer calls and draws
    fewer fresh pages, with streams equal to the cold run's."""
    rng = np.random.RandomState(3)
    shared = rng.randint(1, TINY.vocab, size=16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(1, TINY.vocab, size=4)]) for _ in range(4)]

    def reqs():
        return [Request(rid=i, prompt=p.astype(np.int32).copy(), max_new=4)
                for i, p in enumerate(prompts)]

    cold = ServeEngine(params, TINY, POLICY, cache="paged", device="cpu", **ENGINE)
    warm = ServeEngine(params, TINY, POLICY, cache="prefix", device="cpu", **ENGINE)
    assert cold.run(reqs()) == warm.run(reqs())
    assert cold.metrics()["prefill_jit_calls"] >= 2 * warm.metrics()["prefill_jit_calls"]
    assert cold.metrics()["cache/pages_drawn"] > warm.metrics()["cache/pages_drawn"]


def _admit(cache, prompt, need):
    s = cache.acquire(need, prompt=prompt)
    assert s is not None
    n = len(prompt) - int(cache.pos[s])
    cache.prepare(s, n)
    cache.advance(s, n)
    cache.commit(s, prompt)
    return s


def test_completing_one_sharer_keeps_shared_pages():
    """Completing one of two sharers never zeroes or recycles the shared
    pages; they recycle when the LAST reader (the index) lets go."""
    cache = PrefixCache(TINY, POLICY, n_slots=2, s_max=32, page_size=4, n_pages=24,
                        device="cpu")
    prompt = np.arange(1, 13, dtype=np.int32)  # 3 full pages
    s0 = _admit(cache, prompt, 16)
    assert int(cache.pos[s0]) == 12 and cache.hits == 0
    s1 = cache.acquire(16, prompt=prompt)
    assert int(cache.pos[s1]) == 11  # 2 full pages + 3 COW rows (S-1 cap)
    assert int(cache._shared[s1]) == 2
    # each slot owes one more page: s0 reserved 4 and drew 3; s1 reserved 2
    # for its unmatched rows and drew 1 (the clone); its 2 mapped pages are
    # no draws
    assert cache.pages_available() == cache.pages_free() - 2
    n = len(prompt) - int(cache.pos[s1])
    cache.prepare(s1, n)
    cache.advance(s1, n)
    cache.commit(s1, prompt)
    shared = [int(cache.block_tables[s1, d]) for d in range(2)]
    assert shared == [int(cache.block_tables[s0, d]) for d in range(2)]
    assert cache.block_tables[s1, 2] != cache.block_tables[s0, 2]
    assert all(int(cache._ref[p]) == 3 for p in shared)
    cache.release(s0)
    assert all(int(cache._ref[p]) == 2 for p in shared)
    assert not any(p in cache._free for p in shared)
    cache.release(s1)
    assert all(int(cache._ref[p]) == 1 for p in shared)
    assert cache.pages_live() == cache.index_pages() == 3
    while cache._evict_one(set()):
        pass
    assert cache.pages_live() == 0
    assert sorted([0] + cache._free) == list(range(cache.n_pages))
    assert all(not a.any() for layer in cache.caches for a in layer.values())


def _index_page_bytes(cache) -> dict:
    """Every page the index pins -> its bytes on every cache leaf."""
    pages = []

    def walk(node):
        for ch in node.children.values():
            pages.append(ch.page)
            walk(ch)

    walk(cache._root)
    return {p: [a[p].clone() for layer in cache.caches for a in layer.values()] for p in pages}


def test_shared_page_content_survives_sharer_completion(params):
    """A short sharer admitted and completed mid-run leaves the longer
    sharer's decode unchanged, and its prefill (which gathers and scatters
    back its whole row, shared pages included) rewrites no shared byte."""
    rng = np.random.RandomState(7)
    shared = rng.randint(1, TINY.vocab, size=9).astype(np.int32)
    long_p = np.concatenate([shared, rng.randint(1, TINY.vocab, size=4)])

    def reqs():
        return [Request(rid=0, prompt=long_p.astype(np.int32).copy(), max_new=6),
                Request(rid=1, prompt=shared.copy(), max_new=1)]

    kw = dict(ENGINE, s_max=24)
    cold = ServeEngine(params, TINY, POLICY, cache="paged", device="cpu", **kw)
    warm = ServeEngine(params, TINY, POLICY, cache="prefix", device="cpu", **kw)
    assert cold.run(reqs()) == warm.run(reqs())

    eng = ServeEngine(params, TINY, POLICY, cache="prefix", device="cpu", **kw)
    eng.submit(long_p.copy(), SamplingParams(max_new=6), rid=0)
    eng.step()
    before = _index_page_bytes(eng.cache)
    assert len(before) == 3
    eng.submit(shared.copy(), SamplingParams(max_new=1), rid=1)
    eng.step()
    assert eng.metrics()["cache/tokens_matched"] == 8
    after = _index_page_bytes(eng.cache)
    for p, leaves in before.items():
        assert all(torch.equal(a, b) for a, b in zip(leaves, after[p], strict=True)), p


def test_cow_divergence_leaves_source_page_frozen():
    cache = PrefixCache(TINY, POLICY, n_slots=2, s_max=16, page_size=4, n_pages=12,
                        device="cpu")
    p_a = np.arange(1, 11, dtype=np.int32)
    s0 = _admit(cache, p_a, 12)
    src = int(cache.block_tables[s0, 1])
    leaf = cache.caches[0]["k"]
    leaf[src] = 7  # recognisable bits in the source page
    p_b = p_a.copy()
    p_b[6] = 99  # diverges inside page 1: 2 rows in common
    s1 = cache.acquire(12, prompt=p_b)
    assert int(cache.pos[s1]) == 6
    dst = int(cache.block_tables[s1, 1])
    assert dst != src
    assert torch.equal(leaf[dst], leaf[src])
    for layer in cache.caches:
        for a in layer.values():
            assert torch.equal(a[dst], a[src])
    cache.prepare(s1, 4)
    cache.advance(s1, 4)
    leaf[dst] = -3  # the clone's writes never reach the source
    assert int((leaf[src] == 7).all())
    assert int(cache._ref[src]) == 2  # s0 + index; the clone is private


def test_full_match_caps_at_s_minus_1():
    cache = PrefixCache(TINY, POLICY, n_slots=2, s_max=16, page_size=4, n_pages=12,
                        device="cpu")
    prompt = np.arange(1, 9, dtype=np.int32)  # 2 exact pages
    s0 = _admit(cache, prompt, 10)
    s1 = cache.acquire(10, prompt=prompt)
    assert int(cache.pos[s1]) == 7
    assert int(cache._shared[s1]) == 1
    assert cache.block_tables[s1, 1] != cache.block_tables[s0, 1]
    assert cache.cow_copies == 1


def test_lru_eviction_frees_cold_leaves_only():
    cache = PrefixCache(TINY, POLICY, n_slots=3, s_max=16, page_size=4, n_pages=7,
                        device="cpu")
    s0 = _admit(cache, np.arange(1, 9, dtype=np.int32), 8)
    cache.release(s0)
    assert cache.pages_live() == 2 and cache.index_pages() == 2
    s1 = _admit(cache, np.arange(50, 58, dtype=np.int32), 8)
    assert cache.evictions == 0
    s2 = cache.acquire(12, prompt=np.arange(90, 102, dtype=np.int32))
    assert s2 is not None and cache.evictions >= 1
    live = {int(p) for s in (s1, s2) for p in cache.block_tables[s, :int(cache._alloc[s])]}
    assert all(int(cache._ref[p]) >= 1 for p in live)
    assert not any(p in cache._free for p in live)
    assert cache.pages_free() + cache.pages_live() + 1 == cache.n_pages


def test_eviction_cannot_starve_live_reader():
    cache = PrefixCache(TINY, POLICY, n_slots=2, s_max=16, page_size=4, n_pages=5,
                        device="cpu")
    p_a = np.arange(1, 9, dtype=np.int32)
    s0 = cache.acquire(16, prompt=p_a)  # reserves all 4 pages
    cache.prepare(s0, 8)
    cache.advance(s0, 8)
    cache.commit(s0, p_a)
    p_b = np.arange(50, 58, dtype=np.int32)
    assert not cache.can_admit(16, prompt=p_b)
    assert cache.acquire(16, prompt=p_b) is None
    assert int(cache._alloc[s0]) == 2
    assert all(int(cache._ref[cache.block_tables[s0, d]]) == 2 for d in range(2))


# ---------------------------------------------------------- churn properties


def _assert_pool_conserved(cache):
    """free + distinct live (block-table or index) pages + scratch ==
    n_pages, every live page's refcount is its reader count, and no page is
    both free and referenced."""
    table = [int(p) for s in range(cache.n_slots)
             for p in cache.block_tables[s, :int(cache._alloc[s])]]
    index = set()

    def walk(node):
        for ch in node.children.values():
            index.add(ch.page)
            walk(ch)

    walk(cache._root)
    live = (set(table) | index) - {0}
    assert len(cache._free) + len(live) + 1 == cache.n_pages
    assert not live.intersection(cache._free)
    for p in live:
        assert int(cache._ref[p]) == table.count(p) + (p in index)
    for p in cache._free:
        assert int(cache._ref[p]) == 0


@settings(max_examples=12, deadline=None)
@given(data=st.data())
def test_page_accounting_invariant_under_churn(data):
    cache = PrefixCache(TINY, POLICY, n_slots=3, s_max=24, page_size=4,
                        n_pages=data.draw(st.integers(6, 14), label="pages"), device="cpu")
    prompts = [np.asarray(p, np.int32) for p in (
        list(range(1, 17)), list(range(1, 9)) + list(range(30, 38)),
        list(range(60, 72)), list(range(1, 6)))]
    pending: dict[int, int] = {}  # slot -> need
    for _ in range(12):
        op = data.draw(st.sampled_from(["admit", "advance", "complete"]), label="op")
        if op == "admit" and not all(cache._busy):
            prompt = data.draw(st.sampled_from(prompts), label="prompt")
            need = len(prompt) + data.draw(st.integers(1, 4), label="new")
            if cache.can_admit(need, prompt=prompt):
                pending[_admit(cache, prompt, need)] = need
        elif op == "advance" and pending:
            s = data.draw(st.sampled_from(sorted(pending)), label="slot")
            if int(cache.pos[s]) < pending[s]:
                cache.prepare(s, 1)
                cache.advance(s, 1)
        elif op == "complete" and pending:
            s = data.draw(st.sampled_from(sorted(pending)), label="slot")
            cache.release(s)
            del pending[s]
        _assert_pool_conserved(cache)
    for s in sorted(pending):
        cache.release(s)
    _assert_pool_conserved(cache)


def _sharing_prompts():
    """Four sharers of one 12-token template plus one cold prompt."""
    rng = np.random.RandomState(11)
    shared = rng.randint(1, TINY.vocab, size=12).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(1, TINY.vocab, size=3 + i)]).astype(np.int32)
               for i in range(4)]
    prompts.append(rng.randint(1, TINY.vocab, size=10).astype(np.int32))
    return prompts


_CANCEL_BASELINE: dict[int, list] = {}
_CHURN_ENGINE = dict(n_slots=3, s_max=32, prefill_chunk=4, page_size=4, device="cpu")


@settings(max_examples=5, deadline=None)
@given(data=st.data())
def test_mid_decode_cancellation_conserves_pool_and_sharers(data, params):
    """Random mid-decode cancel() calls against a shared-prefix stream, small
    pools included (admission queues, LRU eviction fires): the pool stays
    conserved after every step and cancellation, survivors' tokens equal an
    uncancelled run's, and nothing leaks once drained."""
    prompts = _sharing_prompts()
    if not _CANCEL_BASELINE:
        eng = ServeEngine(params, TINY, POLICY, cache="prefix", **_CHURN_ENGINE)
        _CANCEL_BASELINE.update(eng.run([Request(rid=i, prompt=p.copy(), max_new=6)
                                         for i, p in enumerate(prompts)]))
    n_pages = data.draw(st.integers(14, 25), label="pages")
    cancel_after = {
        rid: data.draw(st.integers(1, 5), label=f"after{rid}")
        for rid in set(data.draw(st.lists(st.sampled_from(range(len(prompts))), min_size=0,
                                          max_size=3), label="cancel"))}
    eng = ServeEngine(params, TINY, POLICY, cache="prefix", n_pages=n_pages, **_CHURN_ENGINE)
    handles = {i: eng.submit(p.copy(), SamplingParams(max_new=6), rid=i)
               for i, p in enumerate(prompts)}
    while True:
        more = eng.step()
        _assert_pool_conserved(eng.cache)
        for rid, k in cancel_after.items():
            h = handles[rid]
            if not h.done and len(h.request.out or []) >= k:
                h.cancel()
                _assert_pool_conserved(eng.cache)
        if not more:
            break
    for rid, h in handles.items():
        if rid in cancel_after:
            assert h.status == "cancelled"
            assert len(h.request.out) >= cancel_after[rid]
        else:
            assert h.status == "done"
            assert h.request.out == _CANCEL_BASELINE[rid]
    assert eng.metrics()["cancelled"] == len(cancel_after)
    assert eng.cache.pages_live() == eng.cache.index_pages()
    _assert_pool_conserved(eng.cache)


# ------------------------------------------------------------- paged_copy


@pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16"])
def test_paged_copy_plain_matches_reference(dtype):
    """Disjoint, overlapping (a dst page read later as a src reads the
    ORIGINAL bits), self-copying, repeated-source and out-of-range ids."""
    rng = np.random.RandomState(0)
    host = rng.randint(-100, 100, size=(7, 4, 2, 6)).astype(np.float32)
    jpool = jnp.asarray(host).astype(getattr(jnp, dtype))
    tpool = bridge.to_tensor(np.asarray(jpool), device="cpu")
    cases = [([3, 1], [5, 6]), ([1, 2], [2, 3]), ([4, 2, 5], [4, 1, 2]), ([3, 3], [0, 6]),
             ([9, -1, 2], [1, -2, 11])]
    for src, dst in cases:
        want = RPG.paged_copy_ref(jpool, jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32))
        got = paged_copy_ref(tpool.clone(), torch.tensor(src, dtype=torch.int32),
                             torch.tensor(dst, dtype=torch.int32))
        np.testing.assert_array_equal(bridge.to_numpy(got).view(np.uint8),
                                      np.asarray(want).view(np.uint8), err_msg=str((src, dst)))
    out = ops.paged_copy(tpool.clone(), torch.tensor([1, 2], dtype=torch.int32),
                         torch.tensor([2, 3], dtype=torch.int32))
    assert torch.equal(out[3], tpool[2]) and torch.equal(out[2], tpool[1])
