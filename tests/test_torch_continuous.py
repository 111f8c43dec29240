"""PyTorch port, continuous batching: ``mixed_step``, the dense cache write,
``SnapshotRing``, ``PrefillCursor`` and ``ServeEngine(mixed=True)`` on the
CPU, against the JAX reference and the port's own serialized engine.

Reduced internlm2-1.8b under w4a8 with an 8-bit KV cache, weights shared
through the bridge, 2 slots, s_max 32, pages of 16, prompt lengths (3, 9,
5, 2, 7) as in tests/test_torch_serve.py. Tolerances: none. ``mixed_step``
and the dense write are bit-identical to the reference run op by op
(``jax.disable_jit()``), logits and every cache byte, scratch page included;
continuous streams equal the serialized ones token for token (greedy, and
sampled with ``fused_attn=False`` on both engines, the reference's rule:
mixed steps read the cache unfused) and the reference mixed engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro import configs  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro.serve import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    PrefillCursor,
    Request,
    SamplingParams,
    Scheduler,
    ServeEngine,
    SnapshotRing,
    make_scheduler,
)

jax.config.update("jax_platform_name", "cpu")

TINY = configs.reduced(configs.get_arch("internlm2-1.8b"))
POLICY = get_policy("w4a8")
TTINY = tconfigs.reduced(tconfigs.get_arch("internlm2-1.8b"))
TPOLICY = tget_policy("w4a8")
LENGTHS = (3, 9, 5, 2, 7)
ENGINE = dict(n_slots=2, s_max=32, prefill_chunk=4)
PS, S_MAX, W = 16, 32, 4
CACHES = ("slot", "paged", "prefix")


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _requests(cls, params=None):
    rng = np.random.RandomState(0)
    return [cls(rid=i, prompt=rng.randint(1, TINY.vocab, size=n).astype(np.int32), max_new=4,
                params=None if params is None else params(i))
            for i, n in enumerate(LENGTHS)]


def _sampled(i):
    return SamplingParams(temperature=(0.7, 1.0, 1.6, 0.0, 0.9)[i], top_k=(16, 0, 40, 0, 1)[i],
                          top_p=(0.95, 0.9, 1.0, 1.0, 0.5)[i], seed=1000 + i, max_new=4)


def _engine(tp, cache, **kw):
    ps = dict(page_size=PS) if cache != "slot" else {}
    return ServeEngine(tp, TTINY, TPOLICY, cache=cache, device="cpu", **ENGINE, **ps, **kw)


@pytest.fixture(scope="module")
def params():
    jp = RM.init_params(jax.random.key(3), TINY, POLICY, mode="serve")
    return jp, bridge.params_from_reference(_np(jp), device="cpu")


# ------------------------------------------------------- dense cache write


@pytest.mark.parametrize("dtype", [np.int8, np.float32, "bf16"])
def test_dense_seq_insert_equals_reference_and_drops_past_s_max(dtype):
    """The port's dense write (no boolean mask, no host sync) against the
    reference's vector-``pos`` scatter: rows past s_max are dropped, never
    clamped onto the last row; a row whose window starts before its write
    keeps its bytes."""
    rng = np.random.RandomState(1)
    B, S_new, tail = 4, 5, (3, 8)
    buf = (rng.randn(B, S_MAX, *tail) * 40).clip(-100, 100)
    new = (rng.randn(B, S_new, *tail) * 40).clip(-100, 100)
    if dtype == "bf16":
        buf, new = jnp.asarray(buf, jnp.bfloat16), jnp.asarray(new, jnp.bfloat16)
    else:
        buf, new = jnp.asarray(buf.astype(dtype)), jnp.asarray(new.astype(dtype))
    pos = np.array([0, S_MAX - 2, 13, S_MAX], np.int32)  # lane 1 runs 3 rows past s_max
    want = np.asarray(RA.seq_insert(buf, new, jnp.asarray(pos)))
    got = bridge.to_tensor(np.asarray(buf), device="cpu")
    TA.seq_insert([got], [bridge.to_tensor(np.asarray(new), device="cpu")], torch.from_numpy(pos))
    got = bridge.to_numpy(got)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    # the last row of lane 1 holds its own new row, not a clamped later one
    np.testing.assert_array_equal(got[1, -1].view(np.uint8),
                                  np.asarray(new)[1, 1].view(np.uint8))
    np.testing.assert_array_equal(got[3].view(np.uint8), np.asarray(buf)[3].view(np.uint8))


def test_row_window_indices_are_distinct_and_in_range():
    pos = torch.tensor([0, 28, 31, 32, 40], dtype=torch.int32)
    rows, idx, src = TA.row_window(pos, 6, S_MAX)
    assert rows.shape == (5, 1) and idx.shape == src.shape == (5, 6)
    assert int(idx.min()) >= 0 and int(idx.max()) < S_MAX
    for r in range(5):
        assert len(set(idx[r].tolist())) == 6
    assert torch.equal(src, idx - pos.long()[:, None])
    assert idx[1].tolist() == list(range(26, 32)) and src[1].tolist() == list(range(-2, 4))


# -------------------------------------------------------------- mixed_step

#: lanes: decode, prefill (padded), idle, and a fourth per case: dense, a
#: decode lane whose tail runs past s_max; paged "scratch", the prefill
#: lane's tail crosses into an unallocated block (the scratch page);
#: paged "past_table", a decode lane whose tail runs past its table
MIXED_CASES = {
    "dense": dict(pos=[5, 0, 4, S_MAX - 2], n_real=[1, 3, 0, 1]),
    "scratch": dict(pos=[5, 13, 4, 20], n_real=[1, 2, 0, 1],
                    bt=[[3, 0], [1, 0], [5, 0], [7, 8]]),
    "past_table": dict(pos=[5, 8, 4, S_MAX - 2], n_real=[1, 3, 0, 1],
                       bt=[[3, 0], [1, 2], [5, 0], [7, 8]]),
}


@pytest.mark.parametrize("case", sorted(MIXED_CASES))
def test_mixed_step_bit_identical_to_reference(params, case):
    """One mixed step (decode, prefill, idle lanes, a padded tail past the
    cache or on the scratch page) from a random cache: the logits and every
    cache byte equal the reference's ``mixed_step`` run op by op."""
    jp, tp = params
    c = MIXED_CASES[case]
    B = len(c["pos"])
    rng = np.random.RandomState(7)
    paged = "bt" in c
    jc = (RM.init_paged_cache(TINY, POLICY, 9, PS) if paged
          else RM.init_cache(TINY, POLICY, B, S_MAX))
    jc = jax.tree.map(lambda a: (rng.randn(*a.shape) * 40).clip(-100, 100).astype(a.dtype),
                      _np(jc))
    toks = rng.randint(1, TINY.vocab, size=(B, W)).astype(np.int32)
    pos, n_real = np.array(c["pos"], np.int32), np.array(c["n_real"], np.int32)
    kw = dict(block_tables=np.array(c["bt"], np.int32), page_size=PS) if paged else {}
    with jax.disable_jit():
        want, want_c = RM.mixed_step(jp, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(n_real),
                                     jax.tree.map(jnp.asarray, jc), TINY, POLICY, impl="jnp",
                                     **{k: jnp.asarray(v) if k == "block_tables" else v
                                        for k, v in kw.items()})
    tc = bridge.caches_from_reference(jc, device="cpu")
    tkw = {k: torch.from_numpy(v) if k == "block_tables" else v for k, v in kw.items()}
    got = TM.mixed_step(tp, torch.from_numpy(toks), torch.from_numpy(pos),
                        torch.from_numpy(n_real), tc, TTINY, TPOLICY, **tkw)
    assert tuple(got.shape) == (B, 1, TINY.vocab_padded)
    live = n_real > 0
    np.testing.assert_array_equal(bridge.to_numpy(got)[live].view(np.uint16),
                                  np.asarray(want)[live].view(np.uint16))
    ref = bridge.caches_to_numpy(bridge.caches_from_reference(_np(want_c), device="cpu"))
    mine = bridge.caches_to_numpy(tc)
    for r, g in zip(ref, mine, strict=True):
        for k in r:
            np.testing.assert_array_equal(g[k].view(np.uint8), r[k].view(np.uint8), err_msg=k)


def test_mixed_step_refuses_paged_without_page_size(params):
    tc = TM.init_paged_cache(TTINY, TPOLICY, 3, PS, device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        TM.mixed_step(params[1], torch.ones((1, W), dtype=torch.int32), [0], [1], tc, TTINY,
                      TPOLICY, block_tables=torch.zeros((1, 2), dtype=torch.int32))


# ----------------------------------------------------- continuous engine


@pytest.fixture(scope="module")
def serial(params):
    """The port's serialized streams: greedy (default fused read) and
    sampled (fused_attn=False), on every cache."""
    tp = params[1]
    out = {}
    for cache in CACHES:
        out[cache, "greedy"] = _engine(tp, cache).run(_requests(Request))
        out[cache, "sampled"] = _engine(tp, cache, fused_attn=False).run(
            _requests(Request, _sampled))
    return out


@pytest.fixture(scope="module")
def reference_mixed(params):
    """The reference mixed engine (budget 4, inflight 2) run op by op."""
    jp = params[0]
    out = {}
    for cache in CACHES:
        ps = dict(page_size=PS) if cache != "slot" else {}
        eng = RServeEngine(jp, TINY, POLICY, impl="jnp", prefill="chunked", cache=cache,
                           mixed=True, mixed_budget=W, inflight=2, **ENGINE, **ps)
        with jax.disable_jit():
            got = eng.run(_requests(RRequest))
        out[cache] = (got, eng.metrics())
    return out


@pytest.mark.parametrize("inflight", [2, 3])
@pytest.mark.parametrize("cache", CACHES)
def test_continuous_greedy_streams_equal_serialized(params, serial, cache, inflight):
    eng = _engine(params[1], cache, mixed=True, mixed_budget=W, inflight=inflight)
    got = eng.run(_requests(Request))
    assert got == serial[cache, "greedy"]
    m = eng.metrics()
    assert m["mode"] == "continuous" and m["mixed_budget"] == W
    assert m["inflight_depth"] == inflight and m["inflight"] == 0
    assert m["mixed_steps"] > 0 and m["prefill_jit_calls"] == 0
    assert m["kernels/mpmm_calls"] > 0
    if cache != "slot":
        assert m["kernels/paged_scatter_calls"] > 0 and m["kernels/paged_gather_calls"] > 0
        assert m["kernels/paged_attn_calls"] > 0  # the pure-decode steps read fused


@pytest.mark.parametrize("inflight", [2, 3])
@pytest.mark.parametrize("cache", CACHES)
def test_continuous_sampled_streams_equal_serialized(params, serial, cache, inflight):
    """Seeded sampling through the pipeline: counters advance at dispatch,
    the lanes cross as ring snapshots, and every token matches the
    serialized engine (both unfused)."""
    eng = _engine(params[1], cache, fused_attn=False, mixed=True, mixed_budget=W,
                  inflight=inflight)
    assert eng.run(_requests(Request, _sampled)) == serial[cache, "sampled"]
    assert eng.metrics()["inflight"] == 0


@pytest.mark.parametrize("cache", CACHES)
def test_continuous_equals_reference_mixed_engine(params, reference_mixed, cache):
    ref_out, ref_m = reference_mixed[cache]
    eng = _engine(params[1], cache, mixed=True, mixed_budget=W, inflight=2)
    assert eng.run(_requests(Request)) == ref_out
    m = eng.metrics()
    for k in ("mixed_steps", "decode_steps", "mode", "mixed_budget", "inflight_depth",
              "inflight", "tokens_generated", "requests_completed", "prefill_jit_calls"):
        assert m[k] == ref_m[k], k
    assert sorted(m) == sorted(ref_m)


def test_deepseek_continuous_equals_serialized():
    """Reduced DeepSeek-V3 (its MLA-dense layers; the port's own seeded
    weights) on the paged and slot caches: continuous streams equal
    serialized ones."""
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch("deepseek-v3-671b")),
                              dense_layers=2)
    tp = TM.init_params(torch.Generator().manual_seed(3), cfg, TPOLICY, device="cpu")
    for cache in ("slot", "paged"):
        ps = dict(page_size=PS) if cache != "slot" else {}

        def mk(**kw):
            return ServeEngine(tp, cfg, TPOLICY, cache=cache, device="cpu", **ENGINE, **ps, **kw)

        ser = mk().run(_requests(Request))
        eng = mk(mixed=True, mixed_budget=W, inflight=2)
        assert eng.run(_requests(Request)) == ser
        m = eng.metrics()
        assert m["mixed_steps"] > 0 and m["kernels/paged_mla_attn_calls"] > 0


def test_inflight_bound_and_mixed_step_accounting(params):
    """The dispatch queue never exceeds ``inflight`` (read from token
    callbacks) and every prompt token enters through a mixed step."""
    depth_seen = []
    eng = _engine(params[1], "paged", mixed=True, mixed_budget=W, inflight=3)
    reqs = _requests(Request)
    for r in reqs:
        r.on_token = lambda rid, tok: depth_seen.append(eng.metrics()["inflight"])
    eng.run(reqs)
    assert depth_seen and max(depth_seen) <= 3
    assert eng.metrics()["mixed_steps"] >= -(-sum(LENGTHS) // W)


def test_mixed_requires_chunkable_prefill(params):
    with pytest.raises(ValueError, match="chunked prefill"):
        _engine(params[1], "slot", mixed=True, prefill="stepwise")
    for bad in (dict(mixed_budget=0), dict(inflight=0)):
        with pytest.raises(ValueError):
            _engine(params[1], "slot", mixed=True, **bad)


class _DecliningScheduler(Scheduler):
    """Never yields a request: queued work that admission can never place."""

    name = "decline"

    def pick(self, fits=None, cost=None):
        return 0

    def next_request(self, fits=None, cost=None):
        return None


def test_drain_raises_on_wedge_instead_of_spinning(params):
    """The mixed case of the reference's wedge test: drain() raises after a
    bounded run of no-op steps, and the queued request stays visible."""
    eng = _engine(params[1], "slot", mixed=True, scheduler=_DecliningScheduler())
    eng.submit(np.array([5, 6, 7], np.int32), SamplingParams(max_new=2))
    assert eng.step()
    with pytest.raises(RuntimeError, match="wedged"):
        eng.drain()
    assert eng.metrics()["queue_depth"] == 1


# --------------------------------------------------- churn under mixed steps

_RNG = np.random.RandomState(11)
_SHARED = _RNG.randint(1, TINY.vocab, size=12).astype(np.int32)
_PROMPTS = [np.concatenate([_SHARED, _RNG.randint(1, TINY.vocab, size=3 + i)]).astype(np.int32)
            for i in range(4)]
_PROMPTS.append(_RNG.randint(1, TINY.vocab, size=10).astype(np.int32))
_BASE: dict = {}


def _churn_engine(tp, backend="prefix", **kw):
    return ServeEngine(tp, TTINY, TPOLICY, n_slots=3, s_max=32, cache=backend, page_size=4,
                       fused_attn=False, device="cpu", **kw)


def _churn_baseline(tp):
    """Serialized baseline; the stop sequences come from a no-stop run (a
    2-gram of request 1's stream, the 4th token of request 3), so stops fire
    mid-decode. Computed once per module."""
    if not _BASE:
        plain = _churn_engine(tp).run([Request(rid=i, prompt=p.copy(), max_new=6)
                                       for i, p in enumerate(_PROMPTS)])
        stops = {1: (tuple(plain[1][2:4]),), 3: ((plain[3][3],),)}
        eng = _churn_engine(tp)
        hs = {i: eng.submit(p.copy(), SamplingParams(max_new=6, stop=stops.get(i, ())), rid=i)
              for i, p in enumerate(_PROMPTS)}
        eng.drain()
        _BASE.update(stops=stops, expect={i: list(h.request.out) for i, h in hs.items()},
                     status={i: h.status for i, h in hs.items()})
        assert "stopped" in _BASE["status"].values()
    return _BASE["stops"], _BASE["expect"], _BASE["status"]


def _assert_pool_conserved(cache):
    """free + distinct live pages (tables and index) + scratch == n_pages,
    and no page both free and mapped."""
    table = {int(p) for s in range(cache.n_slots)
             for p in cache.block_tables[s, :int(cache._alloc[s])]}
    index = set()
    if hasattr(cache, "_root"):
        def walk(node):
            for ch in node.children.values():
                index.add(ch.page)
                walk(ch)
        walk(cache._root)
    live = (table | index) - {0}
    assert len(cache._free) + len(live) + 1 == cache.n_pages
    assert not live.intersection(cache._free)


@settings(max_examples=4, deadline=None)
@given(data=st.data())
def test_mixed_step_churn_conserves_pool_and_survivors(data, params):
    """Random mid-flight cancels against the continuous engine, with stop
    sequences firing while steps are in flight: the pool is conserved
    after every step, survivors' streams and statuses equal the serialized
    baseline, and a cancelled request holds a prefix of its baseline (its
    in-flight tickets drop, never emit)."""
    tp = params[1]
    stops, expect, status = _churn_baseline(tp)
    backend = data.draw(st.sampled_from(["paged", "prefix"]), label="backend")
    n_pages = data.draw(st.integers(18, 30), label="pages")
    cancel_after = {
        rid: data.draw(st.integers(1, 4), label=f"after{rid}")
        for rid in set(data.draw(st.lists(st.sampled_from(range(len(_PROMPTS))), min_size=0,
                                          max_size=2), label="cancel"))}
    eng = _churn_engine(tp, backend=backend, n_pages=n_pages, mixed=True, mixed_budget=4,
                        inflight=2)
    hs = {i: eng.submit(p.copy(), SamplingParams(max_new=6, stop=stops.get(i, ())), rid=i)
          for i, p in enumerate(_PROMPTS)}
    while True:
        more = eng.step()
        _assert_pool_conserved(eng.cache)
        for rid, k in cancel_after.items():
            h = hs[rid]
            if not h.done and len(h.request.out or []) >= k:
                h.cancel()
                _assert_pool_conserved(eng.cache)
        if not more:
            break
    for rid, h in hs.items():
        if h.status == "cancelled":
            assert rid in cancel_after
            got = list(h.request.out)
            assert got == expect[rid][:len(got)]
        else:
            assert list(h.request.out) == expect[rid]
            assert h.status == status[rid]
    m = eng.metrics()
    assert m["cancelled"] == sum(1 for h in hs.values() if h.status == "cancelled")
    assert m["inflight"] == 0
    _assert_pool_conserved(eng.cache)


# ----------------------------------------------------------- unit pieces


def test_snapshot_ring_isolation_and_reuse():
    ring = SnapshotRing(3)
    a = np.array([1, 2, 3], np.int32)
    s1 = ring.take("pos", a)
    a[:] = [4, 5, 6]
    s2 = ring.take("pos", a)
    a[:] = [7, 8, 9]
    s3 = ring.take("pos", a)
    # snapshots are immune to later host mutation (the host_copy contract)
    assert s1.tolist() == [1, 2, 3] and s2.tolist() == [4, 5, 6]
    # the 4th take recycles snapshot 1's buffer (generations=3), leaving
    # the two most recent generations intact
    a[:] = [10, 11, 12]
    ring.take("pos", a)
    assert s2.tolist() == [4, 5, 6] and s3.tolist() == [7, 8, 9]
    # same-shaped values under DIFFERENT names never share buffers
    t1 = ring.take("temps", np.array([1.0, 2.0], np.float32))
    for v in (9.0, 8.0, 7.0):
        ring.take("top_ps", np.array([v, v], np.float32))
    assert t1.tolist() == [1.0, 2.0]
    # a shape change mid-stream reallocates instead of writing garbage
    assert tuple(ring.take("pos", np.zeros(5, np.int32)).shape) == (5,)
    with pytest.raises(ValueError):
        SnapshotRing(1)


def test_prefill_cursor_and_allot():
    reqs = [Request(rid=i, prompt=np.arange(1, n + 1, dtype=np.int32), max_new=2)
            for i, n in enumerate((10, 3, 6))]
    curs = [PrefillCursor(r, r.prompt, slot=i, order=i) for i, r in enumerate(reqs)]
    assert curs[0].remaining == 10 and not curs[0].done
    assert curs[0].take(4).tolist() == [1, 2, 3, 4]
    assert curs[0].remaining == 6 and curs[0].chunks == 1
    got = make_scheduler("fcfs").allot(curs, 8)
    assert [(c.slot, n) for c, n in got] == [(0, 6), (1, 2)]
    got = make_scheduler("spf").allot(curs, 8)
    assert [(c.slot, n) for c, n in got] == [(1, 3), (0, 5)]
    reqs[2].priority = 5
    got = make_scheduler("priority").allot(curs, 8)
    assert (got[0][0].slot, got[0][1]) == (2, 6)
    assert sum(n for _, n in got) <= 8
    c = PrefillCursor(reqs[0], reqs[0].prompt, slot=0, order=9, off=8)
    assert c.remaining == 2 and c.take(16).tolist() == [9, 10]
    assert c.done


def test_sample_tokens_takes_device_lanes():
    """Lanes given as tensors on the logits' device (the ring's snapshots)
    draw the same tokens as host lanes; temperatures on the device need
    ``sampled=``."""
    g = np.random.RandomState(4)
    logits = torch.from_numpy(g.randn(4, 300).astype(np.float32) * 3)
    lanes = [np.array([0.0, 0.8, 1.3, 0.6], np.float32), np.array([0, 40, 3, 0], np.int32),
             np.array([1.0, 0.95, 0.5, 0.9], np.float32),
             np.array([7, 8, 9, 2**32 - 1], np.uint32), np.array([0, 3, 9, 5], np.int32)]
    want = TM.sample_tokens(logits, *lanes)
    dev_lanes = [torch.from_numpy(lanes[0])] + [torch.from_numpy(x.astype(np.int64)) if
                                                x.dtype != np.float32 else torch.from_numpy(x)
                                                for x in lanes[1:]]
    assert torch.equal(TM.sample_tokens(logits, *dev_lanes, sampled=True), want)
    assert torch.equal(TM.sample_tokens(logits, *dev_lanes), want)  # CPU temps are readable
    assert torch.equal(TM.sample_tokens(logits, *dev_lanes, sampled=False),
                       logits.argmax(-1).to(torch.int32))
