"""PyTorch port, seeded sampling: the threefry PRNG (``core/prng.py``) and
``models.model.sample_tokens`` against ``jax.random`` and the reference's
sampler, then the serving engine at temperature > 0 against the reference
engine (reduced internlm2-1.8b, w4a8, 8-bit KV, run op by op) on the slot,
paged and prefix caches, and the reference's sampling contracts
(tests/test_api.py) held for the port. CPU only.

Tolerances and why:
  * keys, ``fold_in``, random bits and uniforms are integer or exact float
    arithmetic: bit-identical;
  * Gumbel noise is ``-log(-log(u))``; XLA's CPU ``log`` and PyTorch's
    differ by at most one f32 ulp on the same input, so each ``log`` step
    is held within 1 ulp of JAX's on JAX's own input, and the noise within
    2 ulps of ``max(|g|, 1)``;
  * sampled tokens: equal to the reference's, except where the replayed
    reference step shows a near tie (``NEAR`` f32 ulps): the two best
    perturbed scores, or a token's exclusive cumulative probability against
    ``top_p`` (the nucleus cut; ``exp`` and the sums differ by ulps). Every
    other lane must agree; the grid's lanes all agree today.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro import configs  # noqa: E402
from repro.core import policy as RP  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import SamplingParams as RSamplingParams  # noqa: E402
from repro.serve import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import policy as TP  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import Request, SamplingParams, ServeEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SEEDS = (0, 1, 2**31, 2**32 - 1)
COUNTERS = (0, 1, 7, 2**31 - 1)
TEMPS, TOP_KS, TOP_PS = (0.5, 1.0, 2.0), (0, 1, 16), (0.5, 0.95, 1.0)
#: f32 ulps inside which two reference quantities count as a near tie
NEAR = 4
TINY = configs.reduced(configs.get_arch("internlm2-1.8b"))
TTINY = tconfigs.reduced(tconfigs.get_arch("internlm2-1.8b"))
POLICY, TPOLICY = get_policy("w4a8"), tget_policy("w4a8")
ENGINE = dict(n_slots=2, s_max=32, prefill_chunk=4)


def _jkey(seed, ctr):
    return jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(seed)), ctr)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


# ------------------------------------------------------------- (a) the PRNG


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_and_uniforms_bit_identical(seed):
    assert prng.prng_key(seed).tolist() == np.asarray(
        jax.random.PRNGKey(jnp.uint32(seed))).astype(np.int64).tolist()
    for ctr in COUNTERS:
        jk, tk = _jkey(seed, ctr), prng.fold_in(prng.prng_key(seed), ctr)
        assert tk.tolist() == np.asarray(jk).astype(np.int64).tolist(), ctr
        bits = np.asarray(jax.random.bits(jk, (4099,), jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(prng.random_bits(tk, 4099).numpy(), bits)
        for lo in (0.0, prng.TINY):
            ju = np.asarray(jax.random.uniform(jk, (4099,), jnp.float32, lo, 1.0))
            tu = prng.uniform(tk, 4099, lo, 1.0).numpy()
            np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))


def test_batched_keys_match_one_at_a_time():
    """Keys and bits for a (B,) batch of (seed, counter) lanes equal the
    lanes drawn one by one."""
    seeds, ctrs = np.array(SEEDS, np.int64), np.array(COUNTERS, np.int64)
    keys = prng.fold_in(prng.prng_key(torch.from_numpy(seeds)), torch.from_numpy(ctrs))
    bits = prng.random_bits(keys, 64)
    for i, (s, c) in enumerate(zip(SEEDS, COUNTERS)):
        assert keys[i].tolist() == np.asarray(_jkey(s, c)).astype(np.int64).tolist()
        np.testing.assert_array_equal(
            bits[i].numpy(), np.asarray(jax.random.bits(_jkey(s, c), (64,))).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_one_ulp_per_log(seed):
    V = 92544  # internlm2's padded vocabulary
    for ctr in COUNTERS:
        jk, tk = _jkey(seed, ctr), prng.fold_in(prng.prng_key(seed), ctr)
        u = np.array(jax.random.uniform(jk, (V,), jnp.float32, prng.TINY, 1.0))
        inner = np.array(-jnp.log(jnp.asarray(u)))
        assert _ulps((-torch.log(torch.from_numpy(u))).numpy(), inner).max() <= 1
        outer = np.asarray(-jnp.log(jnp.asarray(inner)))
        assert _ulps((-torch.log(torch.from_numpy(inner))).numpy(), outer).max() <= 1
        jg = np.asarray(jax.random.gumbel(jk, (V,)))
        tg = prng.gumbel(tk, V).numpy()
        np.testing.assert_array_equal(jg, outer)  # the same two steps
        assert (np.abs(tg - jg) <= 2 * np.spacing(np.maximum(np.abs(jg), 1))).all()


# ------------------------------------------------------------ (b) sampler


def _logits(V=1000):
    """Seeded logit rows: plain, a 50-way tie at the top, integer-rounded
    (many ties everywhere), bf16-rounded (the model's head output)."""
    rng = np.random.RandomState(5)
    x = (rng.randn(4, V) * 3).astype(np.float32)
    x[1, :50] = x[1].max() + 1.0
    x[2] = np.round(x[2])
    x[3] = np.asarray(jnp.asarray(x[3]).astype(jnp.bfloat16).astype(jnp.float32))
    return x


def _ref_sample(logits, temps, top_k, top_p, seeds, ctrs):
    with jax.disable_jit():
        return np.asarray(RM.sample_tokens(
            jnp.asarray(logits), jnp.asarray(temps, jnp.float32), jnp.asarray(top_k, jnp.int32),
            jnp.asarray(top_p, jnp.float32), jnp.asarray(seeds, jnp.uint32),
            jnp.asarray(ctrs, jnp.int32)))


def _near_tie(lg_row, t, k, p, seed, ctr) -> bool:
    """Replay the reference's steps for one lane: True where its two best
    perturbed scores, or some token's exclusive cumulative probability and
    ``p``, lie within NEAR f32 ulps."""
    with jax.disable_jit():
        lg = jnp.asarray(lg_row) / jnp.maximum(jnp.float32(t), 1e-6)
        order = jnp.argsort(-lg)
        kth = lg[order[jnp.clip(k - 1, 0, lg.shape[0] - 1)]]
        lg = jnp.where((k > 0) & (lg < kth), -jnp.inf, lg)
        sp = jax.nn.softmax(lg)[order]
        excl = np.asarray(jnp.cumsum(sp) - sp)
        keep = jnp.zeros(lg.shape, bool).at[order].set(jnp.asarray(excl) < p)
        scores = np.asarray(jax.random.gumbel(_jkey(seed, ctr), lg.shape)
                            + jnp.where(keep, lg, -jnp.inf))
    if p < 1.0 and (_ulps(excl, np.float32(p)) <= NEAR).any():
        return True
    a, b = np.sort(scores[np.isfinite(scores)])[-2:]
    return bool(_ulps(a, b) <= NEAR)


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_tokens_matches_reference_grid(seed):
    """Every lane of counter x temperature x top-k x top-p over four logit
    rows (ties included), against the reference's sampler run op by op."""
    rows = _logits()
    grid = list(itertools.product(range(len(rows)), COUNTERS, TEMPS, TOP_KS, TOP_PS))
    logits = np.stack([rows[r] for r, *_ in grid])
    temps = np.array([g[2] for g in grid], np.float32)
    top_k = np.array([g[3] for g in grid], np.int32)
    top_p = np.array([g[4] for g in grid], np.float32)
    seeds = np.full(len(grid), seed, np.uint32)
    ctrs = np.array([g[1] for g in grid], np.int32)
    want = _ref_sample(logits, temps, top_k, top_p, seeds, ctrs)
    got = TM.sample_tokens(torch.from_numpy(logits), temps, top_k, top_p, seeds, ctrs).numpy()
    for i in np.flatnonzero(got != want):
        assert _near_tie(logits[i], temps[i], top_k[i], top_p[i], seed, ctrs[i]), grid[i]
    # top-k = 1 is the argmax at every temperature where the maximum is unique
    k1 = (top_k == 1) & ((logits == logits.max(-1, keepdims=True)).sum(-1) == 1)
    assert k1.any()
    np.testing.assert_array_equal(got[k1], logits[k1].argmax(-1))


def test_sample_tokens_mixed_lanes_and_greedy_unchanged():
    """Greedy lanes beside stochastic ones keep their argmax (first maximum),
    idle lanes (temperature 0) too; an all-greedy call is the argmax."""
    rows = _logits()
    temps = np.array([0.0, 0.8, 0.0, 1.3], np.float32)
    args = (temps, np.array([0, 40, 3, 0], np.int32), np.array([1.0, 0.95, 0.5, 0.9], np.float32),
            np.array([1000, 1001, 1002, 1003], np.uint32), np.array([0, 3, 9, 2**31 - 1], np.int32))
    got = TM.sample_tokens(torch.from_numpy(rows), *args).numpy()
    np.testing.assert_array_equal(got, _ref_sample(rows, *args))
    np.testing.assert_array_equal(got[[0, 2]], rows[[0, 2]].argmax(-1))
    greedy = TM.sample_tokens(torch.from_numpy(rows), np.zeros(4, np.float32))
    np.testing.assert_array_equal(greedy.numpy(), rows.argmax(-1))


def test_sample_tokens_snapshots_its_lanes():
    """The sampler copies the host lanes it is given: mutating them after
    the call does not move what it drew."""
    rows = torch.from_numpy(_logits())
    lanes = [np.full(4, 0.9, np.float32), np.zeros(4, np.int32), np.full(4, 0.95, np.float32),
             np.arange(4, dtype=np.uint32), np.zeros(4, np.int32)]
    a = TM.sample_tokens(rows, *lanes)
    for x in lanes:
        x += 1
    b = TM.sample_tokens(rows, *[x - 1 for x in lanes])
    assert torch.equal(a, b)


# ------------------------------------------------------------- (c) engine


@pytest.fixture(scope="module")
def params():
    jp = RM.init_params(jax.random.key(3), TINY, POLICY, mode="serve")
    return jp, bridge.params_from_reference(jax.tree.map(lambda x: np.array(x, copy=True), jp),
                                           device="cpu")


def _prompts():
    """Five prompts; the first three share an 8-token prefix (two pages of
    4, so the prefix cache maps them), one is greedy in the mix."""
    rng = np.random.RandomState(2)
    shared = rng.randint(1, TINY.vocab, size=8)
    tails = [rng.randint(1, TINY.vocab, size=n) for n in (3, 5, 2)]
    out = [np.concatenate([shared, t]) for t in tails]
    out += [rng.randint(1, TINY.vocab, size=n) for n in (7, 4)]
    return [p.astype(np.int32) for p in out]


def _sparams(cls, i):
    if i == 3:
        return cls(max_new=5)  # a greedy lane among stochastic ones
    return cls(temperature=(0.7, 1.0, 1.6, 0.0, 0.9)[i], top_k=(16, 0, 40, 0, 1)[i],
               top_p=(0.95, 0.9, 1.0, 1.0, 0.5)[i], seed=1000 + i, max_new=5)


def _serve(make, cls, cache):
    ps = dict(page_size=4) if cache != "slot" else {}
    eng = make(cache=cache, **ENGINE, **ps)
    hs = [eng.submit(p.copy(), _sparams(cls, i)) for i, p in enumerate(_prompts())]
    eng.drain()
    return [h.result() for h in hs], eng


@pytest.fixture(scope="module")
def engine_runs(params):
    jp, tp = params
    out = {}
    for cache in ("slot", "paged", "prefix"):
        with jax.disable_jit():
            ref, _ = _serve(lambda **kw: RServeEngine(jp, TINY, POLICY, impl="jnp",
                                                      prefill="chunked", **kw),
                            RSamplingParams, cache)
        port, eng = _serve(lambda **kw: ServeEngine(tp, TTINY, TPOLICY, device="cpu", **kw),
                           SamplingParams, cache)
        out[cache] = (ref, port, eng.metrics())
    return out


@pytest.mark.parametrize("cache", ["slot", "paged", "prefix"])
def test_sampled_streams_identical_to_reference(engine_runs, cache):
    ref, port, m = engine_runs[cache]
    assert port == ref
    assert [len(t) for t in port] == [5] * 5
    if cache == "prefix":
        assert m["cache/prefix_hit_rate"] > 0


def test_sampled_streams_identical_across_caches(engine_runs):
    assert engine_runs["slot"][1] == engine_runs["paged"][1] == engine_runs["prefix"][1]


def _w4only(P):
    return P.PrecisionPolicy(name="w4only", default=P.LayerPrecision(None, 4, None),
                             per_class={"router": P.BF16}, kv_cache_bits=8)


@pytest.mark.parametrize("family", ["mla", "w4only"])
def test_sampled_streams_other_families(family):
    """The same sampled requests through the MLA layers (the expert-free
    reduced DeepSeek-V3, w4a8) and through a weight-only w4 policy (reduced
    internlm2) on the slot cache: streams equal to the reference engine's."""
    if family == "mla":
        ref_cfg = dataclasses.replace(configs.reduced(configs.get_arch("deepseek-v3-671b")),
                                      dense_layers=2)
        cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch("deepseek-v3-671b")),
                                  dense_layers=2)
        ref_pol, pol = POLICY, TPOLICY
    else:
        ref_cfg, cfg, ref_pol, pol = TINY, TTINY, _w4only(RP), _w4only(TP)
    jp = RM.init_params(jax.random.key(3), ref_cfg, ref_pol, mode="serve")
    tp = bridge.params_from_reference(jax.tree.map(lambda x: np.array(x, copy=True), jp),
                                      device="cpu")
    with jax.disable_jit():
        ref, _ = _serve(lambda **kw: RServeEngine(jp, ref_cfg, ref_pol, impl="jnp",
                                                  prefill="chunked", **kw),
                        RSamplingParams, "slot")
    port, _ = _serve(lambda **kw: ServeEngine(tp, cfg, pol, device="cpu", **kw),
                     SamplingParams, "slot")
    assert port == ref


# ------------------------------------- (d) the reference's sampling contracts


def _engine(tp, **kw):
    return ServeEngine(tp, TTINY, TPOLICY, device="cpu", **{**ENGINE, **kw})


def _prompt(n=5, seed=0):
    return np.random.RandomState(seed).randint(1, TINY.vocab, size=n).astype(np.int32)


def _seeded(tp, seed, max_new=8, **kw):
    return _engine(tp, **kw).submit(_prompt(6, seed=9), SamplingParams(
        temperature=0.9, top_k=16, top_p=0.95, seed=seed, max_new=max_new)).result()


def test_seeded_sampling_reproducible_run_to_run(params):
    assert _seeded(params[1], 7) == _seeded(params[1], 7)


def test_seeded_sampling_backend_invariant(params):
    tp = params[1]
    a = _seeded(tp, 11)
    assert a == _seeded(tp, 11, cache="paged", page_size=4) == _seeded(
        tp, 11, cache="prefix", page_size=4)


def test_different_seeds_independent_per_slot(params):
    tp = params[1]
    eng = _engine(tp)
    mk = lambda s: SamplingParams(  # noqa: E731
        temperature=0.9, top_k=16, top_p=0.95, seed=s, max_new=8)
    h1 = eng.submit(_prompt(6, seed=9), mk(7))
    h2 = eng.submit(_prompt(6, seed=9), mk(8))
    eng.drain()
    assert h1.result() != h2.result()
    assert h1.result() == _seeded(tp, 7)


def test_temperature_zero_slots_untouched_by_stochastic_neighbors(params):
    tp = params[1]
    prompt = _prompt(9)
    solo = _engine(tp).run([Request(rid=0, prompt=prompt.copy(), max_new=6)])[0]
    eng = _engine(tp)
    hg = eng.submit(prompt.copy(), SamplingParams(max_new=6))
    eng.submit(_prompt(5, seed=3), SamplingParams(temperature=1.0, seed=5, max_new=6))
    eng.drain()
    assert hg.result() == solo


def test_top_k_1_is_greedy(params):
    tp = params[1]
    prompt = _prompt(9)
    greedy = _engine(tp).submit(prompt.copy(), SamplingParams(max_new=5)).result()
    k1 = _engine(tp).submit(prompt.copy(), SamplingParams(
        temperature=1.0, top_k=1, seed=3, max_new=5)).result()
    assert k1 == greedy


def test_released_slot_lanes_return_to_greedy(params):
    """``_release`` clears a slot's lanes; the counter follows the tokens
    emitted while the request is live."""
    eng = _engine(params[1], n_slots=1)
    h = eng.submit(_prompt(4), SamplingParams(temperature=0.8, top_k=5, top_p=0.9, seed=42,
                                              max_new=3))
    eng.step()  # admits (token 0, counter 0) and decodes token 1
    assert (eng._temps[0], eng._top_ks[0], eng._seeds[0], eng._counters[0]) == (
        np.float32(0.8), 5, 42, 2)
    h.result()
    assert (eng._temps[0], eng._top_ks[0], eng._top_ps[0], eng._seeds[0],
            eng._counters[0]) == (0.0, 0, 1.0, 0, 0)
