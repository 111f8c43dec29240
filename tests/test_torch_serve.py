"""PyTorch port, serving layer: the serialized ``ServeEngine`` on the CPU
against the reference engine, on the request stream of tests/test_serve.py
(reduced internlm2-1.8b, w4a8, 8-bit KV, shared weights via the bridge).

Greedy token streams must be identical on the slot and on the paged cache.
The reference engine runs op by op (``jax.disable_jit()``): that is the
program the port reproduces bit for bit. Its jitted build differs after a
few tokens on some requests, because XLA's CPU compiler keeps some bf16
products in f32 inside fusions (see tests/test_torch_model.py and ROADMAP
Queue 3). The page size is pinned to 16 on both sides: the reference would
otherwise take its CPU-tuned page size.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro.serve import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    CapacityError,
    PagedKVCache,
    Request,
    SamplingParams,
    ServeEngine,
    SlotCache,
)

jax.config.update("jax_platform_name", "cpu")

TINY = configs.reduced(configs.get_arch("internlm2-1.8b"))
POLICY = get_policy("w4a8")
TTINY = tconfigs.reduced(tconfigs.get_arch("internlm2-1.8b"))
TPOLICY = tget_policy("w4a8")
LENGTHS = (3, 9, 5, 2, 7)  # tests/test_serve.py: more requests than slots
ENGINE = dict(n_slots=2, s_max=32, prefill_chunk=4)


def _requests(cls, lengths, max_new=4, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(rid=i, prompt=rng.randint(1, TINY.vocab, size=n).astype(np.int32),
                max_new=max_new)
            for i, n in enumerate(lengths)]


@pytest.fixture(scope="module")
def params():
    jp = RM.init_params(jax.random.key(3), TINY, POLICY, mode="serve")
    return jp, bridge.params_from_reference(jax.tree.map(lambda x: np.array(x, copy=True), jp),
                                           device="cpu")


@pytest.fixture(scope="module")
def runs(params):
    jp, tp = params
    out = {}
    for cache in ("slot", "paged"):
        ps = dict(page_size=16) if cache == "paged" else {}
        ref = RServeEngine(jp, TINY, POLICY, impl="jnp", prefill="chunked", cache=cache,
                           **ENGINE, **ps)
        with jax.disable_jit():
            ref_out = ref.run(_requests(RRequest, LENGTHS))
        port = ServeEngine(tp, TTINY, TPOLICY, cache=cache, device="cpu", **ENGINE, **ps)
        port_out = port.run(_requests(Request, LENGTHS))
        out[cache] = (ref, ref_out, port, port_out)
    return out


@pytest.mark.parametrize("cache", ["slot", "paged"])
def test_greedy_streams_identical_to_reference(runs, cache):
    ref, ref_out, port, port_out = runs[cache]
    assert port_out == ref_out
    assert sorted(port_out) == list(range(len(LENGTHS)))
    assert all(len(v) == 4 for v in port_out.values())
    if cache == "paged":
        assert ref.cache.page_size == port.cache.page_size == 16


def test_slot_and_paged_streams_identical(runs):
    assert runs["slot"][3] == runs["paged"][3]


@pytest.mark.parametrize("cache", ["slot", "paged"])
def test_metrics_keys_match_reference(runs, cache):
    ref, _, port, _ = runs[cache]
    mr, mp = ref.metrics(), port.metrics()
    assert sorted(mp) == sorted(mr)
    for k in ("requests_completed", "tokens_generated", "decode_steps", "mode",
              "prefill_jit_calls", "prefill_chunk", "queue_depth", "active_slots",
              "cache/backend", "cache/kv_bytes_total", "spec/enabled"):
        assert mp[k] == mr[k], k
    assert mp["kernels/mpmm_calls"] > 0 and mp["kernels/paged_attn_calls"] > 0
    if cache == "paged":
        assert mp["kernels/paged_scatter_calls"] > 0


@pytest.fixture(scope="module")
def unfused_runs(params):
    """``fused_attn=False``: the reference engine on the paged cache (its
    decode reads the pool through paged_gather), and the port's engine on
    both caches."""
    jp, tp = params
    ps = dict(page_size=16)
    ref = RServeEngine(jp, TINY, POLICY, impl="jnp", prefill="chunked", cache="paged",
                       fused_attn=False, **ENGINE, **ps)
    with jax.disable_jit():
        ref_out = ref.run(_requests(RRequest, LENGTHS))
    out = {"ref": ref_out}
    for cache in ("slot", "paged"):
        port = ServeEngine(tp, TTINY, TPOLICY, cache=cache, device="cpu", fused_attn=False,
                           **ENGINE, **(ps if cache == "paged" else {}))
        out[cache] = port.run(_requests(Request, LENGTHS))
        out[cache + "_metrics"] = port.metrics()
    return out


def test_unfused_paged_streams_identical_to_reference(unfused_runs):
    """The unfused paged read (gather every pool leaf at stored width, then
    dequantize) gives the reference engine's streams, and the port's
    unfused slot streams."""
    got = unfused_runs["paged"]
    assert got == unfused_runs["ref"]
    assert got == unfused_runs["slot"]
    assert sorted(got) == list(range(len(LENGTHS))) and all(len(v) == 4 for v in got.values())
    m = unfused_runs["paged_metrics"]
    assert m["fused_attn"] is False and m["kernels/paged_gather_calls"] > 0
    assert "kernels/paged_attn_calls" not in m
    assert "kernels/paged_gather_calls" not in unfused_runs["slot_metrics"]


def test_engine_without_device_needs_cuda(params):
    """``device=None`` means CUDA for every entry point: on a host without
    CUDA they raise instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: ServeEngine() serves on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(params[1], TTINY, TPOLICY, n_slots=1, s_max=16)
    for make in (lambda: SlotCache(TTINY, TPOLICY, n_slots=1, s_max=16),
                 lambda: PagedKVCache(TTINY, TPOLICY, n_slots=1, s_max=16),
                 lambda: TM.init_params(torch.Generator(), TTINY, TPOLICY),
                 lambda: TM.init_cache(TTINY, TPOLICY, 1, 16)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_unported_modes_raise(params):
    tp = params[1]
    kw = dict(n_slots=1, s_max=16, device="cpu")
    for extra in (dict(mixed=True), dict(spec="self"), dict(trace=object()),
                  dict(cache="prefix"), dict(prefill="stepwise")):
        with pytest.raises(NotImplementedError):
            ServeEngine(tp, TTINY, TPOLICY, **kw, **extra)
    eng = ServeEngine(tp, TTINY, TPOLICY, **kw)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        eng.submit(np.arange(1, 4), SamplingParams(temperature=0.8))


def test_paged_cache_reserves_and_conserves_pages():
    c = PagedKVCache(TTINY, TPOLICY, n_slots=2, s_max=32, page_size=8, n_pages=7, device="cpu")
    assert c.pages_total() == 6 and c.pages_available() == 6
    s0 = c.acquire(20)  # reserves 3 pages, draws none yet
    assert s0 == 0 and c.pages_available() == 3 and c.pages_free() == 6
    c.prepare(s0, 9)  # draws pages for rows [0, 9)
    assert c._alloc[s0] == 2 and c.pages_free() == 4 and c.pages_available() == 3
    assert c.acquire(25) is None  # 4 pages > 3 available: queue, never evict
    c.caches[0]["k"][c.block_tables[s0, 0]] = 7
    c.advance(s0, 9)
    c.release(s0)
    assert c.pages_free() == c.pages_available() == 6 and c.block_tables[s0].sum() == 0
    assert int(c.caches[0]["k"].abs().sum()) == 0  # recycled pages are zeroed
    with pytest.raises(CapacityError):
        c.check_admissible(33)


def test_slot_cache_recycles_on_reacquire():
    c = SlotCache(TTINY, TPOLICY, n_slots=1, s_max=16, device="cpu")
    s = c.acquire(4)
    c.caches[1]["v"][s, 2] = 3
    c.advance(s, 3)
    c.release(s)
    assert c.acquire(4) == s and c.pos[s] == 0 and c.resets == 1
    assert int(c.caches[1]["v"].abs().sum()) == 0


def test_handles_stream_and_cancel(params):
    tp = params[1]
    eng = ServeEngine(tp, TTINY, TPOLICY, n_slots=2, s_max=32, prefill_chunk=4, device="cpu")
    h1 = eng.submit(np.arange(1, 6), SamplingParams(max_new=5))
    h2 = eng.submit(np.arange(3, 9), SamplingParams(max_new=5, stop=[]))
    first = next(iter(h1.tokens()))
    assert h1.cancel() and h1.status == "cancelled" and h1.request.out[0] == first
    assert len(h2.result()) == 5
    m = eng.metrics()
    assert m["cancelled"] == 1 and m["requests_completed"] == 1 and m["active_slots"] == 0
