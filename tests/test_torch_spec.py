"""PyTorch port, speculative decoding's units on the CPU, against the JAX
reference (tests/test_spec.py): the cache managers' ``truncate`` verb, the
4-bit self-draft (``derive_w4_policy``, ``requantize_params_w4``), the
draft-policy seam (``make_spec``, the engine's refusals) and
``models.model.spec_verify_step``.

Reduced internlm2-1.8b, pages of 4, the port's seeded weights carried to
the reference through the bridge (tests/_torch_spec_common.py); the
reference runs op by op (``jax.disable_jit()``). Tolerance: none, every
comparison is bit-exact (positions, block tables, free list, refcounts,
every cache byte, requantized trees, targets). The engines are
tests/test_torch_spec_engine.py and tests/test_torch_spec_rollback.py.
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
from repro.serve import PagedKVCache as RPagedKVCache  # noqa: E402
from repro.serve import PrefixCache as RPrefixCache  # noqa: E402
from repro.serve import SlotCache as RSlotCache  # noqa: E402
from repro.serve import spec as RS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    SPEC_POLICIES,
    DraftModel,
    DraftPolicy,
    PagedKVCache,
    PrefixCache,
    SelfDraft,
    ServeEngine,
    SlotCache,
    make_spec,
)
from repro_torch.serve import spec as TS  # noqa: E402

from tests._torch_spec_common import params  # noqa: E402, F401

jax.config.update("jax_platform_name", "cpu")

TINY = configs.reduced(configs.get_arch("internlm2-1.8b"))
TTINY = tconfigs.reduced(tconfigs.get_arch("internlm2-1.8b"))
POLICIES = ("w4a8", "mixed_paper")
PS = 4


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)




# ------------------------------------------------------------ the truncate verb


def _pair(kind):
    """A reference cache manager and the port's, both holding the same
    random bytes in every cache leaf."""
    pol, tpol = get_policy("w4a8"), tget_policy("w4a8")
    if kind == "slot":
        ref, port = RSlotCache(TINY, pol, 2, 16), SlotCache(TTINY, tpol, 2, 16, device="cpu")
    else:
        rcls, tcls = (RPagedKVCache, PagedKVCache) if kind == "paged" else (RPrefixCache,
                                                                             PrefixCache)
        ref = rcls(TINY, pol, 2, 16, page_size=PS)
        port = tcls(TTINY, tpol, 2, 16, page_size=PS, device="cpu")
    rng = np.random.RandomState(5)
    filled = jax.tree.map(lambda a: (rng.randn(*a.shape) * 40).clip(-100, 100).astype(a.dtype),
                          _np(ref.caches))
    ref.caches = jax.tree.map(jnp.asarray, filled)
    port.caches = bridge.caches_from_reference(filled, device="cpu")
    return ref, port


def _assert_same_state(ref, port):
    np.testing.assert_array_equal(port.pos, np.asarray(ref.pos))
    assert port.truncates == ref.truncates and port.resets == ref.resets
    first = 0
    if ref.paged:
        np.testing.assert_array_equal(port.block_tables, ref.block_tables)
        np.testing.assert_array_equal(port._alloc, ref._alloc)
        np.testing.assert_array_equal(port._ref, ref._ref)
        assert port._free == ref._free
        first = 1  # the reference pads its page zeroing with the scratch page 0
    want = bridge.caches_to_numpy(bridge.caches_from_reference(_np(ref.caches), device="cpu"))
    for w, g in zip(want, bridge.caches_to_numpy(port.caches), strict=True):
        for k in w:
            np.testing.assert_array_equal(g[k][first:].view(np.uint8),
                                          w[k][first:].view(np.uint8), err_msg=k)


def _both(ref, port, verb, *args):
    getattr(ref, verb)(*args)
    getattr(port, verb)(*args)


def test_truncate_slot_equals_reference():
    """Rows [pos - n, pos) of the slot zeroed, the head and the neighbour
    kept, the position rewound; n = 0 a no-op; below position 0 raises."""
    ref, port = _pair("slot")
    _both(ref, port, "acquire", 10)
    _both(ref, port, "advance", 0, 8)
    _both(ref, port, "truncate", 0, 3)
    _assert_same_state(ref, port)
    assert int(port.pos[0]) == 5 and port.truncates == 1
    _both(ref, port, "truncate", 0, 0)
    _both(ref, port, "advance", 0, 6)
    _both(ref, port, "truncate", 0, 11)
    _assert_same_state(ref, port)
    assert int(port.pos[0]) == 0 and port.truncates == 2
    with pytest.raises(ValueError, match="below position"):
        port.truncate(0, 1)
    _assert_same_state(ref, port)


def test_truncate_paged_equals_reference():
    """Pages past the new frontier released (zeroed, back on the free list),
    the tail of the last kept page scrubbed in place, the reservation kept
    (the slot re-draws within its promise); a second slot untouched."""
    ref, port = _pair("paged")
    for s, n in ((0, 10), (1, 6)):
        _both(ref, port, "acquire", 14)
        _both(ref, port, "prepare", s, n)
        _both(ref, port, "advance", s, n)
    _both(ref, port, "truncate", 0, 5)  # 10 -> 5: page 3 released, offsets 1..3 of page 2
    _assert_same_state(ref, port)
    assert int(port._alloc[0]) == 2
    _both(ref, port, "prepare", 0, 7)
    _both(ref, port, "advance", 0, 7)
    _both(ref, port, "truncate", 0, 4)  # 12 -> 8: a page boundary, nothing scrubbed
    _both(ref, port, "truncate", 1, 6)  # to 0: every page released
    _both(ref, port, "truncate", 0, 0)
    _assert_same_state(ref, port)
    with pytest.raises(ValueError, match="below position"):
        port.truncate(0, 99)
    live = {int(p) for s in range(2) for p in port.block_tables[s, :int(port._alloc[s])]} - {0}
    assert len(port._free) + len(live) + 1 == port.n_pages


def test_truncate_prefix_equals_reference_and_refuses_a_shared_page():
    """On the prefix cache: a slot's speculative tail past its published
    prompt truncates as on paged; a truncate that would scrub a page the
    index or another slot reads raises RuntimeError, in both packages."""
    ref, port = _pair("prefix")
    prompt = np.arange(1, 11, dtype=np.int32)
    for s in (0, 1):
        _both(ref, port, "acquire", 16, prompt)
        n = 10 - int(ref.pos[s])
        _both(ref, port, "prepare", s, n)
        _both(ref, port, "advance", s, n)
        _both(ref, port, "commit", s, prompt)
    _both(ref, port, "prepare", 0, 5)
    _both(ref, port, "advance", 0, 5)
    _both(ref, port, "truncate", 0, 3)  # 15 -> 12: offsets past the prompt's pages
    _assert_same_state(ref, port)
    with pytest.raises(RuntimeError, match="readers"):
        ref.truncate(1, 4)  # 10 -> 6 scrubs a published page
    with pytest.raises(RuntimeError, match="readers"):
        port.truncate(1, 4)
    _assert_same_state(ref, port)


def test_truncate_refuses_a_shared_partial_page():
    """The reference's guard: a second reader on the last kept page."""
    _, port = _pair("paged")
    port.acquire(12)
    port.prepare(0, 6)
    port.advance(0, 6)
    port._retain_page(int(port.block_tables[0, 0]))
    with pytest.raises(RuntimeError, match="readers"):
        port.truncate(0, 3)


# ------------------------------------------------------------- the self-draft


def _lp(lp):
    return (lp.x_bits, lp.w_bits, lp.y_bits)


@pytest.mark.parametrize("name", POLICIES)
def test_derive_w4_policy_equals_reference(name):
    want, got = RS.derive_w4_policy(get_policy(name)), TS.derive_w4_policy(tget_policy(name))
    assert got.name == want.name == f"{name}+self4"
    assert got.kv_cache_bits == want.kv_cache_bits
    assert _lp(got.default) == _lp(want.default)
    assert {k: _lp(v) for k, v in got.per_class.items()} == {
        k: _lp(v) for k, v in want.per_class.items()}
    assert got.of("router").w_bits is None and got.of("expert").w_bits == 4


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("name", POLICIES)
def test_requantize_params_w4_equals_reference_and_aliases(params, name):
    """The port's requantized tree equals the reference's, leaf for leaf and
    byte for byte; every tensor of a layer already at 4 bits is the
    target's own (``is``), every 8-bit layer is new."""
    jp, tp = params[name]
    want = dict(_leaves(bridge.params_from_reference(
        _np(RS.requantize_params_w4(jp, get_policy(name))), device="cpu")))
    got = TS.requantize_params_w4(tp, tget_policy(name))
    got_l, tgt_l = dict(_leaves(got)), dict(_leaves(tp))
    assert sorted(got_l) == sorted(want)
    for k, w in want.items():
        g = got_l[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)), k
    changed = {k for k in got_l if got_l[k] is not tgt_l[k]}
    if name == "w4a8":
        assert not changed
    else:  # mixed_paper: attn_out and the head are 8-bit
        assert changed and all(k.split("/")[-2] in ("wo", "head") for k in changed)
        assert {k.split("/")[-1] for k in changed} == {"w_packed", "eps_w"}
        assert got["layers"][0]["attn"]["wq"] is tp["layers"][0]["attn"]["wq"]


def test_requantize_rescales_the_grid_and_eps():
    """The reference's worked example: an 8-bit row to the 4-bit grid."""
    from repro_torch.core import pack as P

    wq8 = torch.tensor([[-127, -64, 0, 64, 127, 1, -1, 100]], dtype=torch.int8)
    tree = {"wo": {"w_packed": P.pack(wq8, 8), "eps_w": torch.tensor(0.5)}}
    out = TS.requantize_params_w4(tree, tget_policy("mixed_paper"))
    wq4 = P.unpack(out["wo"]["w_packed"], 4, signed=True)
    expect = np.clip(np.round(wq8.numpy().astype(np.float32) * 7 / 127), -7, 7)
    assert (wq4.numpy() == expect).all()
    assert np.isclose(float(out["wo"]["eps_w"]), 0.5 * 127 / 7)


def test_make_spec_and_engine_refusals(params):
    assert make_spec(None) is None and make_spec("off") is None
    assert isinstance(make_spec("self4"), SelfDraft) and isinstance(make_spec("draft"), DraftModel)
    assert sorted(SPEC_POLICIES) == sorted(RS.SPEC_POLICIES)
    inst = DraftModel()
    assert make_spec(inst) is inst and isinstance(inst, DraftPolicy)
    with pytest.raises(KeyError):
        make_spec("nope")
    tp = params["w4a8"][1]
    kw = dict(n_slots=2, s_max=32, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServeEngine(tp, TTINY, tget_policy("w4a8"), mixed=True, spec="self4", **kw)
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(tp, TTINY, tget_policy("w4a8"), spec="self4", spec_k=0, **kw)
    with pytest.raises(ValueError, match="vocab"):
        ServeEngine(tp, TTINY, tget_policy("w4a8"),
                    spec=DraftModel(cfg=dataclasses.replace(TTINY, vocab=128)), **kw)


# --------------------------------------------------------- spec_verify_step

#: lanes: a speculating lane (n_real W), a decode lane (1), idle (0), and a
#: second speculating lane; paged: its window crosses into a fresh page,
#: and the decode lane's padded tail runs onto the scratch page
VERIFY_CASES = {
    "dense": dict(pos=[5, 9, 4, 20], n_real=[4, 1, 0, 4]),
    "paged": dict(pos=[5, 11, 4, 14], n_real=[4, 1, 0, 4],
                  bt=[[3, 4, 0, 0], [1, 2, 6, 0], [5, 0, 0, 0], [7, 8, 9, 10]]),
}
W = 4


@pytest.mark.parametrize("temp", [0.0, 0.8])
@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_spec_verify_step_equals_reference(params, case, temp):
    """One verify from a random cache: the targets of every real offset and
    every cache byte (scratch page included) equal the reference's."""
    jp, tp = params["w4a8"]
    pol, tpol = get_policy("w4a8"), tget_policy("w4a8")
    c = VERIFY_CASES[case]
    B = len(c["pos"])
    rng = np.random.RandomState(11)
    paged = "bt" in c
    jc = (RM.init_paged_cache(TINY, pol, 11, PS) if paged else RM.init_cache(TINY, pol, B, 32))
    jc = jax.tree.map(lambda a: (rng.randn(*a.shape) * 40).clip(-100, 100).astype(a.dtype),
                      _np(jc))
    toks = rng.randint(1, TINY.vocab, size=(B, W)).astype(np.int32)
    pos, n_real = np.array(c["pos"], np.int32), np.array(c["n_real"], np.int32)
    samp = (np.array([temp, temp, 0.0, temp], np.float32), np.array([8, 0, 0, 16], np.int32),
            np.array([0.9, 1.0, 1.0, 0.95], np.float32),
            np.array([17, 18, 0, 19], np.uint32), np.array([3, 0, 0, 7], np.int32))
    kw = dict(block_tables=np.array(c["bt"], np.int32), page_size=PS) if paged else {}
    with jax.disable_jit():
        want, want_c = RM.spec_verify_step(
            jp, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(n_real),
            *map(jnp.asarray, samp), jax.tree.map(jnp.asarray, jc), TINY, pol, impl="jnp",
            **{k: jnp.asarray(v) if k == "block_tables" else v for k, v in kw.items()})
    tc = bridge.caches_from_reference(jc, device="cpu")
    tkw = {k: torch.from_numpy(v) if k == "block_tables" else v for k, v in kw.items()}
    got = TM.spec_verify_step(tp, torch.from_numpy(toks), torch.from_numpy(pos),
                              torch.from_numpy(n_real), *samp, tc, TTINY, tpol, **tkw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, W)
    want = np.asarray(want)
    for b in range(B):
        np.testing.assert_array_equal(got[b, :n_real[b]].numpy(), want[b, :n_real[b]])
    ref = bridge.caches_to_numpy(bridge.caches_from_reference(_np(want_c), device="cpu"))
    for r, g in zip(ref, bridge.caches_to_numpy(tc), strict=True):
        for k in r:
            np.testing.assert_array_equal(g[k].view(np.uint8), r[k].view(np.uint8), err_msg=k)


def test_spec_verify_step_refuses_paged_without_page_size(params):
    tc = TM.init_paged_cache(TTINY, tget_policy("w4a8"), 3, PS, device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        TM.spec_verify_step(params["w4a8"][1], torch.ones((1, W), dtype=torch.int32), [0], [W],
                            [0.0], [0], [1.0], [0], [0], tc, TTINY, tget_policy("w4a8"),
                            block_tables=torch.zeros((1, 2), dtype=torch.int32))
