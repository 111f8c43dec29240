"""PyTorch port, paged_attn's split order on the CPU: ``paged_attn_split_ref``
repeats the CUDA kernel's order of work (runs of ``PAGES_PER_SPLIT`` pages,
each a page-blocked softmax from a fresh state, merged in run order) and is
held against the plain version ``paged_attn_ref`` and the reference's jnp
twin (``repro.kernels.ops.paged_attn``, ``impl="jnp"``), atol = rtol = 1e-5:
the merge rescales each run's sums once more (exp(m_i - M)) and adds them in
another order, which the reference's own fused-vs-twin bound covers
(tests/test_paged_attn.py). The card test (tests/test_torch_gpu.py) holds
the kernel to the same bound.

Edge cases: more than three runs of pages; a slot at 0, at each side of a
run boundary and at the last row; D 16, 64, 80 and 128; pages of 5, 8 and 16
rows; G 1, 2 and 8; a window that crosses a run boundary and one shorter
than a page. Exact checks: a run with no visible key, merged or dropped,
leaves the bits unchanged; a single run is the plain version bit for bit; a
slot with no visible key gives the plain version's zeros. The kernel's
compile-time run length is the one the wrapper sizes its scratch for.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro.kernels import ops as rops  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.paged_attn import (  # noqa: E402
    PAGES_PER_SPLIT,
    paged_attn_ref,
    paged_attn_split_ref,
)

jax.config.update("jax_platform_name", "cpu")

PPS = PAGES_PER_SPLIT
NB = 3 * PPS + 2  # more than three runs, the last one partial
TOL = 1e-5

#: (D, page size, G): every D, page size and group the kernel must take
SHAPES = [(16, 16, 2), (64, 8, 1), (80, 5, 8), (128, 16, 2)]


def _case(seed, bits, D, ps, G, Hkv=2, pos=None):
    """A shuffled pool of NB pages a slot; slots at 0, at each side of the
    first run boundary and at the last row."""
    S = NB * ps
    if pos is None:
        pos = [0, PPS * ps - 1, PPS * ps, S - 1]
    B = len(pos)
    rng = np.random.RandomState(seed)
    P_ = B * NB + 1
    q = jnp.asarray(rng.standard_normal((B, G * Hkv, D)).astype(np.float32))
    kf = jnp.asarray(rng.standard_normal((P_, ps, Hkv, D)).astype(np.float32)).astype(jnp.bfloat16)
    vf = jnp.asarray(rng.standard_normal((P_, ps, Hkv, D)).astype(np.float32)).astype(jnp.bfloat16)
    kq, k_s = RA.kv_quantize(kf, bits)
    vq, v_s = RA.kv_quantize(vf, bits)
    bt = jnp.asarray((rng.permutation(P_ - 1)[: B * NB] + 1).reshape(B, NB).astype(np.int32))
    return q, kq, k_s, vq, v_s, jnp.asarray(pos, jnp.int32), bt


def _t(a):
    return None if a is None else bridge.to_tensor(np.asarray(a), device="cpu")


def _window(kind, ps):
    """None; one that crosses a run boundary for the slots at PPS * ps and
    at S - 1; or one shorter than a page, so that it starts inside one."""
    return {"nowin": None, "split": PPS * ps + 3, "subpage": ps // 2}[kind]


WINDOWS = ["nowin", "split", "subpage"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "D{}_ps{}_G{}".format(*s))
@pytest.mark.parametrize("window_kind", WINDOWS)
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_split_order_vs_plain_and_reference(bits, window_kind, shape):
    D, ps, G = shape
    window = _window(window_kind, ps)
    args = _case(100 + D + ps + G + (bits or 0), bits, D, ps, G)
    ref = np.asarray(rops.paged_attn(*args[:6], bits=bits, block_table=args[6], window=window,
                                     impl="jnp"))
    targs = [_t(a) for a in args]
    split = paged_attn_split_ref(*targs, bits=bits, window=window)
    plain = paged_attn_ref(*targs, bits=bits, window=window)
    assert torch.isfinite(split).all()
    np.testing.assert_allclose(split.numpy(), plain.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(split.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window_kind", WINDOWS)
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_dropping_an_empty_run_is_exact(bits, window_kind):
    """Runs with no visible key (past pos, or slid past by the window)
    merged with weight exp(BIG_NEG - M) = 0 or dropped: the same bits."""
    D, ps, G = 64, 8, 2
    window = _window(window_kind, ps)
    targs = [_t(a) for a in _case(7 + (bits or 0), bits, D, ps, G)]
    dropped = paged_attn_split_ref(*targs, bits=bits, window=window)
    merged = paged_attn_split_ref(*targs, bits=bits, window=window, skip_empty=False)
    assert torch.equal(dropped, merged)


@pytest.mark.parametrize("window_kind", WINDOWS)
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_one_run_is_the_plain_version(bits, window_kind):
    """With every page in one run the merge is exact (exp(0) = 1, sums
    added to zeros): the split order is the plain version bit for bit."""
    D, ps, G = 80, 5, 8
    window = _window(window_kind, ps)
    targs = [_t(a) for a in _case(11 + (bits or 0), bits, D, ps, G, pos=[-1, 0, 17, NB * ps - 1])]
    one = paged_attn_split_ref(*targs, bits=bits, window=window, pages_per_split=NB)
    assert torch.equal(one, paged_attn_ref(*targs, bits=bits, window=window))


def test_kernel_run_length_matches_wrapper():
    """The kernel's compile-time PPS is the PAGES_PER_SPLIT its wrapper
    sizes the partials' scratch by."""
    src = (build.CSRC / "paged_attn.cu").read_text()
    found = re.findall(r"^constexpr int PPS = (\d+);", src, flags=re.M)
    assert found == [str(PAGES_PER_SPLIT)]


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_slot_without_visible_key_matches_plain(bits):
    """pos < 0 masks every key: both orders give exactly 0, and the other
    slots are untouched by it."""
    D, ps, G = 16, 5, 2
    targs = [_t(a) for a in _case(31, bits, D, ps, G, pos=[-1, 9, NB * ps - 1])]
    split = paged_attn_split_ref(*targs, bits=bits)
    plain = paged_attn_ref(*targs, bits=bits)
    assert torch.equal(split[0], plain[0]) and not split[0].any()
    q, kq, k_s, vq, v_s, pos, bt = targs
    alone = paged_attn_split_ref(q[1:], kq, k_s, vq, v_s, pos[1:], bt[1:], bits=bits)
    assert torch.equal(split[1:], alone)
