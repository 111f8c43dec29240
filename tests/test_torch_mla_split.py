"""PyTorch port, paged_mla_attn's split order and tensor-core arithmetic on the
CPU: ``paged_mla_attn_split_ref`` repeats the CUDA kernel's order of work
(runs of ``MLA_PAGES_PER_SPLIT`` pages, each a page-blocked softmax from a
fresh state, merged in run order) and its arithmetic (the scores over
[q_lat | q_rope] . [c | r] and p . c as three exact bf16 products a k16 step,
each step's sum from zero rounded toward zero, the steps added with
round-to-nearest) and is held against the plain version ``paged_mla_attn_ref``
and the reference's jnp twin (``repro.kernels.paged_attn.paged_mla_attn_ref``),
atol = rtol = 1e-5, the bound of tests/test_torch_paged_attn_split.py. The
card test (tests/test_torch_gpu.py) holds the kernel to the same bound.

Cases: more than three runs of pages, the last partial; slots at 0, at each
side of a run boundary and at the last row; bf16 / kv8 / kv4; C 16 and 512;
dr 16 and 64; and DeepSeek-V3's full widths (H 128, C 512, dr 64) with
queries scaled so that the scores reach ~20, flash_mha's model scale
(tests/test_torch_flash.py; |s| up to 19.9 here): there the emulated kernel
stays within 0.67 of the gate from the plain version and 0.41 from the twin
(the two references part by 0.59 of it themselves) and within 0.30 of the
exact attention (f64; the plain version 0.56), where one f32 FMA chain a
score, the first design's arithmetic, leaves the gate (1.47). The card test
holds the kernel to the exact attention at that scale. Exact checks: a run with no
visible key, merged or dropped, leaves the bits unchanged; a single run with
the plain arithmetic is the plain version bit for bit; a slot with no visible
key gives zeros; the kernel's compile-time run length and heads a block are
the ones the wrapper sizes its scratch by.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro.kernels.paged_attn import paged_mla_attn_ref as jax_mla_ref  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.paged_attn import (  # noqa: E402
    MLA_HEADS_PER_BLOCK,
    MLA_PAGES_PER_SPLIT,
    paged_mla_attn_f64,
    paged_mla_attn_ref,
    paged_mla_attn_split_ref,
)

jax.config.update("jax_platform_name", "cpu")

PPS = MLA_PAGES_PER_SPLIT
PS = 16
NB = 3 * PPS + 2  # more than three runs, the last one partial
TOL = 1e-5

#: (C, dr): both latent widths and both rope widths
SHAPES = [(16, 16), (16, 64), (512, 16), (512, 64)]


def _case(seed, bits, C, dr, H=3, pos=None, nb=NB, q_scale=1.0):
    """A shuffled pool of ``nb`` pages a slot; slots at 0, at each side of
    the first run boundary and at the last row unless ``pos`` is given."""
    if pos is None:
        pos = [0, PPS * PS - 1, PPS * PS, nb * PS - 1]
    B = len(pos)
    rng = np.random.RandomState(seed)
    P_ = B * nb + 1
    q_lat = rng.standard_normal((B, H, C)).astype(np.float32) * q_scale
    q_rope = rng.standard_normal((B, H, dr)).astype(np.float32) * q_scale
    cf = jnp.asarray(rng.standard_normal((P_, PS, 1, C)).astype(np.float32)).astype(jnp.bfloat16)
    r = jnp.asarray(rng.standard_normal((P_, PS, 1, dr)).astype(np.float32)).astype(jnp.bfloat16)
    cq, c_s = RA.kv_quantize(cf, bits)
    bt = (rng.permutation(P_ - 1)[: B * nb] + 1).reshape(B, nb).astype(np.int32)
    scale = 1.0 / (C + dr) ** 0.5
    return [q_lat, q_rope, cq, c_s, r, np.asarray(pos, np.int32), bt], scale


def _t(a):
    return None if a is None else bridge.to_tensor(np.asarray(a), device="cpu")


def _twin(args, bits, scale):
    return np.asarray(jax_mla_ref(*[None if a is None else jnp.asarray(a) for a in args],
                                  bits=bits, scale=scale))


def _over_tol(a, b):
    """The largest |a - b| / (TOL * (1 + |b|)): at most 1 within atol = rtol = TOL."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (TOL * (1 + np.abs(b)))).max())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "C{}_dr{}".format(*s))
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_split_order_vs_plain_and_reference(bits, shape):
    C, dr = shape
    args, scale = _case(200 + C + dr + (bits or 0), bits, C, dr)
    targs = [_t(a) for a in args]
    split = paged_mla_attn_split_ref(*targs, bits=bits, scale=scale)
    plain = paged_mla_attn_ref(*targs, bits=bits, scale=scale)
    assert torch.isfinite(split).all() and split.shape == plain.shape
    np.testing.assert_allclose(split.numpy(), plain.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(split.numpy(), _twin(args, bits, scale), atol=TOL, rtol=TOL)


def _fma_chain_scores(ql, qr, cf, rf, scale):
    """The first design's scores: one f32 FMA chain over c, then one over r."""
    def chain(q, k):
        s = torch.zeros(q.shape[:-1] + k.shape[1:2], dtype=torch.float32)
        for i in range(q.shape[-1]):
            s = (s.double() + q[..., i:i + 1].double() * k[:, None, :, i].double()).float()
        return s
    return (chain(ql, cf) + chain(qr, rf)) * scale


def test_full_width_at_model_scale(monkeypatch):
    """DeepSeek-V3's H 128, C 512, dr 64 at kv8, two slots over 35 pages (at
    the last row and just past a run boundary), queries scaled so that the
    scores reach ~20: the emulated kernel within the gate of both references;
    the first design's FMA-chain scores, with the same softmax, are not."""
    args, _ = _case(5, 8, 512, 64, H=128, pos=[35 * PS - 1, 4 * PPS * PS], nb=35, q_scale=2.7)
    scale = 1.0 / (128 + 64) ** 0.5  # d_nope + d_rope
    targs = [_t(a) for a in args]
    plain = paged_mla_attn_ref(*targs, bits=8, scale=scale).numpy()
    twin = _twin(args, 8, scale)
    split = paged_mla_attn_split_ref(*targs, bits=8, scale=scale).numpy()
    assert _over_tol(split, plain) < 1 and _over_tol(split, twin) < 1, (
        _over_tol(split, plain), _over_tol(split, twin), _over_tol(plain, twin))
    exact = paged_mla_attn_f64(*targs, bits=8, scale=scale).numpy()
    assert _over_tol(split, exact) < 0.5 and _over_tol(plain, exact) < 1
    from repro_torch.kernels import paged_attn as PA
    seen = []

    def scores(ql, qr, cf, rf, scale, mma):
        s = _fma_chain_scores(ql, qr, cf, rf, scale)
        seen.append(float(s.abs().max()))
        return s

    monkeypatch.setattr(PA, "_mla_scores", scores)
    chain = paged_mla_attn_split_ref(*targs, bits=8, scale=scale, pages_per_split=35,
                                     mma=False).numpy()
    assert 18 < max(seen) < 26
    assert _over_tol(chain, plain) > 1


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_dropping_an_empty_run_is_exact(bits):
    """Runs with no visible key (past pos) merged with weight exp(BIG_NEG -
    M) = 0 or dropped: the same bits."""
    args, scale = _case(7 + (bits or 0), bits, 16, 16)
    targs = [_t(a) for a in args]
    dropped = paged_mla_attn_split_ref(*targs, bits=bits, scale=scale)
    merged = paged_mla_attn_split_ref(*targs, bits=bits, scale=scale, skip_empty=False)
    assert torch.equal(dropped, merged)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_one_run_is_the_plain_version(bits):
    """With every page in one run and the plain arithmetic the merge is
    exact (exp(0) = 1, sums added to zeros): the split order is the plain
    version bit for bit."""
    args, scale = _case(11 + (bits or 0), bits, 16, 64, pos=[-1, 0, 17, NB * PS - 1])
    targs = [_t(a) for a in args]
    one = paged_mla_attn_split_ref(*targs, bits=bits, scale=scale, pages_per_split=NB,
                                   mma=False)
    assert torch.equal(one, paged_mla_attn_ref(*targs, bits=bits, scale=scale))


def test_kernel_split_constants_match_wrapper():
    """The kernel's compile-time PPS and HB are the MLA_PAGES_PER_SPLIT and
    MLA_HEADS_PER_BLOCK its wrapper sizes the partials' scratch by."""
    src = (build.CSRC / "paged_mla_attn.cu").read_text()
    assert re.findall(r"^constexpr int PPS = (\d+);", src, flags=re.M) == [str(PPS)]
    assert re.findall(r"^constexpr int HB = (\d+);", src, flags=re.M) == [
        str(MLA_HEADS_PER_BLOCK)]


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "kv8", "kv4"])
def test_slot_without_visible_key_matches_plain(bits):
    """pos < 0 masks every key: both orders give exactly 0, and the other
    slots are untouched by it."""
    args, scale = _case(31, bits, 16, 16, pos=[-1, 9, NB * PS - 1])
    targs = [_t(a) for a in args]
    split = paged_mla_attn_split_ref(*targs, bits=bits, scale=scale)
    plain = paged_mla_attn_ref(*targs, bits=bits, scale=scale)
    assert torch.equal(split[0], plain[0]) and not split[0].any()
    q_lat, q_rope, cq, c_s, r, pos, bt = targs
    alone = paged_mla_attn_split_ref(q_lat[1:], q_rope[1:], cq, c_s, r, pos[1:], bt[1:],
                                     bits=bits, scale=scale)
    assert torch.equal(split[1:], alone)
