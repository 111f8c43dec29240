"""PyTorch port, decode attention over a dense int8 / int4 cache: the plain
``qkv_decode_plain`` (what ``qkv_decode`` runs on CPU tensors) against the
reference's ``qkv_decode_pallas`` in interpret mode, and both oracles
``qkv_decode_ref`` against each other. No GPU needed; the CUDA kernel is
held against the same plain version on the card (tests/test_torch_gpu.py).

Tolerances and why:
  * plain version vs ``qkv_decode_pallas`` (interpret) and the two oracles
    against each other: atol = rtol = 1e-6. The dequantized values are
    bit-equal (one f32 product a value, bf16-rounded in the oracles) and the
    softmax steps the same, but XLA's CPU dot and ``exp`` differ from
    PyTorch's in the last f32 bits (ROADMAP Queue 3 item 4), a few ulps of
    outputs of order 1;
  * the kernel function vs the oracle: the reference test's own 5e-3
    (tests/test_ssm_attn.py): f32 dequantization against bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro.kernels.qkv_decode import qkv_decode_pallas  # noqa: E402
from repro.kernels.qkv_decode import qkv_decode_ref as rqkv_decode_ref  # noqa: E402
from repro.models.attention import kv_quantize as rkv_quantize  # noqa: E402
from repro_torch.core import pack as P  # noqa: E402
from repro_torch.kernels import qkv_decode as QD  # noqa: E402
from repro_torch.kernels.ref import qkv_decode_plain  # noqa: E402
from repro_torch.models.attention import kv_quantize  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

B, S, HKV, D = 2, 32, 2, 16
#: the reference test's cases (bits, gqa, pos) at bs 8 (tests/test_ssm_attn.py)
REF_CASES = [(8, 1, 30, 8), (8, 2, 12, 8), (4, 1, 31, 8)]
#: bs 32 (one block) and the edges of pos: none visible, the first key, the
#: last key of a block of 8, the first of the next, the last key
EDGE_CASES = [(bits, gqa, pos, bs) for bits in (8, 4) for gqa in (1, 2)
              for pos, bs in ((-1, 8), (0, 32), (7, 8), (8, 8), (31, 32), (-1, 32))]


def _inputs(bits, gqa, seed=11):
    """The reference test's draw (RandomState(11): k, v, then q), quantized
    by the reference's ``kv_quantize``; the same bytes for both sides."""
    rng = np.random.RandomState(seed)
    k = jnp.asarray(rng.randn(B, S, HKV, D).astype(np.float32))
    v = jnp.asarray(rng.randn(B, S, HKV, D).astype(np.float32))
    k_q, k_s = rkv_quantize(k, bits)
    v_q, v_s = rkv_quantize(v, bits)
    q = rng.randn(B, HKV * gqa, D).astype(np.float32)
    jx = (jnp.asarray(q), k_q, k_s, v_q, v_s)
    tx = tuple(torch.from_numpy(np.array(a, copy=True)) for a in jx)
    return jx, tx


@pytest.mark.parametrize("bits,gqa,pos,bs", REF_CASES + EDGE_CASES)
def test_plain_matches_pallas_kernel(bits, gqa, pos, bs):
    jx, tx = _inputs(bits, gqa)
    want = np.asarray(qkv_decode_pallas(*jx, jnp.int32(pos), bits=bits, bs=bs, interpret=True))
    got = QD.qkv_decode(*tx, pos, bits=bits, bs=bs)  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        got.numpy(), qkv_decode_plain(*tx, pos, bits=bits, bs=bs).numpy())
    if pos < 0:  # nothing visible: the mean of v over all S keys
        v = tx[3] if bits == 8 else P.unpack(tx[3], bits, signed=True)
        mean = (v.float() * tx[4][..., None]).mean(dim=1)  # (B, Hkv, D)
        np.testing.assert_allclose(got.numpy(), torch.repeat_interleave(mean, gqa, dim=1).numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits,gqa,pos,bs", REF_CASES + [(4, 2, 0, 32), (8, 1, -1, 8)])
def test_oracles_agree_and_bound_the_kernel_function(bits, gqa, pos, bs):
    """The port's ``qkv_decode_ref`` against the reference's (both
    dequantize through bf16) within 1e-6, and the kernel function within
    the reference test's 5e-3 of it."""
    jx, tx = _inputs(bits, gqa)
    want = np.asarray(rqkv_decode_ref(*jx, pos, bits=bits))
    oracle = QD.qkv_decode_ref(*tx, pos, bits=bits)
    np.testing.assert_allclose(oracle.numpy(), want, rtol=1e-6, atol=1e-6)
    got = QD.qkv_decode(*tx, pos, bits=bits, bs=bs)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=5e-3, atol=5e-3)


def test_port_quantizer_gives_the_reference_bytes():
    """The port's ``kv_quantize`` writes the bytes the reference's does, so
    a cache the port fills is the cache these tests feed both sides."""
    rng = np.random.RandomState(4)
    x = rng.randn(B, S, HKV, D).astype(np.float32)
    for bits in (8, 4):
        rq, rs = rkv_quantize(jnp.asarray(x), bits)
        tq, ts = kv_quantize(torch.from_numpy(x), bits)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))


def test_refuses_what_the_pallas_kernel_asserts():
    _, tx = _inputs(8, 1)
    with pytest.raises(ValueError, match="multiple of the key block"):
        QD.qkv_decode(*tx, 3, bits=8, bs=12)  # S = 32 is not a multiple of 12
    with pytest.raises(ValueError, match="multiple of the key block"):
        qkv_decode_plain(*tx, 3, bits=8, bs=12)
    with pytest.raises(ValueError, match="packed head dim"):
        QD.qkv_decode(*tx, 3, bits=4)  # int8 rows of D bytes read as int4
    with pytest.raises(ValueError, match="bits"):
        QD.qkv_decode(*tx, 3, bits=2)
    q, k_q, k_s, v_q, v_s = tx
    with pytest.raises(ValueError, match="not a multiple"):
        QD.qkv_decode(q[:, :1].repeat(1, 3, 1), k_q, k_s, v_q, v_s, 3)  # Hq 3, Hkv 2
    with pytest.raises(ValueError, match="CUDA"):
        QD.qkv_decode_cuda(*tx, 3)


def test_any_float_query_and_tensor_pos():
    """q in bf16 reads as its f32 widening; ``pos`` may be a one-element
    tensor."""
    _, (q, *rest) = _inputs(8, 2)
    qb = q.to(torch.bfloat16)
    a = QD.qkv_decode(qb, *rest, torch.tensor([12], dtype=torch.int32), bits=8, bs=8)
    b = QD.qkv_decode(qb.float(), *rest, 12, bits=8, bs=8)
    assert a.dtype == torch.float32 and torch.equal(a, b)
