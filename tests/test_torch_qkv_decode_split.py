"""PyTorch port, qkv_decode's split order on the CPU: ``qkv_decode_split_ref``
repeats the CUDA kernel's order of work (runs of ``KEYS_PER_SPLIT`` keys,
each a softmax from a fresh state, merged in run order) and is held against
the reference's ``qkv_decode_pallas`` in interpret mode within the kernel's
``TOL`` (atol = rtol = 1e-5, ``kernels/qkv_decode.py``): the merge rescales
each run's sums once more (exp(m_i - M)) and adds them in another order, and
XLA's CPU dot and ``exp`` differ from PyTorch's in the last f32 bits. The
card test (tests/test_torch_gpu.py) holds the kernel to the same bound.

Cases: pos -1 (every key at BIG_NEG: the mean of v over all S keys), 0, on
a run's last key and on the next run's first; S not a multiple of the run
(a ragged last run) nor of the kernel's 8-lane rows; one run and many.
Exact checks: a single run is the plain version bit for bit; a run past pos,
merged or dropped, leaves the bits unchanged. The kernel's compile-time run
length is the one the wrapper sizes its scratch for.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro.kernels.qkv_decode import qkv_decode_pallas  # noqa: E402
from repro.models.attention import kv_quantize as rkv_quantize  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import qkv_decode as QD  # noqa: E402
from repro_torch.kernels.ref import qkv_decode_plain, qkv_decode_split_ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

#: (B, S, Hkv, G, D, bits, pos, bs, keys a run): the reference test's shape
#: (S 32, D 16, bs 8) over runs of 8 (four runs) and 12 (a ragged last run
#: of 8), pos at -1, 0, a run's last key and the next run's first; S 36 over
#: runs of 8 (a last run of 4); one run (runs of 32 and of KEYS_PER_SPLIT);
#: internlm2's head width at S 300 over the kernel's own runs (128, 128, 44)
CASES = [
    (2, 32, 2, 1, 16, 8, -1, 8, 8),
    (2, 32, 2, 2, 16, 8, 0, 8, 8),
    (2, 32, 2, 2, 16, 4, 11, 8, 12),
    (2, 32, 2, 1, 16, 8, 12, 8, 12),
    (2, 32, 2, 2, 16, 4, -1, 32, 12),
    (1, 36, 2, 2, 16, 8, 33, 12, 8),
    (2, 32, 2, 2, 16, 8, 30, 32, 32),
    (2, 32, 2, 1, 16, 4, 7, 8, QD.KEYS_PER_SPLIT),
    (1, 300, 2, 2, 128, 8, 299, 100, QD.KEYS_PER_SPLIT),
    (1, 300, 2, 2, 128, 4, 127, 300, QD.KEYS_PER_SPLIT),
]


def _inputs(B, S, Hkv, G, D, bits, seed=11):
    """k, v, q from one RandomState, quantized by the reference's
    ``kv_quantize``; the same bytes for both sides."""
    rng = np.random.RandomState(seed + S + D)
    k = jnp.asarray(rng.randn(B, S, Hkv, D).astype(np.float32))
    v = jnp.asarray(rng.randn(B, S, Hkv, D).astype(np.float32))
    k_q, k_s = rkv_quantize(k, bits)
    v_q, v_s = rkv_quantize(v, bits)
    q = jnp.asarray(rng.randn(B, Hkv * G, D).astype(np.float32))
    jx = (q, k_q, k_s, v_q, v_s)
    return jx, tuple(torch.from_numpy(np.array(a, copy=True)) for a in jx)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_order_matches_pallas_kernel(case):
    B, S, Hkv, G, D, bits, pos, bs, kps = case
    jx, tx = _inputs(B, S, Hkv, G, D, bits)
    want = np.asarray(qkv_decode_pallas(*jx, jnp.int32(pos), bits=bits, bs=bs, interpret=True))
    got = qkv_decode_split_ref(*tx, pos, bits=bits, keys_per_split=kps)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=QD.TOL, atol=QD.TOL)
    if S <= kps:  # one run: the plain version's single block, bit for bit
        np.testing.assert_array_equal(
            got.numpy(), qkv_decode_plain(*tx, pos, bits=bits, bs=S).numpy())
    if 0 <= pos < S - kps:  # runs past pos: dropped or merged, the same bits
        every = qkv_decode_split_ref(*tx, pos, bits=bits, keys_per_split=kps, skip_empty=False)
        assert torch.equal(got, every)


def test_kernel_run_length_is_the_wrappers():
    """``KEYS_PER_SPLIT`` sizes the wrapper's scratch; it must be the
    kernel's compile-time ``KPS``."""
    src = (build.CSRC / "qkv_decode.cu").read_text()
    found = re.findall(r"^constexpr int KPS = (\d+);", src, flags=re.M)
    assert found == [str(QD.KEYS_PER_SPLIT)]
