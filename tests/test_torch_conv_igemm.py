"""PyTorch port, conv2d's implicit-GEMM addressing on the CPU:
``conv2d_igemm_ref`` repeats the CUDA kernel's order of work (blocks of
output rows x pixel segments x Cout tiles; channels padded with zeros to
whole k32 steps on both operands; input rows staged into a ring of three
slots, the border and the segment's halo as integer zeros; each m16 tile of
pixels summed tap by tap from rows p + g + dx of its slot) and is held bit
for bit against the reference's ``conv2d_pallas`` in interpret mode
(integer arithmetic: tolerance 0).

Shapes: the card test's ragged ones, (H, W, C, Cout) = (5, 7, 12, 68) and
(3, 9, 13, 66) (C not a multiple of 16, a partial Cout tile, one m16 tile
wider than the row), cells that cover x = 8, 4 and 2; bands of one, two and
three rows (the ring turns over), Cout tiles of 16, 32 and 64, a row of 20
pixels in segments of 16 (a halo between two blocks), and C 64 (two k32
steps a tap).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro.core import pack as RP  # noqa: E402
from repro.core import quant as RQ  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.kernels.ref import conv2d_igemm_ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

#: (H, W, C, Cout, (x, w, y), Cout tile, rows a block, segment)
CASES = [
    (5, 7, 12, 68, (8, 4, 4), 16, 2, 16),
    (5, 7, 12, 68, (4, 2, 2), 64, 3, 16),
    (5, 7, 12, 68, (2, 8, 8), 32, 1, 16),
    (3, 9, 13, 66, (8, 8, 4), 16, 2, 16),
    (3, 9, 13, 66, (8, 8, 8), 64, 3, 16),
    (4, 20, 8, 24, (4, 4, 2), 16, 3, 16),
    (3, 5, 64, 16, (8, 2, 4), 16, 2, 16),
]


def _operands(H, W, C, Cout, xb, wb, yb, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 1 << xb, size=(H, W, C)).astype(np.uint8)
    w = rng.randint(-(1 << (wb - 1)), 1 << (wb - 1), size=(Cout, 9 * C)).astype(np.int8)
    x_p = np.array(RP.pack(jnp.asarray(x), xb), copy=True)
    w_p = np.array(RP.pack(jnp.asarray(w), wb), copy=True)
    # requant parameters that spread the accumulators over the output range
    xp = np.pad(x.astype(np.int64), ((1, 1), (1, 1), (0, 0)))
    cols = np.stack([np.stack([xp[dy:dy + H, dx:dx + W] for dx in range(3)], 2)
                     for dy in range(3)], 2).reshape(H * W, -1)
    phi = cols @ w.astype(np.int64).T
    levels = 1 << yb
    r = levels / 2 / (phi.std() + 1.0)
    r = min(r, 1.0) if yb == 8 else r
    kw = dict(y_bits=yb, eps_phi=float(r), eps_y=1.0, lam=float(levels / 2 / r - phi.mean()))
    return x_p, w_p, RQ.make_requant_params(**kw), TQ.make_requant_params(**kw)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "{}x{}x{}-{}-x{}w{}y{}-ct{}-r{}".format(
    *c[:4], *c[4], *c[5:7]))
def test_igemm_addressing_matches_pallas_kernel(case):
    H, W, C, Cout, (xb, wb, yb), ct, rpb, seg = case
    x_p, w_p, rq_r, rq_t = _operands(H, W, C, Cout, xb, wb, yb, seed=H * W + C + xb)
    bits = dict(x_bits=xb, w_bits=wb, y_bits=yb)
    want = np.asarray(rops.conv2d(jnp.asarray(x_p), jnp.asarray(w_p), rq_r, impl="pallas",
                                  **bits))
    got = conv2d_igemm_ref(torch.from_numpy(x_p), torch.from_numpy(w_p), rq_t, cout_tile=ct,
                           rows_per_block=rpb, segment=seg, **bits)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 1  # the output is not one constant byte
