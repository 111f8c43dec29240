"""PyTorch port, the paper's Reference-Layer path: the plain versions of
the conv2d and qntpack kernels and the two Reference-Layer examples, held
against the JAX reference on the CPU.

  * conv2d: ``kernels.ref.conv2d_ref`` and ``ops.conv2d`` (CPU tensors)
    bit-exact with the reference's ``conv2d_ref`` and with its Pallas kernel
    in interpret mode, over all 27 cells at small shapes, at the paper's
    exact shape, and with saturated ifmaps whose border taps carry the whole
    u8 offset fold (integer arithmetic: tolerance 0);
  * qntpack: bit-exact on every output width, with accumulators near
    +-2^31 whose ``acc + bias`` wraps as JAX's int32 add does;
  * the examples: ``python -m repro_torch.examples.quickstart`` and
    ``mixed_precision_sweep`` on the CPU print exactly the reference
    scripts' lines (mean errors included) and produce the same packed
    ofmaps, bit for bit;
  * the serving-side claims of tests/test_paper_claims.py, held in the port.

The CUDA kernels run only on the card: tests/test_torch_gpu.py (marker
``gpu``) and ``python3 chip_smoke.py`` hold them against these plain
versions there.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pack as RP  # noqa: E402
from repro.core import quant as RQ  # noqa: E402
from repro.core.policy import PERMUTATIONS  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.examples import mixed_precision_sweep, quickstart  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import conv2d_ref, qntpack_ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]


def _conv_operands(rng, H, W, C, Cout, xb, wb, fill=None):
    x = (rng.randint(0, 1 << xb, size=(H, W, C)) if fill is None
         else np.full((H, W, C), fill)).astype(np.uint8)
    w = rng.randint(-(1 << (wb - 1)), 1 << (wb - 1), size=(Cout, 9 * C)).astype(np.int8)
    return (np.array(RP.pack(jnp.asarray(x), xb), copy=True),
            np.array(RP.pack(jnp.asarray(w), wb), copy=True), x, w)


def _spread_rq(x, w, yb):
    """Requant parameters that spread this input's accumulators over the
    whole output range (both sides fold the same floats)."""
    xp = np.pad(x.astype(np.int64), ((1, 1), (1, 1), (0, 0)))
    H, W = x.shape[:2]
    cols = np.stack([np.stack([xp[dy:dy + H, dx:dx + W] for dx in range(3)], 2)
                     for dy in range(3)], 2).reshape(H * W, -1)
    phi = cols @ w.astype(np.int64).T
    levels = 1 << yb
    # y = r * (phi + lam): the mean lands mid-range; the 8-bit path shifts
    # right only, so r <= 1 there
    r = levels / 2 / (phi.std() + 1.0)
    r = min(r, 1.0) if yb == 8 else r
    kw = dict(y_bits=yb, eps_phi=float(r), eps_y=1.0, lam=float(levels / 2 / r - phi.mean()))
    return RQ.make_requant_params(**kw), TQ.make_requant_params(**kw)


def _check_conv(x_p, w_p, rq_r, rq_t, xb, wb, yb):
    bits = dict(x_bits=xb, w_bits=wb, y_bits=yb)
    want = np.asarray(rref.conv2d_ref(jnp.asarray(x_p), jnp.asarray(w_p), rq_r, **bits))
    pallas = np.asarray(rops.conv2d(jnp.asarray(x_p), jnp.asarray(w_p), rq_r, impl="pallas",
                                    **bits))
    np.testing.assert_array_equal(pallas, want)
    tx, tw = torch.from_numpy(x_p), torch.from_numpy(w_p)
    got = conv2d_ref(tx, tw, rq_t, **bits)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the public entry point routes CPU tensors to the plain version
    assert torch.equal(ops.conv2d(tx, tw, rq_t, **bits), got)
    return want


@pytest.mark.parametrize("cell", PERMUTATIONS, ids=lambda c: "x{}w{}y{}".format(*c))
def test_conv2d_bit_exact_all_cells(cell):
    xb, wb, yb = cell
    rng = np.random.RandomState(100 + 16 * xb + 4 * wb + yb)
    H, W = (5, 6) if (xb + wb + yb) % 2 else (6, 4)
    C, Cout = (8, 12, 16)[xb % 3], (8, 12, 16)[(wb + yb) % 3]
    x_p, w_p, x, w = _conv_operands(rng, H, W, C, Cout, xb, wb)
    rq_r, rq_t = _spread_rq(x, w, yb)
    want = _check_conv(x_p, w_p, rq_r, rq_t, xb, wb, yb)
    assert len(np.unique(want)) > 1  # the output is not one constant byte


@pytest.mark.parametrize("x_bits", [8, 4, 2])
def test_conv2d_border_with_saturated_ifmap(x_bits):
    """Every ifmap value at its maximum: the border pixels' taps are the
    only zeros, so a kernel that mishandles the u8 offset fold there (the
    padded tap is x' = -128 and its share of 128 * sum(w) cancels it) moves
    exactly the corner and edge outputs."""
    rng = np.random.RandomState(x_bits)
    x_p, w_p, x, w = _conv_operands(rng, 4, 5, 8, 8, x_bits, 4, fill=(1 << x_bits) - 1)
    rq_r, rq_t = _spread_rq(x, w, 8)
    want = _check_conv(x_p, w_p, rq_r, rq_t, x_bits, 4, 8)
    assert not np.array_equal(want[0, 0], want[1, 1])  # corners differ from the interior


def test_conv2d_paper_reference_layer_exact_shape():
    """The exact Reference Layer: 32x16x16 ifmap -> 64x16x16 ofmap, 3x3,
    im2col size 288, cell (8, 4, 4) (tests/test_kernels.py's case)."""
    rng = np.random.RandomState(288)
    x_p, w_p, x, w = _conv_operands(rng, 16, 16, 32, 64, 8, 4)
    rq_r, rq_t = _spread_rq(x, w, 4)
    want = _check_conv(x_p, w_p, rq_r, rq_t, 8, 4, 4)
    assert want.shape == (16, 16, 32)


def test_conv2d_rejects_bad_shapes():
    rq = TQ.make_requant_params(y_bits=2, eps_phi=1.0, eps_y=1.0)
    x = torch.zeros((3, 3, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="9C"):
        ops.conv2d(x, torch.zeros((4, 35), dtype=torch.int8), rq, x_bits=8, w_bits=8, y_bits=2)
    with pytest.raises(ValueError, match="Cout"):
        ops.conv2d(x, torch.zeros((6, 36), dtype=torch.int8), rq, x_bits=8, w_bits=8, y_bits=2)


@pytest.mark.parametrize("y_bits", [8, 4, 2])
def test_qntpack_bit_exact_with_wrapping_accumulators(y_bits):
    rng = np.random.RandomState(y_bits)
    M, N = 24, 16
    if y_bits == 8:  # y = clip((phi + 2^22) >> 12): phi in [-2^22, -2^22 + 2^20) spreads
        kw = dict(eps_phi=2.0**-12, lam=float(1 << 22))
        phi = rng.randint(-(1 << 22), -(1 << 22) + (1 << 20), size=(M, N)).astype(np.int64)
    else:
        kw = dict(eps_phi=(1 << y_bits) / 2.0**19, lam=(1 << y_bits) / 2)
        phi = rng.randint(-(1 << 18), 1 << 18, size=(M, N)).astype(np.int64)
    # accumulators at the int32 edges: with the 8-bit path's bias of 2^22,
    # acc + bias wraps past 2^31 (JAX's int32 add wraps; so must the port)
    phi[0] = (1 << 31) - 1 - np.arange(N)
    phi[1] = -(1 << 31) + np.arange(N)
    phi = phi.astype(np.int32)
    kw.update(y_bits=y_bits, eps_y=1.0)
    rq_r, rq_t = RQ.make_requant_params(**kw), TQ.make_requant_params(**kw)
    if y_bits == 8:
        assert rq_t.bias == 1 << 22 and (phi[0].astype(np.int64) + rq_t.bias > 2**31 - 1).all()
    want = np.asarray(rref.qntpack_ref(jnp.asarray(phi), rq_r, y_bits=y_bits))
    pallas = np.asarray(rops.qntpack(jnp.asarray(phi), rq_r, y_bits=y_bits, impl="pallas"))
    np.testing.assert_array_equal(pallas, want)
    got = qntpack_ref(torch.from_numpy(phi), rq_t, y_bits=y_bits)
    assert got.dtype == torch.int8 and tuple(got.shape) == (M, N * y_bits // 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(ops.qntpack(torch.from_numpy(phi), rq_t, y_bits=y_bits), got)
    assert len(np.unique(want)) > 2


def _run_reference_example(name, monkeypatch, capsys):
    """Run ``examples/<name>.py``'s main(), recording every packed ofmap its
    ``ops.conv2d`` calls return; returns (stdout, ofmaps)."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    outs = []
    inner = rops.conv2d

    def recording(*a, **kw):
        y = inner(*a, **kw)
        outs.append(np.array(y, copy=True))
        return y

    monkeypatch.setattr(rops, "conv2d", recording)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out, outs


def test_quickstart_matches_reference_example(monkeypatch, capsys):
    ref_out, ref_y = _run_reference_example("quickstart", monkeypatch, capsys)
    res = quickstart.main(device="cpu")
    port_out = capsys.readouterr().out
    assert port_out == ref_out  # every printed line, the mean error included
    assert len(ref_y) == 1
    np.testing.assert_array_equal(res["y_p"].numpy(), ref_y[0])
    printed = float(port_out.split("mean |quantized - float| = ")[1].split()[0])
    assert abs(res["err"] - printed) <= 5e-5
    # the reference script's own error, computed as it does (jnp float conv
    # on its seeded inputs) from its packed ofmap, within 1e-6
    rng = np.random.RandomState(0)
    x = jnp.asarray(np.abs(rng.randn(16, 16, 32)).astype(np.float32))
    w = jnp.asarray(rng.randn(64, 288).astype(np.float32) * 0.1)
    xpad = jnp.pad(x, ((1, 1), (1, 1), (0, 0)))
    cols = jnp.stack([jnp.stack([xpad[dy:dy + 16, dx:dx + 16, :] for dx in range(3)], 2)
                      for dy in range(3)], 2).reshape(256, -1)
    eps_y = res["eps_y"]
    y = RP.unpack(jnp.asarray(ref_y[0]), 4, signed=False).astype(jnp.float32) * eps_y
    y_ref = jnp.clip(cols @ w.T, 0, 8.0 - eps_y).reshape(16, 16, 64)
    assert abs(res["err"] - float(jnp.mean(jnp.abs(y - y_ref)))) <= 1e-6


def test_sweep_matches_reference_example(monkeypatch, capsys):
    ref_out, ref_y = _run_reference_example("mixed_precision_sweep", monkeypatch, capsys)
    rows = mixed_precision_sweep.main(device="cpu")
    port_out = capsys.readouterr().out
    assert port_out == ref_out  # 27 rows of bytes, ratio and mean error
    assert len(rows) == len(ref_y) == 27
    for row, y in zip(rows, ref_y):
        np.testing.assert_array_equal(row["y_p"].numpy(), y, err_msg=row["name"])


# ------------------------------------------- the paper's claims, in the port
# (tests/test_paper_claims.py's serving-side checks; the QAT ones wait for
# the training path)


def test_paper_claim_27_kernels_in_the_registry():
    """'27 kernels, one for each permutation of input feature maps, weights,
    and output feature maps precision': conv2d is registered on each."""
    from repro_torch.core.policy import PERMUTATIONS as TPERMS
    from repro_torch.kernels import dispatch

    assert len(TPERMS) == 27 and set(TPERMS) == set(PERMUTATIONS)
    names = {dispatch.lookup("conv2d", device=torch.device("cuda", 0), x_bits=x, w_bits=w,
                             y_bits=y).name for x, w, y in TPERMS}
    assert len(names) == 27


def test_paper_claim_threshold_ladder_sizes():
    """4-bit requant needs twice the comparison depth of 2-bit: 15 vs 3
    thresholds, the same ladders as the reference's."""
    for yb, n in ((4, 15), (2, 3)):
        kw = dict(y_bits=yb, eps_phi=2**-8, eps_y=1.0)
        t = TQ.make_requant_params(**kw).thresholds
        assert len(t) == n
        np.testing.assert_array_equal(t, RQ.make_requant_params(**kw).thresholds)


def test_paper_claim_memory_footprint_scaling():
    """Packed storage shrinks exactly with precision (the Reference Layer's
    64 x 288 weights), byte-identical to the reference's packing."""
    w = np.random.RandomState(0).randn(64, 288).astype(np.float32)
    sizes = {}
    for bits in (8, 4, 2):
        got, _ = ops.quantize_pack_weight(torch.from_numpy(w), bits)
        q, _ = RQ.quantize_weight(jnp.asarray(w), bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(RP.pack(q, bits)))
        sizes[bits] = got.numel()
    assert sizes[8] == 2 * sizes[4] == 4 * sizes[2]


def test_paper_claim_accumulator_is_int32():
    """'we always consider 32 bits for the accumulator': extreme operands
    over K = 4096 need 28 bits, through mpmm's int32 output."""
    from repro_torch.core import pack as TP

    k = 4096
    x = TP.pack(torch.full((1, k), 255, dtype=torch.uint8), 8)
    w = TP.pack(torch.full((1, k), -128, dtype=torch.int8), 8)
    phi = ops.mpmm(x, w, None, x_bits=8, w_bits=8, y_bits=8, out_kind="int32")
    assert phi.dtype == torch.int32 and int(phi[0, 0]) == 255 * -128 * k


def test_paper_claim_relu_clip_is_the_quant_function():
    """quant() with alpha = 0 subsumes ReLU and clipping: negative
    accumulators map to code 0 through the standalone QntPack."""
    rq = TQ.make_requant_params(y_bits=4, eps_phi=2**-6, eps_y=1.0)
    phi = torch.tensor([[-(2**20), -1, 0, -5]], dtype=torch.int32)
    assert int(ops.qntpack(phi, rq, y_bits=4).abs().sum()) == 0
