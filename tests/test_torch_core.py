"""PyTorch port, core layer: packing, quantization, requantization, the
serve-mode linear and the import boundary, held bit-exact against the JAX
reference (``repro.core``) on seeded numpy inputs."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import linear as RL  # noqa: E402
from repro.core import pack as RP  # noqa: E402
from repro.core import policy as RPol  # noqa: E402
from repro.core import quant as RQ  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import linear as TL  # noqa: E402
from repro_torch.core import pack as TP  # noqa: E402
from repro_torch.core import policy as TPol  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]
BITS = (2, 4, 8)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("signed", [False, True])
def test_pack_unpack_bit_exact(bits, signed):
    rng = np.random.RandomState(bits + 10 * signed)
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed else (0, 1 << bits)
    q = rng.randint(lo, hi, size=(3, 5, 32)).astype(np.int8 if signed else np.uint8)
    ref_p = np.asarray(RP.pack(jnp.asarray(q), bits))
    got_p = TP.pack(torch.from_numpy(q.copy()), bits)
    np.testing.assert_array_equal(got_p.numpy(), ref_p)
    ref_u = np.asarray(RP.unpack(jnp.asarray(ref_p), bits, signed=signed))
    got_u = TP.unpack(got_p, bits, signed=signed).numpy()
    assert got_u.dtype == ref_u.dtype
    np.testing.assert_array_equal(got_u, ref_u)
    np.testing.assert_array_equal(got_u, q)  # round trip


@pytest.mark.parametrize("bits", BITS)
def test_quantizers_bit_exact(bits):
    rng = np.random.RandomState(bits)
    w = (rng.randn(16, 32) * 0.3).astype(np.float32)
    x = (rng.randn(8, 32) * 2.0).astype(np.float32)
    # exact ties: x / eps lands on .5 -- half-to-even must agree
    x[0, :8] = np.float32(6.0 / (1 << (bits - 1))) * (np.arange(8) + 0.5)
    qw_r, ew_r = RQ.quantize_weight(jnp.asarray(w), bits)
    qw_t, ew_t = TQ.quantize_weight(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(qw_t.numpy(), np.asarray(qw_r))
    assert ew_t.item() == float(ew_r)
    for fr, ft in ((RQ.quantize_act, TQ.quantize_act),
                   (RQ.quantize_act_signed, TQ.quantize_act_signed)):
        qr, er = fr(jnp.asarray(x), 6.0, bits)
        qt, et = ft(torch.from_numpy(x), 6.0, bits)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
        assert et.item() == float(er)


@pytest.mark.parametrize("y_bits", BITS)
@pytest.mark.parametrize("lam,rounding", [(0.0, False), (37.5, True)])
def test_requant_params_and_paths(y_bits, lam, rounding):
    kw = dict(y_bits=y_bits, kappa=1.3, lam=lam, eps_phi=2.0**-7, eps_y=0.21,
              rounding=rounding)
    r, t = RQ.make_requant_params(**kw), TQ.make_requant_params(**kw)
    np.testing.assert_array_equal(t.thresholds, r.thresholds)
    assert (t.shift, t.bias, t.mult, t.addend) == (r.shift, r.bias, r.mult, r.addend)
    phi = np.random.RandomState(y_bits).randint(-3000, 3000, size=(7, 33)).astype(np.int32)
    for ladder in (None, True, False):
        got = TQ.requant(torch.from_numpy(phi), t, ladder=ladder).numpy()
        np.testing.assert_array_equal(got, np.asarray(RQ.requant(jnp.asarray(phi), r,
                                                                ladder=ladder)))


def test_policy_is_a_faithful_copy():
    assert TPol.PERMUTATIONS == RPol.PERMUTATIONS
    assert TPol.KERNEL_NAMES == RPol.KERNEL_NAMES
    assert TPol.LAYER_CLASSES == RPol.LAYER_CLASSES
    assert sorted(TPol.POLICIES) == sorted(RPol.POLICIES)
    for name in RPol.POLICIES:
        rp, tp = RPol.get_policy(name), TPol.get_policy(name)
        assert tp.kv_cache_bits == rp.kv_cache_bits
        for cls in RPol.LAYER_CLASSES:
            a, b = rp.of(cls), tp.of(cls)
            assert (a.x_bits, a.w_bits, a.y_bits) == (b.x_bits, b.w_bits, b.y_bits)


@pytest.mark.parametrize("policy", ["w4a8", "w8a8", "w2a4", "mixed_paper"])
def test_serve_linear_bit_exact(policy):
    """The serve branch of linear_apply: quantize (f32), pack, mpmm, f32
    scale, bias in f32, cast to the input dtype -- identical bits."""
    lp = RPol.get_policy(policy).of("ffn_in")
    params = RL.linear_init(jax.random.key(1), 64, 48, lp, bias=True, mode="serve")
    params = dict(params, b=jnp.asarray(np.random.RandomState(0).randn(48), jnp.float32))
    tparams = {k: bridge.to_tensor(np.array(v, copy=True), device="cpu")
               for k, v in params.items()}
    x = np.random.RandomState(2).randn(2, 3, 64).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with jax.disable_jit():
        ref = np.asarray(RL.linear_apply(params, xb, lp, mode="serve", impl="jnp"))
    got = TL.linear_apply(tparams, bridge.to_tensor(np.asarray(xb), device="cpu"), lp)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, 48)
    np.testing.assert_array_equal(bridge.to_numpy(got).astype(np.float32),
                                  ref.astype(np.float32))


def test_convert_linear_to_serving_bit_exact():
    lp = RPol.get_policy("w4a8").of("attn_qkv")
    w = (np.random.RandomState(4).randn(32, 64) * 0.1).astype(np.float32)
    ref = RL.convert_linear_to_serving({"w": jnp.asarray(w), "beta": jnp.float32(6.0)}, lp)
    got = TL.convert_linear_to_serving({"w": torch.from_numpy(w),
                                        "beta": torch.tensor(6.0)}, lp)
    np.testing.assert_array_equal(got["w_packed"].numpy(), np.asarray(ref["w_packed"]))
    assert got["eps_w"].item() == float(ref["eps_w"])


def test_bridge_copies_and_keeps_bf16_bits():
    a = np.asarray(jnp.asarray(np.random.RandomState(0).randn(5, 7)).astype(jnp.bfloat16))
    src = np.array(a, copy=True)
    t = bridge.to_tensor(src, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_numpy(t).view(np.uint16), a.view(np.uint16))
    src[...] = 0  # the tensor owns its memory: mutating the source leaves it intact
    np.testing.assert_array_equal(bridge.to_numpy(t).view(np.uint16), a.view(np.uint16))


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of the port, and chip_smoke.py, leaves jax
    and repro unloaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert len(names) >= 20, names\n"
        "import chip_smoke\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_silu_matches_reference_rounding():
    """``jax.nn.silu`` on bf16 rounds after every op of x * (1 / (1 +
    exp(-x))); the port's silu does the same, which ``F.silu`` (one
    rounding) does not."""
    from repro_torch.models.common import silu

    x = np.asarray(jnp.asarray(np.random.RandomState(0).randn(300, 64)).astype(jnp.bfloat16))
    ref = np.asarray(jax.nn.silu(jnp.asarray(x))).astype(np.float32)
    tx = bridge.to_tensor(x, device="cpu")
    np.testing.assert_array_equal(silu(tx).float().numpy(), ref)
    assert (torch.nn.functional.silu(tx).float().numpy() != ref).any()
