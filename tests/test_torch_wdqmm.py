"""PyTorch port, weight-only layers (bf16 activations, packed 8/4/2-bit
weights) on the CPU, against the JAX reference.

  * ``wdqmm_ref`` (the plain version the CPU runs and the card holds the
    kernel against) against the reference's f32 twin
    ``repro.kernels.wdqmm.wdqmm_ref``: the dequantized weights are
    bit-identical, and the outputs within ``TOL * sum_k |x w|`` (TOL =
    2^-20): XLA's CPU dot and PyTorch's sum the same f32 products in
    different orders (XLA in several interleaved FMA chains at some shapes,
    PyTorch in one), so the last bits differ even at K = 64;
  * ``wdqmm_ref`` against the Pallas kernel in interpret mode, at the
    reference's own bound (rtol 2e-2, atol 2% of max |y|; tests/test_kernels.py):
    the Pallas kernel rounds w * eps_w and x through bf16 before its dot;
  * ``linear_apply`` on a weight-only layer against the reference's, with and
    without bias, on packed and on float weights: within TOL * sum |x w| in
    f32, and at most one bf16 rounding apart when the layer returns bf16;
  * greedy streams of the port's ``ServeEngine`` equal to the reference
    engine's, run op by op (``jax.disable_jit()``, ``impl="jnp"``), on
    reduced internlm2-1.8b: weight-only w4 on the slot, paged and prefix
    caches, w8 and w2 on the paged cache, and a mixed policy (attention
    through mpmm at (8, 4, 8), FFN and head weight-only w2) on the paged
    cache; and weight-only w4 on reduced DeepSeek-V3 (two MLA-dense layers).
    The bf16 logits can tie to one bf16 step where the two sums differ in
    their last f32 bit, and greedy decoding then picks either token; where a
    stream differs, the test replays the reference's own tokens through the
    reference and the port's models and requires that step to be such a tie
    (the two logits within LOGIT_ATOL of each other in the reference).

The CUDA kernel itself runs only on the card (tests/test_torch_gpu.py,
``-k wdqmm``, and ``python3 chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro.core import linear as RL  # noqa: E402
from repro.core import pack as RP  # noqa: E402
from repro.core.policy import BF16 as RBF16  # noqa: E402
from repro.core.policy import LayerPrecision as RLP  # noqa: E402
from repro.core.policy import PrecisionPolicy as RPP  # noqa: E402
from repro.kernels.wdqmm import wdqmm_pallas  # noqa: E402
from repro.kernels.wdqmm import wdqmm_ref as jax_wdqmm  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro.serve import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import linear as TL  # noqa: E402
from repro_torch.core import pack as TP  # noqa: E402
from repro_torch.core.policy import BF16 as TBF16  # noqa: E402
from repro_torch.core.policy import LayerPrecision as TLP  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy as TPP  # noqa: E402
from repro_torch.kernels import build, dispatch, ops  # noqa: E402
from repro_torch.kernels.ref import wdqmm_ref  # noqa: E402
from repro_torch.kernels.wdqmm import TOL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from tests.test_torch_gpu import replay_to_first_tie  # noqa: E402
from tests.test_torch_prefix import _cfgs, _shared_prefix_requests  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

#: the port's bf16 logits against the reference's (tests/test_torch_mla.py)
LOGIT_ATOL = 0.05
ENGINE = dict(n_slots=2, s_max=32, prefill_chunk=4)
LENGTHS = (3, 9, 5, 2, 7)  # tests/test_serve.py: more requests than slots


def _policies(name, default, per_class=None):
    """The same policy for both sides: the reference's ``_uniform`` with
    x = y = None (weight-only), routers bf16, an 8-bit KV cache."""
    def make(PP, LP, BF16):
        pc = {k: LP(*v) for k, v in (per_class or {}).items()}
        return PP(name=name, default=LP(*default), per_class={**pc, "router": BF16},
                  kv_cache_bits=8)
    return make(RPP, RLP, RBF16), make(TPP, TLP, TBF16)


def _operands(rng, M, N, K, wb):
    x = rng.randn(M, K).astype(np.float32)
    w = rng.randint(-(1 << (wb - 1)), 1 << (wb - 1), size=(N, K)).astype(np.int8)
    w_p = np.array(RP.pack(jnp.asarray(w), wb), copy=True)
    eps = np.float32(rng.uniform(1e-3, 5e-2))
    return x, w, w_p, eps


def _bound(x, w, eps):
    """TOL * sum_k |x[m, k] * w[n, k]| (w dequantized), in float64."""
    return TOL * (np.abs(x.astype(np.float64)) @ np.abs(w.astype(np.float64) * eps).T)


@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_wdqmm_ref_matches_reference_twin(w_bits):
    for M, N, K in ((1, 48, 64), (4, 40, 256), (16, 24, 2048), (5, 13, 44)):
        rng = np.random.RandomState(100 * w_bits + K)
        x, w, w_p, eps = _operands(rng, M, N, K, w_bits)
        want = np.asarray(jax_wdqmm(jnp.asarray(x), jnp.asarray(w_p), jnp.asarray(eps),
                                    w_bits=w_bits))
        got = ops.wdqmm(torch.from_numpy(x), torch.from_numpy(w_p), torch.tensor(eps),
                        w_bits=w_bits)
        assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
        assert (np.abs(got.numpy() - want) <= _bound(x, w, eps)).all(), (M, N, K)
        # the dequantized weights are the reference's array, bit for bit
        tw = TP.unpack(torch.from_numpy(w_p), w_bits, signed=True).float() * torch.tensor(eps)
        rw = np.asarray(RP.unpack(jnp.asarray(w_p), w_bits, signed=True).astype(jnp.float32)
                        * jnp.float32(eps))
        np.testing.assert_array_equal(tw.numpy(), rw)
        # bf16 activations are widened exactly
        xb = torch.from_numpy(x).to(torch.bfloat16)
        assert torch.equal(wdqmm_ref(xb, torch.from_numpy(w_p), eps, w_bits=w_bits),
                           wdqmm_ref(xb.float(), torch.from_numpy(w_p), eps, w_bits=w_bits))


@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_wdqmm_ref_matches_pallas_interpret(w_bits):
    """The Pallas kernel's bf16 dot against the f32 plain version, at the
    reference's own bound (tests/test_kernels.py)."""
    rng = np.random.RandomState(7 + w_bits)
    x, _, w_p, eps = _operands(rng, 8, 128, 512, w_bits)
    want = np.asarray(wdqmm_pallas(jnp.asarray(x), jnp.asarray(w_p), jnp.asarray(eps),
                                   w_bits=w_bits, bm=8, bn=128, bk=256, interpret=True))
    got = ops.wdqmm(torch.from_numpy(x), torch.from_numpy(w_p), torch.tensor(eps),
                    w_bits=w_bits).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0.02 * float(np.abs(want).max()))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "float"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_linear_apply_weight_only_matches_reference(w_bits, bias, packed):
    """The weight-only branch of linear_apply: the packed weights (or the
    on-the-fly quantization of float weights), ops.wdqmm, the bias in f32,
    the cast to the input's dtype."""
    lp_r, lp_t = RLP(None, w_bits, None), TLP(None, w_bits, None)
    rng = np.random.RandomState(w_bits)
    params = RL.linear_init(jax.random.key(w_bits), 64, 48, lp_r, bias=bias,
                            mode="serve" if packed else "train")
    assert "beta" not in params and ("w_packed" in params) == packed
    if bias:
        params["b"] = jnp.asarray(rng.randn(48).astype(np.float32))
    tparams = {k: bridge.to_tensor(np.asarray(v), device="cpu") for k, v in params.items()}
    x = rng.randn(3, 5, 64).astype(np.float32)
    w_int = (np.asarray(RP.unpack(params["w_packed"], w_bits, signed=True)) if packed else None)
    for dtype in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x).astype(dtype)
        ref = np.asarray(RL.linear_apply(params, xj, lp_r, mode="serve", impl="jnp"))
        got = TL.linear_apply(tparams, bridge.to_tensor(np.asarray(xj), device="cpu"), lp_t)
        assert got.dtype == (torch.float32 if dtype == jnp.float32 else torch.bfloat16)
        g, r = got.float().numpy(), ref.astype(np.float32)
        assert g.shape == (3, 5, 48)
        if dtype == jnp.float32 and packed:
            bound = _bound(x.reshape(15, 64), w_int, np.float32(params["eps_w"]))
            assert (np.abs(g - r).reshape(15, 48) <= bound).all()
        else:  # one bf16 step at most (the f32 sums straddle a rounding edge)
            np.testing.assert_allclose(g, r, rtol=2.0**-7, atol=1e-6)


def test_weight_only_policies_route_through_wdqmm():
    """A weight-only policy's cells are the wdqmm ones, the mixed policy's
    mpmm and wdqmm (the registry's coverage: tests/test_torch_kernels.py);
    impl='cuda' on CPU tensors raises, and the plain version is never
    counted as a launch."""
    _, wo = _policies("w4only", (None, 4, None))
    _, mixed = _policies("mixed", (None, 2, None), {"attn_qkv": (8, 4, 8), "attn_out": (8, 4, 8)})
    dispatch.ensure_policy_supported(wo)
    dispatch.ensure_policy_supported(mixed)
    assert dispatch.cells_for_policy(wo) == [dispatch.KernelKey("wdqmm", None, 4, None, "cuda")]
    assert {k.op for k in dispatch.cells_for_policy(mixed)} == {"mpmm", "wdqmm"}
    assert dispatch.lookup("wdqmm", device=torch.device("cuda", 0), w_bits=2).name == "wdqmm_i2"
    x, w_p = torch.zeros((2, 16)), torch.zeros((3, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        ops.wdqmm(x, w_p, 1.0, w_bits=4, impl="cuda")
    before = build.LAUNCHES["wdqmm"]
    assert tuple(ops.wdqmm(x, w_p, 1.0, w_bits=4).shape) == (2, 3)
    assert build.LAUNCHES["wdqmm"] == before


# ------------------------------------------------------------ the engine


def _requests(cls, vocab):
    rng = np.random.RandomState(0)
    return [cls(rid=i, prompt=rng.randint(1, vocab, size=n).astype(np.int32), max_new=4)
            for i, n in enumerate(LENGTHS)]


def _replay_ties(jp, tp, rcfg, tcfg, rpol, tpol, prompt, ref_toks, got_toks):
    """The reference's tokens of one request through the reference (op by
    op) and the port's models, to the first tie (``replay_to_first_tie``)."""
    c = {"ref": RM.init_cache(rcfg, rpol, 1, ENGINE["s_max"]),
         "port": TM.init_cache(tcfg, tpol, 1, ENGINE["s_max"], device="cpu")}

    def prefill(toks, pos, kw):
        with jax.disable_jit():
            ref, c["ref"] = RM.prefill_into_slot(jp, jnp.asarray(toks), jnp.int32(0), pos,
                                                 c["ref"], rcfg, rpol, impl="jnp", **kw)
        got = TM.prefill_into_slot(tp, torch.from_numpy(toks), 0, pos, c["port"], tcfg, tpol,
                                   **kw)
        return np.asarray(ref).astype(np.float32).ravel(), got.float().numpy().ravel()

    def decode(toks, pos):
        with jax.disable_jit():
            ref, c["ref"] = RM.decode_step(jp, jnp.asarray(toks), jnp.asarray([pos], np.int32),
                                           c["ref"], rcfg, rpol, impl="jnp", fused_attn=True)
        got = TM.decode_step(tp, torch.from_numpy(toks), torch.tensor([pos], dtype=torch.int32),
                             c["port"], tcfg, tpol, fused_attn=True)
        return np.asarray(ref).astype(np.float32).ravel(), got.float().numpy().ravel()

    return replay_to_first_tie(prefill, decode, prompt, ref_toks, got_toks, LOGIT_ATOL)


#: (arch, policy name, default, per-class, caches): the cells of the
#: engine comparison
CELLS = {
    "internlm2-w4": ("internlm2-1.8b", (None, 4, None), None, ("slot", "paged", "prefix")),
    "internlm2-w8": ("internlm2-1.8b", (None, 8, None), None, ("paged",)),
    "internlm2-w2": ("internlm2-1.8b", (None, 2, None), None, ("paged",)),
    "internlm2-mixed": ("internlm2-1.8b", (None, 2, None),
                        {"attn_qkv": (8, 4, 8), "attn_out": (8, 4, 8)}, ("paged",)),
    "deepseek-w4": ("deepseek-v3-671b", (None, 4, None), None, ("paged",)),
}


@pytest.fixture(scope="module")
def engine_runs():
    """Per cell, lazily: the reference engine (op by op) on the paged cache
    (and on the prefix cache where the cell has it), and the port's engine
    on each of the cell's caches, on the bridged weights."""
    runs: dict = {}

    def get(cell):
        if cell not in runs:
            arch, default, per_class, caches = CELLS[cell]
            rcfg, tcfg = _cfgs(arch)
            rpol, tpol = _policies(cell, default, per_class)
            jp = RM.init_params(jax.random.key(3), rcfg, rpol, mode="serve")
            tp = bridge.params_from_reference(jax.tree.map(lambda a: np.array(a, copy=True), jp),
                                              device="cpu")
            out = {"models": (jp, tp, rcfg, tcfg, rpol, tpol)}
            for cache in caches:
                reqs = _shared_prefix_requests if cache == "prefix" else _requests
                ps = dict(page_size=4 if cache == "prefix" else 16) if cache != "slot" else {}
                if cache != "slot":  # the reference's slot streams are its paged ones
                    ref = RServeEngine(jp, rcfg, rpol, impl="jnp", prefill="chunked",
                                       cache=cache, **ENGINE, **ps)
                    with jax.disable_jit():
                        out["ref", cache] = ref.run(reqs(RRequest, rcfg.vocab))
                port = ServeEngine(tp, tcfg, tpol, cache=cache, device="cpu", **ENGINE, **ps)
                out[cache] = (port.run(reqs(Request, rcfg.vocab)), port.metrics())
            runs[cell] = out
        return runs[cell]

    return get


@pytest.mark.parametrize("cell, cache", [(c, k) for c, v in CELLS.items() for k in v[3]])
def test_greedy_streams_identical_to_reference(engine_runs, cell, cache):
    runs = engine_runs(cell)
    got, m = runs[cache]
    want = runs["ref", "paged" if cache == "slot" else cache]
    assert sorted(got) == list(range(len(LENGTHS))) and all(len(v) == 4 for v in got.values())
    assert m["kernels/wdqmm_calls"] > 0
    assert ("kernels/mpmm_calls" in m) == (cell == "internlm2-mixed")
    if cache == "prefix":
        assert m["cache/prefix_hit_rate"] > 0
    if got == want:
        return
    # a stream that differs must differ at a tie of the reference's logits
    jp, tp, rcfg, tcfg, rpol, tpol = runs["models"]
    reqs = (_shared_prefix_requests if cache == "prefix" else _requests)(Request, rcfg.vocab)
    for r in reqs:
        if got[r.rid] != want[r.rid]:
            _replay_ties(jp, tp, rcfg, tcfg, rpol, tpol, r.prompt, want[r.rid], got[r.rid])


def test_weight_only_slot_and_paged_streams_identical(engine_runs):
    """The port's own invariant, exact: one weight-only model gives the same
    streams on the slot and the paged cache."""
    runs = engine_runs("internlm2-w4")
    assert runs["slot"][0] == runs["paged"][0]
