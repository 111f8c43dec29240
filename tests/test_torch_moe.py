"""PyTorch port, the Mixture-of-Experts feed-forward on the CPU: the
batched mpmm over experts (``ops.mpmm`` with a leading expert axis) against
its plain twin applied expert by expert, the expert linears
(``core.linear.experts_init`` / ``experts_apply`` / the serving
conversion), and ``models.ffn.moe_apply`` against the JAX reference run op
by op (``jax.disable_jit()``, ``impl="jnp"``) on the same weights (the
bridge) and the same inputs (seeded numpy).

``moe_apply`` cases: no drops; drops (``capacity_factor`` 0.25, as in
tests/test_moe.py); grouped dispatch (T * k > 8192 at d_model 64: 32
groups); a nonzero router bias; router weights that tie the logits at the
k-th place for every token; int8 dispatch payloads
(``moe_dispatch_bits = 8``); a shared expert. Each under bf16, w4a8 and
mixed_paper.

Tolerances. ``top_i`` (the expert ids each token picks, read against
``jax.lax.top_k`` of the reference's own router scores) and the dispatch
buffer the experts receive (so every ``dest``) are equal everywhere. Under
the integer policies y is bit-equal on every token whose router logits
and bf16 routing weights equal the reference's; the router's f32 product
sums in another order on the CPU than XLA's dot and the softmax's ``exp``
differs from XLA's by an f32 ulp (ROADMAP Queue 3 items 4 and 11), so a
token whose logit or weight rounds the other way is allowed one bf16 step
of its largest output, and at most 1% of the tokens may be such. Under
bf16 (the experts' f32 products sum in another order too) y is within one
bf16 step of each element. The aux loss is within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro import runtime_flags as RRF  # noqa: E402
from repro.core import linear as RL  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.models import ffn as RF  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import runtime_flags as TRF  # noqa: E402
from repro_torch.core import linear as TL  # noqa: E402
from repro_torch.core import pack as P  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.core.policy import PERMUTATIONS  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.kernels.ref import mpmm_ref  # noqa: E402
from repro_torch.models import ffn as TF  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

POLICIES = ("bf16", "w4a8", "mixed_paper")
#: case -> (MoECfg fields, tokens, router bias, tied router rows, int8 payload)
CASES = {
    "plain": (dict(n_experts=4, top_k=2), 64, False, False, False),
    "drops": (dict(n_experts=4, top_k=2, capacity_factor=0.25), 64, False, False, False),
    "groups": (dict(n_experts=8, top_k=4), 2056, False, False, False),
    "router_bias": (dict(n_experts=4, top_k=2), 64, True, False, False),
    "ties": (dict(n_experts=4, top_k=2), 64, False, True, False),
    "int8_payload": (dict(n_experts=4, top_k=2), 64, False, False, True),
    "shared": (dict(n_experts=4, top_k=2, n_shared=1, d_ff_shared=32), 64, False, False, False),
}
D, F = 64, 32


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        jnp.asarray(a).astype(jnp.float32))


def _bf16_step(a):
    """One bf16 step (ulp) at each |a| (0 where a is 0)."""
    a = np.abs(a.astype(np.float64))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-300))) - 7), 0.0)


class _Recorder:
    """Replace ``module.name`` with a wrapper that records its calls."""

    def __init__(self, monkeypatch, module, name, keep):
        self.calls = []
        fn = getattr(module, name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            self.calls.append(keep(a, out))
            return out

        monkeypatch.setattr(module, name, wrapped)


def _case(name, policy_name, monkeypatch):
    """Run one case on both sides. Returns a dict of both sides' results."""
    fields, T, bias, ties, dq = CASES[name]
    cfg = RF.MoECfg(d_model=D, d_ff_expert=F, **fields)
    tcfg = TF.MoECfg(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    pol, tpol = get_policy(policy_name), tget_policy(policy_name)
    seed = sum(map(ord, name))
    p = _np(jax.jit(lambda k: RF.moe_init(k, cfg, pol, mode="serve", dtype=jnp.bfloat16))(
        jax.random.key(seed)))
    rng = np.random.RandomState(seed)
    if bias:
        p["router_bias"] = (0.05 * rng.standard_normal(cfg.n_experts)).astype(np.float32)
    if ties:  # experts 1..E-1 share one router row: tied logits at the k-th place
        w = p["router"]["w"]
        w[1:] = w[1]
    x = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(lambda a: bridge.to_tensor(a, "cpu"), p)

    router = _Recorder(monkeypatch, RF, "linear_apply",
                       lambda a, out: out if a[0] is jp["router"] else None)
    ref_buf = _Recorder(monkeypatch, RF, "experts_apply", lambda a, out: np.asarray(a[1]))
    port_buf = _Recorder(monkeypatch, TF, "experts_apply", lambda a, out: a[1].clone())
    plan = _Recorder(monkeypatch, TF, "moe_route", lambda a, out: out)
    RRF.FLAGS["moe_dispatch_bits"] = TRF.FLAGS["moe_dispatch_bits"] = 8 if dq else None
    try:
        with jax.disable_jit():
            y_ref, aux_ref = RF.moe_apply(jp, jnp.asarray(x).astype(jnp.bfloat16), cfg, pol,
                                          mode="serve", impl="jnp")
            logits = next(c for c in router.calls if c is not None).astype(jnp.float32)
            probs = jax.nn.softmax(logits, axis=-1)
            sel = probs + jp["router_bias"] if "router_bias" in jp else probs
            _, top_i = jax.lax.top_k(sel, cfg.top_k)
            top_p = jnp.take_along_axis(probs, top_i, axis=-1)
            top_p = (top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)).astype(
                jnp.bfloat16)
        y, aux = TF.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg, tpol)
    finally:
        RRF.FLAGS["moe_dispatch_bits"] = TRF.FLAGS["moe_dispatch_bits"] = None
    r = plan.calls[0]
    port_logits = TL.linear_apply(tp["router"], torch.from_numpy(x).to(torch.bfloat16)
                                  .reshape(T, D), tpol.of("router")).float().numpy()
    return dict(T=T, y=_f32(y).reshape(T, D), y_ref=_f32(y_ref).reshape(T, D),
                aux=float(aux), aux_ref=float(aux_ref), dropped=int((~r["keep"]).sum()),
                top_i=r["top_i"].numpy(), top_i_ref=np.asarray(top_i),
                top_p=_f32(r["top_p"].to(torch.bfloat16)), top_p_ref=_f32(top_p),
                logits=port_logits, logits_ref=np.asarray(logits), G=r["G"],
                buf=_f32(port_buf.calls[0]), buf_ref=_f32(ref_buf.calls[0]))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_matches_reference(name, policy, monkeypatch):
    c = _case(name, policy, monkeypatch)
    if name == "groups":
        assert c["G"] == 32
    if name == "ties":  # every token ties at the k-th place; the lower index wins
        s = np.sort(c["logits_ref"], axis=-1)[:, ::-1]
        assert (s[:, 1] == s[:, 2]).all() or (s[:, 0] == s[:, 2]).all()
    np.testing.assert_array_equal(c["top_i"], c["top_i_ref"])
    np.testing.assert_array_equal(c["buf"], c["buf_ref"])  # every dest and payload
    assert abs(c["aux"] - c["aux_ref"]) <= 1e-6 * abs(c["aux_ref"])
    y, ref = c["y"], c["y_ref"]
    assert np.isfinite(y).all()
    if policy == "bf16":
        assert (np.abs(y - ref) <= _bf16_step(ref)).all()
        return
    odd = ((c["logits"] != c["logits_ref"]).any(-1)
           | (c["top_p"] != c["top_p_ref"]).any(-1))  # routing inputs that round apart
    assert odd.sum() <= c["T"] // 100, int(odd.sum())
    np.testing.assert_array_equal(y[~odd], ref[~odd])
    for t in np.flatnonzero(odd):
        assert (np.abs(y[t] - ref[t]) <= _bf16_step(np.abs(ref[t]).max())).all(), t
    if name == "drops":  # capacity binds: some tokens keep fewer than k experts
        assert c["dropped"] > 0


# ------------------------------------------------------ mpmm over experts


@pytest.mark.parametrize("cell", [(8, 4, 8), (8, 2, 8), (4, 4, 4), (2, 8, 2)])
def test_batched_mpmm_twin_equals_mpmm_ref_expert_by_expert(cell):
    """``ops.mpmm`` on (E, M, K) x (E, N, K) operands (one dispatch) equals
    ``mpmm_ref`` on each expert's operands with that expert's out-scale, bit
    for bit, in every output kind."""
    xb, wb, yb = cell
    g = torch.Generator().manual_seed(sum(cell))
    E, M, N, K = 5, 7, 24, 64
    x = torch.randint(0, 1 << xb, (E, M, K), generator=g, dtype=torch.int32).to(torch.uint8)
    w = torch.randint(-(1 << (wb - 1)), 1 << (wb - 1), (E, N, K), generator=g,
                      dtype=torch.int32).to(torch.int8)
    x_p, w_p = P.pack(x, xb), P.pack(w, wb)
    scale = torch.rand((E,), generator=g) * 1e-2
    rq = Q.make_requant_params(y_bits=yb, eps_phi=2.0**-9, eps_y=1.0, lam=2.0)
    key = dispatch.KernelKey("mpmm", xb, wb, yb, "torch")
    n0 = dispatch.DISPATCH_COUNTS[key]
    for kind in ("f32", "int32", "packed"):
        kw = dict(x_bits=xb, w_bits=wb, y_bits=yb, x_signed=True, out_kind=kind)
        got = ops.mpmm(x_p, w_p, rq, out_scale=scale, **kw)
        assert got.shape[:2] == (E, M)
        for e in range(E):
            want = mpmm_ref(x_p[e], w_p[e], rq, out_scale=scale[e], **kw)
            assert torch.equal(got[e], want), (kind, e)
    assert dispatch.DISPATCH_COUNTS[key] - n0 == 3  # one dispatch a batched call


def test_expert_cells_are_registered_for_every_preset():
    """The expert class's cells are inside the coverage gate (mpmm's 27
    cells on both implementations): w4a8's (8, 4, 8), mixed_paper's (8, 2, 8)."""
    for name, cell in (("w4a8", (8, 4, 8)), ("mixed_paper", (8, 2, 8))):
        lp = tget_policy(name).of("expert")
        assert (lp.x_bits, lp.w_bits, lp.y_bits) == cell
        assert cell in set(PERMUTATIONS)
        for impl in dispatch.IMPLS:
            assert cell in dispatch.coverage("mpmm", impl)
        assert dispatch.KernelKey("mpmm", *cell, "cuda") in dispatch.cells_for_policy(
            tget_policy(name))


# ------------------------------------------------------- expert linears


@pytest.mark.parametrize("policy", ["w4a8", "mixed_paper"])
def test_experts_apply_matches_vmapped_reference(policy):
    """``experts_apply`` on (E, C, d_in) equals the reference's vmapped
    ``linear_apply``, bit for bit, with per-expert betas and scales."""
    pol, tpol = get_policy(policy), tget_policy(policy)
    lp = pol.of("expert")
    p = _np(RL.experts_init(jax.random.key(5), 6, 64, 48, lp, mode="serve", dtype=jnp.bfloat16))
    rng = np.random.RandomState(5)
    p["beta"] = (4.0 + rng.uniform(0, 4, 6)).astype(np.float32)
    p["eps_w"] = (p["eps_w"] * rng.uniform(0.5, 2.0, 6)).astype(np.float32)
    x = rng.standard_normal((6, 12, 64)).astype(np.float32) * 2
    with jax.disable_jit():
        want = RL.experts_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x).astype(jnp.bfloat16),
                                lp, mode="serve", impl="jnp")
    tp = jax.tree.map(lambda a: bridge.to_tensor(a, "cpu"), p)
    got = TL.experts_apply(tp, torch.from_numpy(x).to(torch.bfloat16), tpol.of("expert"))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (6, 12, 48)
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("policy", ["w4a8", "mixed_paper", "bf16"])
def test_experts_init_shapes_mirror_the_reference(policy):
    """Serve-mode expert leaves: (E, d_out, d_in / rw) int8 codes drawn
    directly, (E,) ``eps_w`` and ``beta``, the reference's shapes and dtypes;
    train mode a float (E, d_out, d_in) ``w``."""
    pol, tpol = get_policy(policy), tget_policy(policy)
    lp, tlp = pol.of("expert"), tpol.of("expert")
    for mode in ("serve", "train"):
        ref = jax.eval_shape(lambda: RL.experts_init(jax.random.key(0), 8, 64, 32, lp,
                                                     mode=mode, dtype=jnp.bfloat16))
        got = TL.experts_init(torch.Generator().manual_seed(0), 8, 64, 32, tlp, mode=mode,
                              device="cpu", dtype=torch.bfloat16)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert tuple(got[k].shape) == ref[k].shape, (mode, k)
            assert str(got[k].dtype).split(".")[-1] == str(ref[k].dtype), (mode, k)
        if mode == "serve" and tlp.quantized:
            codes = P.unpack(got["w_packed"], tlp.w_bits, signed=True)
            spec = Q.WGT_SPECS[tlp.w_bits]
            assert int(codes.min()) >= spec.qmin and int(codes.max()) <= spec.qmax
            assert len({tuple(c.flatten().tolist()) for c in codes}) == 8  # experts differ


def test_train_tree_converts_to_the_references_serving_leaves():
    """``convert_model_to_serving`` folds a train-mode MoE's (E, d_out,
    d_in) ``w`` into the leaves the reference's conversion gives (its
    vmapped ``convert_linear_to_serving``), bit for bit; serving the
    converted tree equals serving the train tree on the fly."""
    pol, tpol = get_policy("w4a8"), tget_policy("w4a8")
    cfg = RF.MoECfg(d_model=D, n_experts=4, top_k=2, d_ff_expert=F)
    tcfg = TF.MoECfg(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    p = _np(RF.moe_init(jax.random.key(7), cfg, pol, mode="train", dtype=jnp.bfloat16))
    want = _np(RL.convert_model_to_serving({"moe": p}, pol))["moe"]
    tp = jax.tree.map(lambda a: bridge.to_tensor(a, "cpu"), p)
    got = TL.convert_model_to_serving({"moe": tp}, tpol)["moe"]
    for proj in ("gate", "up", "down"):
        assert sorted(got[proj]) == sorted(want[proj]) == ["beta", "eps_w", "w_packed"]
        for k in want[proj]:
            np.testing.assert_array_equal(bridge.to_numpy(got[proj][k]), want[proj][k], k)
    assert "w" in got["router"]  # the router stays bf16
    x = torch.from_numpy(np.random.RandomState(7).standard_normal((1, 16, D)).astype(
        np.float32)).to(torch.bfloat16)
    a, _ = TF.moe_apply(got, x, tcfg, tpol)
    b, _ = TF.moe_apply(tp, x, tcfg, tpol)
    assert torch.equal(a, b)


def test_experts_convert_and_requantize_at_the_expert_class():
    """Under mixed_paper (experts w2, other FFN projections w4) the
    conversion packs a MoE node's own gate / up / down at the ``expert``
    class's width, expert by expert, and its shared expert at the MLP
    classes'; the self-draft requantizes the w2 experts to w4, each
    expert's ``eps_w`` scaled by 1 / 7 (qmax 1 -> 7; codes -2 clamp to -8). The reference's walks
    class the experts by name as ffn_in / ffn_out (ROADMAP Queue 3 item
    12): its converted tree cannot be served under this policy."""
    from repro_torch.serve.spec import derive_w4_policy, requantize_params_w4

    pol, tpol = get_policy("mixed_paper"), tget_policy("mixed_paper")
    cfg = RF.MoECfg(d_model=D, n_experts=4, top_k=2, d_ff_expert=F, n_shared=1,
                    d_ff_shared=F)
    tcfg = TF.MoECfg(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    p = _np(RF.moe_init(jax.random.key(8), cfg, pol, mode="train", dtype=jnp.bfloat16))
    tp = jax.tree.map(lambda a: bridge.to_tensor(a, "cpu"), p)
    got = TL.convert_model_to_serving({"layers": [{"moe": tp}]}, tpol)["layers"][0]["moe"]
    for proj in ("gate", "up", "down"):
        w = tp[proj]["w"].float()
        assert got[proj]["w_packed"].shape[-1] == w.shape[-1] // 4  # w2: 4 codes a byte
        for e in range(4):
            wq, eps = Q.quantize_weight(w[e], 2)
            assert torch.equal(got[proj]["w_packed"][e], P.pack(wq, 2))
            assert torch.equal(got[proj]["eps_w"][e], eps)
        assert got["shared"][proj]["w_packed"].shape[-1] == (F if proj == "down" else D) // 2
    x = torch.from_numpy(np.random.RandomState(8).standard_normal((1, 16, D)).astype(
        np.float32)).to(torch.bfloat16)
    a, _ = TF.moe_apply(got, x, tcfg, tpol)
    b, _ = TF.moe_apply(tp, x, tcfg, tpol)
    assert torch.equal(a, b)

    draft = requantize_params_w4({"layers": [{"moe": got}]}, tpol)["layers"][0]["moe"]
    for proj in ("gate", "up", "down"):
        codes = P.unpack(got[proj]["w_packed"], 2, signed=True).float()
        want = torch.clamp(torch.round(codes * 7), -8, 7).to(torch.int8)
        assert torch.equal(draft[proj]["w_packed"], P.pack(want, 4))
        assert torch.equal(draft[proj]["eps_w"], got[proj]["eps_w"] * (1 / 7))
        assert draft["shared"][proj] is got["shared"][proj]  # already w4
    assert derive_w4_policy(tpol).of("expert").w_bits == 4
    TF.moe_apply(draft, x, tcfg, derive_w4_policy(tpol))  # the draft serves


def test_weight_only_experts_are_refused():
    """A weight-only expert class (bf16 activations) raises where the expert
    linear would run, never falling back to another path."""
    from repro_torch.core.policy import LayerPrecision

    p = TL.experts_init(torch.Generator().manual_seed(0), 2, 16, 8, LayerPrecision(None, 4, None),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="weight-only expert"):
        TL.experts_apply(p, torch.zeros((2, 4, 16), dtype=torch.bfloat16),
                         LayerPrecision(None, 4, None))
