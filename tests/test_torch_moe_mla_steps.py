"""PyTorch port, DeepSeek-V3's expert layers: the reduced config (an
MLA-dense layer, then an ``mla_moe`` layer: 4 experts top-2 of width 32
and a shared expert, MTP params carried) on the CPU against the JAX
reference run op by op, on the port's seeded weights carried through the
bridge (tests/_torch_moe_common.py).

  * the layer kinds and the MoE config mirror the reference's; the
    ``mla_moe`` layer holds the experts, never a dense MLP;
  * chunked prefill into a slot and into pages, then fused and unfused
    ``decode_step``: every cache byte equal, logits within
    tests/test_torch_mla.py's LOGIT_ATOL (the absorbed MLA products sum in
    another order than XLA's dot) with the same argmax;
  * the continuous (mixed) and speculative (self4) engines' greedy streams
    equal the reference engine's in the same mode (the stream grid over
    caches and policies is in tests/test_torch_moe_serve_mla.py).

The whole-sequence paths (``forward``, ``prefill_step``) raise for MLA
layers, as before (ROADMAP Queue 3 item 8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_moe_common import Runs, assert_streams, cfgs, make_params  # noqa: E402
from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro.core.policy import get_policy  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "deepseek-v3-671b"
LOGIT_ATOL = 0.05
B, S_MAX = 2, 32


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        jnp.asarray(a).astype(jnp.float32))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


@pytest.fixture(scope="module")
def runs():
    return Runs()


def test_mla_moe_layer_holds_the_experts():
    cfg, tcfg = cfgs(ARCH)
    assert TM._layer_kinds(tcfg) == RM._layer_kinds(cfg) == ["mla_dense", "mla_moe"]
    assert tcfg.moe_cfg.__dict__ == cfg.moe_cfg.__dict__
    assert tcfg.moe_cfg.n_shared == 1
    tp = TM.init_params(torch.Generator().manual_seed(0), tcfg, tget_policy("w4a8"),
                        device="cpu")
    dense, moe = tp["layers"]
    assert "mlp" in dense and "moe" not in dense
    assert "moe" in moe and "mlp" not in moe and "shared" in moe["moe"]
    assert tuple(moe["moe"]["gate"]["w_packed"].shape) == (4, 32, 32)  # (E, d_ff, d_model/2)


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_prefill_chunks_then_decode_steps(paged):
    """A 9-token prompt in chunks of 4 (the last right-padded) into slot 1,
    then a fused and an unfused ``decode_step`` of both slots: caches
    bit-equal after the prefill, logits within LOGIT_ATOL, the same argmax."""
    jp, tp = make_params(ARCH, "w4a8")
    cfg, tcfg = cfgs(ARCH)
    pol, tpol = get_policy("w4a8"), tget_policy("w4a8")
    prompt = np.random.RandomState(5).randint(1, cfg.vocab, size=9).astype(np.int32)
    ps = 16
    bt = np.array([[0, 0], [3, 1]], np.int32)
    if paged:
        jc = RM.init_paged_cache(cfg, pol, B * 2 + 1, ps)
        tc = TM.init_paged_cache(tcfg, tpol, B * 2 + 1, ps, device="cpu")
    else:
        jc = RM.init_cache(cfg, pol, B, S_MAX)
        tc = TM.init_cache(tcfg, tpol, B, S_MAX, device="cpu")
    pos = 0
    for off in range(0, len(prompt), 4):
        n = min(4, len(prompt) - off)
        toks = np.zeros((1, 4), np.int32)
        toks[0, :n] = prompt[off:off + n]
        last = off + n >= len(prompt)
        kw = dict(last_idx=n - 1 if last else None, head=last)
        with jax.disable_jit():
            if paged:
                ref, jc = RM.prefill_into_pages(jp, jnp.asarray(toks), jnp.asarray(bt[1]), pos, jc,
                                                cfg, pol, page_size=ps, impl="jnp", **kw)
            else:
                ref, jc = RM.prefill_into_slot(jp, jnp.asarray(toks), jnp.int32(1), pos, jc,
                                               cfg, pol, impl="jnp", **kw)
        if paged:
            got = TM.prefill_into_pages(tp, torch.from_numpy(toks), torch.from_numpy(bt[1]), pos,
                                        tc, tcfg, tpol, page_size=ps, **kw)
        else:
            got = TM.prefill_into_slot(tp, torch.from_numpy(toks), 1, pos, tc, tcfg, tpol, **kw)
        pos += n
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=LOGIT_ATOL, rtol=0)
    assert _f32(got).argmax() == _f32(ref).argmax()
    mine = bridge.caches_from_reference(jax.tree.map(np.asarray, jc), device="cpu")
    for r, g in zip(mine, tc, strict=True):
        for k in r:
            np.testing.assert_array_equal(_bits(g[k]), _bits(r[k]), err_msg=k)

    toks = np.array([[5], [7]], np.int32)
    pv = np.array([3, pos], np.int32)
    bts = dict(block_tables=jnp.asarray(bt)) if paged else {}
    tbts = dict(block_tables=torch.from_numpy(bt)) if paged else {}
    for fused in (True, False):
        tc_f = [{k: a.clone() for k, a in layer.items()} for layer in tc]
        with jax.disable_jit():
            ref, _ = RM.decode_step(jp, jnp.asarray(toks), jnp.asarray(pv), jc, cfg, pol,
                                    impl="jnp", fused_attn=fused, **bts)
        got = TM.decode_step(tp, torch.from_numpy(toks), torch.from_numpy(pv), tc_f, tcfg, tpol,
                             fused_attn=fused, **tbts)
        np.testing.assert_allclose(_f32(got), _f32(ref), atol=LOGIT_ATOL, rtol=0)
        assert (_f32(got).argmax(-1) == _f32(ref).argmax(-1)).all()


@pytest.mark.parametrize("mode", ["mixed", "spec"])
def test_continuous_and_speculative_streams_equal_reference(runs, mode):
    cache = "slot" if mode == "mixed" else "paged"
    m = assert_streams(runs, ARCH, "w4a8", cache, mode)
    if mode == "mixed":
        assert m["mode"] == "continuous" and m["mixed_steps"] > 0
    else:
        assert m["spec/enabled"] and m["spec/rounds"] > 0
