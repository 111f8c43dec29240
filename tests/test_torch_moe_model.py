"""PyTorch port, reduced granite-moe-1b-a400m (tests/test_torch_moe_serve.py
has its config, stream grid and refusals) on the CPU against the JAX
reference run op by op, on the port's seeded weights carried through the
bridge (tests/_torch_moe_common.py):

  * ``forward(mode="serve")``: logits and the summed MoE aux loss;
    ``prefill_step`` (whole prompts) and the ``decode_step`` after it:
    logits and every cache byte (w4a8: bit-equal; aux within 1e-6
    relative);
  * the continuous (mixed) and speculative (self4) engines' greedy streams
    equal the reference engine's in the same mode;
  * a checkpoint round trip through the reference's files (the (count, E,
    ...) expert leaves of the scan-stacked blocks), both directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_moe_common import Runs, assert_streams, cfgs, make_params  # noqa: E402
from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro.checkpoint import store as RS  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import store as TS  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "granite-moe-1b-a400m"
B, S = 2, 12


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


@pytest.fixture(scope="module")
def w4a8():
    return make_params(ARCH, "w4a8")


def test_forward_serve_logits_and_aux(w4a8):
    """Whole-sequence scoring: logits bit-equal, the aux loss (both MoE
    layers' summed) within 1e-6 relative."""
    jp, tp = w4a8
    cfg, tcfg = cfgs(ARCH)
    toks = np.random.RandomState(17).randint(1, cfg.vocab, size=(B, S)).astype(np.int32)
    with jax.disable_jit():
        ref, aux = RM.forward(jp, {"tokens": jnp.asarray(toks)}, cfg, get_policy("w4a8"),
                              mode="serve", impl="jnp")
    got, taux = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg, tget_policy("w4a8"))
    assert tuple(got.shape) == (B, S, cfg.vocab_padded)
    np.testing.assert_array_equal(_f32(got), _f32(ref))
    r = float(aux["moe_aux"])
    assert r > 0 and abs(float(taux["moe_aux"]) - r) <= 1e-6 * r


def test_prefill_step_then_decode_step(w4a8):
    """``prefill_step`` of two 12-token prompts into a dense kv8 cache, then
    two ``decode_step``s (fused and unfused): logits and every cache byte
    equal the reference's."""
    jp, tp = w4a8
    cfg, tcfg = cfgs(ARCH)
    pol, tpol = get_policy("w4a8"), tget_policy("w4a8")
    toks = np.random.RandomState(18).randint(1, cfg.vocab, size=(B, S)).astype(np.int32)
    jc = RM.init_cache(cfg, pol, B, 32)
    tc = TM.init_cache(tcfg, tpol, B, 32, device="cpu")
    with jax.disable_jit():
        ref, jc = RM.prefill_step(jp, {"tokens": jnp.asarray(toks)}, jc, cfg, pol, impl="jnp")
    got, tc = TM.prefill_step(tp, {"tokens": torch.from_numpy(toks)}, tc, tcfg, tpol)
    np.testing.assert_array_equal(_f32(got), _f32(ref))
    nxt = _f32(got)[:, -1].argmax(-1).astype(np.int32)[:, None]
    pos = np.full(B, S, np.int32)
    for fused in (True, False):
        with jax.disable_jit():
            ref, jc = RM.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc, cfg, pol,
                                     impl="jnp", fused_attn=fused)
        got = TM.decode_step(tp, torch.from_numpy(nxt), torch.from_numpy(pos), tc, tcfg, tpol,
                             fused_attn=fused)
        np.testing.assert_array_equal(_f32(got), _f32(ref))
        nxt, pos = _f32(got)[:, -1].argmax(-1).astype(np.int32)[:, None], pos + 1
    mine = bridge.caches_from_reference(jax.tree.map(np.asarray, jc), device="cpu")
    for r, g in zip(mine, tc, strict=True):
        for k in r:
            np.testing.assert_array_equal(_bits(g[k]), _bits(r[k]), err_msg=k)


@pytest.mark.parametrize("mode", ["mixed", "spec"])
def test_continuous_and_speculative_streams_equal_reference(runs, mode):
    """Each engine mode against the reference's engine in the same mode
    (capacity counts every row a step sees, so a mode's tokens may part
    from a serialized run's; the reference parts the same way)."""
    cache = "slot" if mode == "mixed" else "paged"
    m = assert_streams(runs, ARCH, "w4a8", cache, mode)
    if mode == "mixed":
        assert m["mode"] == "continuous" and m["mixed_steps"] > 0
    else:
        assert m["spec/enabled"] and m["spec/rounds"] > 0


def test_mixed_paper_self_draft_equals_serialized():
    """mixed_paper (experts w2) with the self4 draft: the draft's experts
    are requantized at the ``expert`` class (the reference's walk takes
    them for ffn_in / ffn_out and fails here, ROADMAP Queue 3 item 12), so
    its proposals run and get rejected; the greedy streams equal the port's
    own serialized unfused run (a verify of 2 lanes x 4 rows takes no
    capacity drop at 4 experts top-2)."""
    from tests._torch_moe_common import port_run

    _, tp = make_params(ARCH, "mixed_paper")
    want, _ = port_run(ARCH, tp, "mixed_paper", "paged", fused_attn=False, max_new=8)
    got, m = port_run(ARCH, tp, "mixed_paper", "paged", spec="self4", spec_k=3,
                      max_new=8)
    assert got == want
    assert m["spec/proposed"] > 0 and m["spec/accepted"] < m["spec/proposed"]


def _leaves(tree) -> dict:
    return dict((TS._leaf_key(p), a) for p, a in TS._flatten(tree))


def test_checkpoint_round_trip_of_expert_leaves(tmp_path, w4a8):
    """The port saves its params (``params_to_reference``: the experts'
    (E, ...) leaves stacked into the blocks' (count, E, ...) leaves), the
    reference loads them into its own template; the reference saves its
    params, the port loads them into a meta template and bridges them:
    every leaf bit-equal both ways."""
    jp, tp = w4a8
    cfg, tcfg = cfgs(ARCH)
    pol, tpol = get_policy("w4a8"), tget_policy("w4a8")
    tree = {"params": bridge.params_to_reference(tp, tcfg)}
    TS.save(str(tmp_path / "port"), 2, tree)
    target = {"params": jax.eval_shape(
        lambda: RM.init_params(jax.random.key(0), cfg, pol, mode="serve"))}
    restored, step = RS.load(str(tmp_path / "port"), target)
    assert step == 2
    want = _leaves(tree)
    got = {RS._leaf_key(p): np.asarray(a)
           for p, a in jax.tree_util.tree_flatten_with_path(restored)[0]}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
    assert want["params_blocks_0_moe_gate_w_packed"].shape[:2] == (cfg.n_layers,
                                                                     cfg.n_experts)

    RS.save(str(tmp_path / "ref"), 3, {"params": jp})
    meta = TM.init_params(torch.Generator().manual_seed(0), tcfg, tpol, device="meta")
    loaded, step = TS.load(str(tmp_path / "ref"),
                           {"params": bridge.params_to_reference(meta, tcfg)}, device="cpu")
    assert step == 3
    back = bridge.params_from_reference(loaded["params"], device="cpu")
    mine, theirs = _leaves(back), _leaves(tp)
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(_bits(mine[k]), _bits(theirs[k]), err_msg=k)


