"""PyTorch port, rotary tables past position 4096, against the JAX reference
on the CPU (internlm2's rope: head_dim 128, theta 1e4).

The port computes the same program as the reference (``1 / theta ** (i /
half)``, ``pos * inv``, cos, sin in f32), but PyTorch's and XLA's CPU sin and
cos differ by an ulp on some arguments, and larger positions mean larger
arguments. After the bf16 cast that ``apply_rope`` makes, the tables over
positions 0..8191 differ in ``ROPE_BF16_DIFFS`` of 1,048,576 entries, the
first at position 4038 (ROADMAP Queue 3 item 5), each by one bf16 step. The
reference runs op by op (``jax.disable_jit()``): jitted, XLA also computes
some inverse frequencies an ulp away, which the port does not imitate.

The port's tables are built in blocks of ``BLOCK`` positions, the size of
what the model asks for (one position per slot in decode, a chunk in
prefill): PyTorch splits a larger CPU ``cos`` over threads, and in some
processes the first such call computes one thread's share an f32 ulp away.

The second test measures what the differing entries do to a decode step:
one teacher-forced step of ``reduced(internlm2)`` at head_dim 128 from the
same seeded 4160-row caches (carried across by the bridge), unfused (the
attention path does not change how rope is applied). Below position 4038
the logits are bit-identical; at the positions whose rows differ they stay
within ``LOGIT_ATOL`` and the argmax agrees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro import configs  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

HEAD_DIM, THETA, N_POS = 128, 1e4, 8192
#: bf16 table entries (cos and sin, positions 0..8191, 64 frequencies) on
#: which the port and the op-by-op reference differ, as measured: freq 26's
#: sin at 4038 and one cos entry at 5819
ROPE_BF16_DIFFS = 2
FIRST_DIFF_POS = 4038
BLOCK = 256
#: largest |logit difference| of a decode step whose rotary rows differ by a
#: bf16 step: the changed attention output can flip an 8-bit activation code
#: downstream, which moves a logit by a fraction of one (logits reach ~5);
#: the same mechanism as tests/test_torch_model.py's JIT_LOGIT_ATOL
LOGIT_ATOL = 1.0
S_MAX = 4160


def _tables():
    pos = np.arange(N_POS, dtype=np.int32)[None]
    with jax.disable_jit():
        rc, rs = RA.rope_cos_sin(jnp.asarray(pos), HEAD_DIM, THETA)
        ref = [np.asarray(a.astype(jnp.bfloat16)).view(np.uint16)[0] for a in (rc, rs)]
    blocks = [TA.rope_cos_sin(torch.from_numpy(pos[:, i:i + BLOCK]), HEAD_DIM, THETA)
              for i in range(0, N_POS, BLOCK)]
    got = [bridge.to_numpy(torch.cat([b[j] for b in blocks], 1).to(torch.bfloat16))
           .view(np.uint16)[0] for j in (0, 1)]
    return ref, got


def _differing_positions():
    ref, got = _tables()
    return np.nonzero(np.any([r != g for r, g in zip(ref, got)], axis=(0, 2)))[0]


def test_rope_tables_bf16_against_reference():
    ref, got = _tables()
    diff = [r != g for r, g in zip(ref, got)]
    n = int(sum(d.sum() for d in diff))
    assert 0 < n <= ROPE_BF16_DIFFS
    rows = np.nonzero(np.any(diff, axis=(0, 2)))[0]
    assert rows[0] == FIRST_DIFF_POS
    for r, g, d in zip(ref, got, diff):
        # one bf16 step: adjacent bit patterns (no sign flips at these values)
        assert np.abs(r[d].astype(np.int32) - g[d].astype(np.int32)).max() == 1


def _fill(tree, rng):
    """Seeded cache contents: int8 K/V codes and small positive scales."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return rng.randint(-127, 128, size=a.shape).astype(np.int8)
        return (rng.rand(*a.shape) * 0.02 + 1e-3).astype(a.dtype)
    return jax.tree.map(leaf, tree)


def test_decode_step_past_4096_against_reference():
    rcfg = dataclasses.replace(configs.reduced(configs.get_arch("internlm2-1.8b")),
                               head_dim=HEAD_DIM)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch("internlm2-1.8b")),
                               head_dim=HEAD_DIM)
    assert rcfg.rope_theta == tcfg.rope_theta == THETA
    pol, tpol = get_policy("w4a8"), tget_policy("w4a8")
    jp = RM.init_params(jax.random.key(3), rcfg, pol, mode="serve")
    tp = bridge.params_from_reference(jax.tree.map(lambda x: np.array(x, copy=True), jp),
                                      device="cpu")
    rng = np.random.RandomState(0)
    init = _fill(jax.tree.map(lambda x: np.array(x, copy=True), RM.init_cache(rcfg, pol, 2, S_MAX)),
                 rng)
    toks = rng.randint(1, rcfg.vocab, size=(2, 1)).astype(np.int32)
    differ = _differing_positions()
    assert differ.max() > 4096
    for pos, same in (([100, FIRST_DIFF_POS - 1], True), ([differ[0], differ.max()], False)):
        pv = np.asarray(pos, np.int32)
        with jax.disable_jit():
            ref, _ = RM.decode_step(jp, jnp.asarray(toks), jnp.asarray(pv),
                                    jax.tree.map(jnp.array, init), rcfg, pol, impl="jnp")
        got = TM.decode_step(tp, torch.from_numpy(toks), torch.from_numpy(pv),
                             bridge.caches_from_reference(init, device="cpu"), tcfg, tpol)
        r = np.asarray(ref.astype(jnp.float32))[:, -1]
        g = got.float().numpy()[:, -1]
        if same:
            np.testing.assert_array_equal(g, r)
        else:
            assert np.abs(g - r).max() <= LOGIT_ATOL, (pos, np.abs(g - r).max())
            np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1))
