"""PyTorch port, checkpoints of the MLA slice: DeepSeek-V3 cut to two dense
MLA layers, with its MTP params, saved by the JAX reference in serve mode
and loaded by the port. Every leaf is bit-equal to the bridge's crossing of
the same tree, the bridge's stacked layout inverts its per-layer one, and
greedy streams served from disk equal the reference engine's (op by op) on
the slot and the paged cache. The helpers and the internlm2 cases are in
tests/test_torch_checkpoint.py; this file runs on its own worker under
``--dist loadfile``, since the reference engine's first run on a
configuration compiles every primitive (~30 s).
"""

import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from test_torch_checkpoint import (  # noqa: E402
    ARCHS,
    _numpy,
    _port_leaves,
    _ref_leaves,
    assert_bit_equal,
    check_port_loads_bit_equal,
    check_streams,
    ref_checkpoint,
)

from repro_torch import bridge  # noqa: E402


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    return ref_checkpoint("deepseek", tmp_path_factory)


def test_port_loads_reference_checkpoint_bit_equal(ref_ckpt):
    check_port_loads_bit_equal(ref_ckpt)


def test_params_to_reference_inverts_params_from_reference(ref_ckpt):
    tcfg = ARCHS["deepseek"][1]
    jp = _numpy(ref_ckpt[2])
    tp = bridge.params_from_reference(jp, device="cpu")
    assert len(tp["layers"]) == tcfg.n_layers and "mtp_block" in tp
    back = bridge.params_to_reference(tp, tcfg)
    assert_bit_equal(_port_leaves(back), _ref_leaves(jp))
    # tensor leaves cross without numpy: the same per-layer tree
    assert_bit_equal(_port_leaves(bridge.params_from_reference(back, device="cpu")),
                     _port_leaves(tp))


@pytest.mark.parametrize("cache", ["slot", "paged"])
def test_streams_served_from_reference_checkpoint(ref_ckpt, cache):
    check_streams(ref_ckpt, cache)
