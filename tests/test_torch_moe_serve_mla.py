"""PyTorch port, DeepSeek-V3's expert layers served: the reduced config
(an MLA-dense layer, then an ``mla_moe`` layer: 4 experts top-2 of width
32 and a shared expert, MTP params carried) on the CPU against the JAX
reference run op by op, on the port's seeded weights carried through the
bridge (tests/_torch_moe_common.py): the serving engine's greedy streams
equal the reference engine's on slot, paged and prefix caches under w4a8,
w4a8kv4 and bf16. The layer's steps and the continuous and speculative
engines are in tests/test_torch_moe_mla_steps.py (another worker under
``--dist loadfile``).
"""

import pytest

torch = pytest.importorskip("torch")

from tests._torch_moe_common import CACHES, POLICIES, Runs, assert_streams  # noqa: E402
from tests._torch_threads import one_torch_thread  # noqa: E402, F401

ARCH = "deepseek-v3-671b"


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("policy", POLICIES)
def test_greedy_streams_equal_reference(runs, policy, cache):
    m = assert_streams(runs, ARCH, policy, cache, "serial")
    assert m["kernels/paged_mla_attn_calls"] > 0
