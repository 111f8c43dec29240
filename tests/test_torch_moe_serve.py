"""PyTorch port, the moe family served: reduced granite-moe-1b-a400m (two
MoE layers: 4 experts top-2 of width 32, GQA 4 / 2 heads of 16) on the CPU
against the JAX reference run op by op, on the port's seeded weights
carried through the bridge (tests/_torch_moe_common.py).

  * the config mirrors the reference's, at published widths and reduced;
  * the serving engine's greedy streams equal the reference engine's on
    slot, paged and prefix caches under w4a8, w4a8kv4 and bf16;
  * a weight-only expert policy is refused at ``init_params(mode="serve")``
    and at engine construction.

The whole-sequence paths, the continuous and speculative engines and the
checkpoint round trip are in tests/test_torch_moe_model.py (another worker
under ``--dist loadfile``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from tests._torch_moe_common import (  # noqa: E402
    CACHES,
    POLICIES,
    Runs,
    assert_streams,
    cfgs,
    make_params,
)
from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro import configs  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import BF16, LayerPrecision, PrecisionPolicy  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def runs():
    return Runs()


def test_config_mirrors_the_reference():
    for full in (True, False):
        r, t = configs.get_arch(ARCH), tconfigs.get_arch(ARCH)
        if not full:
            r, t = configs.reduced(r), tconfigs.reduced(t)
        rf = dataclasses.asdict(r)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == rf[f.name], (full, f.name)
        assert t.moe_cfg.__dict__ == r.moe_cfg.__dict__
        assert TM._layer_kinds(t) == RM._layer_kinds(r)
    full = tconfigs.get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.kv_heads, full.head_dim) == \
        (24, 1024, 16, 8, 64)
    assert (full.n_experts, full.top_k, full.moe_d_ff, full.vocab_padded) == (32, 8, 512, 49408)
    assert {"moe", "mla_moe"} <= set(TM.PORTED_KINDS)
    for fam in (TM.PREFILL_CHUNKABLE_FAMILIES, TM.PAGEABLE_FAMILIES):
        assert "moe" in fam and "mla_moe" in fam


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("policy", POLICIES)
def test_greedy_streams_equal_reference(runs, policy, cache):
    m = assert_streams(runs, ARCH, policy, cache, "serial")
    if policy != "bf16":
        assert m["kernels/mpmm_calls"] > 0


def test_weight_only_experts_refused_at_construction():
    """Experts quantized weight-only (bf16 activations; the reference
    serves them through a vmapped wdqmm) are refused before any weight is
    drawn and before any step runs; a policy whose experts stay bf16 or are
    fully quantized is served."""
    _, tcfg = cfgs(ARCH)
    wo = PrecisionPolicy(name="experts_w4only", default=LayerPrecision(8, 4, 8),
                         per_class={"router": BF16, "expert": LayerPrecision(None, 4, None)},
                         kv_cache_bits=8)
    with pytest.raises(NotImplementedError, match="weight-only"):
        TM.init_params(torch.Generator(), tcfg, wo, device="cpu")
    with pytest.raises(NotImplementedError, match="weight-only"):
        ServeEngine(make_params(ARCH, "w4a8")[1], tcfg, wo, n_slots=2, s_max=32, device="cpu")
    # a dense config under the same policy has no experts to refuse
    dense = tconfigs.reduced(tconfigs.get_arch("internlm2-1.8b"))
    TM.check_policy(dense, wo)
    TM.check_policy(tcfg, tget_policy("mixed_paper"))
