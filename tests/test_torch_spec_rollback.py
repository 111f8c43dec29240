"""PyTorch port, speculative decoding through ``ServeEngine(spec=...)`` on
the CPU, drafts that get rejected: ``mixed_paper``'s 8-bit ``attn_out``
and head requantize lossily (acceptance < 1, truncates > 0);
``DraftModel`` with the reference's draft weights through the bridge;
streams, ``spec/`` metrics and ``cache/truncates`` equal the reference's
spec engine (tests/test_spec.py), the reference run op by op. Then reduced
DeepSeek-V3 (its MLA-dense layers) on paged, a DraftModel's release, and
the reference's rollback churn property against the port's
non-speculative engine. The identity self-draft is
tests/test_torch_spec_engine.py; the set-up, tests/_torch_spec_common.py.
Tolerance: none.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro.serve import DraftModel as RDraftModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import DraftModel, SamplingParams, ServeEngine  # noqa: E402

from tests._hypothesis_compat import given, settings, st  # noqa: E402
from tests._torch_spec_common import (  # noqa: E402, F401
    ENGINE,
    TEMPS,
    TINY,
    TTINY,
    assert_spec_metrics,
    baseline,
    np_tree,
    params,
    port_run,
    prompts,
    reference_run,
)


def test_lossy_selfdraft_truncates_and_equals_reference(params):  # noqa: F811
    """mixed_paper's 8-bit layers requantized to 4 bits draft other tokens:
    rounds roll back through truncate, the streams stay the serialized
    ones; greedy against the reference, seeded against the port's own."""
    jp, tp = params["mixed_paper"]
    want, ref_m, _ = reference_run(jp, "mixed_paper", "self4", "paged", 0.0)
    got, m = port_run(tp, "mixed_paper", "self4", "paged", 0.0)
    assert got == want == baseline(tp, "mixed_paper", "paged", 0.0)
    assert_spec_metrics(m, ref_m)
    assert 0.0 < m["spec/acceptance_rate"] < 1.0 and m["cache/truncates"] > 0
    for cache in ("slot", "prefix"):
        got, m = port_run(tp, "mixed_paper", "self4", cache, 0.8)
        assert got == baseline(tp, "mixed_paper", cache, 0.8)
        assert m["cache/truncates"] > 0


def test_draftmodel_with_reference_weights_equals_reference(params):  # noqa: F811
    """DraftModel with the reference's default draft weights (its reduced
    config at the target's vocab, ``jax.random.key(1)``) through the
    bridge: streams, acceptance and truncates equal the reference's; the
    port's own seeded draft moves only the acceptance."""
    jp, tp = params["w4a8"]
    want, ref_m, ref_eng = reference_run(jp, "w4a8", RDraftModel(), "paged", 0.0)
    dcfg = dataclasses.replace(tconfigs.reduced(TTINY), vocab=TTINY.vocab)
    dparams = bridge.params_from_reference(np_tree(ref_eng.spec.params), device="cpu")
    got, m = port_run(tp, "w4a8", DraftModel(cfg=dcfg, params=dparams), "paged", 0.0)
    assert got == want == baseline(tp, "w4a8", "paged", 0.0)
    assert_spec_metrics(m, ref_m)
    assert m["spec/policy"] == "draft" and m["cache/truncates"] > 0
    for temp in TEMPS:
        got, m = port_run(tp, "w4a8", "draft", "paged", temp)
        assert got == baseline(tp, "w4a8", "paged", temp)
        assert m["spec/rounds"] > 0


def test_draftmodel_releases_its_rows():
    """A DraftModel slot is zeroed through the cache's reset path when its
    request leaves, and its position rewinds."""
    tp = TM.init_params(torch.Generator().manual_seed(3), TTINY, tget_policy("w4a8"),
                        device="cpu")
    eng = ServeEngine(tp, TTINY, tget_policy("w4a8"), spec="draft", device="cpu", **ENGINE)
    h = eng.submit(prompts()[1], SamplingParams(max_new=8))
    eng.step()
    assert eng.spec.pos[0] > 0 and any(bool(a[0].any()) for lay in eng.spec.caches
                                       for a in lay.values())
    eng.drain()
    assert h.status == "done" and eng.spec.pos[0] == 0
    assert not any(bool(a.any()) for lay in eng.spec.caches for a in lay.values())


def test_deepseek_selfdraft_paged_equals_serialized():
    """Reduced DeepSeek-V3 (its MLA-dense layers; the port's own seeded
    weights) on paged, greedy and seeded: the streams equal the port's
    non-speculative ones; every round verifies through the latent cache."""
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch("deepseek-v3-671b")),
                              dense_layers=2)
    tp = TM.init_params(torch.Generator().manual_seed(3), cfg, tget_policy("w4a8"), device="cpu")
    for temp in TEMPS:
        got, m = port_run(tp, "w4a8", "self4", "paged", temp, cfg=cfg)
        assert got == baseline(tp, "w4a8", "paged", temp, cfg=cfg)
        assert m["spec/rounds"] > 0 and m["spec/acceptance_rate"] == 1.0
        assert m["kernels/paged_gather_calls"] > 0 and "kernels/paged_mla_attn_calls" not in m


# ------------------------------------------------ rollback churn (tests/test_spec.py)


_CHURN: dict = {}


@pytest.mark.parametrize("cache", ["paged", "prefix"])
@settings(max_examples=2, deadline=None)
@given(data=st.data())
def test_spec_churn_conserves_pool(params, cache, data):  # noqa: F811
    """Lossy drafts (mixed_paper) with a cancel mid-speculation: the pool is
    conserved after every step and every cancel, and the survivors equal
    the port's non-speculative engine."""
    tp = params["mixed_paper"][1]
    spec_k = data.draw(st.integers(2, 3), label="spec_k")
    rng = np.random.RandomState(data.draw(st.integers(0, 3), label="seed"))
    shared = rng.randint(1, TINY.vocab, size=8).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(1, TINY.vocab, size=2 + i)]).astype(np.int32)
               for i in range(4)]
    cancel = {data.draw(st.integers(0, 3), label="victim"):
              data.draw(st.integers(1, 3), label="after")}

    def engine(spec):
        return ServeEngine(tp, TTINY, tget_policy("mixed_paper"), n_slots=2, s_max=32,
                           cache=cache, page_size=4, spec=spec, spec_k=spec_k,
                           fused_attn=False, device="cpu")

    eng = engine("self4")
    handles = {i: eng.submit(p, SamplingParams(max_new=6)) for i, p in enumerate(prompts)}
    cancelled = set()
    while True:
        more = eng.step()
        eng.cache.check_conserved()
        for rid, after in cancel.items():
            h = handles[rid]
            # a round retires up to k+1 tokens at once: the victim may finish first
            if rid not in cancelled and not h.done and len(h.request.out or []) >= after:
                h.cancel()
                cancelled.add(rid)
                eng.cache.check_conserved()
        if not more:
            break
    key = (cache, tuple(map(len, prompts)), int(shared[0]))
    if key not in _CHURN:
        base = engine(None)
        bh = {i: base.submit(p, SamplingParams(max_new=6)) for i, p in enumerate(prompts)}
        base.drain()
        _CHURN[key] = {i: h.result() for i, h in bh.items()}
    for rid, h in handles.items():
        if rid in cancelled:
            assert h.status == "cancelled"
        else:
            assert h.status == "done" and h.request.out == _CHURN[key][rid]
    eng.cache.check_conserved()
