"""What tests/test_torch_spec_engine.py (the identity self-draft, greedy
and seeded) and tests/test_torch_spec_rollback.py (drafts that get
rejected) share: speculative decoding through ``ServeEngine(spec=...)`` on
the CPU, against the JAX reference's spec engine (tests/test_spec.py) and
the port's own non-speculative engine.

Reduced internlm2-1.8b, 2 slots, s_max 32, pages of 4, ``spec_k=3``, four
prompts of 3 to 8 tokens and 6 new tokens each; the weights are the port's
seeded ones, carried to the reference through the bridge; the reference
engine runs op by op (``jax.disable_jit()``), each run once per process.
Tolerance: none. The two files run on two workers under ``--dist
loadfile``: a process's first op-by-op reference run compiles every
primitive it meets (~30 s), its first sampled one the sampler's (~10 s
more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.serve import SamplingParams as RSamplingParams  # noqa: E402
from repro.serve import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import SamplingParams, ServeEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TINY = configs.reduced(configs.get_arch("internlm2-1.8b"))
TTINY = tconfigs.reduced(tconfigs.get_arch("internlm2-1.8b"))
ENGINE = dict(n_slots=2, s_max=32, spec_k=3)
CACHES = ("slot", "paged", "prefix")
TEMPS = (0.0, 0.8)
SPEC_KEYS = ("spec/enabled", "spec/policy", "spec/k", "spec/rounds", "spec/proposed",
             "spec/accepted", "spec/acceptance_rate", "spec/accepted_len_count",
             "spec/accepted_len_p50_s", "spec/accepted_len_p99_s", "cache/truncates",
             "tokens_generated", "decode_steps")


def np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, TINY.vocab, size=rng.randint(3, 9)).astype(np.int32)
            for _ in range(4)]


def sampling(cls, temp, i):
    return cls(temperature=temp, top_k=8, top_p=0.9, seed=17 + i, max_new=6)


class _Params(dict):
    """policy name -> (the reference's params, the port's), drawn at first
    use by the port's seeded ``init_params`` and carried to the reference's
    layout through the bridge (``params_to_reference``)."""

    def __missing__(self, name):
        tp = TM.init_params(torch.Generator().manual_seed(3), TTINY, tget_policy(name),
                            device="cpu")
        jp = jax.tree.map(lambda t: jnp.asarray(bridge.to_numpy(t)),
                          bridge.params_to_reference(tp, TTINY), is_leaf=torch.is_tensor)
        self[name] = jp, tp
        return self[name]


@pytest.fixture(scope="module")
def params():
    return _Params()


REF_RUNS: dict = {}


def reference_run(jp, policy, spec, cache, temp):
    """The reference spec engine's streams and metrics, once per module."""
    key = (policy, spec if isinstance(spec, str) else spec.name, cache, temp)
    if key not in REF_RUNS:
        ps = dict(page_size=4) if cache != "slot" else {}
        eng = RServeEngine(jp, TINY, get_policy(policy), impl="jnp", cache=cache, spec=spec,
                           **ENGINE, **ps)
        with jax.disable_jit():
            hs = [eng.submit(p, sampling(RSamplingParams, temp, i))
                  for i, p in enumerate(prompts())]
            eng.drain()
        REF_RUNS[key] = [h.result() for h in hs], eng.metrics(), eng
    return REF_RUNS[key]


def port_run(tp, policy, spec, cache, temp, cfg=TTINY, **kw):
    ps = dict(page_size=4) if cache != "slot" else {}
    eng = ServeEngine(tp, cfg, tget_policy(policy), cache=cache, spec=spec, device="cpu",
                      **{**ENGINE, **ps, **kw})
    hs = [eng.submit(p, sampling(SamplingParams, temp, i)) for i, p in enumerate(prompts())]
    eng.drain()
    return [h.result() for h in hs], eng.metrics()


BASE_RUNS: dict = {}


def baseline(tp, policy, cache, temp, cfg=TTINY):
    """The port's non-speculative streams (unfused, as a verify reads)."""
    key = (policy, cache, temp, cfg.name)
    if key not in BASE_RUNS:
        BASE_RUNS[key] = port_run(tp, policy, None, cache, temp, cfg=cfg, fused_attn=False)[0]
    return BASE_RUNS[key]


def assert_spec_metrics(m, ref_m):
    for k in SPEC_KEYS:
        assert m[k] == ref_m[k], k
    assert sorted(k for k in m if k.startswith("spec/")) == sorted(
        k for k in ref_m if k.startswith("spec/"))


def check_selfdraft(params, cache, temp):
    """self4 under w4a8 (the identity draft: every proposal accepted, no
    truncate) equals the reference spec engine and the port's
    non-speculative engine; the drafts and the verify read unfused."""
    jp, tp = params["w4a8"]
    want, ref_m, _ = reference_run(jp, "w4a8", "self4", cache, temp)
    got, m = port_run(tp, "w4a8", "self4", cache, temp)
    assert got == want
    assert got == baseline(tp, "w4a8", cache, temp)
    assert_spec_metrics(m, ref_m)
    assert m["spec/acceptance_rate"] == 1.0 and m["cache/truncates"] == 0
    assert m["spec/enabled"] and m["spec/policy"] == "self4" and m["spec/k"] == 3
    assert m["spec/accepted_len_p50_s"] == 4.0 and m["spec/rounds"] > 0
    assert m["kernels/mpmm_calls"] > 0 and m.get("kernels/paged_attn_calls", 0) == 0
    if cache != "slot":
        assert m["kernels/paged_gather_calls"] > 0 and m["kernels/paged_scatter_calls"] > 0
