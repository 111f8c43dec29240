"""What the MoE serving tests share: tests/test_torch_moe_serve.py and
tests/test_torch_moe_model.py (reduced granite-moe-1b-a400m),
tests/test_torch_moe_serve_mla.py and tests/test_torch_moe_mla_steps.py
(reduced DeepSeek-V3: an MLA-dense layer and an ``mla_moe`` layer): the
port's seeded weights carried to the reference through the bridge, one
request set, and the two engines' runs.

Requests: four prompts of 7 to 11 tokens over one shared 6-token head
(so the prefix cache shares pages), three new tokens each, more requests
than slots. Engines: 2 slots, s_max 32, prefill chunks of 4, pages of 4.
The reference engine runs op by op (``jax.disable_jit()``) with
``impl="jnp"``, each run once per process; a process's first op-by-op run
compiles every primitive it meets (~30 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro.serve import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ENGINE = dict(n_slots=2, s_max=32, prefill_chunk=4)
PAGE = 4
#: the stream grid (tests/test_paged.py's and tests/test_prefix.py's cells)
CACHES = ("slot", "paged", "prefix")
POLICIES = ("w4a8", "w4a8kv4", "bf16")
TAILS = (3, 5, 1, 4)
SHARED = 6
MAX_NEW = 3


def cfgs(arch):
    """(reference, port) reduced configs of ``arch``."""
    return (configs.reduced(configs.get_arch(arch)),
            tconfigs.reduced(tconfigs.get_arch(arch)))


def make_params(arch, policy, seed=3):
    """(the reference's params, the port's): drawn by the port's seeded
    ``init_params`` and carried to the reference's layout through the
    bridge."""
    _, tcfg = cfgs(arch)
    tp = TM.init_params(torch.Generator().manual_seed(seed), tcfg, tget_policy(policy),
                        device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(bridge.to_numpy(t)),
                      bridge.params_to_reference(tp, tcfg), is_leaf=torch.is_tensor)
    return jp, tp


def requests(cls, vocab, max_new=MAX_NEW):
    rng = np.random.RandomState(0)
    head = rng.randint(1, vocab, size=SHARED)
    return [cls(rid=i, prompt=np.concatenate([head, rng.randint(1, vocab, size=n)])
                .astype(np.int32), max_new=max_new) for i, n in enumerate(TAILS)]


def _kw(cache, extra):
    return {**ENGINE, **(dict(page_size=PAGE) if cache != "slot" else {}), **extra}


def reference_run(arch, jp, policy, cache, **extra):
    cfg, _ = cfgs(arch)
    eng = RServeEngine(jp, cfg, get_policy(policy), impl="jnp", prefill="chunked", cache=cache,
                       **_kw(cache, extra))
    with jax.disable_jit():
        return eng.run(requests(RRequest, cfg.vocab)), eng.metrics()


def port_run(arch, tp, policy, cache, max_new=MAX_NEW, **extra):
    _, tcfg = cfgs(arch)
    eng = ServeEngine(tp, tcfg, tget_policy(policy), cache=cache, device="cpu",
                      **_kw(cache, extra))
    return eng.run(requests(Request, tcfg.vocab, max_new)), eng.metrics()


class Runs(dict):
    """(arch, policy, cache, mode) -> (reference streams, port streams, the
    port's metrics), each run at first use. Modes: "serial", "mixed"
    (continuous: budget 4, two steps in flight), "spec" (self4, k 3)."""

    MODES = {"serial": {}, "mixed": dict(mixed=True, mixed_budget=4, inflight=2),
             "spec": dict(spec="self4", spec_k=3)}

    def __init__(self):
        super().__init__()
        self.params = {}

    def __missing__(self, key):
        arch, policy, cache, mode = key
        if (arch, policy) not in self.params:
            self.params[arch, policy] = make_params(arch, policy)
        jp, tp = self.params[arch, policy]
        want, _ = reference_run(arch, jp, policy, cache, **self.MODES[mode])
        got, m = port_run(arch, tp, policy, cache, **self.MODES[mode])
        self[key] = want, got, m
        return self[key]


def assert_streams(runs, arch, policy, cache, mode):
    want, got, m = runs[arch, policy, cache, mode]
    assert got == want
    assert sorted(got) == list(range(len(TAILS)))
    assert all(len(t) == MAX_NEW for t in got.values())
    assert ("kernels/mpmm_calls" in m) == (policy != "bf16")
    if cache == "prefix":
        assert m["cache/prefix_hit_rate"] > 0.0
    return m
