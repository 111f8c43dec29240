"""PyTorch port, the dense variants served: greedy streams of the reduced
``h2o-danube-1.8b``, ``qwen1.5-4b`` and ``stablelm-3b`` (w4a8, 8-bit KV,
norms and biases redrawn as in tests/test_torch_dense_variants.py) on the
port's serialized ``ServeEngine``, slot and paged cache, equal to the
reference engine's run op by op (``jax.disable_jit()``) on the same
weights; prompts of 9 to 14 tokens (longer than danube's reduced window of
8), more requests than slots. Then a checkpoint round trip of the leaves
the variants add: stablelm's LayerNorm biases and qwen's q/k/v biases,
saved by the port and loaded by the reference, and the other way, every
leaf bit-equal.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401
from tests.test_torch_dense_variants import ARCHS, POLICY, TPOLICY, ref_params  # noqa: E402

from repro.checkpoint import store as RS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro.serve import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import store as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LENGTHS = (11, 9, 14, 10)
ENGINE = dict(n_slots=2, s_max=32, prefill_chunk=4)


def _requests(cls, vocab):
    rng = np.random.RandomState(1)
    return [cls(rid=i, prompt=rng.randint(1, vocab, size=n).astype(np.int32), max_new=6)
            for i, n in enumerate(LENGTHS)]


@pytest.fixture(scope="module", params=ARCHS)
def variant(request):
    return (request.param, *ref_params(request.param, seed=4))


@pytest.mark.parametrize("cache", ["slot", "paged"])
def test_greedy_streams_equal_reference(variant, cache):
    _, cfg, tcfg, jp, tp = variant
    ps = dict(page_size=16) if cache == "paged" else {}
    ref = RServeEngine(jp, cfg, POLICY, impl="jnp", prefill="chunked", cache=cache, **ENGINE,
                       **ps)
    with jax.disable_jit():
        want = ref.run(_requests(RRequest, cfg.vocab))
    port = ServeEngine(tp, tcfg, TPOLICY, cache=cache, device="cpu", **ENGINE, **ps)
    got = port.run(_requests(Request, tcfg.vocab))
    assert got == want
    assert sorted(got) == list(range(len(LENGTHS))) and all(len(v) == 6 for v in got.values())


def _leaves(tree) -> dict:
    return dict((TS._leaf_key(p), a) for p, a in TS._flatten(tree))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("name", ["stablelm-3b", "qwen1.5-4b"])
def test_checkpoint_round_trip_of_norm_and_qkv_biases(tmp_path, name):
    """The port saves its params (``params_to_reference``), the reference
    loads them into its own template; the reference saves its params, the
    port loads them into a meta template and bridges them: every leaf
    bit-equal both ways, the variant's bias leaves among them."""
    cfg, tcfg, jp, tp = ref_params(name, seed=6)
    tree = {"params": bridge.params_to_reference(tp, tcfg)}
    TS.save(str(tmp_path / "port"), 2, tree)
    target = {"params": jax.eval_shape(
        lambda: RM.init_params(jax.random.key(0), cfg, POLICY, mode="serve"))}
    restored, step = RS.load(str(tmp_path / "port"), target)
    assert step == 2
    want = _leaves(tree)
    got = {RS._leaf_key(p): np.asarray(a)
           for p, a in jax.tree_util.tree_flatten_with_path(restored)[0]}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
    bias_keys = ({"params_blocks_0_norm1_bias", "params_final_norm_bias"} if name == "stablelm-3b"
                 else {f"params_blocks_0_attn_{w}_b" for w in ("wq", "wk", "wv")})
    assert bias_keys <= set(want)

    RS.save(str(tmp_path / "ref"), 3, {"params": jp})
    meta = TM.init_params(torch.Generator().manual_seed(0), tcfg, TPOLICY, device="meta")
    loaded, step = TS.load(str(tmp_path / "ref"),
                           {"params": bridge.params_to_reference(meta, tcfg)}, device="cpu")
    assert step == 3
    back = bridge.params_from_reference(loaded["params"], device="cpu")
    mine, theirs = _leaves(back), _leaves(tp)
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(_bits(mine[k]), _bits(theirs[k]), err_msg=k)
