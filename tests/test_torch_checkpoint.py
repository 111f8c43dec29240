"""PyTorch port, checkpoints: ``repro_torch.checkpoint.store``, the bridge's
checkpoint layout (``params_to_reference``), train-mode ``init_params`` and
``convert_model_to_serving``, against the JAX reference on the CPU.

The port writes and reads the reference's files, so a checkpoint saved by
either package loads in the other with every leaf bit-equal (compared as
bytes, dtypes equal). Key sets, leaf shapes and dtypes of the port's
templates equal the reference's ``init_params`` in both modes (reduced
internlm2-1.8b; DeepSeek-V3 cut to two dense MLA layers, with MTP), and the
manifest and on-disk arrays of a tree equal what the reference writes for
it. Served from disk, greedy token streams equal the reference engine's on
the same weights: internlm2 (slot and paged) and DeepSeek-V3 (slot and
paged) under w4a8 with an 8-bit KV cache, with tests/test_torch_serve.py's
requests and engine settings, and a JAX train state whose params the port
reads and converts. The reference engine runs op by op
(``jax.disable_jit()``), as in tests/test_torch_serve.py; its first run on a
configuration compiles every primitive (~30 s), so DeepSeek-V3's checkpoint
is served in tests/test_torch_checkpoint_mla.py, which pytest-xdist's
``--dist loadfile`` runs on another worker.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro import configs  # noqa: E402
from repro.checkpoint import store as RS  # noqa: E402
from repro.core.linear import convert_model_to_serving as rconvert  # noqa: E402
from repro.core.policy import get_policy  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import Request as RRequest  # noqa: E402
from repro.serve import ServeEngine as RServeEngine  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import store as TS  # noqa: E402
from repro_torch.core import linear as TL  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
ARCHS = {
    "internlm2": (configs.reduced(configs.get_arch("internlm2-1.8b")),
                  tconfigs.reduced(tconfigs.get_arch("internlm2-1.8b"))),
    "deepseek": (dataclasses.replace(configs.reduced(configs.get_arch("deepseek-v3-671b")),
                                     dense_layers=2),
                 dataclasses.replace(tconfigs.reduced(tconfigs.get_arch("deepseek-v3-671b")),
                                     dense_layers=2)),
}
POLICY = get_policy("w4a8")
TPOLICY = tget_policy("w4a8")
LENGTHS = (3, 9, 5, 2, 7)  # tests/test_torch_serve.py
ENGINE = dict(n_slots=2, s_max=32, prefill_chunk=4)


def _requests(cls, vocab):
    rng = np.random.RandomState(0)
    return [cls(rid=i, prompt=rng.randint(1, vocab, size=n).astype(np.int32), max_new=4)
            for i, n in enumerate(LENGTHS)]


def _ref_leaves(tree) -> dict:
    """{reference key: numpy leaf} of a JAX tree."""
    return {RS._leaf_key(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    """{port key: leaf} of a port tree."""
    return dict((TS._leaf_key(p), a) for p, a in TS._flatten(tree))


def _bits(a) -> np.ndarray:
    """A leaf's bytes (tensor or numpy; bf16 included) as uint8."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        return a.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _dtype_name(a) -> str:
    return str(a.dtype).removeprefix("torch.")


def assert_bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert _dtype_name(got[k]) == _dtype_name(want[k]), k
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


def _template(arch: str, mode: str) -> dict:
    """The port's meta-device params in the reference's layout."""
    tcfg = ARCHS[arch][1]
    meta = TM.init_params(torch.Generator().manual_seed(0), tcfg, TPOLICY, mode=mode,
                          device="meta")
    return bridge.params_to_reference(meta, tcfg)


def _ref_init(arch: str, seed: int, mode: str) -> dict:
    """The reference's ``init_params``, jitted (op by op it takes ~10 s)."""
    cfg = ARCHS[arch][0]
    return jax.jit(lambda k: RM.init_params(k, cfg, POLICY, mode=mode))(jax.random.key(seed))


def _numpy(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


# ------------------------------------------------------------- layout parity


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mode", ["serve", "train"])
def test_template_keys_shapes_dtypes_match_reference(arch, mode):
    """Leaf by leaf, before any round trip is trusted: ``load`` casts to
    the template's dtype, which would hide a dtype drift."""
    cfg = ARCHS[arch][0]
    ref = jax.eval_shape(lambda: RM.init_params(jax.random.key(0), cfg, POLICY, mode=mode))
    want = {RS._leaf_key(p): (tuple(a.shape), str(a.dtype))
            for p, a in jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = {k: (tuple(a.shape), _dtype_name(a))
           for k, a in _port_leaves(_template(arch, mode)).items()}
    assert got == want
    if arch == "deepseek":
        assert any(k.startswith("mtp_block_") for k in got) and "mtp_norm_scale" in got


def test_train_state_keys_match_reference():
    """The port's keys over a JAX train state ``{"params", "opt"}`` are the
    reference's ``_leaf_key``s."""
    cfg = ARCHS["deepseek"][0]

    def state():
        params = RM.init_params(jax.random.key(1), cfg, POLICY, mode="train")
        return {"params": params, "opt": ropt.adamw_init(params)}

    shapes = jax.eval_shape(state)
    want = [RS._leaf_key(p) for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert [TS._leaf_key(p) for p, _ in TS._flatten(shapes)] == want  # the same order too
    assert "opt_step" in want and "opt_m_blocks_0_attn_wq_a_w" in want


# ------------------------------------------ reference saves, the port loads
# (DeepSeek-V3's run in tests/test_torch_checkpoint_mla.py, on its own worker)


def ref_checkpoint(arch: str, tmp_path_factory) -> tuple:
    """A serve-mode checkpoint the reference saved: (arch, root, its tree)."""
    jp = _ref_init(arch, 3, "serve")
    root = str(tmp_path_factory.mktemp(f"ref_{arch}"))
    RS.save(root, 4, jp)
    return arch, root, jp


def _load_port_params(arch, root, mode="serve"):
    loaded, step = TS.load(root, _template(arch, mode), device="cpu")
    return bridge.params_from_reference(loaded, device="cpu"), step


def check_port_loads_bit_equal(ckpt):
    """Every leaf the port loads equals ``params_from_reference`` of the
    tree the reference saved."""
    arch, root, jp = ckpt
    tp, step = _load_port_params(arch, root)
    assert step == 4
    assert_bit_equal(_port_leaves(tp),
                     _port_leaves(bridge.params_from_reference(_numpy(jp), device="cpu")))


def check_streams(ckpt, cache):
    """Greedy streams served from the loaded checkpoint equal the reference
    engine's on the tree it saved."""
    arch, root, jp = ckpt
    cfg, tcfg = ARCHS[arch]
    tp, _ = _load_port_params(arch, root)
    ps = dict(page_size=16) if cache == "paged" else {}
    ref = RServeEngine(jp, cfg, POLICY, impl="jnp", prefill="chunked", cache=cache,
                       **ENGINE, **ps)
    with jax.disable_jit():
        want = ref.run(_requests(RRequest, cfg.vocab))
    port = ServeEngine(tp, tcfg, TPOLICY, cache=cache, device="cpu", **ENGINE, **ps)
    got = port.run(_requests(Request, tcfg.vocab))
    assert got == want
    assert all(len(v) == 4 for v in got.values())


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    return ref_checkpoint("internlm2", tmp_path_factory)


def test_port_loads_reference_checkpoint_bit_equal(ref_ckpt):
    check_port_loads_bit_equal(ref_ckpt)


@pytest.mark.parametrize("cache", ["slot", "paged"])
def test_streams_served_from_reference_checkpoint(ref_ckpt, cache):
    check_streams(ref_ckpt, cache)


# ------------------------------------------ the port saves, the reference loads


@pytest.mark.parametrize("arch,mode", [("internlm2", "serve"), ("internlm2", "train"),
                                       ("deepseek", "serve")])
def test_reference_loads_port_checkpoint(tmp_path, arch, mode):
    """Same keys, on-disk dtypes and shapes, manifest and bytes as the
    reference writes for the same tree; the reference's ``load`` restores
    every leaf bit-equal."""
    cfg, tcfg = ARCHS[arch]
    tp = TM.init_params(torch.Generator().manual_seed(5), tcfg, TPOLICY, mode=mode,
                        device="cpu")
    tree = {"params": bridge.params_to_reference(tp, tcfg)}
    TS.save(str(tmp_path / "port"), 6, tree)
    RS.save(str(tmp_path / "ref"), 6, jax.tree.map(bridge.to_numpy, tree))
    files = {}
    for who in ("port", "ref"):
        d = tmp_path / who / "step_6"
        assert sorted(os.listdir(d)) == ["arrays_proc0.npz", "manifest.json"]
        with np.load(d / "arrays_proc0.npz") as z:
            files[who] = (json.loads((d / "manifest.json").read_text()),
                          {k: z[k] for k in z.files})
    assert files["port"][0] == files["ref"][0]
    assert_bit_equal(files["port"][1], files["ref"][1])
    if mode == "serve":
        assert files["port"][0]["leaves"]["params_embed_table"]["dtype"] == "bfloat16"
        assert files["port"][1]["params_embed_table"].dtype == np.uint16

    target = {"params": jax.eval_shape(
        lambda: RM.init_params(jax.random.key(0), cfg, POLICY, mode=mode))}
    restored, step = RS.load(str(tmp_path / "port"), target)
    assert step == 6
    assert_bit_equal(_ref_leaves(restored), _port_leaves(tree))


def test_bit_views_cross_both_ways(tmp_path):
    """Every dtype rule of the store: plain numpy dtypes as they are, bf16
    and float8 as bit views under their logical names, 0-d leaves, tuples."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 5, generator=g)
    tree = {"bf16": x.to(torch.bfloat16), "f8": x.to(torch.float8_e4m3fn),
            "f16": x.to(torch.float16), "f32": x, "i8": (x * 40).to(torch.int8),
            "u8": (x.abs() * 40).to(torch.uint8), "b": x > 0,
            "i32": torch.arange(4, dtype=torch.int32),
            "scalar": torch.tensor(2.5), "pair": (torch.ones(2, dtype=torch.int32),
                                                  torch.zeros(1, dtype=torch.bfloat16))}
    TS.save(str(tmp_path / "p"), 1, tree)
    manifest = json.loads((tmp_path / "p" / "step_1" / "manifest.json").read_text())
    assert manifest["leaves"]["f8"]["dtype"] == "float8_e4m3fn"
    assert manifest["leaves"]["pair_1"]["dtype"] == "bfloat16"
    np_tree = jax.tree.map(bridge.to_numpy, {k: v for k, v in tree.items() if k != "f8"})
    np_tree["f8"] = tree["f8"].view(torch.uint8).numpy().view(jnp.float8_e4m3fn)
    restored, _ = RS.load(str(tmp_path / "p"), jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), np_tree))
    assert_bit_equal(_ref_leaves(restored), _port_leaves(tree))

    RS.save(str(tmp_path / "r"), 2, np_tree)
    back, step = TS.load(str(tmp_path / "r"), tree, device="cpu")
    assert step == 2 and isinstance(back["pair"], tuple)
    assert_bit_equal(_port_leaves(back), _port_leaves(tree))
    # numpy (and JAX shape) targets work too: only .shape and .dtype are read
    back_np, _ = TS.load(str(tmp_path / "r"), np_tree, device="cpu")
    assert_bit_equal(_port_leaves(back_np), _port_leaves(tree))


# -------------------------------------------- a JAX train state, converted


@pytest.fixture(scope="module")
def train_state_ckpt(tmp_path_factory):
    """A reference train state ``{"params", "opt"}`` (QAT params in bf16,
    AdamW moments in f32) saved by the reference."""
    params = _ref_init("internlm2", 5, "train")
    state = {"params": params, "opt": ropt.adamw_init(params)}
    root = str(tmp_path_factory.mktemp("train_state"))
    RS.save(root, 9, state)
    return root, params


def test_convert_model_to_serving_matches_reference(train_state_ckpt):
    root, jparams = train_state_ckpt
    tcfg = ARCHS["internlm2"][1]
    loaded, step = TS.load(root, {"params": _template("internlm2", "train")}, device="cpu")
    assert step == 9
    assert_bit_equal(_port_leaves(loaded["params"]), _ref_leaves(jparams))
    want = _ref_leaves(rconvert(jparams, POLICY))
    assert any(k.endswith("w_packed") for k in want)
    assert not [k for k in want if k.endswith("_w") and not k.endswith("eps_w")]
    # the per-layer tree, converted layer by layer ...
    tp = bridge.params_from_reference(loaded["params"], device="cpu")
    got = TL.convert_model_to_serving(tp, TPOLICY)
    assert_bit_equal(_port_leaves(bridge.params_to_reference(got, tcfg)), want)
    # ... and the stacked tree, converted over its leading layer axis
    assert_bit_equal(_port_leaves(TL.convert_model_to_serving(loaded["params"], TPOLICY)),
                     want)


def test_convert_stacked_equals_each_matrix():
    """A ``w`` with leading axes (stacked layers, experts) converts matrix
    by matrix; ``b`` and ``beta`` are kept, unquantized layers untouched."""
    lp = TPOLICY.of("ffn_in")
    g = torch.Generator().manual_seed(8)
    w = torch.randn(2, 3, 16, 32, generator=g).to(torch.bfloat16)
    tree = {"up": {"w": w, "beta": torch.full((2, 3), 6.0), "b": torch.zeros(2, 3, 16)},
            "router": {"w": w[0, 0]}}
    out = TL.convert_model_to_serving(tree, TPOLICY)
    assert out["up"]["w_packed"].shape == (2, 3, 16, 32 // 2)
    assert out["up"]["eps_w"].shape == (2, 3)
    for i in range(2):
        for j in range(3):
            one = TL.convert_linear_to_serving({"w": w[i, j]}, lp)
            assert torch.equal(out["up"]["w_packed"][i, j], one["w_packed"])
            assert torch.equal(out["up"]["eps_w"][i, j], one["eps_w"])
    assert out["up"]["beta"] is tree["up"]["beta"] and out["up"]["b"] is tree["up"]["b"]
    assert out["router"] is tree["router"]  # routers stay bf16 under every preset


def test_streams_served_from_converted_train_state(train_state_ckpt):
    root, jparams = train_state_ckpt
    cfg, tcfg = ARCHS["internlm2"]
    loaded, _ = TS.load(root, {"params": _template("internlm2", "train")}, device="cpu")
    tp = TL.convert_model_to_serving(
        bridge.params_from_reference(loaded["params"], device="cpu"), TPOLICY)
    ref = RServeEngine(rconvert(jparams, POLICY), cfg, POLICY, impl="jnp", prefill="chunked",
                       cache="slot", **ENGINE)
    with jax.disable_jit():
        want = ref.run(_requests(RRequest, cfg.vocab))
    got = ServeEngine(tp, tcfg, TPOLICY, cache="slot", device="cpu", **ENGINE).run(
        _requests(Request, tcfg.vocab))
    assert got == want
    # the unconverted train-mode tree serves the same codes, converted on the fly
    unconverted = bridge.params_from_reference(loaded["params"], device="cpu")
    assert ServeEngine(unconverted, tcfg, TPOLICY, cache="slot", device="cpu",
                       **ENGINE).run(_requests(Request, tcfg.vocab)) == want


# ------------------------------------------------- the store's own behaviour


def test_checkpointer_retention_and_stale_tmp(tmp_path):
    root = str(tmp_path / "ck")
    ck = TS.Checkpointer(root, keep=2)
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    for s in (1, 2, 3):
        ck.save_async(s, tree)
    ck.wait()
    assert TS.latest_step(root) == 3
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(root) if d.startswith("step_"))
    assert steps == [2, 3]
    os.makedirs(os.path.join(root, ".tmp_99"), exist_ok=True)  # a save cut short
    assert TS.latest_step(root) == 3 == RS.latest_step(root)
    assert TS.latest_step(str(tmp_path / "none")) is None


def test_save_async_isolated_from_later_in_place_update(tmp_path):
    root = str(tmp_path / "ck")
    ck = TS.Checkpointer(root)
    live = {"w": torch.arange(1 << 16, dtype=torch.float32),
            "n": np.arange(4, dtype=np.int32)}
    want = {k: v.clone() if isinstance(v, torch.Tensor) else v.copy() for k, v in live.items()}
    ck.save_async(1, live)
    live["w"].add_(1.0)  # a live parameter updated in place while the thread writes
    live["n"] += 1
    ck.wait()
    got, _ = TS.load(root, live, device="cpu")
    assert torch.equal(got["w"], want["w"])
    np.testing.assert_array_equal(got["n"].numpy(), want["n"])


def test_preemption_handler_saves_and_exits(tmp_path):
    root = str(tmp_path / "ck")
    ck = TS.Checkpointer(root)
    tree = {"w": torch.full((3,), 7.0)}
    before = signal.getsignal(signal.SIGTERM)
    try:
        ck.install_preemption_handler(lambda: (12, tree))
        assert not ck.preempted
        with pytest.raises(SystemExit) as e:
            os.kill(os.getpid(), signal.SIGTERM)  # the handler runs before kill returns
        assert e.value.code == 143
    finally:
        signal.signal(signal.SIGTERM, before)
    assert signal.getsignal(signal.SIGTERM) is before
    assert ck.preempted and TS.latest_step(root) == 12
    got, _ = TS.load(root, tree, device="cpu")
    assert torch.equal(got["w"], tree["w"])


def test_errors_match_reference(tmp_path):
    root = str(tmp_path / "ck")
    for load, kw in ((RS.load, {}), (TS.load, dict(device="cpu"))):
        with pytest.raises(FileNotFoundError, match="no checkpoints under"):
            load(root, {"w": np.zeros(3, np.float32)}, **kw)
    TS.save(root, 1, {"w": torch.zeros(3)})
    msgs = []
    for load, kw in ((RS.load, {}), (TS.load, dict(device="cpu"))):
        with pytest.raises(KeyError) as k:
            load(root, {"v": np.zeros(3, np.float32)}, **kw)
        with pytest.raises(ValueError) as v:
            load(root, {"w": np.zeros((3, 1), np.float32)}, **kw)
        msgs.append((str(k.value), str(v.value)))
    assert msgs[0] == msgs[1]
    assert msgs[1] == ("'checkpoint missing leaf v'", "shape mismatch for w: ckpt (3,) vs (3, 1)")


def test_load_defaults_to_cuda(tmp_path):
    """``device=None`` means CUDA, as for every entry point of the port:
    no silent fallback to the CPU."""
    TS.save(str(tmp_path), 1, {"w": torch.zeros(3)})
    if torch.cuda.is_available():
        got, _ = TS.load(str(tmp_path), {"w": torch.empty(3, device="meta")})
        assert got["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TS.load(str(tmp_path), {"w": torch.empty(3, device="meta")})


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    """The card's machine has no ml_dtypes: save and load bf16 with it
    blocked, in a fresh process."""
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.checkpoint import store\n"
        "x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))\n"
        "tree = {'a': x.to(torch.bfloat16), 'b': [x[0].to(torch.bfloat16), x]}\n"
        f"store.save({str(tmp_path)!r}, 3, tree)\n"
        "meta = {'a': torch.empty(4, 6, dtype=torch.bfloat16, device='meta'),\n"
        "        'b': [torch.empty(6, dtype=torch.bfloat16, device='meta'),\n"
        "              torch.empty(4, 6, device='meta')]}\n"
        f"got, step = store.load({str(tmp_path)!r}, meta, device='cpu')\n"
        "assert step == 3 and got['a'].dtype == torch.bfloat16\n"
        "assert torch.equal(got['a'].view(torch.int16), tree['a'].view(torch.int16))\n"
        "assert torch.equal(got['b'][0].view(torch.int16), tree['b'][0].view(torch.int16))\n"
        "assert torch.equal(got['b'][1], x)\n"
        "assert sys.modules['ml_dtypes'] is None\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
