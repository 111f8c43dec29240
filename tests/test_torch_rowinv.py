"""PyTorch port, the row-invariant f32 products (``ops.rowinv_einsum``,
kernel ``csrc/rowinv_bmm.cu``) on the CPU: the unfused attention's seven
einsums.

On CPU tensors the op is the einsum the call sites computed before it
existed (the plain version is ``torch.einsum`` itself): bit for bit, so
every parity test of the unfused read keeps its bits. The kernel's launch
plan (the batch, row, column and contraction letters and the twelve
strides, read straight from the operands) addresses the einsum's
operands: a strided f64 product over that plan equals the einsum. The
kernel itself runs only on the card (tests/test_torch_gpu.py ``rowinv``:
row-invariant at the serving shapes, within ``TOL`` of the einsum).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.kernels.rowinv import launch_args, plan  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

#: the call sites' einsums (models/attention.py) at small sizes: (spec,
#: letter sizes)
SPECS = [
    ("bqhd,bkhd->bhqk", dict(b=2, q=3, h=4, d=16, k=32)),
    ("bhqk,bkhd->bqhd", dict(b=2, q=3, h=4, d=16, k=32)),
    ("bshd,hdc->bshc", dict(b=2, s=3, h=4, d=16, c=8)),
    ("bshc,btc->bhst", dict(b=2, s=3, h=4, c=8, t=32)),
    ("bshd,btd->bhst", dict(b=2, s=3, h=4, d=8, t=32)),
    ("bhst,btc->bshc", dict(b=2, s=3, h=4, t=32, c=8)),
    ("bshc,hdc->bshd", dict(b=2, s=3, h=4, c=8, d=16)),
]


def _operands(spec, sizes, seed, dtype=torch.float32, strided=False, ints=False):
    """The einsum's operands from a seeded numpy draw (small integers with
    ``ints``: every sum exact); with ``strided``, each a view into a wider
    buffer (every stride other than a packed tensor's), as the call sites'
    slices are."""
    p = plan(spec)
    rng = np.random.RandomState(seed)

    def draw(shape):
        x = rng.randint(-8, 9, size=shape) if ints else rng.standard_normal(shape)
        return torch.from_numpy(x).to(dtype)

    out = []
    for letters in (p.a, p.b):
        shape = [sizes[c] for c in letters]
        if strided:
            out.append(draw([n + 1 for n in shape])[tuple(slice(0, n) for n in shape)])
        else:
            out.append(draw(shape))
    return out


@pytest.mark.parametrize("strided", [False, True], ids=["packed", "strided"])
@pytest.mark.parametrize("spec,sizes", SPECS, ids=[s for s, _ in SPECS])
def test_plain_version_is_the_einsum(spec, sizes, strided):
    """On the CPU ``ops.rowinv_einsum`` is ``torch.einsum`` bit for bit (the
    call sites' products keep their bits), through the registry's plain
    cell."""
    a, b = _operands(spec, sizes, 1, strided=strided)
    key = dispatch.KernelKey("rowinv_bmm", None, None, None, "torch")
    n0 = dispatch.DISPATCH_COUNTS[key]
    got = ops.rowinv_einsum(spec, a, b)
    assert dispatch.DISPATCH_COUNTS[key] == n0 + 1
    assert got.dtype == torch.float32 and torch.equal(got, torch.einsum(spec, a, b))


@pytest.mark.parametrize("strided", [False, True], ids=["packed", "strided"])
@pytest.mark.parametrize("spec,sizes", SPECS, ids=[s for s, _ in SPECS])
def test_launch_plan_addresses_the_einsum(spec, sizes, strided):
    """The kernel's (Z1, Z2, M, N, K) and twelve strides, applied to the
    operands' storage as ``as_strided`` views, give the einsum (f64 over
    small integers: every sum exact) in the output's contiguous layout; the row letter is
    the query rows' (q or s), a batch letter an operand lacks has stride
    0."""
    p = plan(spec)
    assert p.m in "qs" and p.m in p.a and p.m not in p.b and len(p.batch) == 2
    a, b = _operands(spec, sizes, 2, dtype=torch.float64, strided=strided, ints=True)
    shape, (Z1, Z2, M_, N, K), st = launch_args(p, a, b)
    assert (M_, N, K) == (sizes[p.m], sizes[p.n], sizes[p.k])
    A = a.as_strided((Z1, Z2, M_, K), st[0:4], a.storage_offset())
    B = b.as_strided((Z1, Z2, K, N), st[4:8], b.storage_offset())
    out = torch.zeros(shape, dtype=torch.float64)
    out.as_strided((Z1, Z2, M_, N), st[8:12]).copy_(A @ B)
    assert torch.equal(out, torch.einsum(spec, a, b))
    for i, z in enumerate(p.batch):
        if z not in p.b:
            assert st[4 + i] == 0


@pytest.mark.parametrize("spec", ["bqhd,bkhd->bhqkd", "bqhd,bkhd", "bqhd,bkhe->bhqk",
                                  "bthd,bkhd->bhtk", "abqhd,bkhd->abhqk", "bqqd,bkhd->bhqk"])
def test_plan_refuses_what_is_not_one_batched_product(spec):
    """No contraction or two, no row letter (q or s), three batch letters,
    a repeated letter: refused when the einsum is parsed."""
    with pytest.raises(ValueError, match="rowinv"):
        plan(spec)


def test_registered_as_the_ports_own_kernel():
    """Both cells registered, outside the TPU kernels' coverage list; on
    CPU tensors ``impl="cuda"`` raises (no kernel there)."""
    assert dispatch.PORT_OWN_OPS == ("rowinv_bmm",)
    assert dispatch.coverage("rowinv_bmm", "cuda") == dispatch.coverage("rowinv_bmm", "torch") \
        == {(None, None, None)}
    a, b = _operands(*SPECS[0], 3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.rowinv_einsum(SPECS[0][0], a, b, impl="cuda")


def _reduced(arch):
    cfg = configs.reduced(configs.get_arch(arch))
    return dataclasses.replace(cfg, dense_layers=2) if cfg.family == "mla_moe" else cfg


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v3-671b", "h2o-danube-1.8b"])
def test_unfused_read_goes_through_rowinv_and_rows_are_invariant(arch):
    """The unfused read dispatches rowinv_bmm twice a GQA layer and five
    times an MLA layer (a decode step and a mixed step alike; the fused
    decode never); one unfused decode step and one mixed step of the same
    four decode lanes (width 16) from copies of one paged cache give
    bit-equal logits."""
    cfg, policy = _reduced(arch), get_policy("w4a8")
    params = M.init_params(torch.Generator().manual_seed(4), cfg, policy, device="cpu")
    rng = np.random.RandomState(3)
    caches = M.init_paged_cache(cfg, policy, 17, 16, device="cpu")
    for layer in caches:
        for a in layer.values():
            a.copy_(torch.from_numpy((rng.standard_normal(tuple(a.shape)) * 20)
                                     .clip(-100, 100)).to(a.dtype))
    bt = torch.arange(1, 17, dtype=torch.int32).reshape(4, 4)
    pos = torch.tensor([3, 17, 40, 60], dtype=torch.int32)
    toks = torch.tensor([5, 9, 11, 200], dtype=torch.int32)
    key = dispatch.KernelKey("rowinv_bmm", None, None, None, "torch")
    per_layer = 5 if cfg.family == "mla_moe" else 2

    def copy():
        return [{k: a.clone() for k, a in layer.items()} for layer in caches]

    n0 = dispatch.DISPATCH_COUNTS[key]
    M.decode_step(params, toks[:, None], pos, copy(), cfg, policy, block_tables=bt,
                  fused_attn=True)
    assert dispatch.DISPATCH_COUNTS[key] == n0
    dec = M.decode_step(params, toks[:, None], pos, copy(), cfg, policy, block_tables=bt,
                        fused_attn=False)[:, -1]
    assert dispatch.DISPATCH_COUNTS[key] == n0 + per_layer * cfg.n_layers
    wide = torch.zeros(4, 16, dtype=torch.int32)
    wide[:, 0] = toks
    mix = M.mixed_step(params, wide, pos, torch.ones_like(pos), copy(), cfg, policy,
                       block_tables=bt, page_size=16)[:, 0]
    assert dispatch.DISPATCH_COUNTS[key] == n0 + 2 * per_layer * cfg.n_layers
    assert torch.equal(dec, mix)


def test_engine_metrics_keep_the_references_kernel_keys():
    """The engine's ``kernels/<op>_calls`` name the reference's kernels
    only: an unfused run dispatches rowinv_bmm, and no metric names it."""
    cfg, policy = _reduced("internlm2-1.8b"), get_policy("w4a8")
    params = M.init_params(torch.Generator().manual_seed(1), cfg, policy, device="cpu")
    eng = ServeEngine(params, cfg, policy, n_slots=2, s_max=32, cache="paged", page_size=16,
                      fused_attn=False, device="cpu")
    key = dispatch.KernelKey("rowinv_bmm", None, None, None, "torch")
    n0 = dispatch.DISPATCH_COUNTS[key]
    eng.run([Request(rid=0, prompt=np.arange(1, 8, dtype=np.int32), max_new=3)])
    assert dispatch.DISPATCH_COUNTS[key] > n0
    m = eng.metrics()
    assert m["kernels/paged_gather_calls"] > 0
    assert not any("rowinv" in k for k in m)
