"""PyTorch port, wdqmm's tensor-core arithmetic emulated on the CPU.

On bf16 activations the CUDA kernel (``csrc/wdqmm.cu``) multiplies x by the
integer weights on the tensor cores (bf16 ``mma.sync`` m16n8k16, f32
accumulator) and scales the sum by eps_w once. Every product is exact in
f32, but a tensor-core step does not round its sum to nearest: it aligns the
16 products to the largest and may truncate. Over K = 8192 (internlm2's down
projection) or 18432 (DeepSeek-V3's MLA-dense down projection) a running
accumulator could drift towards the gate, so the kernel restarts it every
``MMA_CHUNK`` (64) values and adds the chunks' partials in increasing k
with f32 round-to-nearest.

``_emulate`` repeats that arithmetic with the worst case of the tensor core:
products exact, each k16 step's sum (the running chunk sum plus its 16
products) rounded toward zero in f32, the chunk partials added with
round-to-nearest, eps_w applied last. Its k16 steps group k as the kernel's
fragments do (lane t of a quad holds k = 16 t + 0..15 of a chunk, and step s
takes the four of them that its weight unpacking pairs; see
``_step_offsets``). Inputs are drawn from a numpy seed at internlm2-1.8b's and
DeepSeek-V3's full (N, K), two rows, weights at 4 bits. The result must lie
within ``TOL * sum_k |x w|`` (TOL = 2^-20, ``kernels/wdqmm.py``) of the plain
version ``wdqmm_ref``; without the restarts (one chunk over all of K) it
comes closer to that gate, which is why the kernel restarts them. The card
test (tests/test_torch_gpu.py) holds the kernel itself to the same gate.
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from repro_torch import configs  # noqa: E402
from repro_torch.core import pack as P  # noqa: E402
from repro_torch.kernels.ref import wdqmm_ref  # noqa: E402
from repro_torch.kernels.wdqmm import MMA_CHUNK, TOL  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

EPS = 3.7e-3
ROWS = 2
#: output columns emulated at a time (the f64 step sums of one block)
NB = 1024


def _shapes(name):
    """(N, K) of every projection the weight-only path multiplies: internlm2's
    q, k / v, o, up / gate, down and head; DeepSeek-V3's MLA-dense wq_a, wq_b,
    wkv_a, wo, up / gate, down and head."""
    cfg = configs.get_arch(name)
    if cfg.mla_cfg is None:
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
        return [(cfg.n_heads * hd, d), (cfg.kv_heads * hd, d), (d, cfg.n_heads * hd), (f, d),
                (d, f), (cfg.vocab_padded, d)]
    a, f = cfg.mla_cfg, M._mlp_cfg(cfg, "mla_dense").d_ff
    return [(a.q_lora, a.d_model), (a.n_heads * (a.d_nope + a.d_rope), a.q_lora),
            (a.kv_lora + a.d_rope, a.d_model), (a.d_model, a.n_heads * a.d_v), (f, a.d_model),
            (a.d_model, f), (cfg.vocab_padded, a.d_model)]


def _step_offsets(w_bits):
    """The four in-lane offsets (of a lane's 16) that k16 step s of a chunk
    multiplies, for s = 0..3: the kernel pairs a lane's weights (k, k + 1) at
    w 8, (k, k + 4) within each 8 at w 4 and (k, k + 8) at w 2, and step s
    takes pairs 2 s and 2 s + 1."""
    if w_bits == 8:
        pairs = [(2 * q, 2 * q + 1) for q in range(8)]
    elif w_bits == 4:
        pairs = [(8 * (q >> 2) + (q & 3), 8 * (q >> 2) + (q & 3) + 4) for q in range(8)]
    else:
        pairs = [(q, q + 8) for q in range(8)]
    return [[*pairs[2 * s], *pairs[2 * s + 1]] for s in range(4)]


def _rz32(s):
    """f64 -> f32 rounded toward zero."""
    r = s.to(torch.float32)
    over = r.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _emulate(x, w, w_bits, chunk):
    """y = eps * sum_k x w as the kernel sums it, chunks of ``chunk`` values
    (a multiple of MMA_CHUNK; K or more: no restart). x (M, K) bf16, w (N, K)
    integers."""
    Mr, K = x.shape
    K64 = -(-K // MMA_CHUNK) * MMA_CHUNK  # the kernel zero-fills the last chunk
    offs = _step_offsets(w_bits)
    perm = torch.tensor([c + 16 * t + o for c in range(0, K64, MMA_CHUNK) for s in range(4)
                         for t in range(4) for o in offs[s]])
    steps_per_chunk = max(1, min(chunk, K64) // 16)
    xd = torch.zeros((Mr, K64), dtype=torch.float64)
    xd[:, :K] = x.double()
    xs = xd[:, perm].reshape(Mr, -1, 16).permute(1, 0, 2)  # (S, M, 16)
    wd = torch.zeros((w.shape[0], K64), dtype=torch.float64)
    wd[:, :K] = w.double()
    ws = wd[:, perm].reshape(w.shape[0], -1, 16).permute(1, 2, 0)  # (S, 16, N)
    steps = torch.bmm(xs, ws)  # (S, M, N): each step's 16 products, summed exactly
    S = steps.shape[0]
    C = -(-S // steps_per_chunk)
    st = torch.zeros((C * steps_per_chunk, *steps.shape[1:]), dtype=torch.float64)
    st[:S] = steps
    st = st.reshape(C, steps_per_chunk, *steps.shape[1:])
    part = torch.zeros((C, *steps.shape[1:]), dtype=torch.float32)
    for j in range(steps_per_chunk):  # a fresh accumulator per chunk, truncating steps
        part = _rz32(part.double() + st[:, j])
    tot = torch.zeros(steps.shape[1:], dtype=torch.float32)
    for c in range(C):  # the chunks in increasing k, round to nearest
        tot = tot + part[c]
    return tot * torch.tensor(EPS, dtype=torch.float32)


def _ratios(seed, N, K, w_bits, chunks):
    """max over outputs of |emulation - wdqmm_ref| / (TOL * sum_k |x w| eps)
    for each chunk length, columns drawn and emulated NB at a time."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((ROWS, K)).astype(np.float32)).to(torch.bfloat16)
    lo, hi = -(1 << (w_bits - 1)), 1 << (w_bits - 1)
    worst = dict.fromkeys(chunks, 0.0)
    for n0 in range(0, N, NB):
        w = torch.from_numpy(rng.integers(lo, hi, (min(NB, N - n0), K)).astype(np.int8))
        ref = wdqmm_ref(x, P.pack(w, w_bits), EPS, w_bits=w_bits).double()
        gate = TOL * (x.double().abs() @ w.double().abs().T) * EPS
        for c in chunks:
            err = (_emulate(x, w, w_bits, c).double() - ref).abs()
            worst[c] = max(worst[c], float((err / gate).max()))
    return worst


def test_kernel_chunk_is_the_wrappers():
    """The kernel's compile-time chunk is the MMA_CHUNK this file emulates."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "wdqmm.cu").read_text()
    assert re.findall(r"^constexpr int KP = (\d+);", src, flags=re.M) == [str(MMA_CHUNK)]


@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_step_offsets_cover_each_k_once(w_bits):
    offs = [o for s in _step_offsets(w_bits) for o in s]
    assert sorted(offs) == list(range(16))


@pytest.mark.parametrize("name", ["internlm2-1.8b", "deepseek-v3-671b"])
def test_chunked_mma_sums_within_tol_at_model_scale(name):
    """Every projection of the model at its full (N, K), w 4: the emulated
    kernel within TOL * sum |x w| of the plain version; one chunk over all of
    K (no restarts) comes closer to that gate."""
    whole = 1 << 20  # more than any K: one chunk
    worst = {MMA_CHUNK: 0.0, whole: 0.0}
    for i, (N, K) in enumerate(_shapes(name)):
        r = _ratios(i, N, K, 4, (MMA_CHUNK, whole))
        assert r[MMA_CHUNK] < 1.0, (N, K, r)
        worst = {c: max(worst[c], r[c]) for c in worst}
    assert worst[whole] > worst[MMA_CHUNK], worst


@pytest.mark.parametrize("w_bits", [8, 2])
def test_chunked_mma_sums_within_tol_at_other_widths(w_bits):
    """w 8 and 2 (their own step grouping) at DeepSeek-V3's largest K."""
    r = _ratios(10 + w_bits, 256, 18432, w_bits, (MMA_CHUNK,))
    assert r[MMA_CHUNK] < 1.0, r
