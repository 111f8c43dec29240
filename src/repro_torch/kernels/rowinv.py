"""Row-invariant f32 batched products: the unfused attention's einsums.

The port's own kernel (``csrc/rowinv_bmm.cu``), not a TPU kernel's: the
reference computes these products with ``jnp.einsum``. A two-operand
einsum with one row letter (``q`` or ``s``: the query rows), one column
letter, one contraction letter and at most two batch letters maps onto
one launch of ``C[z] = A[z] @ B[z]`` over the operands' own strides (a
batch letter an operand lacks gets stride 0). Every output is one f32 FMA
chain over the contraction in order, so a query row has the same bits
alone (a decode step) as among any number of rows (a continuous mixed
step, a speculative verify): what ``torch.einsum`` on the card (cuBLAS,
its kernel picked by the shape) does not give.

The plain version is ``torch.einsum`` itself: on CPU tensors the call
sites compute exactly what they computed before. The kernel and the plain
version sum in other orders, so they agree within :data:`TOL`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

#: kernel vs plain version (``torch.einsum``), atol = rtol, scaled by the
#: largest |output| of the call (``1e-5 * (1 + max |plain|)``): two f32
#: orders of the same sums
TOL = 1e-5
#: letters that name the query rows (the products' M)
ROWS = "qs"

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2


@dataclasses.dataclass(frozen=True)
class Plan:
    """An einsum as a batched product: the output's batch letters (at
    most two, in its order), the row letter m, the column letter n and the
    contraction letter k; ``a``, ``b``, ``out`` the operands' letters."""

    a: str
    b: str
    out: str
    batch: tuple
    m: str
    n: str
    k: str


@functools.lru_cache(maxsize=None)
def plan(spec: str) -> Plan:
    """Parse ``spec`` (e.g. ``"bqhd,bkhd->bhqk"``); raises ValueError for
    an einsum the kernel does not take."""
    try:
        ins, out = spec.replace(" ", "").split("->")
        a, b = ins.split(",")
    except ValueError:
        raise ValueError(f"rowinv: {spec!r} is not a two-operand einsum") from None
    for name, s in (("a", a), ("b", b), ("out", out)):
        if len(set(s)) != len(s):
            raise ValueError(f"rowinv: {spec!r} repeats a letter in {name}")
    ks = [c for c in a if c in b and c not in out]
    ns = [c for c in b if c in out and c not in a]
    ms = [c for c in a if c in ROWS and c in out and c not in b]
    if len(ks) != 1 or len(ns) != 1 or len(ms) != 1:
        raise ValueError(f"rowinv: {spec!r} needs one contraction letter, one column letter "
                         f"only in b and one row letter ({ROWS}) only in a")
    batch = tuple(c for c in out if c not in (ms[0], ns[0]))
    if len(batch) > 2 or set(a) - set(batch) - {ms[0], ks[0]} or set(b) - set(batch) - {ns[0],
                                                                                      ks[0]}:
        raise ValueError(f"rowinv: {spec!r} needs at most two batch letters and every letter "
                         f"of a and b in the output or contracted")
    return Plan(a, b, out, batch, ms[0], ns[0], ks[0])


def _stride(t: torch.Tensor, letters: str, c: str) -> int:
    return t.stride(letters.index(c)) if c in letters else 0


def _size(p: Plan, a: torch.Tensor, b: torch.Tensor, c: str) -> int:
    sizes = {a.shape[i] for i, x in enumerate(p.a) if x == c}
    sizes |= {b.shape[i] for i, x in enumerate(p.b) if x == c}
    if len(sizes) != 1:
        raise ValueError(f"rowinv: letter {c!r} has sizes {sorted(sizes)} in {p.a},{p.b}")
    return sizes.pop()


def launch_args(p: Plan, a: torch.Tensor, b: torch.Tensor):
    """The output's shape and the launch's (Z1, Z2, M, N, K) and twelve
    strides (A's z1, z2, m, k; B's z1, z2, k, n; C's z1, z2, m, n) for a
    contiguous output. The batch is padded to two letters with a size-1
    one."""
    if a.dim() != len(p.a) or b.dim() != len(p.b):
        raise ValueError(f"rowinv: operands of {a.dim()} and {b.dim()} dims for "
                         f"{p.a},{p.b}->{p.out}")
    size = {c: _size(p, a, b, c) for c in set(p.a) | set(p.b)}
    shape = tuple(size[c] for c in p.out)
    ostride = {c: s for c, s in zip(p.out, torch.empty(shape, device="meta").stride())}
    zs = list(p.batch) + [None] * (2 - len(p.batch))

    def st(t, letters, c):
        return 0 if c is None else _stride(t, letters, c)

    strides = ([st(a, p.a, z) for z in zs] + [_stride(a, p.a, p.m), _stride(a, p.a, p.k)]
               + [st(b, p.b, z) for z in zs] + [_stride(b, p.b, p.k), _stride(b, p.b, p.n)]
               + [0 if z is None else ostride[z] for z in zs] + [ostride[p.m], ostride[p.n]])
    dims = tuple(1 if z is None else size[z] for z in zs) + (size[p.m], size[p.n], size[p.k])
    return shape, dims, strides


def rowinv_einsum_ref(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: exactly the einsum the call sites computed."""
    return torch.einsum(spec, a, b)


def rowinv_einsum_cuda(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: f32 operands on the card, any strides.
    Returns the einsum's output, contiguous, f32."""
    dev = a.device
    if dev.type != "cuda" or b.device != dev:
        raise ValueError(f"rowinv_einsum_cuda needs both operands on one CUDA device, got "
                         f"{a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"rowinv: operands {a.dtype} and {b.dtype}, expected float32")
    shape, (Z1, Z2, M, N, K), strides = launch_args(plan(spec), a, b)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    st = (ctypes.c_longlong * 12)(*strides)
    fn = build.entry("rowinv_bmm", "rowinv_bmm_launch", _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), Z1, Z2, M, N, K,
             ctypes.cast(st, ctypes.c_void_p), build.stream_ptr(dev))
    build.check(err, "rowinv_bmm_launch")
    build.LAUNCHES["rowinv_bmm"] += 1
    return out
