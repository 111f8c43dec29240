"""Kernel dispatch registry (counterpart of ``repro.kernels.dispatch``).

Every kernel variant is a ``KernelEntry`` under a ``KernelKey`` ``(op,
x_bits, w_bits, y_bits, impl)``; coverage of the cells the port has is
validated at import time (a missing cell is an ImportError, not a latent
KeyError), and every call in ops.py routes through :func:`lookup`, which
counts dispatches per cell.

Two implementations per cell:
  * ``cuda``  — the hand-written CUDA kernel (csrc/), CUDA tensors only;
  * ``torch`` — its plain PyTorch version, on any device.

``impl="auto"`` picks by the DEVICE of the tensors: the kernel for CUDA
tensors, the plain version for CPU tensors. There is no fallback: on a CUDA
device a kernel that does not build or launch raises.

Ops in the registry: ``mpmm`` and ``conv2d`` (all 27 (x, w, y) cells),
``qntpack`` (one cell per output width y), ``paged_gather`` and
``paged_scatter`` (one storage-agnostic cell each), ``paged_attn`` and
``paged_mla_attn`` (one cell per KV width each).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.core.policy import BITS, LAYER_CLASSES, PERMUTATIONS, perm_name


@dataclasses.dataclass(frozen=True)
class KernelKey:
    """Identity of one cell of the kernel matrix."""

    op: str
    x_bits: Optional[int]
    w_bits: Optional[int]
    y_bits: Optional[int]
    impl: str  # "cuda" | "torch"

    def __str__(self) -> str:
        bits = "_".join(
            "x" if b is None else str(b) for b in (self.x_bits, self.w_bits, self.y_bits))
        return f"{self.op}[{bits}]@{self.impl}"


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    key: KernelKey
    fn: Callable
    name: str


_REGISTRY: dict[KernelKey, KernelEntry] = {}

#: How many times each kernel cell has been dispatched (process-wide).
DISPATCH_COUNTS: collections.Counter = collections.Counter()

IMPLS = ("cuda", "torch")

#: KV-cache storage widths (bf16, int8, packed int4); paged_attn and
#: paged_mla_attn key on them.
KV_BITS = (None, 8, 4)


def register(op: str, *, x_bits: Optional[int] = None, w_bits: Optional[int] = None,
             y_bits: Optional[int] = None, impl: str, fn: Callable,
             name: Optional[str] = None) -> KernelEntry:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    key = KernelKey(op, x_bits, w_bits, y_bits, impl)
    if key in _REGISTRY:
        raise ValueError(f"duplicate kernel registration: {key}")
    entry = KernelEntry(key, fn, name or str(key))
    _REGISTRY[key] = entry
    return entry


def resolve_impl(impl: str, device: torch.device) -> str:
    """``auto`` -> ``cuda`` for CUDA tensors, ``torch`` for CPU tensors.
    ``cuda`` on a non-CUDA device raises."""
    device = torch.device(device)
    if impl == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got device {device}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be auto or one of {IMPLS}, got {impl!r}")
    return impl


def lookup(op: str, *, device: torch.device, x_bits: Optional[int] = None,
           w_bits: Optional[int] = None, y_bits: Optional[int] = None,
           impl: str = "auto") -> KernelEntry:
    """Route one call: returns the registered entry, counting the dispatch."""
    key = KernelKey(op, x_bits, w_bits, y_bits, resolve_impl(impl, device))
    entry = _REGISTRY.get(key)
    if entry is None:
        have = sorted(str(k) for k in _REGISTRY if k.op == op)
        raise KeyError(
            f"no kernel registered for {key} — the precision permutation is "
            f"outside the library. Registered {op} cells: {have}")
    DISPATCH_COUNTS[key] += 1
    return entry


def coverage(op: str, impl: str) -> set[tuple]:
    return {(k.x_bits, k.w_bits, k.y_bits) for k in _REGISTRY
            if k.op == op and k.impl == impl}


def validate_coverage() -> None:
    """The import-time gate over the cells the port has: mpmm and conv2d
    cover all 27 permutations, qntpack every output width, paged_gather and
    paged_scatter one cell each, paged_attn and paged_mla_attn every KV
    width, on both implementations."""
    missing: list[str] = []
    for impl in IMPLS:
        for op in ("mpmm", "conv2d"):
            for cell in sorted(set(PERMUTATIONS) - coverage(op, impl)):
                missing.append(f"{op}[{cell[0]}_{cell[1]}_{cell[2]}]@{impl}")
        have_y = {c[2] for c in coverage("qntpack", impl)}
        for b in BITS:
            if b not in have_y:
                missing.append(f"qntpack[y={b}]@{impl}")
        for op in ("paged_gather", "paged_scatter"):
            if not coverage(op, impl):
                missing.append(f"{op}@{impl}")
        for op in ("paged_attn", "paged_mla_attn"):
            have_kv = {c[1] for c in coverage(op, impl)}
            for b in KV_BITS:
                if b not in have_kv:
                    missing.append(f"{op}[kv={b}]@{impl}")
    if missing:
        raise RuntimeError(f"kernel matrix has {len(missing)} unregistered cells: {missing}")


def cells_for_policy(policy) -> list[KernelKey]:
    """The cells a policy's serving path routes through: fully quantized
    layers hit mpmm (signed activations, f32 out, y_bits=8 requant vector);
    weight-only layers would hit wdqmm, which the port does not have yet."""
    cells: set[KernelKey] = set()
    for cls in LAYER_CLASSES:
        lp = policy.of(cls)
        if not lp.quantized:
            continue
        if lp.act_quantized:
            cells.add(KernelKey("mpmm", lp.x_bits, lp.w_bits, 8, "cuda"))
        else:
            cells.add(KernelKey("wdqmm", None, lp.w_bits, None, "cuda"))
    return sorted(cells, key=str)


def ensure_policy_supported(policy) -> None:
    """Fail fast (KeyError) if any cell a policy needs is unregistered."""
    for cell in cells_for_policy(policy):
        for impl in IMPLS:
            key = dataclasses.replace(cell, impl=impl)
            if key not in _REGISTRY:
                raise KeyError(f"policy {getattr(policy, 'name', policy)!r} needs "
                               f"unregistered kernel cell {key}")


def _register_library() -> None:
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.kernels.mpmm import mpmm_cuda
    from repro_torch.kernels.paged_attn import (
        paged_attn_cuda,
        paged_attn_ref,
        paged_mla_attn_cuda,
        paged_mla_attn_ref,
    )
    from repro_torch.kernels.paged_gather import (
        paged_gather_cuda,
        paged_gather_ref,
        paged_scatter_cuda,
        paged_scatter_ref,
    )
    from repro_torch.kernels.qntpack import qntpack_cuda
    from repro_torch.kernels.ref import conv2d_ref, mpmm_ref, qntpack_ref

    for x_bits, w_bits, y_bits in PERMUTATIONS:
        name = perm_name(x_bits, w_bits, y_bits)
        bound = dict(x_bits=x_bits, w_bits=w_bits, y_bits=y_bits)
        register("mpmm", **bound, impl="cuda",
                 fn=functools.partial(mpmm_cuda, **bound), name=name)
        register("mpmm", **bound, impl="torch",
                 fn=functools.partial(mpmm_ref, **bound), name=name + "_ref")
        conv = name.replace("mpmm_", "conv3x3_")
        register("conv2d", **bound, impl="cuda",
                 fn=functools.partial(conv2d_cuda, **bound), name=conv)
        register("conv2d", **bound, impl="torch",
                 fn=functools.partial(conv2d_ref, **bound), name=conv + "_ref")
    for y_bits in BITS:
        register("qntpack", y_bits=y_bits, impl="cuda",
                 fn=functools.partial(qntpack_cuda, y_bits=y_bits), name=f"qntpack_u{y_bits}")
        register("qntpack", y_bits=y_bits, impl="torch",
                 fn=functools.partial(qntpack_ref, y_bits=y_bits),
                 name=f"qntpack_u{y_bits}_ref")
    register("paged_gather", impl="cuda", fn=paged_gather_cuda, name="paged_gather")
    register("paged_gather", impl="torch", fn=paged_gather_ref, name="paged_gather_ref")
    register("paged_scatter", impl="cuda", fn=paged_scatter_cuda, name="paged_scatter")
    register("paged_scatter", impl="torch", fn=paged_scatter_ref, name="paged_scatter_ref")
    for kv_bits in KV_BITS:
        tag = "bf16" if kv_bits is None else f"kv{kv_bits}"
        register("paged_attn", w_bits=kv_bits, impl="cuda",
                 fn=functools.partial(paged_attn_cuda, bits=kv_bits), name=f"paged_attn_{tag}")
        register("paged_attn", w_bits=kv_bits, impl="torch",
                 fn=functools.partial(paged_attn_ref, bits=kv_bits),
                 name=f"paged_attn_{tag}_ref")
        register("paged_mla_attn", w_bits=kv_bits, impl="cuda",
                 fn=functools.partial(paged_mla_attn_cuda, bits=kv_bits),
                 name=f"paged_mla_attn_{tag}")
        register("paged_mla_attn", w_bits=kv_bits, impl="torch",
                 fn=functools.partial(paged_mla_attn_ref, bits=kv_bits),
                 name=f"paged_mla_attn_{tag}_ref")


_register_library()
validate_coverage()
