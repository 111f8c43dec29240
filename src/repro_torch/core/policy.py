"""Precision policies: the paper's 27-kernel permutation space as a
first-class, per-layer-class configuration system.

The paper generates one conv kernel per (ifmap, weight, ofmap) precision
permutation over {8, 4, 2}. Here the same space parameterizes every linear
projection of every architecture; a ``PrecisionPolicy`` assigns a permutation
(or bf16 passthrough) per layer *class* — the network-scale version of
mixed-precision-per-layer (paper ref [1], CMix-NN).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Optional

BITS = (8, 4, 2)

#: All 27 (x_bits, w_bits, y_bits) permutations, in the paper's enumeration
#: order (ifmap-major). ``PERMUTATIONS[i]`` is the i-th "kernel" of the library.
PERMUTATIONS: tuple[tuple[int, int, int], ...] = tuple(itertools.product(BITS, BITS, BITS))

assert len(PERMUTATIONS) == 27


def perm_name(x_bits: int, w_bits: int, y_bits: int) -> str:
    """PULP-NN style kernel name, e.g. ``mpmm_u8_i4_u2``."""
    return f"mpmm_u{x_bits}_i{w_bits}_u{y_bits}"


KERNEL_NAMES: tuple[str, ...] = tuple(perm_name(*p) for p in PERMUTATIONS)


@dataclasses.dataclass(frozen=True)
class LayerPrecision:
    """Precision assignment for one layer class. ``None`` bits => bf16 (no quant)."""

    x_bits: Optional[int] = None
    w_bits: Optional[int] = None
    y_bits: Optional[int] = None

    @property
    def quantized(self) -> bool:
        return self.w_bits is not None

    @property
    def act_quantized(self) -> bool:
        return self.x_bits is not None

    def validate(self) -> "LayerPrecision":
        for b in (self.x_bits, self.w_bits, self.y_bits):
            if b is not None and b not in BITS:
                raise ValueError(f"bits must be in {BITS} or None, got {b}")
        return self


BF16 = LayerPrecision()  # full-precision passthrough (the paper's fp baseline)

#: Layer classes a policy can address. Every QuantizedLinear in the model zoo
#: declares one of these.
LAYER_CLASSES = (
    "embed",        # token embedding gather
    "attn_qkv",     # Q/K/V projections (incl. MLA down/up, RWKV r/k/v/g)
    "attn_out",     # attention output projection
    "ffn_in",       # FFN up/gate projections
    "ffn_out",      # FFN down projection
    "expert",       # MoE expert FFNs
    "router",       # MoE router (kept fp by default: precision-sensitive)
    "ssm_proj",     # SSM in/out/x projections (mamba2, rwkv channel-mix)
    "head",         # LM head
)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Maps layer class -> LayerPrecision. Unlisted classes fall back to default."""

    name: str
    default: LayerPrecision = BF16
    per_class: Mapping[str, LayerPrecision] = dataclasses.field(default_factory=dict)
    kv_cache_bits: Optional[int] = None  # beyond-paper: quantized KV cache

    def of(self, layer_class: str) -> LayerPrecision:
        if layer_class not in LAYER_CLASSES:
            raise KeyError(f"unknown layer class {layer_class!r}")
        return self.per_class.get(layer_class, self.default)


def _uniform(name: str, x: Optional[int], w: Optional[int], y: Optional[int],
             kv: Optional[int] = None) -> PrecisionPolicy:
    lp = LayerPrecision(x, w, y).validate()
    return PrecisionPolicy(
        name=name,
        default=lp,
        per_class={"router": BF16},  # routers always fp (DESIGN.md Sec. 11)
        kv_cache_bits=kv,
    )


#: Named presets. ``bf16`` is the paper's "32-bit" style baseline; ``w8a8`` is
#: the PULP-NN symmetric baseline; the rest exercise the mixed-precision space.
POLICIES: dict[str, PrecisionPolicy] = {
    "bf16": PrecisionPolicy(name="bf16"),
    "w8a8": _uniform("w8a8", 8, 8, 8, kv=8),
    "w4a8": _uniform("w4a8", 8, 4, 8, kv=8),
    "w2a8": _uniform("w2a8", 8, 2, 8, kv=8),
    "w4a4": _uniform("w4a4", 4, 4, 4, kv=8),
    "w2a4": _uniform("w2a4", 4, 2, 2, kv=8),
    "w2a8kv4": _uniform("w2a8kv4", 8, 2, 8, kv=4),  # decode memory hillclimb
    "w4a8kv4": _uniform("w4a8kv4", 8, 4, 8, kv=4),
    # The paper-style mixed assignment: sensitive layers (embed/head/attn_out)
    # at 8-bit, bulk FFN weights at 4-bit, expert weights at 2-bit.
    "mixed_paper": PrecisionPolicy(
        name="mixed_paper",
        default=LayerPrecision(8, 4, 8),
        per_class={
            "embed": LayerPrecision(8, 8, 8),
            "head": LayerPrecision(8, 8, 8),
            "attn_out": LayerPrecision(8, 8, 8),
            "expert": LayerPrecision(8, 2, 8),
            "router": BF16,
        },
        kv_cache_bits=8,
    ),
}


def get_policy(name: str) -> PrecisionPolicy:
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; available: {sorted(POLICIES)}") from None
