"""Architecture registry (counterpart of ``repro.configs``): ``get_arch``
resolves a name, ``reduced()`` shrinks a config to a CPU-test size of the
same family. The port serves the dense family and the MLA layers of the
mla_moe family (its expert layers are not ported); the registry holds the
configurations ported so far."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import deepseek_v3_671b, internlm2_1p8b, refconv
from repro_torch.models.model import ArchConfig

ARCHS: dict[str, ArchConfig] = {m.ARCH.name: m.ARCH for m in (deepseek_v3_671b, internlm2_1p8b)}
#: the paper's Reference Layer (a conv shape, not an LM architecture)
REFCONV = refconv.ARCH


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None


def reduced(cfg: ArchConfig, *, layers: int = 2) -> ArchConfig:
    """Family-preserving tiny config for CPU tests (the reference's rule for
    the dense, MoE and MLA fields)."""
    n_heads = min(cfg.n_heads, 4)
    kv_heads = max(1, min(cfg.kv_heads, n_heads, 2 if cfg.kv_heads < cfg.n_heads else n_heads))
    upd: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=max(layers, 2),
        d_model=64,
        n_heads=n_heads,
        kv_heads=kv_heads,
        head_dim=16,
        d_ff=128,
        vocab=256,
    )
    if cfg.n_experts:
        upd.update(n_experts=4, top_k=2, moe_d_ff=32, shared_d_ff=32,
                   dense_layers=min(cfg.dense_layers, 1))
    if cfg.mla:
        upd.update(q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16, head_dim=16)
    if cfg.window:
        upd.update(window=8)
    return dataclasses.replace(cfg, **upd)


__all__ = ["ARCHS", "REFCONV", "ArchConfig", "get_arch", "reduced"]
