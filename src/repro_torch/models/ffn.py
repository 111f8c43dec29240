"""Feed-forward stack, (gated) MLP only (counterpart of
``repro.models.ffn``). Mixture-of-Experts is not ported yet."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.linear import linear_apply, linear_init
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.kernels import ops
from repro_torch.models.common import act_fn


@dataclasses.dataclass(frozen=True)
class MLPCfg:
    d_model: int
    d_ff: int
    act: str = "silu"
    gated: bool = True  # SwiGLU-family; False -> up/act/down


def mlp_init(gen: torch.Generator, cfg: MLPCfg, policy: PrecisionPolicy, *,
             mode: str = "serve", device, dtype=torch.float32) -> dict:
    lp_in, lp_out = policy.of("ffn_in"), policy.of("ffn_out")
    kw = dict(mode=mode, device=device, dtype=dtype)
    p = {"up": linear_init(gen, cfg.d_model, cfg.d_ff, lp_in, **kw),
         "down": linear_init(gen, cfg.d_ff, cfg.d_model, lp_out, **kw)}
    if cfg.gated:
        p["gate"] = linear_init(gen, cfg.d_model, cfg.d_ff, lp_in, **kw)
    return p


def mlp_apply(params: dict, x: torch.Tensor, cfg: MLPCfg, policy: PrecisionPolicy, *,
              impl: ops.Impl = "auto") -> torch.Tensor:
    lp_in, lp_out = policy.of("ffn_in"), policy.of("ffn_out")
    up = linear_apply(params["up"], x, lp_in, impl=impl)
    f = act_fn(cfg.act)
    if cfg.gated:
        gate = linear_apply(params["gate"], x, lp_in, impl=impl)
        h = f(gate) * up
    else:
        h = f(up)
    return linear_apply(params["down"], h, lp_out, impl=impl)
