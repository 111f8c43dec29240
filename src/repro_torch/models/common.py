"""Shared model components: norms, embeddings, activation functions
(counterpart of ``repro.models.common``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * params["scale"]).to(dt)


def layer_norm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dt)


NORMS = {"rms": (rms_norm_init, rms_norm), "layer": (layer_norm_init, layer_norm)}


def embed_init(gen: torch.Generator, vocab: int, d: int, device,
               dtype=torch.float32) -> dict:
    t = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device)
    return {"table": t.to(dtype) * 0.02}


def embed_apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with sigmoid = 1 / (1 + exp(-x)), each op rounded to
    x's dtype: the reference's ``jax.nn.silu`` on bf16 lowers to exactly
    this chain, which ``F.silu`` (one rounding at the end) does not match."""
    return x * (1 / (1 + torch.exp(-x)))


def act_fn(name: str):
    return {"silu": silu, "gelu": F.gelu, "relu": F.relu}[name]
