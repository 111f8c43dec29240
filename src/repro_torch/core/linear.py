"""QuantizedLinear (counterpart of ``repro.core.linear``).

Params come in two modes, as in the reference: ``train`` params hold a
float ``w`` (what QAT trains), ``serve`` params hold the packed ``w_packed``
and its scale ``eps_w`` (what a converted checkpoint holds).
``convert_model_to_serving`` folds a train-mode tree into the serve-mode
one; ``linear_apply`` also serves a train-mode ``w`` by converting it on the
fly, to the same codes.

The integer serving path: weights live PACKED sub-byte in device memory. A
fully quantized layer quantizes its activations (signed, offset-binary
storage) and runs the mpmm kernel (int32 accumulation); a weight-only layer
keeps its activations bf16 and runs the wdqmm kernel (in-kernel unpack and
dequantize, f32 accumulation). The output is cast to the input's dtype.
Weight layout is PULP-NN's filter-major (d_out, d_in): the contraction axis
is the packed axis.

Cast points mirror the reference exactly: the input is cast to f32 before
quantizing, the bias is added in f32, then the result is cast to the input
dtype. The QAT training branch of ``linear_apply`` is not ported yet.

Mixture-of-Experts layers hold E linears stacked on a leading axis
(``experts_init``: (E, d_out, d_in) weights, (E,) ``eps_w`` and ``beta``,
what the reference's ``jax.vmap`` of ``linear_init`` gives);
``experts_apply`` quantizes each expert's rows against its own ``beta``
and runs every expert in ONE mpmm launch (the reference vmaps
``linear_apply``, one Pallas call with an expert grid axis).
"""

from __future__ import annotations

import torch

from repro_torch.core import pack as P
from repro_torch.core import quant as Q
from repro_torch.core.policy import LayerPrecision
from repro_torch.kernels import ops


def linear_init(gen: torch.Generator, d_in: int, d_out: int, lp: LayerPrecision, *,
                bias: bool = False, mode: str = "serve", device,
                dtype=torch.float32) -> dict:
    """Params for one linear, drawn from ``gen``. ``serve`` mode gives a
    quantized layer packed placeholder weights (what a converted checkpoint
    holds); ``train`` mode, and any unquantized layer, a float ``w`` in
    ``dtype``. The default is ``serve`` (the reference's is ``train``):
    every serving caller wants the packed form."""
    if mode not in ("serve", "train"):
        raise ValueError(f"mode must be 'serve' or 'train', got {mode!r}")
    std = 1.0 / (d_in**0.5)
    p: dict = {}
    if mode == "serve" and lp.quantized:
        rw = P.pack_ratio(lp.w_bits)
        if d_in % rw:
            raise ValueError(f"d_in={d_in} not divisible by pack ratio {rw}")
        spec = Q.WGT_SPECS[lp.w_bits]
        wq = torch.randint(-127, 128, (d_out, d_in), generator=gen, dtype=torch.int8,
                           device=device)
        p["w_packed"] = P.pack(torch.clamp(wq, spec.qmin, spec.qmax), lp.w_bits)
        p["eps_w"] = torch.tensor(std * 2.0 / spec.qmax, dtype=torch.float32, device=device)
    else:
        w = torch.randn((d_out, d_in), generator=gen, dtype=torch.float32, device=device)
        p["w"] = (w * std).to(dtype)
    if lp.act_quantized:
        p["beta"] = torch.tensor(6.0, dtype=torch.float32, device=device)
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def linear_apply(params: dict, x: torch.Tensor, lp: LayerPrecision, *,
                 impl: ops.Impl = "auto") -> torch.Tensor:
    """y = x @ W^T (+ b) under the layer's precision (serve mode)."""
    out_dtype = x.dtype
    *lead, d_in = x.shape
    x2 = x.reshape(-1, d_in)
    if not lp.quantized:
        w = params.get("w")
        if w is None:
            raise ValueError("params lack 'w'; converted for serving only")
        y = x2.to(torch.float32) @ w.to(torch.float32).T
    else:
        if "w_packed" in params:
            w_p, eps_w = params["w_packed"], params["eps_w"]
        else:  # on-the-fly conversion (tests / small models)
            wq, eps_w = Q.quantize_weight(params["w"].to(torch.float32), lp.w_bits)
            w_p = P.pack(wq, lp.w_bits)
        if lp.act_quantized:
            xq, eps_x = Q.quantize_act_signed(x2.to(torch.float32), params["beta"], lp.x_bits)
            x_p = P.pack(xq, lp.x_bits)
            y = ops.mpmm(x_p, w_p, None, x_bits=lp.x_bits, w_bits=lp.w_bits, y_bits=8,
                         x_signed=True, out_kind="f32", out_scale=eps_x * eps_w, impl=impl)
        else:  # weight-only: bf16 activations, in-kernel unpack and dequantize
            y = ops.wdqmm(x2, w_p, eps_w, w_bits=lp.w_bits, impl=impl)
    if "b" in params:
        y = y + params["b"]
    return y.to(out_dtype).reshape(*lead, -1)


def _expert_chunk(d_out: int, d_in: int) -> int:
    """Experts drawn at once by ``experts_init``: packing holds int32
    copies of the codes, so a chunk keeps them near 256 MiB (DeepSeek-V3's
    256 experts of 2048 x 7168 would take 15 GB a projection at once)."""
    return max(1, (1 << 26) // (d_out * d_in))


def experts_init(gen: torch.Generator, n_experts: int, d_in: int, d_out: int,
                 lp: LayerPrecision, *, mode: str = "serve", device,
                 dtype=torch.float32) -> dict:
    """Batched expert weights, one QuantizedLinear per expert: ``serve``
    mode packs int8 codes drawn directly (no float weights, on the card or
    off it) into (E, d_out, d_in / rw) with (E,) ``eps_w``; ``train`` mode
    and an unquantized class give a float (E, d_out, d_in) ``w``. A fully
    quantized class carries an (E,) ``beta``."""
    if mode not in ("serve", "train"):
        raise ValueError(f"mode must be 'serve' or 'train', got {mode!r}")
    std = 1.0 / (d_in**0.5)
    E = n_experts
    p: dict = {}
    if mode == "serve" and lp.quantized:
        rw = P.pack_ratio(lp.w_bits)
        if d_in % rw:
            raise ValueError(f"d_in={d_in} not divisible by pack ratio {rw}")
        spec = Q.WGT_SPECS[lp.w_bits]
        w_p = torch.empty((E, d_out, d_in // rw), dtype=torch.int8, device=device)
        step = _expert_chunk(d_out, d_in)
        for e0 in range(0, E, step):
            n = min(step, E - e0)
            wq = torch.randint(-127, 128, (n, d_out, d_in), generator=gen, dtype=torch.int8,
                               device=device)
            w_p[e0:e0 + n] = P.pack(torch.clamp(wq, spec.qmin, spec.qmax), lp.w_bits)
        p["w_packed"] = w_p
        p["eps_w"] = torch.full((E,), std * 2.0 / spec.qmax, dtype=torch.float32,
                                device=device)
    else:
        w = torch.randn((E, d_out, d_in), generator=gen, dtype=torch.float32, device=device)
        p["w"] = (w * std).to(dtype)
    if lp.act_quantized:
        p["beta"] = torch.full((E,), 6.0, dtype=torch.float32, device=device)
    return p


def experts_apply(params: dict, x: torch.Tensor, lp: LayerPrecision, *,
                  impl: ops.Impl = "auto") -> torch.Tensor:
    """Per-expert linear (E, C, d_in) -> (E, C, d_out) in x's dtype, serve
    mode: each expert's rows are quantized against its own ``beta``, scaled
    by its own ``eps_x * eps_w``, and the E products are ONE mpmm launch.
    Weight-only expert layers are not ported (the reference runs a vmapped
    wdqmm there): they raise, and ``models.model`` refuses such a policy
    before any weight is drawn."""
    out_dtype = x.dtype
    E = x.shape[0]
    if not lp.quantized:
        w = params.get("w")
        if w is None:
            raise ValueError("params lack 'w'; converted for serving only")
        y = torch.bmm(x.to(torch.float32), w.to(torch.float32).transpose(1, 2))
        return y.to(out_dtype)
    if not lp.act_quantized:
        raise NotImplementedError(
            f"weight-only expert layers (w{lp.w_bits}, bf16 activations) are not ported: "
            "serve the experts fully quantized")
    if "w_packed" in params:
        w_p, eps_w = params["w_packed"], params["eps_w"]
    else:  # on-the-fly conversion (tests / small models), expert by expert
        conv = _convert_stacked(params["w"], lp)
        w_p, eps_w = conv["w_packed"], conv["eps_w"]
    xq, eps_x = Q.quantize_act_signed(x.to(torch.float32), params["beta"].reshape(E, 1, 1),
                                      lp.x_bits)
    y = ops.mpmm(P.pack(xq, lp.x_bits), w_p, None, x_bits=lp.x_bits, w_bits=lp.w_bits,
                 y_bits=8, x_signed=True, out_kind="f32",
                 out_scale=eps_x.reshape(E) * eps_w.reshape(E), impl=impl)
    return y.to(out_dtype)


def convert_linear_to_serving(params: dict, lp: LayerPrecision) -> dict:
    """Fold trained weights into the packed integer representation."""
    if not lp.quantized or "w" not in params:
        return params
    wq, eps_w = Q.quantize_weight(params["w"].to(torch.float32), lp.w_bits)
    out = {k: v for k, v in params.items() if k != "w"}
    out["w_packed"] = P.pack(wq, lp.w_bits)
    out["eps_w"] = eps_w.to(torch.float32)
    return out


#: path-name -> policy layer class (the reference's table)
_NAME_TO_CLASS = {
    "wq": "attn_qkv", "wk": "attn_qkv", "wv": "attn_qkv",
    "wq_a": "attn_qkv", "wq_b": "attn_qkv", "wkv_a": "attn_qkv",
    "wkv_b": "attn_qkv", "wr": "attn_qkv", "wg": "attn_qkv",
    "wo": "attn_out",
    "up": "ffn_in", "gate": "ffn_in", "ck": "ffn_in", "cr": "ffn_in",
    "down": "ffn_out", "cv": "ffn_out",
    "in_proj": "ssm_proj", "out_proj": "ssm_proj",
    "router": "router", "head": "head", "patch_proj": "embed",
    "mtp_proj": "head",
}


def layer_class(name: str, owner: str):
    """The policy class of the linear stored under ``name`` in the dict
    stored under ``owner``; None when ``name`` holds no linear. A MoE
    node's own ``gate`` / ``up`` / ``down`` are its experts, class
    ``expert`` (the reference's walks class them by name as ``ffn_in`` /
    ``ffn_out``, which breaks a policy where the classes differ: ROADMAP
    Queue 3 item 12); its shared expert's are an MLP's."""
    if owner == "moe" and name in ("gate", "up", "down"):
        return "expert"
    return _NAME_TO_CLASS.get(name)


def _convert_stacked(w: torch.Tensor, lp: LayerPrecision) -> dict:
    """``convert_linear_to_serving`` of each (d_out, d_in) matrix of ``w``,
    stacked back on ``w``'s leading axes (scan-stacked layers, experts)."""
    lead = w.shape[:-2]
    if not lead:
        return convert_linear_to_serving({"w": w}, lp)
    parts = [convert_linear_to_serving({"w": m}, lp) for m in w.reshape(-1, *w.shape[-2:])]
    return {k: torch.stack([p[k] for p in parts]).reshape(*lead, *parts[0][k].shape)
            for k in parts[0]}


def convert_model_to_serving(params: dict, policy) -> dict:
    """Checkpoint conversion: fold every QAT-trained linear of a model's
    param tree into its packed integer form under ``policy``. A linear is a
    dict holding ``w`` under a name :func:`layer_class` knows; its ``b`` and
    ``beta`` are kept. A ``w`` with leading axes (stacked layers, experts)
    converts matrix by matrix. Everything else (norms, embeddings) passes
    through unchanged."""

    def walk(node, parent="", owner=""):
        if isinstance(node, dict):
            cls = layer_class(parent, owner)
            if "w" in node and cls is not None:
                lp = policy.of(cls)
                if not lp.quantized:
                    return node
                keep = {k: v for k, v in node.items() if k not in ("w", "b", "beta")}
                out = {**keep, **_convert_stacked(node["w"], lp)}
                for k in ("b", "beta"):
                    if k in node:
                        out[k] = node[k]
                return out
            return {k: walk(v, k, parent) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, parent, owner) for v in node]
        return node

    return walk(params)
