"""QuantizedLinear, serve mode (counterpart of ``repro.core.linear``).

The integer serving path: weights live PACKED sub-byte in device memory,
activations are quantized (signed, offset-binary storage), the matmul is the
mpmm kernel (int32 accumulation), and the output is dequantized to the
input's dtype. Weight layout is PULP-NN's filter-major (d_out, d_in): the
contraction axis is the packed axis.

Cast points mirror the reference exactly: the input is cast to f32 before
quantizing, the bias is added in f32, then the result is cast to the input
dtype. The QAT training branch and weight-only (wdqmm) layers are not
ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.core import pack as P
from repro_torch.core import quant as Q
from repro_torch.core.policy import LayerPrecision
from repro_torch.kernels import ops


def linear_init(gen: torch.Generator, d_in: int, d_out: int, lp: LayerPrecision, *,
                bias: bool = False, device, dtype=torch.float32) -> dict:
    """Serve-mode params for one linear: packed placeholder weights drawn
    from ``gen`` (what a converted checkpoint holds), or float weights for
    an unquantized layer."""
    std = 1.0 / (d_in**0.5)
    p: dict = {}
    if lp.quantized:
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
    elif not lp.act_quantized:
        raise NotImplementedError(
            "weight-only layers need the wdqmm kernel, which the port does not have yet")
    else:
        if "w_packed" in params:
            w_p, eps_w = params["w_packed"], params["eps_w"]
        else:  # on-the-fly conversion (tests / small models)
            wq, eps_w = Q.quantize_weight(params["w"].to(torch.float32), lp.w_bits)
            w_p = P.pack(wq, lp.w_bits)
        xq, eps_x = Q.quantize_act_signed(x2.to(torch.float32), params["beta"], lp.x_bits)
        x_p = P.pack(xq, lp.x_bits)
        y = ops.mpmm(x_p, w_p, None, x_bits=lp.x_bits, w_bits=lp.w_bits, y_bits=8,
                     x_signed=True, out_kind="f32", out_scale=eps_x * eps_w, impl=impl)
    if "b" in params:
        y = y + params["b"]
    return y.to(out_dtype).reshape(*lead, -1)


def convert_linear_to_serving(params: dict, lp: LayerPrecision) -> dict:
    """Fold trained weights into the packed integer representation."""
    if not lp.quantized or "w" not in params:
        return params
    wq, eps_w = Q.quantize_weight(params["w"].to(torch.float32), lp.w_bits)
    out = {k: v for k, v in params.items() if k != "w"}
    out["w_packed"] = P.pack(wq, lp.w_bits)
    out["eps_w"] = eps_w.to(torch.float32)
    return out
