"""Quickstart: the paper's Reference Layer through the port's mixed-precision
library (quantize -> packed conv (im2col + MatMul + QntPack) -> dequantize),
validated against the float conv (counterpart of ``examples/quickstart.py``,
with its seeded inputs and its prints).

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card (the default) the conv is the hand-written CUDA kernel; with
``--device cpu`` it is its plain PyTorch version. The float conv it is
checked against runs on the host in numpy, so both devices print the same
error.
"""

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import REFCONV
from repro_torch.core import pack as P
from repro_torch.core import quant as Q
from repro_torch.examples import device_arg
from repro_torch.kernels import ops

H, W = REFCONV.H, REFCONV.W
C_IN, C_OUT = REFCONV.C_in, REFCONV.C_out
X_BITS, W_BITS, Y_BITS = 8, 4, 4  # one of the 27 permutations


def float_conv(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The float Reference Layer, (H*W, Cout) f32: im2col of the zero-padded
    ifmap times the weights, on the host."""
    h, wd = x.shape[:2]
    xpad = np.pad(x, ((1, 1), (1, 1), (0, 0)))
    cols = np.stack(
        [np.stack([xpad[dy:dy + h, dx:dx + wd, :] for dx in range(3)], 2)
         for dy in range(3)], 2).reshape(h * wd, -1)
    return cols @ w.T


def main(device=None) -> dict:
    """Returns the packed ofmap (on ``device``), the mean error and eps_y."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    x = np.abs(rng.randn(H, W, C_IN)).astype(np.float32)  # post-ReLU
    w = rng.randn(C_OUT, 9 * C_IN).astype(np.float32) * np.float32(0.1)

    # 1. quantize + pack (the paper's storage format)
    beta_x = float(x.max()) * 1.001
    x_p, eps_x = ops.quantize_pack_act(torch.from_numpy(x).to(dev), beta_x, X_BITS)
    w_p, eps_w = ops.quantize_pack_weight(torch.from_numpy(w).to(dev), W_BITS)
    print(f"ifmap  {x.nbytes}B fp32 -> {x_p.numel()}B packed u{X_BITS} "
          f"({x.nbytes / x_p.numel():.0f}x)")
    print(f"weights {w.nbytes}B fp32 -> {w_p.numel()}B packed i{W_BITS} "
          f"({w.nbytes / w_p.numel():.0f}x)")

    # 2. fold the requantization (Eq. 3) for the chosen ofmap precision
    eps_phi = float(eps_x * eps_w)
    beta_y = 8.0  # calibrated ofmap range
    eps_y = Q.ACT_SPECS[Y_BITS].scale_from_range(beta_y)
    rq = ops.make_rq(y_bits=Y_BITS, eps_phi=eps_phi, eps_y=eps_y)
    print(f"requant: {len(rq.thresholds)} thresholds (2^{Y_BITS}-1 ladder)")

    # 3. the packed conv (the CUDA kernel on the card; its plain version on CPU)
    y_p = ops.conv2d(x_p, w_p, rq, x_bits=X_BITS, w_bits=W_BITS, y_bits=Y_BITS)
    print(f"ofmap packed: {tuple(y_p.shape)} int8 ({y_p.numel()}B)")

    # 4. dequantize and compare against the float conv
    y = (P.unpack(y_p, Y_BITS, signed=False).to(torch.float32) * eps_y).cpu().numpy()
    y_ref = np.clip(float_conv(x, w), 0, beta_y - eps_y).reshape(H, W, C_OUT)
    err = float(np.mean(np.abs(y - y_ref)))
    print(f"mean |quantized - float| = {err:.4f} (eps_y = {eps_y:.4f})")
    assert err < 3 * eps_y, "quantized conv diverged from float reference"
    print("OK — mixed-precision conv matches the float layer within quant noise")
    return {"y_p": y_p, "err": err, "eps_y": eps_y}


if __name__ == "__main__":
    main(device_arg(__doc__.splitlines()[0]))
