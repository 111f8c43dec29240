"""Sweep all 27 precision permutations on the paper's Reference Layer:
verify each against the oracle and report quantization error vs the float
layer, the CMix-NN-style accuracy/footprint trade-off table (counterpart of
``examples/mixed_precision_sweep.py``, with its seeded inputs and its
prints).

Run: PYTHONPATH=src python -m repro_torch.examples.mixed_precision_sweep [--device cpu]

On the card (the default) every cell runs the hand-written CUDA conv kernel
and is held bit for bit against its plain PyTorch version on the same
inputs; with ``--device cpu`` the plain version runs. The float layer is
computed on the host in numpy, as in the reference script.
"""

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import REFCONV
from repro_torch.core import pack as P
from repro_torch.core import quant as Q
from repro_torch.core.policy import PERMUTATIONS, perm_name
from repro_torch.examples import device_arg
from repro_torch.examples.quickstart import float_conv
from repro_torch.kernels import ops, ref


def main(device=None) -> list:
    """Returns one dict per permutation: name, bits, the packed operands,
    requant parameters and ofmap (on ``device``), mean error and packed
    bytes."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    H, W = REFCONV.H, REFCONV.W
    C, Cout = REFCONV.C_in, REFCONV.C_out
    x = np.abs(rng.randn(H, W, C)).astype(np.float32)
    w = (rng.randn(Cout, 9 * C) * 0.1).astype(np.float32)
    beta_y = 8.0
    y_f = np.clip(float_conv(x, w), 0, beta_y).reshape(H, W, Cout)
    xt, wt = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)

    rows = []
    print(f"{'kernel':24s} {'bytes':>6s} {'vs fp32':>8s} {'mean|err|':>10s}")
    for x_bits, w_bits, y_bits in PERMUTATIONS:
        beta_x = float(x.max()) * 1.001
        x_p, eps_x = ops.quantize_pack_act(xt, beta_x, x_bits)
        w_p, eps_w = ops.quantize_pack_weight(wt, w_bits)
        eps_y = Q.ACT_SPECS[y_bits].scale_from_range(beta_y)
        rq = ops.make_rq(y_bits=y_bits, eps_phi=float(eps_x * eps_w), eps_y=float(eps_y))
        bits = dict(x_bits=x_bits, w_bits=w_bits, y_bits=y_bits)
        y_p = ops.conv2d(x_p, w_p, rq, **bits)
        want = ref.conv2d_ref(x_p, w_p, rq, **bits)
        assert torch.equal(y_p, want), "oracle mismatch"
        y = (P.unpack(y_p, y_bits, signed=False).to(torch.float32) * float(eps_y)).cpu().numpy()
        err = float(np.mean(np.abs(y.reshape(H, W, Cout) - y_f)))
        nbytes = x_p.numel() + w_p.numel() + y_p.numel()
        fp = x.nbytes + w.nbytes + y_f.nbytes
        name = perm_name(x_bits, w_bits, y_bits)
        print(f"{name:24s} {nbytes:6d} {fp / nbytes:7.1f}x {err:10.4f}")
        rows.append({"name": name, "bits": bits, "x_p": x_p, "w_p": w_p, "rq": rq, "y_p": y_p,
                     "err": err, "bytes": nbytes})
    print("all 27 permutations bit-exact vs oracle")
    return rows


if __name__ == "__main__":
    main(device_arg(__doc__.splitlines()[0]))
