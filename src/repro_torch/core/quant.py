"""Layer-wise linear quantization math, serving subset (PyTorch counterpart
of ``repro.core.quant``).

Contract (Bruschi et al., CF'20, Eq. 1-3):
  t = alpha_t + eps_t * INT(t),   eps_t = (beta_t - alpha_t) / 2^N
  activations / outputs: unsigned, alpha = 0       -> INT in [0, 2^N)
  weights:               signed, symmetric          -> INT in [-2^(N-1), 2^(N-1))
  accumulator phi = linear(INT(w), INT(x)):         int32, always

Requantization (Eq. 3) has two integer-exact realizations: the threshold
ladder for ``y_bits in {2, 4}`` and shift-and-clamp for ``y_bits == 8``.
Their parameters are folded host-side in float64 (numpy), so the device path
is pure int32.

``round(x / eps)`` stays a division, never a reciprocal multiply, and
``torch.round`` is half-to-even like ``jnp.round``: quantized integers match
the reference bit for bit. The QAT fake-quant code is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

SUPPORTED_BITS = (2, 4, 8)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of one quantized tensor's integer grid."""

    bits: int
    signed: bool

    def __post_init__(self):
        if self.bits not in SUPPORTED_BITS:
            raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {self.bits}")

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1)) if self.signed else 0

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1 if self.signed else (1 << self.bits) - 1

    @property
    def levels(self) -> int:
        return 1 << self.bits

    def scale_from_range(self, beta: float, alpha: float = 0.0) -> float:
        """eps_t = (beta - alpha) / 2^N (paper Eq. 1). Symmetric signed uses
        [-beta, beta) => eps = beta / 2^(N-1)."""
        if self.signed:
            return float(beta) / float(1 << (self.bits - 1))
        return (float(beta) - float(alpha)) / float(self.levels)


ACT_SPECS = {b: QuantSpec(b, signed=False) for b in SUPPORTED_BITS}
WGT_SPECS = {b: QuantSpec(b, signed=True) for b in SUPPORTED_BITS}


@dataclasses.dataclass(frozen=True)
class RequantParams:
    """Folded (kappa, lambda, eps_phi, eps_y) for one layer, device-ready.

    ``thresholds``: int32 [2^Ny - 1] ascending (sub-byte ladder path).
    ``shift``/``bias``: 8-bit path, y = clip((phi + bias) >> shift).
    """

    y_bits: int
    thresholds: np.ndarray  # int32 [2^Ny - 1]
    shift: int
    bias: int
    mult: float  # kappa * eps_phi / eps_y
    addend: float  # lambda * eps_phi / eps_y


def make_requant_params(
    *,
    y_bits: int,
    kappa: float = 1.0,
    lam: float = 0.0,
    eps_phi: float,
    eps_y: float,
    rounding: bool = False,
) -> RequantParams:
    """Fold Eq. 3 into device-ready integer parameters (host-side, float64)."""
    if y_bits not in SUPPORTED_BITS:
        raise ValueError(f"y_bits must be in {SUPPORTED_BITS}")
    kappa = float(kappa)
    lam = float(lam)
    r = np.float64(eps_phi) / np.float64(eps_y)
    mult = np.float64(kappa) * r
    addend = np.float64(lam) * r
    if mult <= 0:
        raise ValueError("requant multiplier must be positive")
    n_thresh = (1 << y_bits) - 1
    # y >= i+1  <=>  phi >= ((i+1)/r - lam)/kappa: the smallest such integer
    ks = np.arange(1, n_thresh + 1, dtype=np.float64)
    raw = (ks / r - lam) / kappa
    thresholds = np.ceil(raw - 1e-12).astype(np.int64)
    thresholds = np.clip(thresholds, np.iinfo(np.int32).min, np.iinfo(np.int32).max)
    thresholds = thresholds.astype(np.int32)
    # 8-bit path: the requant scale snapped to a power of two (PULP-NN)
    shift = int(np.clip(np.round(-np.log2(mult)), 0, 31))
    bias = int(np.round(addend * np.float64(1 << shift)))
    if rounding and shift > 0:
        bias += (1 << shift) // 2
    return RequantParams(
        y_bits=y_bits,
        thresholds=thresholds,
        shift=shift,
        bias=bias,
        mult=float(mult),
        addend=float(addend),
    )


def requant_ladder(phi: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Threshold ladder: INT(y) = sum_i [phi >= T_i]. Pure int32."""
    phi = phi.to(torch.int32)
    t = thresholds.to(device=phi.device, dtype=torch.int32)
    y = torch.zeros(phi.shape, dtype=torch.int32, device=phi.device)
    for i in range(t.shape[0]):
        y = y + (phi >= t[i]).to(torch.int32)
    return y.to(torch.uint8)


def requant_shift(phi: torch.Tensor, shift: int, bias: int, y_bits: int) -> torch.Tensor:
    """Shift-and-clamp: y = clip((phi + bias) >> shift). Pure int32."""
    phi = phi.to(torch.int32)
    y = (phi + bias) >> shift  # arithmetic shift: floor division by 2^shift
    y = torch.clamp(y, 0, (1 << y_bits) - 1)
    return y.to(torch.uint8)


def requant(phi: torch.Tensor, params: RequantParams, *,
            ladder: Optional[bool] = None) -> torch.Tensor:
    """Canonical dispatch: ladder for sub-byte, shift-and-clamp for 8-bit."""
    use_ladder = (params.y_bits < 8) if ladder is None else ladder
    if use_ladder:
        return requant_ladder(phi, torch.from_numpy(params.thresholds.copy()))
    return requant_shift(phi, params.shift, params.bias, params.y_bits)


def quantize_weight(w: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric integer weights. Returns (int8 values, eps scale)."""
    spec = WGT_SPECS[bits]
    beta = torch.clamp(torch.max(torch.abs(w)), min=1e-8)
    eps = beta / (1 << (bits - 1))
    q = torch.clamp(torch.round(w / eps), spec.qmin, spec.qmax).to(torch.int8)
    return q, eps


def _f32_scalar(beta, device) -> torch.Tensor:
    if isinstance(beta, torch.Tensor):
        return beta.to(device=device, dtype=torch.float32)
    return torch.tensor(beta, dtype=torch.float32, device=device)


def quantize_act(x: torch.Tensor, beta, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Unsigned activation quantization against a known clip range beta."""
    spec = ACT_SPECS[bits]
    eps = _f32_scalar(beta, x.device) / spec.levels
    q = torch.clamp(torch.round(x / eps), spec.qmin, spec.qmax).to(torch.uint8)
    return q, eps


def quantize_act_signed(x: torch.Tensor, beta, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed activation quantization (LM hidden states), stored offset-binary
    (q + 2^(b-1)) as uint8 so the packed layout matches the unsigned kernels
    (the kernel subtracts the offset). ``beta`` is a scalar, or a tensor
    that broadcasts against ``x`` (the experts' (E, 1, 1): one clip range
    an expert, as the reference's vmap gives them); eps has its shape."""
    half = 1 << (bits - 1)
    eps = _f32_scalar(beta, x.device) / half
    q = torch.clamp(torch.round(x / eps), -half, half - 1)
    return (q + half).to(torch.uint8), eps
