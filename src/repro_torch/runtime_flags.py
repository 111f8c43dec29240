"""Process-wide serving flags (counterpart of ``repro.runtime_flags``).

The port keeps only ``moe_dispatch_bits``: None, or 8 for int8 MoE
dispatch payloads (per-token symmetric scales; serve mode), the one flag
that changes what a model computes. The reference's other flags
(``unroll_scans``, ``flash_chunk``, ``ssm_chunk``, ``causal_skip``) steer
how XLA lowers its scans and chunked loops; eager PyTorch has nothing to
lower, so they have no counterpart here.
"""

from __future__ import annotations

FLAGS = {
    "moe_dispatch_bits": None,  # None | 8
}
