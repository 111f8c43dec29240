"""Host/device boundary discipline for the serving loop (counterpart of
``repro.serve.boundary``, ``host_copy`` only).

``torch.from_numpy`` shares the numpy buffer, and a host-to-device copy may
complete after the call returns. Every host-side numpy value that is both
fed to a device step and mutated by the serving loop afterwards (slot
positions, block tables) crosses the boundary through :func:`host_copy`,
which snapshots it into a private buffer first.
"""

from __future__ import annotations

import numpy as np
import torch


def host_copy(a, device) -> torch.Tensor:
    """Snapshot host state into a tensor on ``device``; the caller may keep
    mutating ``a``."""
    return torch.from_numpy(np.array(a, copy=True)).to(device)
