"""PyTorch/CUDA port of the mixed-precision QNN library and its serving
stack. The JAX package ``repro`` is the reference: ``repro_torch/X.py`` is
the counterpart of ``repro/X.py``. This package imports ``torch``, never
``jax`` or ``repro``; its kernels are hand-written CUDA under ``csrc/``.

Entry points take ``device=None``, which means CUDA: they run on the card
unless the caller passes ``device="cpu"`` (where the kernels' plain PyTorch
versions run), and never fall back to the CPU on their own."""

import torch


def resolve_device(device) -> torch.device:
    """``None`` means CUDA; a CUDA device on a host without CUDA raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass device='cpu' to run "
                           "the kernels' plain versions on the CPU")
    return device
