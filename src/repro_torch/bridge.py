"""Bridge from the reference's parameter tree and KV caches to the port's
tensors.

Input is the reference's tree with every leaf already a numpy array (nested
dicts and lists; the caller converts with ``np.array(x, copy=True)``). The
bridge copies every leaf once more before handing it to torch, so no tensor
ever aliases a buffer another framework owns. bf16 leaves arrive as
ml_dtypes ``bfloat16`` arrays, which ``torch.from_numpy`` rejects: they
cross as uint16 bit patterns and are viewed as ``torch.bfloat16``.

The reference stacks each scan group's layers on a leading axis; the bridge
unstacks them into the port's per-layer list. Scan groups of GQA layers
(kind ``dense``) and of MLA layers (kind ``mla_dense``) both unstack the
same way; the MTP params (``mtp_block``, ``mtp_proj``, ``mtp_norm``) are
single trees and cross as they are.

Like every entry point of the port, ``device=None`` means CUDA (raising on
a host without it); pass ``device="cpu"`` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def to_tensor(a, device=None) -> torch.Tensor:
    """One numpy leaf -> a tensor on ``device`` that owns its memory."""
    device = resolve_device(device)
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor -> numpy; bf16 comes back as ml_dtypes ``bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, fn) for v in node]
    return fn(node)


def _unstack(groups: list, count_of) -> list:
    """Scan groups with leaves stacked on axis 0 -> one tree per layer."""
    layers = []
    for g in groups:
        for i in range(count_of(g)):
            layers.append(_tree(g, lambda a, i=i: a[i]))
    return layers


def _leading(tree) -> int:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.shape[0]


def params_from_reference(ref: dict, device=None) -> dict:
    """The reference's serve-mode params (numpy leaves) -> the port's
    params: ``embed``, ``final_norm``, ``head``, a per-layer list, and the
    MTP params where the reference has them."""
    device = resolve_device(device)
    conv = lambda a: to_tensor(a, device)  # noqa: E731
    out = {
        "embed": _tree(ref["embed"], conv),
        "final_norm": _tree(ref["final_norm"], conv),
        "head": _tree(ref["head"], conv),
        "layers": [_tree(layer, conv) for layer in _unstack(ref["blocks"], _leading)],
    }
    for key in ("mtp_block", "mtp_proj", "mtp_norm"):
        if key in ref:
            out[key] = _tree(ref[key], conv)
    return out


def caches_from_reference(ref: list, device=None) -> list:
    """The reference's caches (a list of scan groups: a GQA group is
    ``{"self": {leaf: (count, ...)}}``, an MLA group ``{"c", "c_s", "r"}``
    with no ``"self"`` level) -> the port's per-layer list of
    ``{leaf: tensor}``."""
    device = resolve_device(device)
    return [_tree(layer.get("self", layer), lambda a: to_tensor(a, device))
            for layer in _unstack(ref, _leading)]


def caches_to_numpy(caches: list) -> list:
    """The port's per-layer caches -> numpy, for comparisons."""
    return [{k: to_numpy(v) for k, v in layer.items()} for layer in caches]
