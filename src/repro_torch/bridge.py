"""Bridge between the reference's parameter tree (the layout of its
checkpoints) and KV caches and the port's tensors.

Input is the reference's tree with every leaf a numpy array (nested dicts
and lists; the caller converts with ``np.array(x, copy=True)``) or a tensor
(as ``checkpoint.store.load`` returns them). The bridge copies every numpy
leaf once more before handing it to torch, so no tensor ever aliases a
buffer another framework owns. bf16 numpy leaves arrive as ml_dtypes
``bfloat16`` arrays, which ``torch.from_numpy`` rejects: they cross as
uint16 bit patterns and are viewed as ``torch.bfloat16``. Tensor leaves are
moved to the device as they are (a layer's leaf is then a view of its
group's stacked tensor).

The reference stacks each scan group's layers on a leading axis (its groups
are the contiguous runs of one layer kind, ``model._scan_groups``); the
bridge unstacks them into the port's per-layer list, and
``params_to_reference`` stacks them back. Scan groups of every layer kind
(``dense``, ``moe``, ``mla_dense``, ``mla_moe``) unstack the same way: a
MoE group's (count, E, ...) expert leaves become each layer's (E, ...);
the MTP params (``mtp_block``, ``mtp_proj``, ``mtp_norm``) are single trees
and cross as they are.

Like every entry point of the port, ``device=None`` means CUDA (raising on
a host without it); pass ``device="cpu"`` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import _scan_groups


def to_tensor(a, device=None) -> torch.Tensor:
    """One numpy leaf -> a tensor on ``device`` that owns its memory; a
    tensor leaf -> the same tensor on ``device``."""
    device = resolve_device(device)
    if isinstance(a, torch.Tensor):
        return a.to(device)
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


def _stack(layers: list):
    """One tree per layer -> one tree with its leaves stacked on axis 0."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([layer[i] for layer in layers]) for i in range(len(first))]
    return torch.stack(layers)


def _leading(tree) -> int:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.shape[0]


_PASSED = ("mtp_block", "mtp_proj", "mtp_norm")


def params_from_reference(ref: dict, device=None) -> dict:
    """The reference's params (numpy or tensor leaves, serve or train mode)
    -> the port's params: ``embed``, ``final_norm``, ``head``, a per-layer
    list, and the MTP params where the reference has them."""
    device = resolve_device(device)
    conv = lambda a: to_tensor(a, device)  # noqa: E731
    out = {
        "embed": _tree(ref["embed"], conv),
        "final_norm": _tree(ref["final_norm"], conv),
        "head": _tree(ref["head"], conv),
        "layers": [_tree(layer, conv) for layer in _unstack(ref["blocks"], _leading)],
    }
    for key in _PASSED:
        if key in ref:
            out[key] = _tree(ref[key], conv)
    return out


def params_to_reference(params: dict, cfg) -> dict:
    """The port's params -> the reference's layout (its checkpoints' keys):
    ``layers`` stacked into ``blocks``, one tree a scan group of ``cfg``
    (leaves ``torch.stack``-ed on their own device: a meta tree stays
    meta); ``embed``, ``final_norm``, ``head`` and the MTP params passed
    through."""
    layers, blocks, i = params["layers"], [], 0
    for _, count in _scan_groups(cfg):
        blocks.append(_stack(layers[i:i + count]))
        i += count
    if i != len(layers):
        raise ValueError(f"{len(layers)} layers in params, {i} in {cfg.name}'s scan groups")
    out = {k: params[k] for k in ("embed", "final_norm", "head")}
    out["blocks"] = blocks
    out.update({k: params[k] for k in _PASSED if k in params})
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
