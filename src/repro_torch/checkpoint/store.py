"""Fault-tolerant checkpointing (counterpart of ``repro.checkpoint.store``):
atomic directory commit, async background save, preemption hook. The files
are the reference's, so either package loads what the other saved.

Layout:  <root>/step_<N>/arrays_proc<k>.npz + manifest.json
``k`` is the process's rank under ``torch.distributed`` (0 for a single
process); ``load`` merges every ``arrays_proc*.npz``. The manifest is
``{"step": N, "leaves": {key: {"shape", "dtype"}}}`` with each leaf's
logical dtype; a dtype outside numpy's plain set (bfloat16, float8) is
stored as a bit view of its width (uint16 or uint8), as the reference
stores it. bf16 crosses as int16 bits both ways: neither ``save`` nor
``load`` needs ``ml_dtypes``.

Commit protocol: write into <root>/.tmp_<N>, fsync, os.replace -> step_<N>.
Incomplete saves are invisible; ``latest_step`` only sees committed dirs.

A tree is nested dicts, lists and tuples (``None`` holds no leaf) whose
leaves are tensors on any device, numpy arrays or scalars; every leaf is
copied to the host before anything is written. A leaf's key is the
reference's ``_leaf_key``: JAX's ``keystr`` of its path (``['name']`` for a
dict key, ``[i]`` for an index) with every run of characters outside
``[A-Za-z0-9_.]`` turned into ``_`` and ``_`` stripped from both ends,
dicts walked in sorted key order as JAX flattens them. The port's
per-layer params cross in the reference's stacked layout through
``bridge.params_to_reference`` / ``bridge.params_from_reference``.

``load`` takes a target tree whose leaves need only ``.shape`` and
``.dtype``: tensors on ``torch.device("meta")`` (e.g.
``model.init_params(gen, cfg, policy, device="meta")``) are the port's
``jax.eval_shape``. Only the target's leaves are read: ``{"params": ...}``
reads the params out of a train state that also holds ``opt``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device

#: numpy dtypes the reference stores as they are; any other is a bit view
_STORED = (np.float32, np.float64, np.int8, np.uint8, np.int16, np.int32, np.int64, np.bool_,
           np.float16)


def _flatten(tree, path: str = ""):
    """(keystr path, leaf) pairs in JAX's flattening order: a dict's
    entries by sorted key, printed ``['name']``; a list's or tuple's by
    index, printed ``[i]``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _map(fn, tree, path: str = ""):
    """``tree`` with each leaf replaced by ``fn(keystr path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{path}[{i}]") for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def _leaf_key(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.]+", "_", path).strip("_")


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf's bytes on the host as the reference stores them, and its
    logical dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        try:
            leaf = t.numpy()
        except TypeError:  # no numpy dtype (bfloat16, float8): its bits
            bits = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.uint16)}
            if t.dtype.itemsize not in bits:
                raise TypeError(f"cannot store a {t.dtype} leaf") from None
            tbits, nbits = bits[t.dtype.itemsize]
            return t.view(tbits).numpy().view(nbits), str(t.dtype).removeprefix("torch.")
    host = np.asarray(leaf)
    logical = str(host.dtype)
    if host.dtype not in _STORED:
        host = host.view(np.uint16) if host.dtype.itemsize == 2 else host.view(np.uint8)
    return host, logical


def _host_copy(leaf):
    """A private host copy of a leaf: later updates of the live one (in
    place, on any device) do not reach it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _torch_dtype(dt) -> torch.dtype:
    """A target leaf's dtype (torch's, or numpy's by name) as a torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    name = str(np.dtype(dt))
    t = getattr(torch, name, None)
    if not isinstance(t, torch.dtype):
        raise TypeError(f"no torch dtype for {name}")
    return t


def _restore(arr: np.ndarray, logical: str) -> torch.Tensor:
    """The stored array as a tensor of its logical dtype (bits reinterpreted,
    never converted)."""
    if str(arr.dtype) == logical:
        return torch.from_numpy(arr)
    t = getattr(torch, logical, None)
    if isinstance(t, torch.dtype) and t.itemsize == arr.dtype.itemsize:
        ints = {1: np.uint8, 2: np.int16}[arr.dtype.itemsize]  # bf16: int16 bits
        return torch.from_numpy(arr.view(ints)).view(t)
    return torch.from_numpy(arr.view(np.dtype(logical)))


def _process_index() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank()
    return 0


def save(root: str, step: int, tree: Any) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f".tmp_{step}")
    final = os.path.join(root, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)

    arrays = {}
    manifest = {"step": step, "leaves": {}}
    for path, leaf in _flatten(tree):
        key = _leaf_key(path)
        host, logical = _host(leaf)
        arrays[key] = host
        manifest["leaves"][key] = {"shape": list(host.shape), "dtype": logical}
    npz = os.path.join(tmp, f"arrays_proc{_process_index()}.npz")
    with open(npz, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)  # atomic commit
    return final


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(m.group(1)) for d in os.listdir(root)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def load(root: str, target: Any, *, step: Optional[int] = None,
         device=None) -> tuple[Any, int]:
    """Restore into the structure of ``target``: each leaf read from the
    checkpoint, cast to the target leaf's dtype and placed on ``device``
    (None means CUDA, raising on a host without it). Keys the target lacks
    are not read."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = os.path.join(root, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    files = [np.load(os.path.join(d, fn)) for fn in sorted(os.listdir(d))
             if fn.startswith("arrays_proc") and fn.endswith(".npz")]
    where = {key: z for z in files for key in z.files}  # a later file wins

    def leaf(path, ref):
        key = _leaf_key(path)
        if key not in where:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = where[key][key]
        meta = manifest["leaves"].get(key)
        t = _restore(arr, meta["dtype"] if meta else str(arr.dtype))
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {tuple(t.shape)} vs "
                             f"{tuple(ref.shape)}")
        return t.to(_torch_dtype(ref.dtype)).to(device)

    try:
        tree = _map(leaf, target)
    finally:
        for z in files:
            z.close()
    return tree, step


class Checkpointer:
    """Async checkpointer with preemption handling and retention."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._preempted = threading.Event()

    def install_preemption_handler(self, get_state: Callable[[], tuple[int, Any]]):
        """On SIGTERM: write a final synchronous checkpoint before exit."""

        def handler(signum, frame):
            self._preempted.set()
            self.wait()
            step, state = get_state()
            save(self.root, step, state)
            raise SystemExit(143)

        signal.signal(signal.SIGTERM, handler)

    def save_async(self, step: int, tree: Any):
        """Copy every leaf to the host now, then write in a thread."""
        self.wait()
        host_tree = _map(lambda _, a: _host_copy(a), tree)

        def work():
            save(self.root, step, host_tree)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=False)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.root)
            if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"), ignore_errors=True)

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()
