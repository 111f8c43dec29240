"""Host/device boundary discipline for the serving loop (counterpart of
``repro.serve.boundary``).

``torch.from_numpy`` shares the numpy buffer, and a host-to-device copy may
complete after the call returns. Every host-side numpy value that is both
fed to a device step and mutated by the serving loop afterwards (slot
positions, block tables) crosses the boundary through :func:`host_copy`
(defined in the package root, so the kernels can use it too), which
snapshots it into a private buffer first; on CUDA that buffer is pinned and
the upload does not wait for the card.

:class:`SnapshotRing` is the pipelined form: an engine that keeps several
steps in flight (continuous batching) takes the same snapshots every step.
Each call-site name owns a ring of ``generations`` buffers (pinned host
memory on CUDA); a buffer is rewritten only after ``generations - 1`` newer
takes of its name, so with at most ``k`` steps in flight and ``generations
>= k + 1`` no upload still in flight ever reads a rewritten buffer.
:func:`counting_syncs` counts what in a block of code makes the host wait
for the card.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from repro_torch import host_copy

__all__ = ["SnapshotRing", "counting_syncs", "host_copy"]


class SnapshotRing:
    """N-buffered host-to-device snapshots, one ring per call-site name.

    ``take(name, a)`` behaves like :func:`host_copy` but recycles buffers:
    successive takes of ``name`` cycle through ``generations`` host buffers
    (pinned on CUDA, where the take is a ``non_blocking`` copy into a device
    buffer of the same generation and never synchronises; on the CPU the
    returned tensor is the private host buffer itself). One ring per name,
    not per shape: two same-shaped vectors of one step (temperatures and
    top-p) never share a buffer. A shape or dtype change reallocates."""

    def __init__(self, generations: int, device="cpu"):
        if generations < 2:
            raise ValueError(f"need >= 2 generations, got {generations}")
        self.generations = int(generations)
        self.device = torch.device(device)
        self._rings: dict[str, list] = {}
        self._idx: dict[str, int] = {}

    def _fresh(self, a: np.ndarray):
        host = torch.from_numpy(np.array(a, copy=True))
        if self.device.type != "cuda":
            return host, host
        host = host.pin_memory()
        return host, torch.empty(host.shape, dtype=host.dtype, device=self.device)

    def take(self, name: str, a) -> torch.Tensor:
        a = np.asarray(a)
        ring = self._rings.setdefault(name, [])
        if len(ring) < self.generations:  # still growing: a fresh pair
            ring.append(self._fresh(a))
            i = self._idx[name] = len(ring) - 1
            host, dev = ring[i]
        else:
            i = self._idx[name] = (self._idx[name] + 1) % len(ring)
            host, dev = ring[i]
            if tuple(host.shape) != a.shape or host.numpy().dtype != a.dtype:
                host, dev = ring[i] = self._fresh(a)
            else:
                np.copyto(host.numpy(), a)
        if dev is not host:
            dev.copy_(host, non_blocking=True)
        return dev


@contextlib.contextmanager
def counting_syncs():
    """Record every operation inside the block that synchronises the host
    with a CUDA device (PyTorch's sync debug mode at "warn": a blocking
    copy, ``.item()``, a ``nonzero``, a stream or device synchronize).
    Yields a list that receives, on exit, one ``"file:line: message"`` per
    synchronising call. A CUDA event's ``synchronize`` is not among them."""
    got: list[str] = []
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield got
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    got.extend(f"{w.filename}:{w.lineno}: {w.message}" for w in seen
               if "called a synchronizing CUDA operation" in str(w.message))
