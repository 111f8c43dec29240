"""Speculative decoding: the draft policies of the serving engine
(counterpart of ``repro.serve.spec``).

A round drafts k tokens with a cheap model, scores all k+1 positions in one
``models.model.spec_verify_step`` call of the target, and emits the longest
prefix where draft and target agree plus the target's token at the first
mismatch (the engine's ``_spec_round``); rejected cache rows roll back
through the cache manager's ``truncate`` verb. The verify samples every
offset at the PRNG counter the serialized engine would use for that
emission, from logits over exactly the accepted prefix, so the streams are
the non-speculative engine's (greedy and seeded): the draft moves only the
acceptance rate, never the tokens.

This module owns WHO drafts:

- :class:`SelfDraft` (``spec="self4"``): the target itself with its packed
  weights requantized to 4 bits (a layer already at 4 bits, e.g. under
  ``w4a8``, shares the target's tensors), writing through the target's own
  cache: verify overwrites every draft row before a later read.
- :class:`DraftModel` (``spec="draft"``): a separate small model (default:
  ``configs.reduced`` of the target at the target's vocab, weights drawn
  from a seeded ``torch.Generator``) with a dense cache of its own, which
  mirrors the target's positions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import configs, host_copy
from repro_torch.core import pack as P
from repro_torch.core import quant as Q
from repro_torch.core.linear import layer_class
from repro_torch.core.policy import LayerPrecision, PrecisionPolicy
from repro_torch.kernels import dispatch
from repro_torch.models import model as M
from repro_torch.serve.cache import zero_slot

#: the position of a lane that takes no part in a draft step: its dense
#: cache write is dropped (``attention.row_window``), its paged write lands
#: on the scratch page, and its token is never read
OUT_OF_RANGE = 2**30


def _w4(lp: LayerPrecision) -> LayerPrecision:
    """The 4-bit-weight twin of a layer precision; unquantized layers (the
    bf16 router) keep theirs, and the activation, output and cache widths
    are untouched, so the draft can share the target's cache."""
    if not lp.quantized or lp.w_bits == 4:
        return lp
    return dataclasses.replace(lp, w_bits=4)


def derive_w4_policy(policy: PrecisionPolicy) -> PrecisionPolicy:
    """The self-draft policy: ``policy`` with every quantized layer class at
    4-bit weights and the same ``kv_cache_bits``."""
    return PrecisionPolicy(
        name=f"{policy.name}+self4",
        default=_w4(policy.default),
        per_class={k: _w4(v) for k, v in policy.per_class.items()},
        kv_cache_bits=policy.kv_cache_bits)


def requantize_params_w4(params: dict, policy: PrecisionPolicy) -> dict:
    """Requantize a serving tree's packed weights to 4 bits: unpack each at
    ``policy``'s width, ``clip(round(wq * 7 / qmax_old), -7, 7)`` in f32
    (``torch.round`` rounds half to even, as ``jnp.round``), repack at 4
    bits and scale ``eps_w`` by ``qmax_old / 7``, so the dequantized
    magnitude is kept. The tree is walked as
    ``core.linear.convert_model_to_serving`` walks it (a linear is a dict
    holding ``w_packed`` under a name ``core.linear.layer_class`` knows; a
    MoE node's experts are class ``expert``, their (E,) ``eps_w`` scaled
    alike). Layers already at 4 bits, and unquantized ones, are returned
    as they are: the draft tree holds the target's tensors there."""
    spec4 = Q.WGT_SPECS[4]

    def repack(node: dict, lp: LayerPrecision) -> dict:
        spec_old = Q.WGT_SPECS[lp.w_bits]
        wq = P.unpack(node["w_packed"], lp.w_bits, signed=True)
        wq4 = torch.clamp(torch.round(wq.to(torch.float32) * (spec4.qmax / spec_old.qmax)),
                          spec4.qmin, spec4.qmax).to(torch.int8)
        out = dict(node)
        out["w_packed"] = P.pack(wq4, 4)
        out["eps_w"] = node["eps_w"].to(torch.float32) * (spec_old.qmax / spec4.qmax)
        return out

    def walk(node, parent="", owner=""):
        if isinstance(node, dict):
            cls = layer_class(parent, owner)
            if "w_packed" in node and cls is not None:
                lp = policy.of(cls)
                if not lp.quantized or lp.w_bits == 4:
                    return node
                return repack(node, lp)
            return {k: walk(v, k, parent) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, parent, owner) for v in node]
        return node

    return walk(params)


class DraftPolicy:
    """Who drafts. After :meth:`build` a policy holds the draft ``params``,
    ``cfg`` and ``policy``, and ``shares_cache``: True when drafting writes
    through the target's cache manager, False when the policy owns a dense
    cache (``caches``, and ``pos``, which the engine keeps at the target's
    positions)."""

    name = "draft"
    shares_cache = False

    def build(self, engine) -> None:
        """Derive the draft at engine construction, so a missing kernel cell
        fails before any request is taken."""
        raise NotImplementedError

    def on_admit(self, slot: int, prompt, engine) -> None:
        """A request was admitted and prefilled into ``slot``."""

    def on_release(self, slot: int, engine) -> None:
        """``slot`` left through the engine's ``_release`` (done, stopped or
        cancelled, also mid-round)."""


class SelfDraft(DraftPolicy):
    """Draft with the target at 4-bit weights through the same kernels: no
    weights of its own where the target is at 4 bits already, no cache of
    its own, no prefill."""

    name = "self4"
    shares_cache = True

    def build(self, engine) -> None:
        self.cfg = engine.cfg
        self.policy = derive_w4_policy(engine.policy)
        dispatch.ensure_policy_supported(self.policy)
        self.params = requantize_params_w4(engine.params, engine.policy)


class DraftModel(DraftPolicy):
    """Draft with a separate small model over the target's vocabulary.

    The default is ``configs.reduced(engine.cfg)`` at the target's vocab
    (a draft must propose target tokens), its weights from ``init_params``
    with a ``torch.Generator`` seeded by ``seed`` on the engine's device (so
    not the reference's weights: that moves the acceptance, never the
    tokens); pass ``cfg`` / ``policy`` / ``params`` for a trained draft. It
    owns a dense cache at the target's positions, and enters each prompt
    token by token at admission, the other lanes at ``OUT_OF_RANGE``."""

    name = "draft"
    shares_cache = False

    def __init__(self, cfg=None, policy: Optional[PrecisionPolicy] = None,
                 params: Optional[dict] = None, *, seed: int = 1):
        self._cfg, self._policy, self._params = cfg, policy, params
        self._seed = seed

    def build(self, engine) -> None:
        self.cfg = self._cfg if self._cfg is not None else dataclasses.replace(
            configs.reduced(engine.cfg), vocab=engine.cfg.vocab)
        if self.cfg.vocab != engine.cfg.vocab:
            raise ValueError(f"draft vocab {self.cfg.vocab} != target vocab {engine.cfg.vocab}: "
                             f"drafted ids would not be target tokens")
        self.policy = self._policy if self._policy is not None else engine.policy
        dispatch.ensure_policy_supported(self.policy)
        dev = engine.device
        self.params = (self._params if self._params is not None else M.init_params(
            torch.Generator(device=dev).manual_seed(self._seed), self.cfg, self.policy,
            mode="serve", device=dev))
        self.caches = M.init_cache(self.cfg, self.policy, engine.n_slots, engine.s_max,
                                   device=dev)
        self.pos = np.zeros(engine.n_slots, np.int32)

    def on_admit(self, slot: int, prompt, engine) -> None:
        dev = engine.device
        for i, t in enumerate(np.asarray(prompt, np.int32)):
            toks = np.zeros((engine.n_slots, 1), np.int32)
            toks[slot, 0] = t
            pos = np.full(engine.n_slots, OUT_OF_RANGE, np.int32)
            pos[slot] = i
            M.decode_step(self.params, host_copy(toks, dev), host_copy(pos, dev), self.caches,
                          self.cfg, self.policy, impl=engine.impl)
        self.pos[slot] = len(prompt)

    def on_release(self, slot: int, engine) -> None:
        if self.pos[slot]:
            zero_slot(self.caches, slot)
            self.pos[slot] = 0


#: name -> draft policy class (as ``cache.CACHE_BACKENDS``)
SPEC_POLICIES: dict[str, type] = {"self4": SelfDraft, "draft": DraftModel}


def make_spec(spec: Union[str, DraftPolicy, None]) -> Optional[DraftPolicy]:
    """Resolve ``ServeEngine(spec=...)``: None or "off" -> no speculation, a
    registered name -> a fresh policy, an instance -> itself."""
    if spec is None or spec == "off":
        return None
    if not isinstance(spec, str):
        return spec
    cls = SPEC_POLICIES.get(spec)
    if cls is None:
        raise KeyError(f"unknown draft policy {spec!r}; available: {sorted(SPEC_POLICIES)} "
                       f"(or pass a DraftPolicy instance)")
    return cls()
