"""Feed-forward stack: (gated) MLP and Mixture-of-Experts with sort-based
capacity dispatch (counterpart of ``repro.models.ffn``, serve mode).

The MoE follows the reference step for step, so that the same rows reach
the same experts in the same places and the combine adds in the same
order:

  * top-k is a stable descending sort of the selection scores, first k
    taken: among equal scores the lower expert index comes first, as
    ``jax.lax.top_k`` orders them (the router's logits are bf16, so equal
    scores are common; ``torch.topk`` promises no order);
  * the dispatch is a stable argsort of each group's expert ids and a
    row-wise ``searchsorted(side="left")`` for each entry's rank within its
    expert; a dropped entry's destination, ``E * G * Cg``, is a spare last
    row of the dispatch buffer, cut off before the experts run;
  * the three expert projections run as ONE batched mpmm launch each
    (``core.linear.experts_apply``);
  * the combine ``zeros((T, d), bf16).at[token].add(contrib)`` adds each
    token's k contributions one at a time in bf16, in their sorted order
    (what XLA's scatter does, op by op and jitted): here each token's k
    contributions are gathered in that order and added in k bf16 adds, with
    no atomics, so the bits are the same on every run.

Capacity counts every row the call sees (``T = B * S``): padded rows of a
final prefill chunk and idle decode lanes are routed and take capacity, as
in the reference. Where capacity binds, a token's output depends on the
rest of the batch.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import runtime_flags as RF
from repro_torch.core.linear import experts_apply, experts_init, linear_apply, linear_init
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.kernels import ops
from repro_torch.models.common import act_fn


@dataclasses.dataclass(frozen=True)
class MLPCfg:
    d_model: int
    d_ff: int
    act: str = "silu"
    gated: bool = True  # SwiGLU-family; False -> up/act/down


def mlp_init(gen: torch.Generator, cfg: MLPCfg, policy: PrecisionPolicy, *,
             mode: str = "serve", device, dtype=torch.float32) -> dict:
    lp_in, lp_out = policy.of("ffn_in"), policy.of("ffn_out")
    kw = dict(mode=mode, device=device, dtype=dtype)
    p = {"up": linear_init(gen, cfg.d_model, cfg.d_ff, lp_in, **kw),
         "down": linear_init(gen, cfg.d_ff, cfg.d_model, lp_out, **kw)}
    if cfg.gated:
        p["gate"] = linear_init(gen, cfg.d_model, cfg.d_ff, lp_in, **kw)
    return p


def mlp_apply(params: dict, x: torch.Tensor, cfg: MLPCfg, policy: PrecisionPolicy, *,
              impl: ops.Impl = "auto") -> torch.Tensor:
    lp_in, lp_out = policy.of("ffn_in"), policy.of("ffn_out")
    up = linear_apply(params["up"], x, lp_in, impl=impl)
    f = act_fn(cfg.act)
    if cfg.gated:
        gate = linear_apply(params["gate"], x, lp_in, impl=impl)
        h = f(gate) * up
    else:
        h = f(up)
    return linear_apply(params["down"], h, lp_out, impl=impl)


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # deepseek-v3: 1 shared expert
    d_ff_shared: int = 0
    act: str = "silu"
    capacity_factor: float = 1.25
    router_bias_balance: bool = True  # aux-loss-free bias (deepseek-style)


def _shared_cfg(cfg: MoECfg) -> MLPCfg:
    return MLPCfg(cfg.d_model, cfg.d_ff_shared or cfg.d_ff_expert, cfg.act)


def moe_init(gen: torch.Generator, cfg: MoECfg, policy: PrecisionPolicy, *,
             mode: str = "serve", device, dtype=torch.float32) -> dict:
    lp_e = policy.of("expert")
    kw = dict(mode=mode, device=device, dtype=dtype)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p = {
        "router": linear_init(gen, d, E, policy.of("router"), **kw),
        "gate": experts_init(gen, E, d, f, lp_e, **kw),
        "up": experts_init(gen, E, d, f, lp_e, **kw),
        "down": experts_init(gen, E, f, d, lp_e, **kw),
    }
    if cfg.router_bias_balance:
        p["router_bias"] = torch.zeros((E,), dtype=torch.float32, device=device)
    if cfg.n_shared:
        p["shared"] = mlp_init(gen, _shared_cfg(cfg), policy, **kw)
    return p


def moe_capacity(n_tokens: int, cfg: MoECfg) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(4, -(-c // 4) * 4)  # multiple of 4


def _dispatch_groups(flat: int, pref: int = 32) -> int:
    """Largest power-of-two group count <= pref dividing the flat length;
    one group up to 8192 entries (decode), as in the reference."""
    if flat <= 8192:
        return 1
    g = 1
    while g < pref and flat % (2 * g) == 0 and flat // (2 * g) >= 4:
        g *= 2
    return g


def _top_k(sel: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row, lower index first
    among equals (``jax.lax.top_k``'s order)."""
    return torch.sort(sel, dim=-1, descending=True, stable=True).indices[:, :k]


def moe_route(params: dict, xt: torch.Tensor, cfg: MoECfg, policy: PrecisionPolicy, *,
              impl: ops.Impl = "auto"):
    """Router and sort-based dispatch plan of the (T, d) rows ``xt``.
    Returns a dict: ``top_i`` (T, k) expert ids, ``top_p`` (T, k) their
    normalized weights, ``aux`` the load-balance loss, the sorted flat
    entries ``se`` / ``sp`` / ``stt`` (expert,
    weight, token; (G, T*k/G) each), ``keep`` and ``dest`` (the entry's row
    of the (E * G * Cg) dispatch buffer; ``E * G * Cg`` when dropped), and
    ``G``, ``Cg``."""
    T = xt.shape[0]
    k, E = cfg.top_k, cfg.n_experts
    dev = xt.device
    C = moe_capacity(T, cfg)
    logits = linear_apply(params["router"], xt, policy.of("router"),
                          impl=impl).to(torch.float32)  # (T, E), bf16 values
    probs = torch.softmax(logits, dim=-1)
    sel = probs
    if cfg.router_bias_balance and "router_bias" in params:
        sel = probs + params["router_bias"]
    top_i = _top_k(sel, k)  # (T, k)
    top_p = probs.gather(1, top_i)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    assign = torch.zeros((T, E), dtype=torch.float32, device=dev).scatter_(1, top_i, 1.0)
    aux = E * torch.sum(assign.mean(0) * probs.mean(0))

    Tk = T * k
    G = _dispatch_groups(Tk)
    Cg = max(4, -(-(-(-C // G)) // 4) * 4)  # ceil(C/G) rounded up to 4
    flat_e = top_i.reshape(G, Tk // G)
    flat_p = top_p.reshape(G, Tk // G)
    flat_t = (torch.arange(Tk, device=dev) // k).reshape(G, Tk // G)  # entry -> token
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(Tk // G, device=dev)[None, :] - first  # rank within (group, expert)
    keep = pos < Cg
    g_idx = torch.arange(G, device=dev)[:, None]
    dest = torch.where(keep, se * (G * Cg) + g_idx * Cg + pos,
                       torch.full_like(se, E * G * Cg))
    return dict(top_i=top_i, top_p=top_p, aux=aux, se=se, sp=flat_p.gather(1, order),
                stt=flat_t.gather(1, order), keep=keep, dest=dest, G=G, Cg=Cg)


def moe_apply(params: dict, x: torch.Tensor, cfg: MoECfg, policy: PrecisionPolicy, *,
              impl: ops.Impl = "auto"):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux loss f32 scalar), serve
    mode. Sort-based capacity dispatch, every expert projection one batched
    mpmm launch."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E = cfg.n_experts
    r = moe_route(params, xt, cfg, policy, impl=impl)
    G, Cg = r["G"], r["Cg"]
    rows = E * G * Cg
    dflat, kflat = r["dest"].reshape(-1), r["keep"].reshape(-1)
    src = xt[r["stt"].reshape(-1)]
    # one spare last row takes every dropped entry, then is cut off; the
    # kept destinations are distinct, so the writes are deterministic
    if RF.FLAGS.get("moe_dispatch_bits") == 8:
        srcf = src.to(torch.float32)
        amax = torch.amax(torch.abs(srcf), dim=-1, keepdim=True)
        scl = torch.clamp(amax, min=1e-6) / 127.0
        src_q = torch.clamp(torch.round(srcf / scl), -127, 127).to(torch.int8)
        buf_q = torch.zeros((rows + 1, d), dtype=torch.int8, device=x.device)
        buf_q[dflat] = src_q
        buf_s = torch.zeros((rows + 1, 1), dtype=torch.float32, device=x.device)
        buf_s[dflat] = scl
        buf = (buf_q[:rows].to(torch.float32) * buf_s[:rows]).to(x.dtype)
    else:
        buf = torch.zeros((rows + 1, d), dtype=x.dtype, device=x.device)
        buf[dflat] = src
        buf = buf[:rows]
    buf = buf.reshape(E, G * Cg, d)

    lp_e = policy.of("expert")
    f = act_fn(cfg.act)
    g = experts_apply(params["gate"], buf, lp_e, impl=impl)
    u = experts_apply(params["up"], buf, lp_e, impl=impl)
    h = (f(g) * u).to(x.dtype)
    o = experts_apply(params["down"], h, lp_e, impl=impl)  # (E, G*Cg, d)

    out_flat = o.reshape(rows, d)
    contrib = torch.where(kflat[:, None], out_flat[torch.clamp(dflat, max=rows - 1)],
                          torch.zeros((), dtype=o.dtype, device=o.device))
    contrib = contrib * r["sp"].reshape(-1)[:, None].to(x.dtype)
    # each token's k entries in their sorted order, added one at a time
    by_tok = torch.argsort(r["stt"].reshape(-1), stable=True).reshape(T, cfg.top_k)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(cfg.top_k):
        y = y + contrib[by_tok[:, j]]

    if "shared" in params:
        y = y + mlp_apply(params["shared"], xt, _shared_cfg(cfg), policy, impl=impl)
    return y.reshape(B, S, d), r["aux"]
