"""Mixture-of-Experts: the JAX package's ``repro.models.moe``.

Dispatch is the sort-based capacity scheme (no [T, E, C] one-hot tensors):

  1. f32 router, softmax, top-k -> flat (token, slot) -> expert assignments,
  2. stable argsort by expert, per-expert rank from the run starts
     (``searchsorted``),
  3. scatter into an [E * C + 1, D] buffer whose last row is the drop row;
     with the default drop-free capacity (``capacity_factor=None``, C >=
     the token count) every assignment fits, so a token's output does not
     depend on what else is in the batch (chunked verify equals sequential
     decode); a finite factor restores training-style over-capacity drops,
  4. expert parallelism (a ``mesh`` with a ``model`` axis of M > 1 ranks,
     the experts this rank's [E/M, ...] block): the slabs, as
     [M(dest), E/M, C, D], go through ``all_to_all``, this rank's experts
     run over the M*C rows they received, and a reverse ``all_to_all``
     brings every expert's output home,
  5. the batched expert SwiGLU over the [E, C, D] slabs,
  6. gather back, unsort, and the f32 gate-weighted combine.

Everything stays on the device: C comes from shapes alone, and nothing
reads a data-dependent size back to the host.  The expert SwiGLU runs on
every expert's whole slab, padding included, as the JAX package lays it
out: a routed-rows grouped GEMM is later work (ROADMAP, Hopper
follow-ups).  Under expert parallelism the tokens are replicated within
the replica (JAX's ``P(None)`` on a ``("model",)`` sub-mesh): every rank
routes every token, the router replicated, so the M slabs a rank receives
are the same rows, as in the JAX package; the shared experts run tensor
parallel (``layers.swiglu`` with the model group).

Training under expert parallelism: the M identical slabs an expert rank
receives each carry the whole cotangent back through the reverse
``all_to_all``, so the expert weights would get M times their gradient;
``_ExpertGrad`` (identity forward) divides their cotangent by M, exact
for M a power of two.  The tokens' cotangent is whole on every rank as
it comes back, and so is the replicated router's: neither is summed.

The aux load-balancing loss, as the JAX package takes it by mesh (the
trainer picks): over this call's tokens (no mesh; the compressed sync,
each replica's own; a model axis > 1, each data shard's own, which the
trainer averages), or with ``aux_groups`` (a ``(data, 1)`` mesh under
the plain sync, where JAX's GSPMD routes the global batch) over the
global batch: each rank's summed router probabilities and top-1 counts
summed over the groups first (the sum's backward is the identity, so
each rank's gradient carries its own tokens' share).

Transprecision: the expert products follow the multi-format FMA policy
(``core.ops.tp_einsum``), the activation the elementwise policy; the router
runs in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import ops as tp
from ..launch import spmd
from ..launch.mesh import check_mesh
from .layers import dense_init, swiglu

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    # None = drop-free dispatch (capacity >= n_tokens: no expert can
    # overflow, no token is dropped).  Serving needs drop-free: with a
    # finite factor a token's keep/drop decision depends on the rest of the
    # batch, and chunked verify would part from sequential decode.
    capacity_factor: Optional[float] = None
    router_norm_topk: bool = True   # normalize top-k gates to sum to 1


def moe_params(gen: torch.Generator, d_model: int, cfg: MoEConfig, dtype,
               device) -> dict:
    """The JAX ``moe_params`` distributions, drawn from ``gen``: the router
    [D, E] in f32, expert weights [E, D, F] / [E, F, D] in ``dtype``, and
    the shared experts' SwiGLU (width ``n_shared * d_expert``)."""
    e, f = cfg.n_experts, cfg.d_expert

    def experts(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=F32, device=device)
        return (w * fan_in ** -0.5).to(dtype)

    p = {"router": dense_init(gen, d_model, e, F32, device),
         "w_gate": experts((e, d_model, f), d_model),
         "w_up": experts((e, d_model, f), d_model),
         "w_down": experts((e, f, d_model), f)}
    if cfg.n_shared:
        fs = cfg.n_shared * f
        p["shared"] = {"gate": dense_init(gen, d_model, fs, dtype, device),
                       "up": dense_init(gen, d_model, fs, dtype, device),
                       "down": dense_init(gen, fs, d_model, dtype, device)}
    return p


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    if cfg.capacity_factor is None:
        # drop-free: a token assigns an expert at most once, so one expert
        # receives at most n_tokens rows
        return max(8, -(-n_tokens // 8) * 8)
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _expert_ffn(buf, w_gate, w_up, w_down, policy):
    """buf [E, C, D] -> [E, C, D], the batched SwiGLU."""
    g = tp.tp_einsum("ecd,edf->ecf", buf, w_gate, policy)
    u = tp.tp_einsum("ecd,edf->ecf", buf, w_up, policy)
    h = tp.tp_elementwise("silu", g, policy=policy) * u
    return tp.tp_einsum("ecf,efd->ecd", h, w_down, policy)


def route(x_flat, router, cfg: MoEConfig):
    """The f32 router: ``(probs [T, E], gates [T, k], idx [T, k])``."""
    logits = x_flat.to(F32) @ router.to(F32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.router_norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def dispatch_slots(idx, cap: int, n_experts: int):
    """Sort-based dispatch of the flat assignments ``idx`` [T, k]: ``(order
    [T*k], slot [T*k])``, ``order`` the stable sort of the flat
    assignments by expert and ``slot[i]`` the buffer row of sorted
    assignment ``i`` (``n_experts * cap``, the drop row, when its expert
    is full)."""
    t, k = idx.shape
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=idx.device,
                               dtype=sorted_e.dtype), side="left")
    rank = torch.arange(t * k, device=idx.device) - first[sorted_e]
    slot = torch.where(rank < cap, sorted_e * cap + rank, n_experts * cap)
    return order, slot


class _ExpertGrad(torch.autograd.Function):
    """Identity forward; backward divides the cotangent by ``m`` (the
    expert-parallel group's size: its M identical slabs)."""

    @staticmethod
    def forward(ctx, w, m):
        ctx.m = m
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.m, None


def _expert_weights(params, m: int):
    """The expert weights as the expert SwiGLU reads them: under M > 1
    ranks in training, through ``_ExpertGrad``."""
    ws = [params[k] for k in ("w_gate", "w_up", "w_down")]
    if m == 1 or not torch.is_grad_enabled():
        return ws
    return [_ExpertGrad.apply(w, m) if w.requires_grad else w for w in ws]


def aux_loss(probs, top1, n_experts: int, aux_groups=()):
    """Switch-style load balancing: ``E * sum_e mean_t(probs) *
    frac_top1``, over this call's tokens, or over those of every rank of
    ``aux_groups`` (the summed probabilities [E], the top-1 counts [E]
    and the token count summed over each group first, in one
    collective)."""
    t = torch.full((), probs.shape[0], dtype=F32, device=probs.device)
    if not aux_groups:
        return n_experts * torch.sum(probs.mean(dim=0) * (top1 / t))
    stats = torch.cat([probs.sum(dim=0), top1, t[None]])
    for g in aux_groups:
        stats = spmd.all_reduce_sum(stats, g)
    p_sum, counts, t = stats[:n_experts], stats[n_experts:-1], stats[-1]
    return n_experts * torch.sum((p_sum / t) * (counts / t))


def moe_core(x_flat, params, cfg: MoEConfig, policy, *,
             ep_group: Optional[spmd.Group] = None, with_aux: bool = True,
             aux_groups=()):
    """x_flat [T, D] -> (y [T, D], aux scalar): routing, dispatch, the
    expert SwiGLU and the combine.  ``ep_group`` (M ranks): the expert
    weights are this rank's [E/M, ...] block and the slabs cross the group
    through ``all_to_all``.  ``with_aux=False`` (serving) skips the aux
    loss and returns None in its place, as XLA drops it from the JAX
    package's serving graphs; ``aux_groups``: the aux over the tokens of
    every rank of these groups (``aux_loss``)."""
    t, d = x_flat.shape
    e_total, k = cfg.n_experts, cfg.top_k
    e_loc = params["w_gate"].shape[0]
    ep = ep_group.size if ep_group is not None else 1
    if e_loc * ep != e_total:
        raise ValueError(f"{e_loc} local experts x {ep} ranks is not "
                         f"{e_total} experts")
    cap = _capacity(t, cfg)

    probs, gates, idx = route(x_flat, params["router"], cfg)
    aux = None
    if with_aux:
        # the top-1 dispatch counts by a scatter: no host sync
        top1 = torch.zeros((e_total,), dtype=F32, device=x_flat.device)
        top1.scatter_add_(0, idx[:, 0], torch.ones((t,), dtype=F32,
                                                   device=x_flat.device))
        aux = aux_loss(probs, top1, e_total, aux_groups)

    order, slot = dispatch_slots(idx, cap, e_total)
    buf = torch.zeros((e_total * cap + 1, d), dtype=x_flat.dtype,
                      device=x_flat.device)
    # only the drop row can receive two writes, and it is cut off
    buf[slot] = x_flat[order // k]
    buf = buf[:-1].reshape(e_total, cap, d)
    if ep > 1:
        # [E, C, D] -> [M(dest), E_loc, C, D] -> a2a -> [M(src), E_loc, C,
        # D] -> [E_loc, M*C, D]
        buf = spmd.all_to_all(buf.reshape(ep, e_loc, cap, d), ep_group)
        buf = buf.transpose(0, 1).reshape(e_loc, ep * cap, d)
    out = _expert_ffn(buf, *_expert_weights(params, ep), policy)
    if ep > 1:
        # [E_loc, M(src), C, D] -> [M, E_loc, C, D] -> a2a -> [M(expert
        # block), E_loc, C, D], which is [E, C, D] expert-major
        out = spmd.all_to_all(
            out.reshape(e_loc, ep, cap, d).transpose(0, 1).contiguous(),
            ep_group)
    out = torch.cat([out.reshape(e_total * cap, d),
                     torch.zeros((1, d), dtype=out.dtype, device=out.device)])
    gathered = torch.empty((t * k, d), dtype=out.dtype, device=out.device)
    gathered[order] = out[slot]                     # unsort: flat order
    y = torch.einsum("tkd,tk->td", gathered.reshape(t, k, d).to(F32),
                     gates.to(F32)).to(x_flat.dtype)
    return y, aux


def _axis_group(mesh, axis: Optional[str], width: int):
    """``mesh``'s group on ``axis`` when it has M > 1 ranks dividing
    ``width`` (the sharding rules' divisibility), else None."""
    check_mesh(mesh)
    if mesh is None or axis not in mesh.axis_names:
        return None
    m = mesh.shape[axis]
    return mesh.group(axis) if m > 1 and width % m == 0 else None


def moe_block(x, params, cfg: MoEConfig, policy, *, mesh=None,
              ep_axis: Optional[str] = "model", with_aux: bool = True,
              aux_groups=()):
    """x [B, S, D] -> (y, aux): the routed experts plus the shared experts'
    SwiGLU.  A ``mesh`` with ``ep_axis`` of M > 1 ranks dividing the
    expert count runs expert parallel over it (``params`` this rank's
    shards, the tokens the same on every rank); the result is the same on
    every rank.  ``aux_groups``: as ``moe_core``'s."""
    b, s, d = x.shape
    routed = {n: v for n, v in params.items() if n != "shared"}
    y, aux = moe_core(x.reshape(b * s, d), routed, cfg, policy,
                      ep_group=_axis_group(mesh, ep_axis, cfg.n_experts),
                      with_aux=with_aux, aux_groups=aux_groups)
    y = y.reshape(b, s, d)
    if cfg.n_shared:
        sh = params["shared"]
        y = y + swiglu(x, sh["gate"], sh["up"], sh["down"], policy,
                       _axis_group(mesh, "model",
                                   cfg.n_shared * cfg.d_expert))
    return y, aux
