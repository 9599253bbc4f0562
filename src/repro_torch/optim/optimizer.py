"""Transprecision optimizers: AdamW and Adafactor, the JAX package's
``optim/optimizer.py`` in torch.

  * master weights in ``policy.master_fmt`` (fp32): the expanding-FMA
    destination of the weight update,
  * model weights stored in ``policy.param_fmt`` (bf16 / fp16),
    re-quantised from the master each step (stochastic rounding under
    ``stochastic_grad_round``),
  * Adam moments stored in ``policy.opt_m_fmt`` / ``opt_v_fmt`` (bf16
    under ``prod_tp``), the update math always in f32.

Every leaf is a leaf of JAX's own tree, the ``[R, ...]`` stacks of the
pattern included: weight decay applies to leaves with ``ndim >= 2`` (so
the pattern's norm gains ``[R, d]`` are decayed and ``norm_f`` is not),
Adafactor factors any leaf whose last two dims exceed 1 and takes its
update-RMS clip over the whole stacked leaf, exactly as JAX does.

The update is functional: it returns new tensors and writes none in
place, so a checkpoint copied from the previous state stays valid.  The
step counter and the schedule live on the host (0-d tensors); a device
tensor combines with them as with a scalar, without a sync.

Stochastic re-quantisation draws from a ``torch.Generator`` seeded by
(``sr_seed``, step, leaf index), so a restarted run in a new process
repeats it; JAX keys it by ``hash(str(path))``, which Python salts per
process.

Sharded leaves (``layout=``, a :class:`Layout`): the params are this
rank's model shards, the gradients full over the data axis (synced) and
cut like the params, and the state this rank's block of the whole state
under its specs: the params' own, or under ZeRO-1 ``opt_state_specs``,
which put the data axis on the first unsharded dimension that divides.
The update is the unsharded one: the global gradient norm sums the
squares of split leaves over their groups and counts replicated leaves
once, Adafactor's factored means and its update-RMS clip reduce over the
groups that split the reduced dims (the small row / col factors are
gathered whole where a precondition needs them), and the new params are
gathered back over the data axis.  AdamW's update is elementwise, so a
ZeRO-1 step is the unsharded-state step bit for bit.  A split leaf's
stochastic re-quantisation draws from its own stream, salted by its
block (ROADMAP Queue 3)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core import softfloat
from ..core.device import device_generator
from ..core.policy import PrecisionPolicy
from ..core.tree import leaves, tree_map, unflatten
from ..launch import spmd
from ..models import sharding as shd

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"               # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    # adafactor
    decay_adafactor: float = 0.8


def _f32(x: float, device=None) -> torch.Tensor:
    """``x`` as a 0-d f32 tensor: tensor-by-tensor division divides, where
    a Python scalar numerator would multiply by a reciprocal."""
    return torch.full((), x, dtype=F32, device=device)


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine down to ``min_lr_frac``
    of it at ``total_steps``: a 0-d f32 tensor on the host."""
    step = torch.as_tensor(step).to(device="cpu", dtype=F32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _q_state(x, fmt, policy: PrecisionPolicy):
    """Quantize an optimizer-state tensor to its storage format."""
    if fmt is None:
        return x
    if policy.mode == "native" and fmt.native_dtype is not None:
        return x.to(fmt.native_dtype)
    return softfloat.quantize(x, fmt)


def _is_matrix(x) -> bool:
    return x.dim() >= 2 and x.shape[-1] > 1 and x.shape[-2] > 1


def init_opt_state(params, cfg: OptConfig, policy: PrecisionPolicy) -> dict:
    """``step`` (host int32), ``master`` (f32 copies), and AdamW's ``m`` /
    ``v`` in their storage formats or Adafactor's ``v`` (``row`` / ``col``
    for a matrix, ``full`` otherwise), on the params' devices."""
    def zeros(x, shape=None, fmt=None):
        z = torch.zeros(x.shape if shape is None else shape, dtype=F32,
                        device=x.device)
        return _q_state(z, fmt, policy)

    state = {"step": torch.zeros((), dtype=torch.int32),
             "master": tree_map(lambda x: x.to(F32, copy=True), params)}
    if cfg.name == "adamw":
        state["m"] = tree_map(lambda x: zeros(x, fmt=policy.opt_m_fmt),
                              params)
        state["v"] = tree_map(lambda x: zeros(x, fmt=policy.opt_v_fmt),
                              params)
    elif cfg.name == "adafactor":
        def fac(x):
            if _is_matrix(x):
                return {"row": zeros(x, x.shape[:-1]),
                        "col": zeros(x, x.shape[:-2] + x.shape[-1:])}
            return {"full": zeros(x)}
        state["v"] = tree_map(fac, params)
    else:
        raise ValueError(cfg.name)
    return state


def _global_norm(flat) -> torch.Tensor:
    sq = None
    for g in flat:
        s = torch.sum(torch.square(g.to(F32)))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def sr_generator(seed: int, step: int, leaf: int, device,
                 salt: int = 0) -> torch.Generator:
    """The stochastic-rounding stream of one leaf at one step: a
    ``torch.Generator`` on ``device`` seeded from (seed, step, leaf) and
    ``salt`` (a split leaf's block, a replica's compressed sync)."""
    mix = ((seed + 1) * 0x9E3779B97F4A7C15 ^ step * 0xBF58476D1CE4E5B9
           ^ (leaf + 1) * 0x94D049BB133111EB
           ^ salt * 0xD6E8FEB86659FD93) % (1 << 63)
    return device_generator(device).manual_seed(mix)


class Layout:
    """Where a rank's leaves lie in the whole ones: ``mesh``, the params'
    spec tree (``models.sharding.shard_specs``: their model shards) and,
    under ZeRO-1, the optimizer state's (``opt_state_specs``).  Without
    ``opt_specs`` the state mirrors the params: ``master`` / ``m`` / ``v``
    and Adafactor's ``full`` at the param's spec, its ``row`` / ``col`` at
    that spec less the averaged dim."""

    def __init__(self, mesh, param_specs, opt_specs=None):
        self.mesh = mesh
        self.param_specs = param_specs
        self.opt_specs = opt_specs
        self.p = shd.spec_leaves(param_specs)

    def state_specs(self, state) -> dict:
        """The spec tree of ``state`` (this rank's block of each leaf)."""
        if self.opt_specs is not None:
            return self.opt_specs
        out = {k: self.param_specs for k in state if k != "step"}
        out["step"] = ()
        vs = _factor_leaves(state.get("v"))
        if vs:
            out["v"] = unflatten(state["master"], [
                _factor_specs(sp, v) for sp, v in zip(self.p, vs)])
        return out

    def splits(self, spec, ndim) -> list:
        return shd.split_axes(spec, ndim, self.mesh)

    def sum_over(self, x, axes) -> torch.Tensor:
        """``x`` summed over the groups of ``axes`` (mesh order)."""
        for a in self.mesh.axis_names:
            if a in axes:
                x = spmd.all_reduce_sum(x, self.mesh.group(a))
        return x

    def mean(self, x, dim: int, spec) -> torch.Tensor:
        """The mean of the whole leaf along ``dim`` (``x`` its block
        under ``spec``): ``torch.mean`` where the dim is whole here."""
        axes = self.splits(spec, x.dim())[dim]
        if not axes:
            return torch.mean(x, dim=dim)
        n = x.shape[dim] * math.prod(self.mesh.shape[a] for a in axes)
        return self.sum_over(torch.sum(x, dim=dim), axes) / _f32(n, x.device)

    def mean_all(self, x, spec) -> torch.Tensor:
        """The mean of the whole leaf (``x`` its block under ``spec``)."""
        axes = {a for d in self.splits(spec, x.dim()) for a in d}
        if not axes:
            return torch.mean(x)
        n = x.numel() * math.prod(self.mesh.shape[a] for a in axes)
        return self.sum_over(torch.sum(x), axes) / _f32(n, x.device)

    def relayout(self, x, have, want):
        return shd.relayout(x, have, want, self.mesh)

    def block(self, spec, ndim) -> int:
        """This rank's block index of a leaf split by ``spec`` (0 when the
        leaf is whole here)."""
        idx = 0
        for axes in self.splits(spec, ndim):
            for a in axes:
                idx = idx * self.mesh.shape[a] + self.mesh.coords[a]
        return idx

    def global_norm(self, flat) -> torch.Tensor:
        """The whole tree's gradient norm: replicated leaves summed in
        flatten order (as the unsharded norm), each split leaf's squares
        summed over its groups and added after."""
        sq, split = None, {}
        for g, spec in zip(flat, self.p):
            s = torch.sum(torch.square(g.to(F32)))
            axes = tuple(sorted({a for d in self.splits(spec, g.dim())
                                 for a in d}))
            if axes:
                split[axes] = s if axes not in split else split[axes] + s
            else:
                sq = s if sq is None else sq + s
        for axes in sorted(split):
            t = self.sum_over(split[axes], axes)
            sq = t if sq is None else sq + t
        return torch.sqrt(sq)


def _factor_leaves(tree):
    """Adafactor's per-leaf ``v`` dicts, in flatten order."""
    if isinstance(tree, dict) and ("row" in tree or "full" in tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _factor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _factor_leaves(v)]
    return []


def _factor_specs(spec, v) -> dict:
    """Adafactor's ``v`` specs under a param spec: ``full`` the param's,
    ``row`` / ``col`` the param's less the averaged dim."""
    if "full" in v:
        return {"full": spec}
    nd = v["row"].dim() + 1
    sp = list(spec) + [None] * (nd - len(spec))
    return {"row": tuple(sp[:-1]), "col": tuple(sp[:-2] + sp[-1:])}


def apply_update(params, grads, state, cfg: OptConfig,
                 policy: PrecisionPolicy, *, sr_seed: Optional[int] = None,
                 layout: Optional[Layout] = None):
    """One optimizer step: ``(new_params, new_state, metrics)`` with
    ``metrics`` the step's ``lr`` (host) and the pre-clip ``grad_norm``
    (device).  ``sr_seed`` turns on stochastic re-quantisation of the
    params when the policy asks for it (``stochastic_grad_round``).
    ``layout``: the leaves are this rank's blocks (module docstring)."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    flat_g = [g.to(F32) for g in leaves(grads)]
    gnorm = (_global_norm(flat_g) if layout is None
             else layout.global_norm(flat_g))
    if cfg.clip_norm is not None:
        scale = torch.clamp(_f32(cfg.clip_norm, gnorm.device)
                            / (gnorm + 1e-9), max=1.0)
        flat_g = [g * scale for g in flat_g]
    flat_master = leaves(state["master"])
    if layout is None:
        pspec = mspec = [()] * len(flat_g)
        move = lambda x, have, want: x
    else:
        sspecs = layout.state_specs(state)
        pspec, mspec = layout.p, shd.spec_leaves(sspecs["master"])
        move = layout.relayout
    pad = lambda sp, nd: list(sp) + [None] * (nd - len(sp))

    new_state = {"step": step}
    if cfg.name == "adamw":
        t = step.to(F32)
        bc1 = 1 - cfg.b1 ** t
        bc2 = 1 - cfg.b2 ** t
        gm = [move(g, pspec[i], mspec[i]) for i, g in enumerate(flat_g)]
        m_new = [cfg.b1 * m.to(F32) + (1 - cfg.b1) * g
                 for g, m in zip(gm, leaves(state["m"]))]
        v_new = [cfg.b2 * v.to(F32) + (1 - cfg.b2) * g * g
                 for g, v in zip(gm, leaves(state["v"]))]

        def upd(master, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            wd = cfg.weight_decay * master if master.dim() >= 2 else 0.0
            return master - lr * (u + wd)

        flat_new = [upd(*z) for z in zip(flat_master, m_new, v_new)]
        new_state["m"] = unflatten(state["m"], [
            _q_state(m, policy.opt_m_fmt, policy) for m in m_new])
        new_state["v"] = unflatten(state["v"], [
            _q_state(v, policy.opt_v_fmt, policy) for v in v_new])
    else:  # adafactor
        rho = 1.0 - step.to(F32) ** (-cfg.decay_adafactor)
        flat_v = _factor_leaves(state["v"])
        vspec = ([None] * len(flat_v) if layout is None
                 else _factor_leaves(sspecs["v"]))

        def mean(x, dim, spec):
            return (torch.mean(x, dim=dim) if layout is None
                    else layout.mean(x, dim, spec))

        def v_upd(i, g, v):
            if "full" in v:
                gf = move(g, pspec[i], vspec[i] and vspec[i]["full"])
                return {"full": rho * v["full"] + (1 - rho) * gf * gf}
            ps = pad(pspec[i], g.dim())
            r = mean(g * g, -1, ps)
            c = mean(g * g, -2, ps)
            if layout is not None:
                r = move(r, tuple(ps[:-1]), vspec[i]["row"])
                c = move(c, tuple(ps[:-2] + ps[-1:]), vspec[i]["col"])
            return {"row": rho * v["row"] + (1 - rho) * r,
                    "col": rho * v["col"] + (1 - rho) * c}

        def upd(i, master, g, v):
            g = move(g, pspec[i], mspec[i])
            if "full" in v:
                vf = move(v["full"], vspec[i] and vspec[i]["full"], mspec[i])
                precond = g * torch.rsqrt(vf + cfg.eps)
            else:
                # the factors whole where the leaf is split
                row = move(v["row"], vspec[i] and vspec[i]["row"], ())
                col = move(v["col"], vspec[i] and vspec[i]["col"], ())
                rfac = row / torch.clamp(
                    torch.mean(row, dim=-1, keepdim=True), min=1e-30)
                ms = pad(mspec[i], master.dim())
                rfac = move(rfac, (), tuple(ms[:-1]))
                col = move(col, (), tuple(ms[:-2] + ms[-1:]))
                precond = g * torch.rsqrt(
                    rfac[..., None] * col[..., None, :] + cfg.eps)
            # relative update clipping (Adafactor d=1), over the whole leaf
            sq = torch.square(precond)
            ms2 = (torch.mean(sq) if layout is None
                   else layout.mean_all(sq, mspec[i]))
            rms = torch.sqrt(ms2 + 1e-30)
            precond = precond / torch.clamp(rms, min=1.0)
            wd = cfg.weight_decay * master if master.dim() >= 2 else 0.0
            return master - lr * (precond + wd)

        v_new = [v_upd(i, g, v) for i, (g, v) in enumerate(zip(flat_g,
                                                                flat_v))]
        flat_new = [upd(i, *z) for i, z in enumerate(zip(flat_master, flat_g,
                                                         v_new))]
        new_state["v"] = unflatten(state["master"], v_new)

    new_state["master"] = unflatten(state["master"], flat_new)
    sr = (policy.mode == "native" and policy.stochastic_grad_round
          and sr_seed is not None)

    def requant(i, master, old):
        if policy.mode != "native":
            q = softfloat.quantize(master, policy.param_fmt)
        elif sr:
            salt = 0
            if layout is not None and any(layout.splits(mspec[i],
                                                        master.dim())):
                salt = 1 + layout.block(mspec[i], master.dim())
            gen = sr_generator(sr_seed, int(step), i, master.device, salt)
            q = softfloat.quantize(master, policy.param_fmt, "stochastic",
                                   generator=gen).to(old.dtype)
        else:
            q = master.to(old.dtype)
        return move(q, mspec[i], pspec[i])

    new_params = unflatten(params, [
        requant(i, m, p) for i, (m, p) in enumerate(zip(flat_new,
                                                        leaves(params)))])
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer-state sharding specs
# ---------------------------------------------------------------------------
def opt_state_specs(param_specs_tree, opt_state, *, zero_axis: str = "data",
                    mesh=None) -> dict:
    """Shard ``master`` / ``m`` / ``v`` over ``zero_axis`` on the first
    dimension that (a) is unsharded in the parameter's own spec and (b)
    divides by the axis size; else the parameter's spec (replication over
    data), as the JAX package's ``opt_state_specs``.  A state leaf below
    a parameter's (Adafactor's ``row`` / ``col`` / ``full``) starts from
    ``()``, as JAX's path walk does.  Specs are tuples padded to the
    leaf's rank; ``opt_state`` may hold meta tensors."""
    size = mesh.shape[zero_axis] if mesh is not None else 1

    def place(spec: tuple, leaf) -> tuple:
        parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
        for i, (p, dim) in enumerate(zip(parts, leaf.shape)):
            if p is None and dim % size == 0 and dim >= size:
                parts[i] = zero_axis
                return tuple(parts)
        return tuple(parts)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k] if isinstance(spec, dict)
                            and k in spec else None)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, spec[i] if isinstance(spec, list)
                         and i < len(spec) else None)
                    for i, v in enumerate(node)]
        return place(spec if isinstance(spec, tuple) else (), node)

    out = {"step": ()}
    for k in opt_state:
        if k != "step":
            out[k] = walk(opt_state[k], param_specs_tree)
    return out
