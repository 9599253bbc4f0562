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
process.  ZeRO-1 sharding (``opt_state_specs``) is not ported."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core import softfloat
from ..core.policy import PrecisionPolicy
from ..core.tree import leaves, tree_map, unflatten

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


def sr_generator(seed: int, step: int, leaf: int, device) -> torch.Generator:
    """The stochastic-rounding stream of one leaf at one step: a
    ``torch.Generator`` on ``device`` seeded from (seed, step, leaf)."""
    mix = ((seed + 1) * 0x9E3779B97F4A7C15 ^ step * 0xBF58476D1CE4E5B9
           ^ (leaf + 1) * 0x94D049BB133111EB) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mix)


def apply_update(params, grads, state, cfg: OptConfig,
                 policy: PrecisionPolicy, *, sr_seed: Optional[int] = None):
    """One optimizer step: ``(new_params, new_state, metrics)`` with
    ``metrics`` the step's ``lr`` (host) and the pre-clip ``grad_norm``
    (device).  ``sr_seed`` turns on stochastic re-quantisation of the
    params when the policy asks for it (``stochastic_grad_round``)."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    flat_g = [g.to(F32) for g in leaves(grads)]
    gnorm = _global_norm(flat_g)
    if cfg.clip_norm is not None:
        scale = torch.clamp(_f32(cfg.clip_norm, gnorm.device)
                            / (gnorm + 1e-9), max=1.0)
        flat_g = [g * scale for g in flat_g]
    flat_master = leaves(state["master"])

    new_state = {"step": step}
    if cfg.name == "adamw":
        t = step.to(F32)
        bc1 = 1 - cfg.b1 ** t
        bc2 = 1 - cfg.b2 ** t
        m_new = [cfg.b1 * m.to(F32) + (1 - cfg.b1) * g
                 for g, m in zip(flat_g, leaves(state["m"]))]
        v_new = [cfg.b2 * v.to(F32) + (1 - cfg.b2) * g * g
                 for g, v in zip(flat_g, leaves(state["v"]))]

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

        def v_upd(g, v):
            if "full" in v:
                return {"full": rho * v["full"] + (1 - rho) * g * g}
            return {"row": rho * v["row"] + (1 - rho) * torch.mean(
                        g * g, dim=-1),
                    "col": rho * v["col"] + (1 - rho) * torch.mean(
                        g * g, dim=-2)}

        def upd(master, g, v):
            if "full" in v:
                precond = g * torch.rsqrt(v["full"] + cfg.eps)
            else:
                rfac = v["row"] / torch.clamp(
                    torch.mean(v["row"], dim=-1, keepdim=True), min=1e-30)
                precond = g * torch.rsqrt(
                    rfac[..., None] * v["col"][..., None, :] + cfg.eps)
            # relative update clipping (Adafactor d=1), over the whole leaf
            rms = torch.sqrt(torch.mean(torch.square(precond)) + 1e-30)
            precond = precond / torch.clamp(rms, min=1.0)
            wd = cfg.weight_decay * master if master.dim() >= 2 else 0.0
            return master - lr * (precond + wd)

        # v has one dict level below each param leaf
        flat_v = []
        tree_map(lambda _, v: flat_v.append(v), grads, state["v"])
        v_new = [v_upd(g, v) for g, v in zip(flat_g, flat_v)]
        flat_new = [upd(*z) for z in zip(flat_master, flat_g, v_new)]
        it = iter(v_new)
        new_state["v"] = tree_map(lambda _: next(it), grads)

    new_state["master"] = unflatten(state["master"], flat_new)
    sr = (policy.mode == "native" and policy.stochastic_grad_round
          and sr_seed is not None)

    def requant(i, master, old):
        if policy.mode != "native":
            return softfloat.quantize(master, policy.param_fmt)
        if sr:
            gen = sr_generator(sr_seed, int(step), i, master.device)
            q = softfloat.quantize(master, policy.param_fmt, "stochastic",
                                   generator=gen)
            return q.to(old.dtype)
        return master.to(old.dtype)

    new_params = unflatten(params, [
        requant(i, m, p) for i, (m, p) in enumerate(zip(flat_new,
                                                        leaves(params)))])
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}


def opt_state_specs(*args, **kwargs):
    """ZeRO-1 optimizer-state sharding specs: not ported."""
    raise NotImplementedError(
        "opt_state_specs (ZeRO-1 sharding of the optimizer state over the "
        "data axis) is not ported: ROADMAP Queue 1 item 8b (training under a mesh)")
