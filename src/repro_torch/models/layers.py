"""Common policy-aware layers: rms and layer norms, rotary embeddings,
the SwiGLU and gelu MLPs, logit soft-capping and the init helpers.  Every
matmul routes through ``core.ops`` so the active PrecisionPolicy applies
uniformly.  Weights keep the JAX layout ``[d_in, d_out]`` (``x @ W``).

Tensor parallelism (``group``, a ``launch.spmd.Group`` of the mesh's model
axis): the MLPs take this rank's column block of ``gate`` / ``up`` /
``b_up`` and row block of ``down``, and ``row_parallel`` sums the partial
products across the group before the policy's one output snap — what
GSPMD makes of the JAX package's ``col`` / ``row`` rules.  ``whole_cols``
and ``row_project`` do the same for a mixer whose ``col`` outputs must be
whole before it runs (MLA's latents, the recurrent mixers' projections):
gather the column blocks, run whole, project out row-parallel.

Training under a model axis: the sums backprop as the identity, and the
replicated input of the column-parallel ``gate`` / ``up`` passes through
``spmd.grad_sum`` (its gradient is the sum of the ranks').  The gather of
``whole_cols`` backprops as this rank's block of each cotangent, which is
right because what follows it runs whole on every rank: ``row_project``
sums the cotangent of its whole input (each rank's covers only its own
rows' slice), and ``col_input`` sums that of a replicated input entering
a ``col`` projection whose weight this rank holds a block of."""
from __future__ import annotations

from typing import Optional

import torch

from ..core import ops as tp
from ..core.policy import PrecisionPolicy, get_policy
from ..launch import spmd

F32 = torch.float32


def param_dtype(policy: PrecisionPolicy) -> torch.dtype:
    return tp.storage_dtype(policy.param_fmt, policy.mode)


# ---------------------------------------------------------------------------
# init helpers (numbers differ from jax.random's; tests convert JAX weights)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in, d_out, dtype, device,
               scale: Optional[float] = None):
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=F32, device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab, d, dtype, device):
    # d^-1/2 keeps tied-unembedding logits at unit scale
    w = torch.randn((vocab, d), generator=gen, dtype=F32, device=device)
    return (w * d ** -0.5).to(dtype)


def mlp_params(gen, d, f, dtype, device, kind: str = "swiglu"):
    """``kind`` "swiglu": gate / up / down; "gelu": up, b_up, down,
    b_down (biases zero, as the JAX package's)."""
    if kind == "swiglu":
        return {"gate": dense_init(gen, d, f, dtype, device),
                "up": dense_init(gen, d, f, dtype, device),
                "down": dense_init(gen, f, d, dtype, device)}
    z = lambda n: torch.zeros((n,), dtype=dtype, device=device)
    return {"up": dense_init(gen, d, f, dtype, device), "b_up": z(f),
            "down": dense_init(gen, f, d, dtype, device), "b_down": z(d)}


# ---------------------------------------------------------------------------
# norms (always f32 — FPnew keeps normalization in full precision)
# ---------------------------------------------------------------------------
def rmsnorm(x, gamma, eps: float = 1e-6):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.to(F32))
    return out.to(x.dtype)


def layernorm(x, gamma, beta, eps: float = 1e-5):
    """f32 mean and variance; ``gamma`` scales as it is (not ``1 +
    gamma`` as in ``rmsnorm``), then ``beta`` shifts."""
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * gamma.to(F32) + beta.to(F32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 1e4):
    """x: [..., S, D] (D even), positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = torch.as_tensor(positions, device=x.device)[..., None].to(F32) \
        * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def row_parallel(h, w, policy, group, *, narrow: bool = True):
    """``h [..., K/M] @ w [K/M, N]`` summed over the M ranks of ``group``:
    each rank's partial product in f32, an f32 sum across the group, and
    the policy's accumulate / output snap ONCE on the sum (where the
    unsharded ``tp_matmul`` applies it: a per-rank snap would round the
    partials themselves).  Under ``narrow_partials`` (and ``narrow``) the
    partials come out in the narrow output type and are summed in it.
    The same on every rank of the group."""
    pol = get_policy(policy)
    mp = pol.matmul
    out_f = mp.resolved_out()
    if (narrow and pol.mode == "native" and pol.narrow_partials
            and out_f.width < mp.acc_fmt.width
            and out_f.native_dtype is not None):
        return spmd.all_reduce_sum(tp.tp_matmul(h, w, pol), group,
                                   dtype=out_f.native_dtype)
    r = spmd.all_reduce_sum(tp.tp_matmul(h, w, pol, out_fmt="fp32"), group)
    if pol.mode == "native":
        return r.to(out_f.native_dtype)
    if mp.acc_fmt.name != "fp32":
        r = tp.quantize_ste(r, mp.acc_fmt, pol.rounding)
    if out_f.name != "fp32":
        r = tp.quantize_ste(r, out_f, pol.rounding)
    return r


def whole_cols(parts, widths, group):
    """The whole of each ``parts[i]`` ([..., widths[i]]): a ``col``-sharded
    leaf's output or weight holds this rank's block of the last dim and
    is gathered (every sharded part in ONE ``spmd.all_gather_cat`` over
    ``group``); a part already whole (its leaf replicated) is kept."""
    out = list(parts)
    if group is None or group.size == 1:
        return out
    idx = [i for i, (p, w) in enumerate(zip(parts, widths))
           if p.shape[-1] != w]
    if idx:
        for i, g in zip(idx, spmd.all_gather_cat([parts[i] for i in idx],
                                                 group)):
            out[i] = g
    return out


def col_input(x, w, width, group):
    """``x``, a value replicated over ``group``, as the input of the ``col``
    leaf ``w`` (output width ``width`` whole): through ``spmd.grad_sum``
    when ``w`` is this rank's column block (each rank's cotangent of
    ``x`` then covers its block only), else ``x`` itself (a replicated
    leaf's product runs whole, its cotangent whole on every rank)."""
    if group is None or group.size == 1 or w.shape[-1] == width:
        return x
    return spmd.grad_sum(x, group)


def row_project(h, w, policy, group, unsharded):
    """``h [..., K]`` (whole on every rank) through a ``row`` leaf ``w``:
    with ``w`` this rank's block of rows [K/M, N], this rank's slice of
    ``h``'s last dim through ``row_parallel`` (f32 partials, one snap after
    the sum, as ``attention._row_parallel_wo``); with ``w`` whole (no
    group, or the leaf replicated), ``unsharded(h, w)``.  In training the
    slice's cotangent covers this rank's rows only, so ``h`` passes
    through ``spmd.grad_sum`` first: the whole cotangent on every rank."""
    if group is None or group.size == 1 or w.shape[0] == h.shape[-1]:
        return unsharded(h, w)
    k = w.shape[0]
    h = spmd.grad_sum(h, group)
    hs = h[..., group.index * k:(group.index + 1) * k]
    return row_parallel(hs, w, policy, group, narrow=False)


def _down(h, w_down, policy, group):
    if group is None or group.size == 1:
        return tp.tp_matmul(h, w_down, policy)
    return row_parallel(h, w_down, policy, group)


def swiglu(x, w_gate, w_up, w_down, policy, group=None):
    """SwiGLU MLP: matmuls under the multi-format FMA policy, the
    activation under the elementwise policy.  ``group``: the weights are
    this rank's blocks, ``down`` row-parallel over it."""
    x = spmd.grad_sum(x, group)
    g = tp.tp_matmul(x, w_gate, policy)
    u = tp.tp_matmul(x, w_up, policy)
    h = tp.tp_elementwise("silu", g, policy=policy) * u
    return _down(h, w_down, policy, group)


def gelu_mlp(x, w_up, b_up, w_down, b_down, policy, group=None):
    """Non-gated gelu MLP with biases (granite): each bias is added to
    the matmul's output in its output dtype, then gelu (tanh form) under
    the elementwise policy, as the JAX package's ``gelu_mlp``.  ``group``:
    ``up`` / ``b_up`` are this rank's column blocks, ``down`` its row
    block, and ``b_down`` is added once, after the reduce."""
    h = tp.tp_matmul(spmd.grad_sum(x, group), w_up, policy) + b_up
    h = tp.tp_elementwise("gelu", h, policy=policy)
    return _down(h, w_down, policy, group) + b_down


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    xf = x.to(F32)
    return (cap * torch.tanh(xf / cap)).to(x.dtype)
