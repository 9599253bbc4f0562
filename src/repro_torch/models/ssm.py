"""State-space / recurrent mixers: the JAX package's ``repro.models.ssm``,
Mamba2 (SSD, zamba2's backbone) and xLSTM's mLSTM and sLSTM.

Each mixer is one function, ``*_mix(x, params, cfg, policy, cache=None)
-> (y, new_cache or None)``.  Without a cache (training) the chunkwise
parallel form runs from a zero state; with one (prefill, decode) the
same code runs from the cached state and returns the next cache.  Decode
at ``S = 1`` is that code with a chunk of one token, as in the JAX
package, which has no separate step form.  The chunks are a Python loop
where JAX scans (``lax.scan``); sLSTM's recurrence is a loop over time.

Transprecision, as JAX's: every projection and every state product is
``core.ops.tp_einsum`` under the policy, so under ``tp_bf16`` the carried
f32 states (Mamba2's ``ssm``, mLSTM's ``c`` and ``nrm``) are rounded to
bf16 at the multiplier input while the states themselves stay f32 (the
expanding FMA's destination); gates and normalisers are f32.  sLSTM's
recurrent product is a plain f32 einsum (TF32 is off, ``core.ops``).  The
conv window is stored between calls in the cache's dtype
(``attention.kv_store_dtype``: bf16 under ``tp_bf16``, fp8 under
``tp_bf16_kv8``), so it is rounded there, as in JAX.

Tensor parallelism (``group``, the mesh's model axis, M ranks; ``params``
this rank's shards under the rule table): the ``col`` leaves split
concatenated projections into contiguous column blocks that do not line
up with the segments the mixers cut their outputs into (Mamba2's ``[z |
xBC | dt]``, mLSTM's ``[x | z]`` and ``[i | f]``, sLSTM's gate and up
halves), so each rank computes its block of the projection and one
``layers.whole_cols`` gather per call makes it whole, the ``col`` conv
weights (and mLSTM's ``w_if``) with it; the mixer then runs whole on every
rank on the whole state, with no collective inside its chunk or time
loop; the out projections (``out_proj``, ``down_proj``, ``down``) run
row-parallel on this rank's slice of the mixer's output
(``layers.row_project``).  The states stay whole on every rank.  In
training the gather backprops as this rank's block of the whole
cotangent, the replicated input of the ``col`` projection passes through
``layers.col_input`` and the mixer's output through ``row_project``'s
``spmd.grad_sum``, so the replicated leaves (``A_log``, ``D``,
``dt_bias``, the norms, mLSTM's headwise projections, sLSTM's gates) get
whole gradients on every rank.

``softplus`` and ``log_sigmoid`` are JAX's forms (``logaddexp(x, 0)``),
``silu`` is ``x * sigmoid(x)``; torch's ``F.softplus`` would return ``x``
itself above 20.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import ops as tp
from .layers import col_input, dense_init, rmsnorm, row_project, whole_cols

F32 = torch.float32

#: the log-space stabiliser's start (and mLSTM's pad log input gate)
NEG = -1e30


def _softplus(x):
    """JAX's ``softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _log_sigmoid(x):
    """JAX's ``log_sigmoid``: ``-softplus(-x)``."""
    return -_softplus(-x)


def _silu(x):
    """JAX's ``silu``: ``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


def _f32_const(values, device) -> torch.Tensor:
    """A host-computed f64 array rounded once to f32, on ``device``."""
    return torch.from_numpy(np.asarray(values, np.float64).astype(
        np.float32)).to(device)


def _forget_bias(n: int, device) -> torch.Tensor:
    """``linspace(3, 6, n)`` in f32, each value rounded once from f64
    (XLA's CPU fusion rounds some of JAX's up to one ulp otherwise)."""
    return _f32_const(np.linspace(3.0, 6.0, n), device)


def _randn(gen, shape, scale, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=F32, device=device)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# Mamba2: chunked SSD (zamba2's backbone)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


class Mamba2Cache(NamedTuple):
    conv: torch.Tensor   # [B, d_conv-1, conv_dim] rolling conv window
    ssm: torch.Tensor    # [B, H, head_dim, d_state] f32 state


def mamba2_params(gen: torch.Generator, cfg: Mamba2Config, dtype,
                  device) -> dict:
    """JAX's ``mamba2_params`` distributions; ``in_proj`` emits ``[z
    (d_inner), xBC (conv_dim), dt (H)]``.  ``A_log = log(1..H)`` (``A =
    -exp(A_log)``), ``D = 1``, ``dt_bias = 0``, zero conv bias and norm."""
    di, cd, h = cfg.d_inner, cfg.conv_dim, cfg.n_heads
    return {
        "in_proj": dense_init(gen, cfg.d_model,
                              2 * di + 2 * cfg.n_groups * cfg.d_state + h,
                              dtype, device),
        "conv_w": _randn(gen, (cfg.d_conv, cd), cfg.d_conv ** -0.5, dtype,
                         device),
        "conv_b": torch.zeros((cd,), dtype=dtype, device=device),
        "A_log": _f32_const(np.log(np.arange(1, h + 1, dtype=np.float64)),
                            device),
        "D": torch.ones((h,), dtype=F32, device=device),
        "dt_bias": torch.zeros((h,), dtype=F32, device=device),
        "norm": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, di, cfg.d_model, dtype, device),
    }


def _split_zxbcdt(zxbcdt, cfg: Mamba2Config):
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn],
            zxbcdt[..., 2 * di + 2 * gn:])


def _causal_conv(xbc, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time, then silu.  ``xbc`` [B, S, C], ``w``
    [K, C]; ``state`` [B, K-1, C] is the previous segment's trailing
    window.  Returns ``(out f32, new window in xbc's dtype)``; the taps sum
    left to right in f32, as JAX's ``sum``."""
    k, s = w.shape[0], xbc.shape[1]
    pad = (torch.zeros((xbc.shape[0], k - 1, xbc.shape[-1]), dtype=xbc.dtype,
                       device=xbc.device)
           if state is None else state.to(xbc.dtype))
    xp = torch.cat([pad, xbc], dim=1)
    wf = w.to(F32)
    out = xp[:, 0:s] * wf[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * wf[i]
    new_state = xp[:, xp.shape[1] - (k - 1):] if k > 1 else pad
    return _silu(out + b.to(F32)), new_state


def _segsum(x):
    """Log-space segment sums: ``out[..., i, j] = sum_{j < k <= i} x[...,
    k]``; -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(q, device=x.device)
    return torch.where(idx[:, None] >= idx[None, :], diff, -torch.inf)


def _chunked(t, nc: int, q: int):
    """[B, nc*q, ...] -> nc views [B, q, ...]."""
    return t.reshape((t.shape[0], nc, q) + tuple(t.shape[2:])).unbind(1)


def _pad_time(t, pad: int, value: float = 0.0):
    """Right-pads axis 1 of ``t`` by ``pad`` steps of ``value``."""
    widths = [0, 0] * (t.dim() - 2) + [0, pad]
    return F.pad(t, widths, value=value)


def mamba2_mix(x, params, cfg: Mamba2Config, policy, *,
               cache: Optional[Mamba2Cache] = None, group=None):
    """x [B, S, D] -> (y [B, S, D], new cache or None).

    Chunked SSD over ``S / chunk`` chunks (the last padded with ``dt =
    0``, so the pad neither decays nor feeds the state), carrying the
    [B, H, P, N] f32 state from ``cache.ssm`` (zeros without a cache).
    ``group``: tensor parallel over its ranks (module docstring)."""
    b, s, _ = x.shape
    h, p, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    d_proj = 2 * cfg.d_inner + 2 * g * n + h
    x = col_input(x, params["in_proj"], d_proj, group)
    zxbcdt, conv_w, conv_b = whole_cols(
        [tp.tp_einsum("bsd,de->bse", x, params["in_proj"], policy,
                      out_fmt="fp32"), params["conv_w"], params["conv_b"]],
        [d_proj, cfg.conv_dim, cfg.conv_dim],
        group)
    z, xbc, dt = _split_zxbcdt(zxbcdt, cfg)
    xbc, new_conv = _causal_conv(xbc, conv_w, conv_b,
                                 cache.conv if cache is not None else None)
    di = cfg.d_inner
    xin = xbc[..., :di].reshape(b, s, h, p)
    rep = h // g
    Bh = xbc[..., di:di + g * n].reshape(b, s, g, n).repeat_interleave(
        rep, dim=2)                                    # [B, S, H, N]
    Ch = xbc[..., di + g * n:].reshape(b, s, g, n).repeat_interleave(
        rep, dim=2)
    A = -torch.exp(params["A_log"])                    # [H], negative
    dt = _softplus(dt + params["dt_bias"])             # [B, S, H]

    q = min(cfg.chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        xin, Bh, Ch, dt = (_pad_time(t, pad) for t in (xin, Bh, Ch, dt))

    state = (cache.ssm.to(F32) if cache is not None else
             torch.zeros((b, h, p, n), dtype=F32, device=x.device))
    ys = []
    for xq, bq, cq, dq in zip(*(_chunked(t, nc, q)
                                for t in (xin, Bh, Ch, dt))):
        da_t = (dq * A).transpose(1, 2)                # [B, H, q] log-decay
        L = torch.exp(_segsum(da_t))                   # [B, H, q, q]
        # intra-chunk: Y[i] = sum_{j <= i} (C_i . B_j) L_ij dt_j x_j
        cb = tp.tp_einsum("bihn,bjhn->bhij", cq, bq, policy, out_fmt="fp32")
        w = cb * L * dq.transpose(1, 2)[:, :, None, :]
        y_intra = tp.tp_einsum("bhij,bjhp->bihp", w, xq, policy,
                               out_fmt="fp32")
        # inter-chunk: the carried state's contribution
        cumda = torch.cumsum(da_t, dim=-1)             # [B, H, q]
        y_inter = tp.tp_einsum("bihn,bhpn->bihp", cq, state, policy,
                               out_fmt="fp32")
        ys.append(y_intra + y_inter
                  * torch.exp(cumda).transpose(1, 2)[..., None])
        # S' = exp(sum da) S + sum_j exp(sum_{k > j} da) dt_j x_j B_j^T
        total = cumda[..., -1]                         # [B, H]
        decay_j = torch.exp(total[..., None] - cumda)  # [B, H, q]
        wx = xq * (dq * decay_j.transpose(1, 2))[..., None]
        state = (state * torch.exp(total)[..., None, None]
                 + tp.tp_einsum("bjhp,bjhn->bhpn", wx, bq, policy,
                                out_fmt="fp32"))
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + xin[:, :s] * params["D"][:, None]
    y = y.reshape(b, s, di)
    # gated RMSNorm (Mamba2's norm_before_gate=False): norm(y * silu(z))
    y = rmsnorm(y * _silu(z), params["norm"])
    out = row_project(y, params["out_proj"], policy, group,
                      lambda a, w: tp.tp_einsum("bse,ed->bsd", a, w, policy))
    new_cache = (Mamba2Cache(new_conv.to(cache.conv.dtype), state)
                 if cache is not None else None)
    return out, new_cache


def init_mamba2_cache(batch: int, cfg: Mamba2Config, dtype,
                      device) -> Mamba2Cache:
    return Mamba2Cache(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                        dtype=F32, device=device))


# ---------------------------------------------------------------------------
# mLSTM: matrix-memory LSTM, chunkwise parallel (xLSTM)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MLSTMConfig:
    d_model: int
    n_heads: int = 4
    proj_factor: float = 2.0
    d_conv: int = 4
    chunk: int = 128
    # beyond-paper: the intra-chunk [q, q] gate / weight tensors in bf16
    # (log-space stabilisers stay f32)
    narrow_intra: bool = False

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)

    @property
    def head_dim(self) -> int:
        assert self.d_inner % self.n_heads == 0
        return self.d_inner // self.n_heads


class MLSTMCache(NamedTuple):
    conv: torch.Tensor   # [B, d_conv-1, d_inner]
    c: torch.Tensor      # [B, H, dk, dv] matrix memory (f32)
    nrm: torch.Tensor    # [B, H, dk] normaliser (f32)
    m: torch.Tensor      # [B, H] log-stabiliser (f32)


def mlstm_params(gen: torch.Generator, cfg: MLSTMConfig, dtype,
                 device) -> dict:
    """JAX's ``mlstm_params`` distributions: ``up_proj`` (x branch and z
    gate), the conv, headwise (block-diagonal) q / k / v [H, dk, dk], the
    i / f gate heads ``w_if`` with ``b_if = [0 (H), linspace(3, 6, H)]``,
    the per-head out norm ``ln`` and ``down_proj``."""
    d, di, h, dk = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.head_dim
    heads = lambda: _randn(gen, (h, dk, dk), dk ** -0.5, dtype, device)
    return {
        "up_proj": dense_init(gen, d, 2 * di, dtype, device),
        "conv_w": _randn(gen, (cfg.d_conv, di), cfg.d_conv ** -0.5, dtype,
                         device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "wq_h": heads(), "wk_h": heads(), "wv_h": heads(),
        "w_if": dense_init(gen, di, 2 * h, dtype, device),
        "b_if": torch.cat([torch.zeros((h,), dtype=F32, device=device),
                           _forget_bias(h, device)]),
        "ln": torch.zeros((di,), dtype=dtype, device=device),
        "down_proj": dense_init(gen, di, d, dtype, device),
    }


def mlstm_mix(x, params, cfg: MLSTMConfig, policy, *,
              cache: Optional[MLSTMCache] = None, group=None):
    """Chunkwise-parallel mLSTM with log-space gate stabilisation.

    Within a chunk, ``W_ij = exp(F_i - F_j + logi_j - m_i)`` weighs the
    intra-chunk term; the inter-chunk term reads the carried matrix
    memory ``C``.  A padded last chunk gets ``logi = -1e30`` (no input)
    and ``logf = 0`` (no decay), so the final state does not see it.
    ``group``: tensor parallel over its ranks (module docstring)."""
    b, s, _ = x.shape
    h, dk, di = cfg.n_heads, cfg.head_dim, cfg.d_inner
    narrow = cfg.narrow_intra
    act_fmt = "fp16alt" if narrow else "fp32"
    intra_dt = torch.bfloat16 if narrow else F32
    x = col_input(x, params["up_proj"], 2 * di, group)
    up, conv_w, conv_b, w_if = whole_cols(
        [tp.tp_einsum("bsd,de->bse", x, params["up_proj"], policy,
                      out_fmt=act_fmt), params["conv_w"], params["conv_b"],
         params["w_if"]], [2 * di, di, di, 2 * h], group)
    xb, z = up[..., :di], up[..., di:]
    xc, new_conv = _causal_conv(xb, conv_w, conv_b,
                                cache.conv if cache is not None else None)
    xch = xc.to(up.dtype).reshape(b, s, h, dk)
    xbh = xb.reshape(b, s, h, dk)
    q = tp.tp_einsum("bshe,hef->bshf", xch, params["wq_h"], policy,
                     out_fmt=act_fmt)
    k = tp.tp_einsum("bshe,hef->bshf", xch, params["wk_h"], policy,
                     out_fmt=act_fmt) * dk ** -0.5
    v = tp.tp_einsum("bshe,hef->bshf", xbh, params["wv_h"], policy,
                     out_fmt=act_fmt)
    gates = (tp.tp_einsum("bse,eg->bsg", xb, w_if, policy,
                          out_fmt="fp32") + params["b_if"])
    logi = gates[..., :h]                              # [B, S, H]
    logf = _log_sigmoid(gates[..., h:])

    qq = min(cfg.chunk, s)
    nc = -(-s // qq)
    pad = nc * qq - s
    if pad:
        q, k, v, logf = (_pad_time(t, pad) for t in (q, k, v, logf))
        logi = _pad_time(logi, pad, NEG)

    if cache is not None:
        C, nrm, m = cache.c.to(F32), cache.nrm.to(F32), cache.m.to(F32)
    else:
        C = torch.zeros((b, h, dk, dk), dtype=F32, device=x.device)
        nrm = torch.zeros((b, h, dk), dtype=F32, device=x.device)
        m = torch.full((b, h), NEG, dtype=F32, device=x.device)
    ys = []
    for qi, ki, vi, li, fi in zip(*(_chunked(t, nc, qq)
                                    for t in (q, k, v, logi, logf))):
        fT, lT = fi.transpose(1, 2), li.transpose(1, 2)   # [B, H, q]
        F_cum = torch.cumsum(fT, dim=-1)
        # intra log-weights D_ij = F_i - F_j + logi_j (j <= i)
        D = _segsum(fT) + lT[:, :, None, :]            # [B, H, q, q]
        m_inter = F_cum + m[..., None]
        m_i = torch.maximum(D.amax(dim=-1), m_inter)
        W = torch.exp(D - m_i[..., None]).to(intra_dt)
        qk = tp.tp_einsum("bihe,bjhe->bhij", qi, ki, policy,
                          out_fmt=act_fmt)
        wq_ = (W * qk).to(intra_dt)
        h_intra = tp.tp_einsum("bhij,bjhe->bihe", wq_, vi, policy,
                               out_fmt="fp32")
        inter_scale = torch.exp(m_inter - m_i)         # [B, H, q]
        h_inter = (tp.tp_einsum("bihe,bhef->bihf", qi, C, policy,
                                out_fmt="fp32")
                   * inter_scale.transpose(1, 2)[..., None])
        # normaliser: max(|W (q.k) row sums + q . n|, exp(-m))
        n_intra = torch.sum(wq_.to(F32), dim=-1)
        n_inter = tp.tp_einsum("bihe,bhe->bhi", qi, nrm, policy,
                               out_fmt="fp32") * inter_scale
        denom = torch.maximum(torch.abs(n_intra + n_inter), torch.exp(-m_i))
        ys.append((h_intra + h_inter) / denom.transpose(1, 2)[..., None])
        # carry update
        F_tot = F_cum[..., -1]                         # [B, H]
        m_new = torch.maximum(F_tot + m, torch.amax(
            lT + (F_tot[..., None] - F_cum), dim=-1))
        kv_scale = torch.exp(lT + F_tot[..., None] - F_cum - m_new[..., None])
        kw = ki * kv_scale.transpose(1, 2)[..., None]
        decay = torch.exp(F_tot + m - m_new)
        C = (C * decay[..., None, None]
             + tp.tp_einsum("bjhe,bjhf->bhef", kw, vi, policy,
                            out_fmt="fp32"))
        nrm = nrm * decay[..., None] + torch.sum(kw, dim=1)
        m = m_new
    y = torch.cat(ys, dim=1)[:, :s].reshape(b, s, di)
    y = rmsnorm(y, params["ln"])
    y = y * _silu(z)                                   # output gate branch
    out = row_project(y, params["down_proj"], policy, group,
                      lambda a, w: tp.tp_einsum("bse,ed->bsd", a, w, policy))
    new_cache = (MLSTMCache(new_conv.to(cache.conv.dtype), C, nrm, m)
                 if cache is not None else None)
    return out, new_cache


def init_mlstm_cache(batch: int, cfg: MLSTMConfig, dtype,
                     device) -> MLSTMCache:
    h, dk = cfg.n_heads, cfg.head_dim
    return MLSTMCache(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype,
                         device=device),
        c=torch.zeros((batch, h, dk, dk), dtype=F32, device=device),
        nrm=torch.zeros((batch, h, dk), dtype=F32, device=device),
        m=torch.full((batch, h), NEG, dtype=F32, device=device))


# ---------------------------------------------------------------------------
# sLSTM: scalar-memory LSTM with exponential gating (xLSTM)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SLSTMConfig:
    d_model: int
    n_heads: int = 4
    proj_factor: float = 4.0 / 3.0

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


class SLSTMCache(NamedTuple):
    c: torch.Tensor     # [B, D] cell
    nrm: torch.Tensor   # [B, D] normaliser
    m: torch.Tensor     # [B, D] stabiliser
    h: torch.Tensor     # [B, D] hidden (the recurrent input)


def slstm_params(gen: torch.Generator, cfg: SLSTMConfig, dtype,
                 device) -> dict:
    """JAX's ``slstm_params`` distributions: the input gates ``w_gates``
    (i, f, z, o), the block-diagonal recurrent ``r_gates`` [4, H, dh, dh],
    ``b_gates = [0 (D), linspace(3, 6, D), 0 (2D)]``, the norm ``ln`` and
    the gated FFN tail ``up`` / ``down`` (width ``int(proj_factor D)``)."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    dff = int(cfg.proj_factor * d)
    zeros = lambda k: torch.zeros((k,), dtype=F32, device=device)
    return {
        "w_gates": dense_init(gen, d, 4 * d, dtype, device),
        "r_gates": _randn(gen, (4, h, dh, dh), dh ** -0.5, dtype, device),
        "b_gates": torch.cat([zeros(d), _forget_bias(d, device),
                              zeros(2 * d)]),
        "ln": torch.zeros((d,), dtype=dtype, device=device),
        "up": dense_init(gen, d, 2 * dff, dtype, device),
        "down": dense_init(gen, dff, d, dtype, device),
    }


def slstm_mix(x, params, cfg: SLSTMConfig, policy, *,
              cache: Optional[SLSTMCache] = None, group=None):
    """A sequential loop over time (the sLSTM's memory mixing is
    recurrent), then the norm and the gated gelu FFN tail.  ``group``:
    tensor parallel over its ranks (module docstring)."""
    b, s, d = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    gx = tp.tp_einsum("bsd,dg->bsg", x, params["w_gates"], policy,
                      out_fmt="fp32") + params["b_gates"]
    if cache is not None:
        c, nrm, m, hp = (t.to(F32) for t in cache)
    else:
        c = nrm = hp = torch.zeros((b, d), dtype=F32, device=x.device)
        m = torch.full((b, d), NEG, dtype=F32, device=x.device)
    r = params["r_gates"].to(F32)
    ys = []
    for t in range(s):
        rec = torch.einsum("bhe,ghef->bghf", hp.reshape(b, h, dh),
                           r).reshape(b, 4 * d)
        gi, gf, gz, go = (gx[:, t] + rec).chunk(4, dim=-1)
        m_new = torch.maximum(gf + m, gi)
        i_ = torch.exp(gi - m_new)
        f_ = torch.exp(gf + m - m_new)
        c = f_ * c + i_ * torch.tanh(gz)
        nrm = torch.maximum(f_ * nrm + i_, torch.exp(-m_new))
        hp = torch.sigmoid(go) * c / nrm
        m = m_new
        ys.append(hp)
    y = rmsnorm(torch.stack(ys, dim=1), params["ln"])  # [B, S, D]
    # gated FFN tail (part of the sLSTM block in xLSTM)
    dff = int(cfg.proj_factor * d)
    y = col_input(y, params["up"], 2 * dff, group)
    uu, = whole_cols([tp.tp_einsum("bsd,df->bsf", y, params["up"], policy)],
                     [2 * dff], group)
    y = tp.tp_elementwise("gelu", uu[..., :dff], policy=policy) \
        * uu[..., dff:]
    out = row_project(y, params["down"], policy, group,
                      lambda a, w: tp.tp_einsum("bsf,fd->bsd", a, w, policy))
    new_cache = SLSTMCache(c, nrm, m, hp) if cache is not None else None
    return out, new_cache


def init_slstm_cache(batch: int, cfg: SLSTMConfig, dtype,
                     device) -> SLSTMCache:
    """All f32 (``dtype`` is unused, as in JAX)."""
    zeros = lambda: torch.zeros((batch, cfg.d_model), dtype=F32,
                                device=device)
    return SLSTMCache(zeros(), zeros(),
                      torch.full((batch, cfg.d_model), NEG, dtype=F32,
                                 device=device), zeros())
