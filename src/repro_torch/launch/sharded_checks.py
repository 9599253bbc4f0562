"""What the sharded serving path is checked on: the same cases run
unsharded in one process and sharded on every rank of a mesh
(``launch.spmd.spawn(rank_main, ...)``), and the caller holds the two
against each other.  The rank function lives here, in an importable
module: under ``spawn`` a function of a test module or a ``__main__``
script cannot be pickled into the child.

Each case is ``fn(mesh, rmesh, device, **kw) -> dict`` (tensors moved to
the CPU), ``mesh`` the serving mesh (None: unsharded) and ``rmesh`` this
rank's ``("model",)`` replica sub-mesh of it:

  * ``attend``: one GQA layer at ``B, S, DM, H, HKV, HD`` on every read
    route (dense and kernel; contiguous and paged prefill, paged at query
    offsets 0 and 4; contiguous and paged decode; the speculative verify
    read; cross-attention prefill and cached decode), the per-head attend
    outputs of this rank's heads (``return_attend``), and the projected
    outputs under ``tp_bf16`` and ``fp32``;
  * ``logits``: a model's prefill logits from the given full weights,
    this rank's parameter bytes and greedy ``generate`` tokens;
  * ``engine``: a ``ContinuousEngine`` run's token streams and stats;
  * ``replicated``: a ``ReplicatedEngine`` over the whole ``(dp, tp)``
    mesh: streams, order and the fleet stats;
  * ``fleet_ha``: a journaled ``ReplicatedEngine`` (on the mesh, or the
    meshless fleet of ``replicas``) under a replica fault plan: streams,
    schedule, heartbeats, ``ha_*``, the journal's bytes, moved blobs;
  * ``moe``: ``moe_block`` with its router choices and dropped (token,
    slot) set recorded;
  * ``reads``: one layer's decode and prefill reads through the kernels'
    wrappers on the same q and pools, this rank's heads.

``card_rank`` runs chip_smoke's tp phase on each rank of one card:
``card_engine`` (gemma2-9b through the paged engine) and ``card_arch``
(through ``generate``: qwen3-moe with the oracle's expert choices, then
``moe_block`` alone; MLA's minicpm3 and deepseek, with ``mla_reads``;
the recurrent zamba2 and xlstm), each between a reset and a read of the
attention kernels' launch counters, on a ``(1, world)`` mesh; then
``card_fleet`` (the sharded fleet's legs, faults and journal) on a
``(world, 1)`` mesh.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

from ..models import attention as attn
from ..models import moe as moe_mod
from ..models.paged import init_paged_kv_cache
from ..models.registry import build_model
from ..models.sharding import shard_params
from . import spmd
from .engine import ContinuousEngine, ReplicatedEngine, synthetic_trace
from .mesh import make_serving_mesh, replica_meshes

F32 = torch.float32
B, S, DM, H, HKV, HD = 2, 16, 32, 8, 8, 16
PAGE, MAXLEN, FRAMES, VERIFY = 8, 32, 12, 3


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def attend_inputs(device):
    """The layer's weights and inputs, from a CPU generator seeded 0."""
    gen = torch.Generator().manual_seed(0)
    params = attn.gqa_params(gen, DM, H, HKV, HD, F32, "cpu")
    x = torch.randn((B, S, DM), generator=gen)
    x1 = torch.randn((B, 1, DM), generator=gen)
    xv = torch.randn((B, VERIFY, DM), generator=gen)
    enc = torch.randn((B, FRAMES, DM), generator=gen)
    mv = lambda t: t.to(device)
    return ({k: mv(v) for k, v in params.items()}, mv(x), mv(x1), mv(xv),
            mv(enc))


def attend(mesh, rmesh, device, policies=("tp_bf16", "fp32")) -> dict:
    params, x, x1, xv, enc = attend_inputs(device)
    shards = attn._head_shard_size(rmesh, H, HKV) or 1
    if shards > 1:
        params = shard_params(params, rmesh)
    hkv = HKV // shards
    dev = torch.device(device)
    pos = torch.arange(S, device=dev)
    full = lambda v: torch.full((B,), v, dtype=torch.int64, device=dev)
    p1 = full(S)[:, None, None]
    out = {}

    def call(x_, pos_, policy="tp_bf16", **kw):
        return attn.gqa_attention(x_, params, policy, n_heads=H,
                                  n_kv_heads=HKV, head_dim=HD,
                                  positions=pos_, mesh=rmesh, **kw)

    def read(x_, pos_, **kw):
        return call(x_, pos_, return_attend=True, **kw)[0]

    def kv(paged):
        if paged:
            return init_paged_kv_cache(B, hkv, MAXLEN, PAGE, HD, F32,
                                       device=dev)
        return attn.init_kv_cache(B, hkv, MAXLEN, HD, F32, dev)

    for be in ("dense", "auto"):
        out[f"prefill_{be}"] = read(x, pos, prefill_backend=be)
        for off in (0, 4):
            out[f"paged_prefill_{be}_{off}"] = read(
                x, pos + off, cache=kv(True), cache_pos=off,
                kv_len=full(off + S), prefill_backend=be)
        for paged in (False, True):
            _, cache = call(x, pos, cache=kv(paged), cache_pos=0,
                            kv_len=full(S), prefill_backend=be)
            name = "paged_decode" if paged else "decode"
            out[f"{name}_{be}"] = read(
                x1, p1, cache=cache, cache_pos=full(S), kv_len=full(S + 1),
                decode_backend=be)
            offs = full(S)[:, None] + torch.arange(VERIFY, device=dev)
            out[f"{'paged_' if paged else ''}verify_{be}"] = read(
                xv, offs[:, None, :], cache=cache, cache_pos=full(S),
                kv_len=offs + 1, decode_backend=be, verify=True)
        xc = attn.init_kv_cache(B, hkv, FRAMES, HD, F32, dev)
        out[f"cross_{be}"] = read(x, pos, kv_states=enc, causal=False,
                                  use_rope=False, cache=xc, cache_pos=0,
                                  prefill_backend=be)
        out[f"cross_decode_{be}"] = attn.cross_attend_cached(
            x1, params, xc, "tp_bf16", n_heads=H, n_kv_heads=HKV,
            head_dim=HD, backend=be, mesh=rmesh, return_attend=True)
    for pol in policies:
        out[f"proj_{pol}"] = call(x, pos, policy=pol)[0]
        out[f"proj_decode_{pol}"] = call(
            x1, p1, policy=pol, cache=call(x, pos, policy=pol,
                                           cache=kv(True), cache_pos=0,
                                           kv_len=full(S))[1],
            cache_pos=full(S), kv_len=full(S + 1))[0]
    return _cpu(out)


def _model(arch, policy, device, **cfg):
    return build_model(arch, policy=policy, reduced=True, device=device,
                       **cfg)


def logits(mesh, rmesh, device, *, params, tokens, arch="gemma2-9b",
           policy="fp32", max_len=24, gen_len=0) -> dict:
    """A model's prefill logits from the given full weights (the last
    position's), this rank's parameter bytes and, with ``gen_len``,
    greedy ``generate`` tokens."""
    model = _model(arch, policy, device)
    p = shard_params(_to(params, device), rmesh, model.cfg)
    toks = torch.as_tensor(tokens, device=device)
    lg, _ = model.prefill(p, toks, max_len=max(max_len,
                                               toks.shape[1] + gen_len),
                          mesh=rmesh)
    out = {"logits": lg.cpu(), "param_bytes": weights_bytes(p)}
    if gen_len:
        out["tokens"] = model.generate(p, toks, gen_len=gen_len,
                                       mesh=rmesh)[0].cpu()
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _trace(model, n_req=6, slots=3, plen=16, gen=16):
    reqs = synthetic_trace(n_req, slots, plen, gen, model.cfg.vocab)
    return reqs, max(r.prompt_len + r.max_new for r in reqs)


def engine(mesh, rmesh, device, *, params, arch="gemma2-9b",
           policy="tp_bf16", slots=3) -> dict:
    model = _model(arch, policy, device, paged_kv=True, page_size=16)
    reqs, max_len = _trace(model, slots=slots)
    t0 = time.perf_counter()
    fin, st = ContinuousEngine(model, _to(params, device), slots=slots,
                               max_len=max_len, chunk=8,
                               mesh=rmesh).run(reqs)
    return {"tokens": [list(f.tokens) for f in fin],
            "rids": [f.rid for f in fin],
            "decode_rounds": st["decode_rounds"],
            "seconds": time.perf_counter() - t0}


def replicated(mesh, rmesh, device, *, params, arch="gemma2-9b",
               policy="tp_bf16", slots=3) -> dict:
    model = _model(arch, policy, device, paged_kv=True, page_size=16)
    reqs, max_len = _trace(model, slots=slots)
    fin, st = ReplicatedEngine(model, _to(params, device), mesh=mesh,
                               slots=slots, max_len=max_len,
                               chunk=8).run(reqs)
    keep = ("replicas_n", "decode_rounds", "bursts", "rounds")
    return {"tokens": [list(f.tokens) for f in fin],
            "rids": [f.rid for f in fin],
            "stats": {k: st[k] for k in keep},
            "pool": {"n_pages": st["pool"]["n_pages"],
                     "replica_pages": [r["n_pages"]
                                       for r in st["pool"]["replicas"]]},
            "replica_rounds": [r["decode_rounds"] for r in st["replicas"]]}


#: the fleet cases' engines (``tests/test_torch_replica_ha.py``'s)
FLEET = dict(slots=2, chunk=8, burst_cap=4)


def fleet_queue(vocab: int, queue: str):
    """``short``: eight mixed requests over two arrival waves (a kill
    lands mid-run with residents in flight); ``long``: four long-budget
    residents, mid-decode for several bursts (a hang finds pages to
    swap)."""
    if queue == "short":
        return synthetic_trace(8, 4, 16, 8, vocab)
    import numpy as np
    from .engine import Request
    rng = np.random.RandomState(3)
    return [Request(rid=i, tokens=rng.randint(0, vocab, size=6).tolist(),
                    max_new=14, arrival=0) for i in range(4)]


def fault_plan(faults):
    """``faults``: ``(replica, at_burst, mode)`` triples -> one plan, or
    ``ReplicaFaultPlans`` of several (None for none)."""
    from ..train.fault import ReplicaFaultPlan, ReplicaFaultPlans
    plans = [ReplicaFaultPlan(replica=r, at_burst=b, mode=m)
             for r, b, m in faults]
    if not plans:
        return None
    return plans[0] if len(plans) == 1 else ReplicaFaultPlans(plans)


def fleet_run(model, params, mesh, reqs, *, journal, faults=(),
              replicas=2, restarts=0, **kw) -> dict:
    """A journaled ``ReplicatedEngine`` under the ``faults`` plan: on the
    ``(dp, tp)`` mesh, or (``mesh=None``) the meshless fleet of
    ``replicas``.  ``restarts``: the run goes through
    ``run_with_restarts`` (at most that many), then answers the queue
    again from the journal.  Returns the streams, the schedule fields,
    heartbeats, ``ha_*`` counters, the journal file's bytes (from the
    process that writes it), what moved and the wall time."""
    from ..train.fault import run_with_restarts
    from .journal import RequestJournal
    max_len = max(r.prompt_len + r.max_new for r in reqs)
    jr = RequestJournal(journal)
    fleet = ReplicatedEngine(model, params, mesh=mesh, replicas=replicas,
                             max_len=max_len, journal=jr,
                             replica_fault=fault_plan(faults), **kw)
    used = None
    t0 = time.perf_counter()
    if restarts:
        _, used = run_with_restarts(lambda: fleet.bind(reqs),
                                    max_restarts=restarts)
    fin, st = fleet.run(reqs)
    wall = time.perf_counter() - t0
    jr.close()
    data = None
    if mesh is None or mesh.rank == 0:
        with open(journal, "rb") as f:
            data = f.read()
    fields = ("rid", "admit_round", "finish_round", "slot", "preemptions")
    return {"tokens": {f.rid: list(f.tokens) for f in fin},
            "schedule": [[getattr(f, k) for k in fields] for f in fin],
            "heartbeats": st["heartbeats"],
            "ha": {k: v for k, v in st.items() if k.startswith("ha_")},
            "sdc_detected": st["sdc_detected"], "restarts": used,
            "bursts": [r["bursts"] for r in st["replicas"]],
            "journal": data, "migration": st.get("migration"),
            "wall_s": wall}


def fleet_ha(mesh, rmesh, device, *, params, journal, queue="short",
             arch="gemma2-9b", policy="tp_bf16", **kw) -> dict:
    """``fleet_run`` of reduced ``arch`` (paged at 16 tokens) on a
    ``fleet_queue``, the engines ``FLEET``'s unless ``kw`` says
    otherwise."""
    model = _model(arch, policy, device, paged_kv=True, page_size=16)
    reqs = fleet_queue(model.cfg.vocab, queue)
    return fleet_run(model, _to(params, device), mesh, reqs,
                     journal=journal, **dict(FLEET, **kw))


def moe_inputs(capacity_factor: Optional[float] = None, device="cpu"):
    cfg = moe_mod.MoEConfig(n_experts=8, top_k=2, d_expert=16, n_shared=1,
                            capacity_factor=capacity_factor)
    gen = torch.Generator().manual_seed(0)
    params = moe_mod.moe_params(gen, 32, cfg, F32, "cpu")
    x = torch.randn((2, 16, 32), generator=gen)
    return cfg, _to(params, device), x.to(device)


def moe_probe(params, cfg, x, mesh, policy, with_aux=True) -> dict:
    """``moe_block`` on ``x`` with the routing it made: ``idx`` [T, k] and
    the ``dropped`` mask of the flat assignments."""
    seen = {}
    real = moe_mod.dispatch_slots

    def spy(idx, cap, n_experts):
        order, slot = real(idx, cap, n_experts)
        dropped = torch.empty_like(slot, dtype=torch.bool)
        dropped[order] = slot == n_experts * cap
        seen.update(idx=idx.cpu(), dropped=dropped.cpu())
        return order, slot

    moe_mod.dispatch_slots = spy
    try:
        y, aux = moe_mod.moe_block(x, params, cfg, policy, mesh=mesh,
                                   with_aux=with_aux)
    finally:
        moe_mod.dispatch_slots = real
    return {"y": y.float().cpu(),
            "aux": None if aux is None else aux.cpu(), **seen}


def moe(mesh, rmesh, device, *, capacity_factor=None, policy="fp32") -> dict:
    cfg, params, x = moe_inputs(capacity_factor, device)
    if rmesh is not None:
        params = shard_params(params, rmesh)
    return moe_probe(params, cfg, x, rmesh, policy)


def reads(mesh, rmesh, device, *, heads, kv_heads, head_dim) -> dict:
    """``attend_reads``: this rank's heads of one layer's kernel reads on
    the same q and pools, the decode read at the unsharded split."""
    shards = attn._head_shard_size(rmesh, heads, kv_heads) or 1
    return attend_reads(heads, kv_heads, head_dim, shards=shards,
                        rank=rmesh.coords["model"] if shards > 1 else 0,
                        device=device)


CASES = {"attend": attend, "logits": logits, "engine": engine,
         "replicated": replicated, "fleet_ha": fleet_ha, "moe": moe,
         "reads": reads}


def run_plan(plan, device="cpu") -> dict:
    """Run ``plan`` (a list of ``(name, case, (dp, tp), kwargs)``) on this
    rank: ``(dp, tp) = None`` is the unsharded run, otherwise every rank
    builds the mesh (a collective) and those inside it run the case."""
    out = {}
    for name, case, dims, kw in plan:
        mesh = rmesh = None
        if dims is not None:
            mesh = make_serving_mesh(*dims)
            if not mesh.member:
                continue
            rmesh = replica_meshes(mesh)[mesh.coords["data"]]
        spmd.reset_stats()
        out[name] = CASES[case](mesh, rmesh, device, **kw)
        out[name]["spmd"] = dict(spmd.STATS)
    return out


def rank_main(rank: int, world: int, plan, device="cpu",
              threads: int = 1) -> dict:
    """The spawned rank: ``run_plan`` with its coordinates attached."""
    torch.set_num_threads(threads)
    out = run_plan(plan, device)
    out["rank"] = rank
    return out


def head_slice(t: torch.Tensor, rank: int, shards: int) -> torch.Tensor:
    """Rank ``rank``'s heads of a [B, H, ...] unsharded attend output."""
    n = t.shape[1] // shards
    return t[:, rank * n:(rank + 1) * n]


# ---------------------------------------------------------------------------
# the card: two ranks of one H100 over gloo (chip_smoke's tp phase)
# ---------------------------------------------------------------------------
def attention_launches() -> dict:
    """The two attention kernels' launch counters as their wrappers keep
    them (the count since the last ``reset_attention_launches``), beside
    the query tiles ``kernels.ops`` picked for its default flash calls
    and how many of its picks a tuned winner made."""
    from ..kernels import ops as kops
    from ..kernels.decode_attention import decode_attention_cuda as dec
    from ..kernels.flash_attention import flash_attention_cuda as fla
    return dict(
        flash_launches_by_q_rows=dict(fla.launches_by_q_rows),
        flash_picks_by_q_rows=dict(kops.picked["attn"]),
        tuned_picks=dict(kops.tuned),
        launches={"decode_attention": dec.launches,
                  "flash_attention": fla.launches},
        variants={"flash_attention": {"tc": fla.launches_tc,
                                      "split": fla.launches_split,
                                      "fma": fla.launches_fma},
                  "decode_attention": {"mma": dec.launches_mma,
                                       "fma": dec.launches_fma}},
        decode_launches_by_cluster=dict(dec.launches_by_cluster),
        decode_launches_by_group=dict(dec.launches_by_group),
        flash_launches_by_dims={f"{d}x{dv}": n for (d, dv), n
                                in fla.launches_by_dims.items()},
        flash_launches_noncausal=fla.launches_noncausal)


def reset_attention_launches() -> None:
    from ..kernels import ops as kops
    from ..kernels.decode_attention import decode_attention_cuda as dec
    from ..kernels.flash_attention import flash_attention_cuda as fla
    dec.launches = fla.launches = fla.launches_noncausal = 0
    dec.launches_mma = dec.launches_fma = 0
    fla.launches_tc = fla.launches_split = fla.launches_fma = 0
    for d in (dec.launches_by_cluster, dec.launches_by_group,
              fla.launches_by_dims, fla.launches_by_q_rows):
        d.clear()
    kops.reset_picked()


def weights_digest(params) -> float:
    """An f64 sum of every leaf's f32 sum: ranks that build their weights
    from the same seed must agree with the process that served the
    unsharded oracle."""
    if isinstance(params, dict):
        return sum(weights_digest(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(weights_digest(v) for v in params)
    return float(params.sum(dtype=F32))


#: the attend read of one gemma2-9b layer: 16 rows (the slice's 16-slot
#: decode case: the unsharded call splits a row over 4 CTAs, a half of the
#: heads alone over 8) of pages of 64, softcap 50; a 128-query chunk of
#: row 0
READ_LENS = (1024, 130, 512, 777) * 4
READ_PAGE, READ_PAGES, READ_CHUNK = 64, 16, 128


def attend_read_inputs(heads: int, kv_heads: int, head_dim: int,
                       seed: int = 0):
    """q for a decode read and a prefill chunk, bf16 page pools and a
    shuffled block table, made on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    b, n_pages = len(READ_LENS), len(READ_LENS) * READ_PAGES + 1
    bf = torch.bfloat16
    pool = lambda: torch.randn((n_pages, kv_heads, READ_PAGE, head_dim),
                               generator=gen).to(bf)
    kp, vp = pool(), pool()
    table = torch.randperm(n_pages - 1, generator=gen)[
        :b * READ_PAGES].reshape(b, READ_PAGES).to(torch.int32) + 1
    q = torch.randn((b, heads, 1, head_dim), generator=gen).to(bf)
    qc = torch.randn((1, heads, READ_CHUNK, head_dim), generator=gen).to(bf)
    return q, qc, kp, vp, table


def attend_reads(heads, kv_heads, head_dim, *, shards: int = 1,
                 rank: int = 0, softcap=50.0, seed: int = 0,
                 device="cuda") -> dict:
    """This rank's heads of one layer's decode and prefill reads through
    the kernels' wrappers, the decode read at the unsharded call's split
    partition (``cluster``) — what ``gqa_attention`` pins under a mesh —
    and the largest difference the rows' own split (``own_cluster``)
    would make (``own_split_diff``)."""
    from ..kernels import ops as kops
    q, qc, kp, vp, table = (t.to(device) for t in attend_read_inputs(
        heads, kv_heads, head_dim, seed))
    h, hk = heads // shards, kv_heads // shards
    q, qc = q[:, rank * h:(rank + 1) * h], qc[:, rank * h:(rank + 1) * h]
    kp, vp = (p[:, rank * hk:(rank + 1) * hk].contiguous() for p in (kp, vp))
    lens = torch.tensor(READ_LENS, device=device)
    b = len(READ_LENS)
    pinned = kops.decode_cluster(b * shards, kp, table, group=h // hk)
    dec = kops.decode_attention(q, kp, vp, kv_len=lens, block_table=table,
                                policy="tp_bf16", softcap=softcap,
                                cluster=pinned)
    off = READ_LENS[0] - READ_CHUNK
    fla = kops.flash_attention(qc, kp, vp, kv_len=lens[:1],
                               block_table=table[:1], policy="tp_bf16",
                               scale=head_dim ** -0.5, causal=True,
                               softcap=softcap, q_offset=off)
    own = kops.decode_cluster(b, kp, table, group=h // hk)
    mine = kops.decode_attention(q, kp, vp, kv_len=lens, block_table=table,
                                 policy="tp_bf16", softcap=softcap,
                                 cluster=own)
    return {"decode": dec.cpu(), "flash": fla.cpu(), "cluster": pinned,
            "own_cluster": own,
            "own_split_diff": float((mine - dec).abs().max())}


def _card_model(arch, layers, seed, device, reduced=False, **cfg):
    """``arch`` under ``tp_bf16`` at full width (``reduced``: its reduced
    config, a CPU rehearsal) cut to ``layers``, weights from ``seed``."""
    model = build_model(arch, policy="tp_bf16", device=device,
                        reduced=reduced, n_layers=layers, **cfg)
    return model, model.init(seed)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def card_engine(rmesh, *, arch, layers, seed, requests, slots, chunk,
                page_size, prompt, warm, device="cuda",
                reduced=False) -> dict:
    """The engine on this rank's shards: the weights' digest, one warm-up
    run of ``warm``, the timed run of ``requests`` between a counter reset
    and a read, the first-token logits of ``prompt``, and this rank's
    attend reads."""
    model, params = _card_model(arch, layers, seed, device, reduced,
                                paged_kv=True, page_size=page_size)
    got = weights_digest(params)
    max_len = max(r.prompt_len + r.max_new for r in requests)
    eng = ContinuousEngine(model, params, slots=slots, max_len=max_len,
                           chunk=chunk, mesh=rmesh)
    del params
    eng.run(warm)
    reset_attention_launches()
    spmd.reset_stats()
    (fin, st), wall = _timed(lambda: eng.run(requests), device)
    counted, coll = attention_launches(), dict(spmd.STATS)
    lg, _ = model.prefill(eng.params, torch.tensor([prompt], device=device),
                          max_len=len(prompt) + 1, mesh=rmesh)
    cfg = model.cfg
    return {"digest": got, "tokens": [list(f.tokens) for f in fin],
            "wall_s": wall, "decode_s": st["decode_s"],
            "prefill_s": st["prefill_s"],
            "decode_rounds": st["decode_rounds"],
            "pages_live_end": st["pages_live_end"], "counters": counted,
            "spmd": coll, "first_logits": lg[0, -1].float().cpu(),
            "reads": attend_reads(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                  shards=rmesh.shape["model"],
                                  rank=rmesh.coords["model"],
                                  device=device),
            "shard_gib": weights_bytes(eng.params) / 2 ** 30}


def weights_bytes(params) -> int:
    if isinstance(params, dict):
        return sum(weights_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(weights_bytes(v) for v in params)
    return params.numel() * params.element_size()


@contextlib.contextmanager
def replay_routes(idx):
    """Route every MoE layer call to the experts a recorded pass chose
    (``idx``: the recorded top-k indices, one tensor a call, in call
    order), its own router probabilities at those experts renormalized as
    ``moe.route`` does: a bf16 difference in the router's input flips a
    near-tied choice, which is not the sharding's doing."""
    real, calls = moe_mod.route, iter(idx)

    def pinned(x, router, cfg):
        i = next(calls).to(x.device)
        probs = torch.softmax(x.float() @ router.float(), dim=-1)
        gates = probs.gather(-1, i)
        if cfg.router_norm_topk:
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
        return probs, gates, i

    moe_mod.route = pinned
    try:
        yield
    finally:
        moe_mod.route = real


def mla_read_inputs(cfg, rows, seed: int = 0):
    """The MLA reads' inputs at ``cfg``'s widths, made on the CPU from
    ``seed``: the expanded prefill's q / k [B, H, S, nope + rope] and v
    [B, H, S, v_head] (bf16) for ``rows`` prompt lengths (right-padded to
    the longest), and one decode step's x [B, 1, D] with a latent cache
    ``(c_kv, k_pe)`` [B, T, r] of T = the longest + 1."""
    gen = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    b, s_ = len(rows), max(rows)
    qd, h = cfg.nope_dim + cfg.rope_dim, cfg.n_heads
    r = lambda *shape: torch.randn(shape, generator=gen).to(bf)
    return dict(q=r(b, h, s_, qd), k=r(b, h, s_, qd),
                v=r(b, h, s_, cfg.v_head_dim),
                x=r(b, 1, cfg.d_model), c_kv=r(b, s_ + 1, cfg.kv_lora),
                k_pe=r(b, s_ + 1, cfg.rope_dim),
                lens=torch.tensor(rows))


def mla_reads(cfg, layer_params, rows, *, rmesh=None, seed: int = 0,
              device="cuda") -> dict:
    """This rank's heads (all heads without ``rmesh``) of MLA's two reads
    on the same inputs (``mla_read_inputs``): the expanded prefill through
    the flash kernel's wrapper, and one absorbed decode step of the
    layer ``layer_params`` (this rank's shards) against the latent cache,
    through ``mla_attention(return_attend=True)``."""
    from ..kernels import ops as kops
    t = {k: v.to(device) for k, v in mla_read_inputs(cfg, rows,
                                                      seed).items()}
    shards = attn._head_shard_size(rmesh, cfg.n_heads, cfg.n_heads) or 1
    rank = rmesh.coords["model"] if shards > 1 else 0
    h = cfg.n_heads // shards
    mine = lambda x: x[:, rank * h:(rank + 1) * h].contiguous()
    qd = cfg.nope_dim + cfg.rope_dim
    flash = kops.flash_attention(mine(t["q"]), mine(t["k"]), mine(t["v"]),
                                 kv_len=t["lens"], policy="tp_bf16",
                                 scale=qd ** -0.5, causal=True)
    cache = attn.MLACache(t["c_kv"].clone(), t["k_pe"].clone())
    dec, _ = attn.mla_attention(
        t["x"], layer_params, "tp_bf16", n_heads=cfg.n_heads,
        nope_dim=cfg.nope_dim, rope_dim=cfg.rope_dim,
        v_head_dim=cfg.v_head_dim, positions=t["lens"][:, None, None],
        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps, cache=cache,
        cache_pos=t["lens"], mesh=rmesh, return_attend=True)
    return {"flash": flash.cpu(), "decode": dec.float().cpu(),
            "heads": h}


def card_arch(rmesh, *, arch, layers, seed, batches, gen_len,
              routes=None, probe_x=None, mla_rows=None, device="cuda",
              reduced=False, **cfg) -> dict:
    """``generate`` on this rank's shards of ``arch`` (``cfg``: config
    overrides), one call a batch of ``batches`` (``(tokens, prompt_lens
    or None)``), with the oracle's expert choices (``routes``) for a MoE
    stack, between a counter reset and a read; then ``moe_probe`` of the
    first MoE layer on ``probe_x`` and, for an MLA stack, ``mla_reads`` of
    layer 0 at ``mla_rows``."""
    model, params = _card_model(arch, layers, seed, device, reduced, **cfg)
    got = weights_digest(params)
    local = shard_params(params, rmesh, model.cfg)
    del params
    reset_attention_launches()
    spmd.reset_stats()
    ctx = (replay_routes(routes) if routes is not None
           else contextlib.nullcontext())

    def run():
        out = []
        for toks, lens in batches:
            out.append(model.generate(
                local, toks.to(device), gen_len=gen_len, mesh=rmesh,
                prompt_lens=None if lens is None else lens.to(device),
                return_logits=True))
        return out
    with ctx:
        outs, wall = _timed(run, device)
    counted, coll = attention_launches(), dict(spmd.STATS)
    res = {"digest": got, "tokens": [g.cpu().tolist() for g, _ in outs],
           "first_logits": [lg[:, 0].float().cpu() for _, lg in outs],
           "wall_s": wall, "counters": counted, "spmd": coll,
           "shard_gib": weights_bytes(local) / 2 ** 30}
    if probe_x is not None:
        i = next(i for i, sp in enumerate(model.cfg.layer_list())
                 if sp.ffn == "moe")
        res["probe"] = moe_probe(local["layers"][i]["mlp"], model.cfg.moe,
                                 probe_x.to(device), rmesh, "tp_bf16",
                                 with_aux=False)
    if mla_rows is not None:
        res["mla_reads"] = mla_reads(model.cfg, local["layers"][0]["attn"],
                                     mla_rows, rmesh=rmesh, seed=seed,
                                     device=device)
    return res


def card_fleet(mesh, *, arch, layers, seed, requests, legs, journal_dir,
               device="cuda", reduced=False, **kw) -> dict:
    """The sharded fleet on ``mesh`` (this rank's row), each leg of
    ``legs`` (name -> ``fleet_run`` arguments: ``faults``, ``restarts``,
    engine knobs) journaled to its own file in ``journal_dir``, between a
    reset and a read of the attention kernels' launch counters."""
    import os
    rmesh = replica_meshes(mesh)[mesh.coords["data"]]
    model, params = _card_model(arch, layers, seed, device, reduced,
                                paged_kv=True, page_size=kw.pop("page_size"))
    got = weights_digest(params)
    local = shard_params(params, rmesh, model.cfg)
    del params
    out = {"digest": got}
    for name, leg in legs.items():
        reset_attention_launches()
        spmd.reset_stats()
        out[name] = fleet_run(model, local, mesh, requests,
                              journal=os.path.join(journal_dir,
                                                   f"mesh_{name}.jsonl"),
                              **dict(kw, **leg))
        out[name].update(counters=attention_launches(),
                         spmd=dict(spmd.STATS))
    return out


def card_rank(rank: int, world: int, spec: dict) -> dict:
    """One of ``world`` ranks on one card: on a ``(1, world)`` mesh,
    ``card_engine`` on ``spec["engine"]`` and ``card_arch`` on each of
    ``spec["archs"]``; on a ``(world, 1)`` mesh ``card_fleet`` on
    ``spec["fleet"]``."""
    mesh = make_serving_mesh(1, world)
    rmesh = replica_meshes(mesh)[0]
    out = {"rank": rank}

    def free():
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    if "engine" in spec:
        out["engine"] = card_engine(rmesh, **spec["engine"])
        free()
    for tag, kw in spec.get("archs", {}).items():
        out[tag] = card_arch(rmesh, **kw)
        free()
    if "fleet" in spec:
        out["fleet"] = card_fleet(make_serving_mesh(world, 1),
                                  **spec["fleet"])
    return out
