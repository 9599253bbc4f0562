"""Serving launcher of the port: one fixed batch through ``Model.generate``,
or a request queue through the continuous-batching engine.

Fixed batch (the default): ``--batch`` prompts of ``--prompt-len`` tokens,
``--gen`` tokens each.  ``--loop scan`` / ``--loop while`` run
``Model.generate`` in that loop form (the guard on: non-finite logits
raise ``PoisonedLogitsError``); ``--loop python`` is the per-step prefill
+ ``decode_step`` loop.  ``--arch minicpm3-4b`` and ``--arch
deepseek-v2-lite-16b`` (MLA) serve from a contiguous latent cache:
``--paged`` and ``--continuous`` are refused with
``ModelConfig.paged_unsupported_reason``.  ``--arch qwen3-moe-30b-a3b``
(Mixture-of-Experts) and ``--arch granite-20b`` (MQA: 48 query heads on
one KV head, a gelu MLP with biases), ``--arch gemma3-12b`` and ``--arch
internvl2-26b`` (text only: the launcher feeds no patch embeddings, as
the JAX launcher does not) serve either way.  ``--arch whisper-small``
is refused by ``--paged`` / ``--continuous`` (its cross-attention cache
is contiguous) and, like the JAX launcher, feeds the encoder no frame
embeddings: its fixed batch raises in ``encode``.  ``--arch
zamba2-1.2b`` (Mamba2 + a shared attention block) and ``--arch
xlstm-1.3b`` (mLSTM + sLSTM) serve the fixed batch only, as in JAX:
``--paged`` / ``--continuous`` are refused (recurrent state has no page
axis), ``--ragged`` raises in ``prefill`` (their mixers cannot mask pad
tokens out of the state), and ``--speculate`` needs ``--continuous``.
``--ragged``
packs prompts of 1/4 .. 4/4 of ``--prompt-len`` into one right-padded
batch, ``--stop-token`` freezes a row at that token, ``--paged`` serves
from a page pool of ``--page-size``-token pages; a uniform paged batch
also runs the prefix-sharing gate (every row shares the first half of
its prompt, stored once: tokens and logits must equal the unshared
layout's exactly).

``--continuous`` serves a queue through ``ContinuousEngine`` (implied by
``--arrival-trace``, ``arrival:prompt_len:max_new[:priority[:deadline]]``
tuples in decode rounds; default: the ``chat`` trace of
``engine.synthetic_trace``, or its ``soak`` trace with ``--soak``).
Overload controls: ``--priority`` / ``--deadline-ms`` (converted to
rounds by ``--round-ms``) annotate the default trace, ``--pool-pages``
shrinks the page pool, ``--preempt free|swap``, ``--degrade-fmt fp8``
(implies swap), ``--shed/--no-shed``, and the fault plan
``--fault-exhaust/--fault-poison/--fault-slow/--fault-corrupt-swap``
(rounds, or swap-out events for the last; ``--soak`` alone exhausts the
pool at round ``--gen``).  It runs once to warm up, then once timed.

Numerical health (needs ``--policy fp32``, the f32 pool):
``--escalate fp8,fp16,fp16alt`` turns on flag-driven KV-precision
escalation at ``--escalate-of-threshold`` overflow flags a row, and
``--fault-overflow`` scales the K/V writes of the listed decode rounds by
``--overflow-scale``; each request's trail shows ``escalated L<n>`` and a
``numerical health`` line counts escalations and swap SDC checks.

Speculative decoding (needs ``--continuous``, greedy, no penalties):
``--speculate K`` drafts K tokens a row each burst round and verifies the
chunk in one call; ``--draft-layers N`` drafts with the first N repeats of
the layer pattern (default: full depth), ``--draft-fmt POLICY`` under
another precision policy (e.g. ``tp_bf16_kv8``).  The accepted stream is
plain decode's; a ``speculative`` line gives the accept rate.

Replica fault tolerance (needs ``--continuous``): ``--replicas N`` serves
the queue with a meshless fleet of N engine replicas on the one device
(disjoint page pools, one copy of the weights); ``--fault-replica
R:BURST[:MODE]`` kills (default) or hangs replica R at its BURST-th
burst; ``--migrate swap|reingest`` picks how a dead replica's requests
move to a survivor (swap blobs need ``--preempt swap`` and a hang: a
killed replica's memory is gone, so a kill always re-ingests); ``--journal
PATH`` appends the crash-consistent request journal (JSON lines, the JAX
package's bytes), and the run then goes through ``run_with_restarts``,
which replays it after a loss no replica survives (``--replicas 1`` is a
one-replica fleet here, so ``--fault-replica 0:2`` exercises the
restart).  A run with a fault plan or a journal runs once, without the
warm-up.  A ``replica HA`` line counts kills, hangs, migrations and each
replica's heartbeats.

Sharded serving: ``--mesh DP,TP`` spawns DP x TP ranks
(``launch.spmd``) joined by ``--dist-backend``: ``nccl`` (the default)
runs one rank per card, ``gloo`` runs on the CPU (``--device cpu``) or
several ranks on one card.  Each ``data`` row is one engine replica,
tensor parallel over its TP ranks (heads, paged pools, MLPs, vocab;
MoE experts; MLA's heads with its latents gathered whole; the recurrent
mixers' projections); DP > 1 needs ``--continuous``, and then takes
``--fault-replica`` and ``--journal`` as ``--replicas`` does.  On any
mesh the journal's file is written by global rank 0 alone.  Every rank
builds the same weights from seed 0 and keeps its shards; rank 0
prints.  ``--loop python`` is not
ported to a mesh.

Attention backends: ``--decode-backend`` / ``--prefill-backend``
``auto|kernel|plain|dense`` (``pallas``, the JAX package's name, is
``kernel``), as ``kernels.ops`` names them; ``auto`` (the default) is the
kernel on the card and its plain version on the CPU.  ``--devices N`` is
the JAX package's CPU bring-up flag for ``--mesh``: N ranks (gloo's with
``--device cpu``), the mesh over the first dp x tp of them, and N below
dp x tp raises ("mesh (dp, tp) needs n devices, have N").

Sampling everywhere: ``--temperature --top-k --top-p --seed
--repetition-penalty --presence-penalty``.  The model is the reduced
config unless ``--full``; weights are random from seed 0.  Runs on the GPU
unless ``--device cpu``; without a card and without ``--device`` it
raises.

    python -m repro_torch.launch.serve --full --batch 4 --gen 32
    python -m repro_torch.launch.serve --arch minicpm3-4b --full --ragged
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --full \
        --continuous --speculate 3 --draft-layers 1
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --full
    python -m repro_torch.launch.serve --arch granite-20b --full --continuous
    python -m repro_torch.launch.serve --device cpu --paged --page-size 16
    python -m repro_torch.launch.serve --continuous --soak --device cpu \\
        --slots 3 --requests 10 --prompt-len 16 --gen 24 --pool-pages 5 \\
        --preempt swap --degrade-fmt fp8 --policy tp_bf16_kv8 \\
        --fault-exhaust 2 --fault-poison 6 --fault-slow 4
    python -m repro_torch.launch.serve --continuous --policy fp32 \
        --escalate fp8,fp16,fp16alt --fault-overflow 2 --device cpu
    python -m repro_torch.launch.serve --continuous --speculate 3 \
        --draft-layers 1 --device cpu
    python -m repro_torch.launch.serve --full --continuous --replicas 2 \
        --fault-replica 1:2 --journal /tmp/j.jsonl
    python -m repro_torch.launch.serve --continuous --mesh 2,2 \
        --dist-backend gloo --device cpu
    python -m repro_torch.launch.serve --continuous --mesh 2,1 \
        --dist-backend gloo --device cpu --fault-replica 0:3:hang \
        --journal /tmp/j.jsonl
    python -m repro_torch.launch.serve --arch minicpm3-4b --mesh 1,2 \
        --dist-backend gloo --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import sys
import time

import numpy as np
import torch

from ..core.policy import EscalationPolicy
from ..models.paged import (PageAllocator, build_tables, identity_block_table,
                            num_pages)
from ..models.registry import build_model, get_config
from ..models.sharding import shard_params
from ..models.transformer import sample_token
from ..train.fault import (PoisonedLogitsError, ReplicaFaultPlan,
                           ServeFaultPlan, run_with_restarts)
from . import spmd
from .engine import (ContinuousEngine, ReplicatedEngine, Request,
                     synthetic_trace)
from .journal import RequestJournal
from .mesh import make_serving_mesh, replica_meshes


def ragged_lengths(batch: int, prompt_len: int):
    """The mixed-length pack of ``--ragged``: rows cycle over 1/4, 1/2,
    3/4, 4/4 of ``prompt_len`` (at least 1)."""
    fracs = (0.25, 0.5, 0.75, 1.0)
    return [max(1, int(prompt_len * fracs[i % len(fracs)]))
            for i in range(batch)]


def prefix_sharing_parity(model, params, prompts, *, gen: int, max_len: int,
                          mesh=None):
    """Give every row of ``prompts`` [B, S] the first row's first half,
    store the pages that half covers ONCE (aliased into every row's block
    table), and generate greedily from the shared and from the identity
    layout.  Returns ``(token_mismatches, max_abs_logit_diff, prompts,
    shared_table, n_pages, live_pages)``: the first two must be 0."""
    b, s = prompts.shape
    page = model.cfg.page_size
    common = s // 2
    prompts = torch.cat([prompts[:1, :common].expand(b, common),
                         prompts[:, common:]], 1)
    mp = num_pages(max_len, page)
    n_pages = b * mp
    alloc = PageAllocator(n_pages)
    shared = build_tables(alloc, b, mp, shared_pages=common // page)
    shared = torch.as_tensor(shared, device=model.device)
    runs = [model.generate(params, prompts, gen_len=gen, max_len=max_len,
                           page_table=t, n_pages=n_pages, return_logits=True,
                           mesh=mesh)
            for t in (shared, torch.as_tensor(identity_block_table(b, mp),
                                              device=model.device))]
    (g_s, lg_s), (g_u, lg_u) = runs
    return (int((g_s != g_u).sum()), float((lg_s - lg_u).abs().max()),
            prompts, shared, n_pages, alloc.n_live)


#: the attention backend flags' choices: ``kops.BACKENDS`` and ``pallas``,
#: the JAX package's name for the kernel
BACKEND_CHOICES = ("auto", "kernel", "plain", "dense", "pallas")


def _backend(name: str) -> str:
    return "kernel" if name == "pallas" else name


def _arg_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--policy", default="tp_bf16")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--decode-backend", choices=BACKEND_CHOICES,
                    default="auto",
                    help="decode attention: kernel (the CUDA decode "
                         "kernel; 'pallas', the JAX package's name, is the "
                         "same), plain (its PyTorch version), dense (the "
                         "masked softmax), auto (default: the kernel on the "
                         "card, the plain version on the CPU)")
    ap.add_argument("--prefill-backend", choices=BACKEND_CHOICES,
                    default="auto",
                    help="prefill attention: the flash kernel, its plain "
                         "version or the dense path, as --decode-backend")
    ap.add_argument("--loop", choices=("scan", "while", "python"),
                    default="scan")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="> 0 enables sampling (0 = greedy, the default)")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--repetition-penalty", type=float, default=None)
    ap.add_argument("--presence-penalty", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling generator seed")
    ap.add_argument("--ragged", action="store_true")
    ap.add_argument("--stop-token", type=int, default=None)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine (implies --paged)")
    ap.add_argument("--arrival-trace", default=None,
                    help="arrival:prompt_len:max_new[:priority[:deadline]],"
                         "... (rounds)")
    ap.add_argument("--priority", type=int, default=0)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--round-ms", type=float, default=1.0)
    ap.add_argument("--shed", dest="shed", action="store_true", default=True)
    ap.add_argument("--no-shed", dest="shed", action="store_false")
    ap.add_argument("--preempt", choices=("free", "swap"), default="free")
    ap.add_argument("--degrade-fmt", default=None)
    ap.add_argument("--pool-pages", type=int, default=None)
    ap.add_argument("--soak", action="store_true")
    ap.add_argument("--fault-exhaust", default=None)
    ap.add_argument("--fault-poison", default=None)
    ap.add_argument("--fault-slow", default=None)
    ap.add_argument("--fault-corrupt-swap", default=None)
    ap.add_argument("--escalate", default=None,
                    help="comma-separated KV-format ladder (e.g. "
                         "fp8,fp16,fp16alt): flag-driven precision "
                         "escalation on an f32 pool (--policy fp32)")
    ap.add_argument("--escalate-of-threshold", type=int, default=8,
                    help="overflow flags of a request that move it one "
                         "rung up the ladder")
    ap.add_argument("--fault-overflow", default=None,
                    help="comma-separated decode rounds whose K/V writes "
                         "are scaled by --overflow-scale before the "
                         "write-time snap")
    ap.add_argument("--overflow-scale", type=float, default=65536.0)
    ap.add_argument("--burst-cap", type=int, default=64)
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="self-speculative decoding: draft K tokens per "
                         "row with the cheap pass, verify the whole chunk "
                         "at target precision in ONE call, accept the "
                         "longest matching prefix (greedy-only; accepted "
                         "tokens are bit-identical to plain decode)")
    ap.add_argument("--draft-layers", type=int, default=None, metavar="N",
                    help="layer-skip draft: run only the first N repeats "
                         "of the layer pattern in the draft pass "
                         "(default: full depth — the draft is then the "
                         "target model and every proposal is accepted)")
    ap.add_argument("--draft-fmt", default=None, metavar="POLICY",
                    help="precision-policy preset the DRAFT pass runs "
                         "under (e.g. tp_bf16_kv8; verify stays at the "
                         "serving policy)")
    ap.add_argument("--slots", type=int, default=4,
                    help="batch slots of the continuous engine")
    ap.add_argument("--requests", type=int, default=16,
                    help="requests in the synthetic queue")
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill chunk width of the continuous engine")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the arch at full width")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="serving mesh dp,tp: tp-way tensor-parallel "
                         "heads, paged KV pools, MLPs and vocab per "
                         "replica, dp data-parallel engine replicas (dp > 1 "
                         "requires --continuous); spawns dp*tp ranks")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="--mesh over a world of N ranks (the JAX package's "
                         "CPU bring-up flag): the mesh takes the first dp*tp "
                         "and N < dp*tp raises; with --device cpu the ranks "
                         "are gloo's")
    ap.add_argument("--dist-backend", choices=spmd.BACKENDS, default="nccl",
                    help="torch.distributed backend of --mesh: nccl (one "
                         "rank per card) or gloo (the CPU, or several "
                         "ranks on one card)")
    ap.add_argument("--replicas", type=int, default=None, metavar="N",
                    help="meshless HA fleet: N engine replicas on the one "
                         "device over disjoint page pools (requires "
                         "--continuous)")
    ap.add_argument("--fault-replica", default=None,
                    metavar="R:BURST[:MODE]",
                    help="replica R dies at its BURST-th burst; MODE kill "
                         "(device memory gone; the default) or hang "
                         "(declared dead after missed heartbeats, memory "
                         "still readable)")
    ap.add_argument("--migrate", choices=("swap", "reingest"),
                    default="swap",
                    help="how a lost replica's requests move to a "
                         "survivor: CRC-checked swap blobs (needs "
                         "--preempt swap and a hang) or free-and-reingest")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="append-only crash-consistent request journal "
                         "(JSON lines); the run goes through "
                         "run_with_restarts, which replays it")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def main(argv=None):
    ap = _arg_parser()
    args = ap.parse_args(argv)
    args.decode_backend = _backend(args.decode_backend)
    args.prefill_backend = _backend(args.prefill_backend)
    if args.devices is not None:
        if args.devices < 1:
            ap.error(f"--devices must be >= 1, got {args.devices}")
        if args.device == "cpu":
            args.dist_backend = "gloo"
    if ((args.ragged or args.paged or args.stop_token is not None
         or args.continuous) and args.loop == "python"):
        ap.error("--ragged / --paged / --stop-token / --continuous require "
                 "--loop scan or while")
    if args.arrival_trace and not args.continuous:
        args.continuous = True          # a request queue implies the engine
    if args.continuous and args.ragged:
        ap.error("--continuous subsumes --ragged (per-request lengths)")
    pen = (args.repetition_penalty is not None
           or args.presence_penalty is not None)
    if pen and args.loop == "python":
        ap.error("--repetition-penalty / --presence-penalty apply to the "
                 "generate() and continuous-engine paths only")
    if args.speculate:
        if not args.continuous:
            ap.error("--speculate requires --continuous (the draft/verify "
                     "rounds live in the engine's burst program)")
        if args.temperature > 0.0 or pen:
            ap.error("--speculate is greedy-only: temperature and "
                     "penalties would change the verified stream")
    args.mesh_dims = None
    if args.mesh is not None:
        try:
            dp, tp = (int(x) for x in args.mesh.split(","))
        except ValueError:
            ap.error("--mesh expects DP,TP (e.g. --mesh 2,4)")
        if dp < 1 or tp < 1:
            ap.error(f"--mesh axes must be >= 1, got {dp},{tp}")
        if dp > 1 and not args.continuous:
            ap.error("--mesh with dp > 1 requires --continuous (the data "
                     "axis is engine replication)")
        if args.loop == "python":
            ap.error("--mesh requires --loop scan or while")
        if args.replicas is not None:
            ap.error("--replicas (the meshless fleet) and --mesh are "
                     "exclusive: --mesh DP,TP with DP > 1 is the sharded "
                     "fleet")
        if args.dist_backend == "nccl" and args.device == "cpu":
            ap.error("--dist-backend nccl runs on cards: use gloo with "
                     "--device cpu")
        args.mesh_dims = (dp, tp)
    if args.replicas is not None:
        if args.replicas < 1:
            ap.error(f"--replicas must be >= 1, got {args.replicas}")
        if not args.continuous:
            ap.error("--replicas requires --continuous (replicas are "
                     "engine instances over the request queue)")
    if args.fault_replica is not None:
        parts = args.fault_replica.split(":")
        if len(parts) not in (2, 3):
            ap.error("--fault-replica expects R:BURST[:MODE] "
                     "(e.g. 0:3 or 1:5:hang)")
        try:
            fr, fb = int(parts[0]), int(parts[1])
        except ValueError:
            ap.error("--fault-replica R and BURST must be integers")
        fmode = parts[2] if len(parts) == 3 else "kill"
        if fmode not in ("kill", "hang"):
            ap.error(f"--fault-replica MODE must be kill|hang, "
                     f"got {fmode!r}")
        if args.replicas is None and (args.mesh_dims is None
                                      or args.mesh_dims[0] < 2):
            ap.error("--fault-replica needs a replicated engine "
                     "(--replicas N or --mesh with dp > 1) — a lone "
                     "replica's loss has no survivor to migrate to")
        args.fault_replica = (fr, fb, fmode)
    if args.mesh_dims is not None:
        dp, tp = args.mesh_dims
        world = dp * tp if args.devices is None else args.devices
        if world < dp * tp:
            raise ValueError(f"mesh {(dp, tp)} needs {dp * tp} devices, "
                             f"have {world}")
        return spmd.spawn(_mesh_rank, world, backend=args.dist_backend,
                          args=(args,))[0]
    return _serve(ap, args)



def _mesh_rank(rank: int, world: int, args):
    """One rank of ``--mesh``: this rank's replica row, rank 0 printing."""
    if args.dist_backend == "nccl":
        args.device = f"cuda:{rank}"
    mesh = make_serving_mesh(*args.mesh_dims)
    if not mesh.member:                 # a --devices rank past dp * tp
        return None
    rmesh = replica_meshes(mesh)[mesh.coords["data"]]
    if rank == 0:
        dp, tp = args.mesh_dims
        print(f"serving mesh: {dp} data-parallel replica(s) x {tp}-way "
              f"tensor parallel over {world} ranks ({args.dist_backend})")
    sink = sys.stdout if rank == 0 else io.StringIO()
    with contextlib.redirect_stdout(sink):
        out = _serve(_arg_parser(), args, mesh, rmesh)
        if rank == 0:
            st = spmd.STATS
            print(f"collectives: {st['collectives']} calls, "
                  f"{st['collective_ms']:.1f} ms, {st['staged_bytes']} "
                  f"bytes staged through the host")
    return out if rank == 0 else None


def _serve(ap, args, mesh=None, rmesh=None):
    paged = args.paged or args.continuous
    cfg = get_config(args.arch, reduced=args.reduced)
    why = cfg.paged_unsupported_reason()
    if paged and why is not None:
        ap.error(f"--paged / --continuous: paged_kv is unsupported for "
                 f"{cfg.name}: {why} cannot page a contiguous-state cache")
    model = build_model(args.arch, policy=args.policy, reduced=args.reduced,
                        device=args.device, paged_kv=paged,
                        page_size=args.page_size,
                        decode_backend=args.decode_backend,
                        prefill_backend=args.prefill_backend)
    params = model.init(0)
    if args.continuous:
        return _continuous(args, model, params, mesh, rmesh)
    if rmesh is None:
        return _fixed_batch(args, model, params)
    gen = _fixed_batch(args, model, shard_params(params, rmesh, model.cfg),
                       rmesh)
    return gen.cpu()            # the rank's result crosses to the parent


def _where(model) -> str:
    return (torch.cuda.get_device_name(model.device)
            if model.device.type == "cuda" else str(model.device))


def _sync(model) -> None:
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)


def _fixed_batch(args, model, params, mesh=None):
    dev = model.device
    max_len = args.prompt_len + args.gen
    rng = np.random.RandomState(1)
    prompts = torch.as_tensor(rng.randint(
        0, model.cfg.vocab, size=(args.batch, args.prompt_len)), device=dev)
    prompt_lens = None
    if args.ragged:
        lens = ragged_lengths(args.batch, args.prompt_len)
        prompt_lens = torch.as_tensor(lens, device=dev)
        live = (torch.arange(args.prompt_len, device=dev)[None, :]
                < prompt_lens[:, None])
        prompts = torch.where(live, prompts, 0)
        print(f"ragged pack: lengths {lens} padded to {args.prompt_len}")
    page_table = n_pages = None
    if args.paged and not args.ragged:
        d_tok, d_lg, prompts, page_table, n_pages, live = \
            prefix_sharing_parity(model, params, prompts, gen=args.gen,
                                  max_len=max_len, mesh=mesh)
        print(f"paged pool: page={args.page_size}, {live}/{n_pages} pages "
              f"live with the shared prefix ({args.prompt_len // 2} common "
              f"prompt tokens) vs {n_pages} unshared")
        print(f"prefix-sharing parity: max |dlogits| = {d_lg:.1e}, "
              f"token mismatches = {d_tok} (both must be 0)")
        assert d_tok == 0 and d_lg == 0.0, "prefix sharing changed outputs"
    elif args.paged:
        print(f"paged pool: page={args.page_size}, identity table "
              f"(ragged rows keep private page runs)")

    sampling = dict(temperature=args.temperature, top_k=args.top_k,
                    top_p=args.top_p)
    if args.loop != "python":
        def run():
            g = torch.Generator(device=dev).manual_seed(args.seed)
            return model.generate(
                params, prompts, gen_len=args.gen, max_len=max_len,
                loop=args.loop,
                generator=g, prompt_lens=prompt_lens,
                stop_token=args.stop_token, page_table=page_table,
                n_pages=n_pages, repetition_penalty=args.repetition_penalty,
                presence_penalty=args.presence_penalty,
                guard_nonfinite=True, mesh=mesh, **sampling)
        run()                               # warm-up (kernel build)
        _sync(model)
        t0 = time.perf_counter()
        gen, _, bad = run()
        _sync(model)
        dt = time.perf_counter() - t0
        if int(bad.sum()) > 0:
            raise PoisonedLogitsError(
                f"non-finite logits at {int(bad.sum())} sampling steps "
                f"(rows {torch.nonzero(bad).flatten().tolist()})")
        n_tok = args.batch * args.gen
        if args.stop_token is not None:
            live_tok = int((gen != args.stop_token).sum()
                           + (gen == args.stop_token).any(1).sum())
            print(f"stop-token {args.stop_token}: {live_tok}/{n_tok} "
                  f"tokens live (rest frozen post-EOS)")
    else:
        g = torch.Generator(device=dev).manual_seed(args.seed)
        lg, caches = model.prefill(params, prompts, max_len=max_len)
        tok = sample_token(lg[:, -1], g, **sampling)[:, None]
        _sync(model)
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            lg, caches = model.decode_step(params, tok, caches,
                                           args.prompt_len + i)
            tok = sample_token(lg[:, -1], g, **sampling)[:, None]
        _sync(model)
        dt = time.perf_counter() - t0
        gen = None
        n_tok = args.batch * (args.gen - 1)
    tag = args.loop + (f"/paged{args.page_size}" if args.paged else "")
    print(f"{args.arch} [{tag}] on {_where(model)}: {n_tok} tokens in "
          f"{dt:.3f} s ({n_tok / dt:.1f} tok/s)")
    return gen


def _continuous(args, model, params, mesh=None, rmesh=None):
    dl_rounds = (None if args.deadline_ms is None
                 else max(1, int(args.deadline_ms / args.round_ms)))
    if args.arrival_trace:
        reqs = []
        for i, tup in enumerate(args.arrival_trace.split(",")):
            parts = [int(x) for x in tup.split(":")]
            arr, plen, budget = parts[:3]
            pri = parts[3] if len(parts) > 3 else args.priority
            dl = (parts[4] if len(parts) > 4
                  else (arr + dl_rounds if dl_rounds else None))
            toks = np.random.RandomState(100 + i).randint(
                0, model.cfg.vocab, size=plen)
            reqs.append(Request(rid=i, tokens=toks.tolist(), max_new=budget,
                                arrival=arr, priority=pri, deadline=dl))
    else:
        reqs = synthetic_trace(args.requests, args.slots, args.prompt_len,
                               args.gen, model.cfg.vocab,
                               flavor="soak" if args.soak else "chat")
        if args.priority or dl_rounds is not None:
            reqs = [dataclasses.replace(
                r, priority=r.priority or args.priority,
                deadline=(r.arrival + dl_rounds if dl_rounds
                          else r.deadline)) for r in reqs]
    rounds = lambda s: tuple(int(x) for x in s.split(",")) if s else ()
    plan = None
    if (args.fault_exhaust or args.fault_poison or args.fault_slow
            or args.fault_overflow or args.fault_corrupt_swap or args.soak):
        plan = ServeFaultPlan(
            exhaust_at=rounds(args.fault_exhaust) or
            ((args.gen,) if args.soak else ()),
            slow_at=rounds(args.fault_slow),
            poison_at=rounds(args.fault_poison), mask_poison=True,
            overflow_at=rounds(args.fault_overflow),
            overflow_scale=args.overflow_scale,
            corrupt_swap_at=rounds(args.fault_corrupt_swap))
    if args.degrade_fmt is not None:
        args.preempt = "swap"           # degradation rides the swap store
    esc = (EscalationPolicy(ladder=tuple(args.escalate.split(",")),
                            of_threshold=args.escalate_of_threshold)
           if args.escalate is not None else None)
    # speculative headroom: the verify chunk writes spec_k slots past the
    # budget
    max_len = (max(r.prompt_len + r.max_new for r in reqs)
               + args.speculate)
    eng_kw = dict(
        slots=args.slots, max_len=max_len, chunk=args.chunk,
        n_pages=args.pool_pages, stop_token=args.stop_token,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.seed, burst_cap=args.burst_cap,
        repetition_penalty=args.repetition_penalty,
        presence_penalty=args.presence_penalty, preempt=args.preempt,
        degrade_fmt=args.degrade_fmt, shed=args.shed, fault_plan=plan,
        escalate=esc, spec_k=args.speculate, draft_repeats=args.draft_layers,
        draft_policy=args.draft_fmt)
    rplan = (ReplicaFaultPlan(*args.fault_replica)
             if args.fault_replica is not None else None)
    journal = (RequestJournal(args.journal)
               if args.journal is not None else None)
    replicated = args.replicas is not None or (
        mesh is not None and mesh.shape["data"] > 1)
    if replicated:
        eng = ReplicatedEngine(model, params, mesh=mesh,
                               replicas=args.replicas, migrate=args.migrate,
                               replica_fault=rplan, journal=journal,
                               **eng_kw)
    else:
        eng = ContinuousEngine(model, params, journal=journal, mesh=rmesh,
                               **eng_kw)
    restarts = 0
    if rplan is None and journal is None:
        eng.run(reqs)                   # warm-up (kernel build, allocator)
    t0 = time.perf_counter()
    if journal is not None:
        # the journal is one run's crash-consistent story: a loss that no
        # replica survives restarts the run, which replays the journal
        class _Runner:
            def reset_monitors(self):
                eng.reset_monitors()

            def run(self):
                self.res = eng.run(reqs)

        runner, restarts = run_with_restarts(_Runner, max_restarts=2)
        fin, stats = runner.res
    else:
        fin, stats = eng.run(reqs)
    _sync(model)
    dt = time.perf_counter() - t0
    print(f"continuous engine on {_where(model)}: {model.cfg.name}, "
          f"{args.slots} slots, page={args.page_size}, chunk={args.chunk}, "
          f"{len(reqs)} requests, pool {stats['n_pages']} pages, "
          f"preempt={args.preempt}"
          + (f", degrade={args.degrade_fmt}" if args.degrade_fmt else "")
          + (f", speculate k={args.speculate}"
             + (f" draft_layers={args.draft_layers}"
                if args.draft_layers is not None else "")
             + (f" draft_fmt={args.draft_fmt}" if args.draft_fmt else "")
             if args.speculate else "")
          + (f", replicas={stats['replicas_n']} migrate={args.migrate}"
             if replicated else ""))
    for f in fin:
        trail = ""
        if f.preemptions:
            trail += f" preempted x{f.preemptions}"
        if f.sheds:
            trail += f" shed x{f.sheds}"
        if f.degraded:
            trail += " degraded"
        if f.escalated:
            trail += f" escalated L{f.escalated}"
        if f.deadline is not None:
            trail += (" DEADLINE MISS" if f.deadline_miss
                      else f" met r{f.deadline}")
        print(f"  req {f.rid:3d}: prompt {f.prompt_len:3d} -> "
              f"{len(f.tokens):3d} tokens  (slot {f.slot}, admitted "
              f"r{f.admit_round}, finished r{f.finish_round}){trail}")
    n_tok = sum(len(f.tokens) for f in fin)
    print(f"occupancy {stats['occupancy']:.2f} over "
          f"{stats['decode_rounds']} rounds / {stats['bursts']} bursts; "
          f"peak live pages {stats['peak_live_pages']} vs "
          f"{stats['fixed_equiv_pages']} fixed-batch equivalent "
          f"(pool {stats['n_pages']}, {stats['pages_live_end']} live at end)")
    print(f"robustness: {stats['preemptions']} preemptions "
          f"({stats['preempt_swap']} swap / "
          f"{stats['preempt_reingest']} reingest), "
          f"{stats['shed_events']} sheds, {stats['degraded']} degraded, "
          f"{stats['deadline_misses']}/{stats['deadline_total']} deadline "
          f"misses, {stats['poisoned_rounds']} poisoned rounds masked, "
          f"{stats['stragglers']} stragglers, "
          f"{stats['faults_exhaust']} exhaustion episodes")
    if args.speculate:
        print(f"speculative: accept rate "
              f"{stats['spec_accept_rate']:.2f} over "
              f"{stats['spec_rounds']} draft/verify row-rounds "
              f"({stats['spec_emitted']} tokens emitted, chunk "
              f"k+1={args.speculate + 1})")
    if esc is not None or plan is not None:
        print(f"numerical health: {stats['escalations']} escalations "
              f"({stats['esc_deferred']} deferred, {stats['esc_refused']} "
              f"refused), {stats['sdc_injected']} SDC injected / "
              f"{stats['sdc_detected']} detected / "
              f"{stats['sdc_reingest']} recovered by reingest")
    if replicated:
        print(f"replica HA: {stats['ha_kills']} kills, "
              f"{stats['ha_hangs']} hangs, {stats['ha_migrations']} "
              f"migrations ({stats['ha_migrated_swap']} swap-blob / "
              f"{stats['ha_migrated_reingest']} reingest); heartbeats "
              + ", ".join(f"r{i}:{h['beats']}b/{h['missed']}m "
                          f"{h['status']}"
                          for i, h in enumerate(stats["heartbeats"])))
    if journal is not None:
        journal.close()
        print(f"journal {args.journal}: " + ", ".join(
            f"{v}x {k}" for k, v in sorted(journal.counts().items()))
              + f"; {restarts} restarts, {stats['journal_replayed']} "
                f"requests replayed")
    if plan is not None:
        if plan.events:
            kinds = {}
            for k, _ in plan.events:
                kinds[k] = kinds.get(k, 0) + 1
            print("fault log: " + ", ".join(
                f"{v}x {k}" for k, v in sorted(kinds.items())))
    print(f"{n_tok} tokens in {dt:.3f} s = {n_tok / dt:.1f} tok/s "
          f"(prefill {stats['prefill_s']:.3f} s, decode "
          f"{stats['decode_s']:.3f} s)")
    return fin, stats


if __name__ == "__main__":
    main()
