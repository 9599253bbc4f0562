"""Continuous-batching serving engine: admission, chunked prefill, decode
bursts, page recycling, and overload handling (the port of the JAX
package's ``repro.launch.engine``).

  * **Admission** — host-side, over a request queue in (effective
    priority, deadline, arrival, rid) order.  A finished row's pages go
    back to the ``PageAllocator`` the round it finishes and its slot is
    refilled from the queue mid-generation.
  * **Chunked prefill** — an admitted prompt is consumed in fixed-width
    chunks through the paged flash read path (``Model.prefill_chunk``), one
    chunk per round, same-offset slots batched into one call, interleaved
    with short decode bursts so ongoing streams are not stalled.  The
    final chunk's logits go through the same sampling site as a decode
    round: non-finite guard, penalties, then greedy or a draw.
  * **Page accounting** — prompt pages at admission, one page per row as
    its length crosses a page boundary; admission reserves each request's
    worst case (``num_pages(prompt + budget)``) against the pool.
  * **Sampling** — ``temperature`` / ``top_k`` / ``top_p`` draw from ONE
    ``torch.Generator`` on the model's device, seeded at every ``start``
    and consumed at the JAX key's sites in the same order (each prefill
    wave, each decode round), so the same queue gives the same tokens.
    ``repetition_penalty`` / ``presence_penalty`` keep a host histogram
    per slot, re-seeded at admission and resume (prompt + emitted) and
    re-synced after every burst.

Overload is handled, not assumed away:

  * **Priorities and deadlines** — ``Request.priority`` orders admission
    and picks preemption victims; a request that can no longer make its
    ``deadline`` (a round number) gains one effective level, and misses
    are counted on ``Finished``.
  * **Preemption** — when a higher-priority request cannot fit or a lazy
    page allocation fails, the weakest resident row is evicted and
    re-queued.  ``preempt="free"`` re-ingests prompt + emitted tokens
    through chunked prefill on resume; ``preempt="swap"`` copies the row's
    live K/V pages to pinned host memory (``index_select`` on the device,
    then asynchronous copies, one synchronise per swap-out) and writes
    them back into its new pages on resume.  Every swapped payload
    carries per-layer CRC32s; a mismatch at swap-in (``corrupt_swap_at``
    injects one bit flip) falls back to re-ingest.
  * **Degradation** — ``degrade_fmt`` (``fp8``) casts a swapped victim's
    pages to that format ON THE DEVICE before the copy, so half the bytes
    cross PCIe; tracked per request, refused by ``Request.no_degrade``.
  * **Shedding** — with ``shed=True`` (the default) an entry that cannot
    be placed while a slot sits free is deferred with jittered exponential
    backoff, deterministic in (seed, rid, attempt).
  * **Faults and watchdog** — a ``ServeFaultPlan`` injects pool
    exhaustion, slow bursts, NaN-poisoned rounds (masked and counted,
    or ``PoisonedLogitsError``) and, under escalation, overflowing K/V
    writes; a ``ServeWatchdog`` turns a livelocked loop into
    ``EngineStuckError``, as does a burst that advances nothing.
  * **Flag-driven precision escalation** — with an ``EscalationPolicy``
    (on an f32 pool with no ``kv_fmt``) every cache write is snapped onto
    its row's ladder rung with the saturating cast and reports per-row
    OF / UF counts; a row whose pressure crosses the threshold moves one
    rung up (fp8 -> fp16 -> ...) by a forced free-and-reingest, never a
    swap (the saturated bytes are what the flags condemned).  Refusable
    per request (``Request.no_escalate``), deferred under page pressure.

Dead-slot discipline: idle slots are parked at ``max_len - 1`` on a
reserved scratch page; every other garbage write lands on a slot that a
real write overwrites before any mask lets it be read.

Speculative decoding (``spec_k``): every burst round drafts ``spec_k``
tokens a row with a layer-skip draft (``draft_repeats`` pattern groups,
optionally under ``draft_policy``), verifies the chunk in one
``Model.verify_chunk`` call and accepts the longest matching prefix plus
the verify model's own token (``Model.speculate_burst``).  Greedy only;
the streams are plain decode's.  Each request reserves ``spec_k`` slots of
lookahead past its budget; ``Request.spec_k`` caps a request's drafts and
``Request.no_speculate`` opts it out (one verified token a round, in the
same batch).  Composes with preemption and escalation.

Replica-level fault tolerance rides the same host boundary.  ``run`` is
``start()`` + ``step()`` until drained + ``finalize()``, so a fleet host
(``ReplicatedEngine``) interleaves replicas one scheduler iteration at a
time and reacts to a replica dying mid-run:

  * **Failure injection** — a ``ReplicaFaultPlan`` kills a replica at a
    chosen burst (``ReplicaLostError`` at the burst dispatch, after host
    scheduling and before any launch: device memory gone) or hangs it
    (the fleet's heartbeat view declares it dead after missed beats,
    device memory still readable).
  * **Live-request migration** — a dead replica's residents leave through
    the preemption capture (``evacuate``): swap payloads (CRC32-checked,
    tagged with their pool's provenance) that a survivor ``adopt``s into
    its own pool, or free-and-reingest when the pages are unreachable.
  * **Crash-consistent journal** — with a ``launch/journal.py``
    ``RequestJournal`` attached, every admission, per-burst token delta,
    preempt / migrate / escalation event and completion is recorded after
    it happened, in the JAX package's bytes; a full restart
    (``train.fault.run_with_restarts``) replays unfinished requests from
    their last journaled token through the reingest resume path.

On one card the replicas share one ``params`` (one copy of the weights);
each has its own pool and block tables.

Sharded serving (``mesh=``, a ``launch.mesh.Mesh`` over
``torch.distributed`` ranks, ``launch.spmd``): ``ContinuousEngine`` on a
mesh whose ``model`` axis has M > 1 ranks keeps this rank's parameter
shards (``models.sharding.shard_params``, the JAX engine's placement) and
paged pools of this rank's KV heads; every rank runs the same scheduler
on the same queue, so block tables and the ``PageAllocator`` stay on the
host and identical, and each token pick is made on the group's first rank
and broadcast.  ``ReplicatedEngine`` over a ``(data, model)`` mesh runs
one engine a data row, in that row's ranks, and gathers the finished
requests and stats to every rank in the JAX package's order and shape.
Replica faults and the journal run on a mesh with more than one data row
too: the rows exchange each sweep's turns, journal records and a lost
row's evacuated entries over the data axis (``ReplicatedEngine``).
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.policy import EscalationPolicy, get_policy
from ..models.attention import kv_store_dtype, kv_swap_dtype
from ..models.paged import (PageAllocator, SwapBlobTag, aggregate_stats,
                            check_blob_tag, dtype_name, num_pages)
from ..models.sharding import shard_params
from ..models.transformer import _penalized, _pick, caches_with_table
from ..train.fault import (EngineStuckError, PoisonedLogitsError,
                           ReplicaFaultPlan, ReplicaLostError,
                           ServeFaultPlan, ServeWatchdog, StragglerMonitor)
from . import spmd
from .journal import JournalTap, one_writer
from .journal import merge as merge_journal
from .mesh import check_mesh, model_size, replica_meshes


def _crc_blobs(blobs: list) -> list:
    """Per-layer (crc32(k), crc32(v)) of host swap payloads: CRC32 of each
    tensor's bytes in C order, as the JAX package computes over numpy."""
    crc = lambda t: zlib.crc32(t.contiguous().view(torch.uint8).numpy())
    return [(crc(k), crc(v)) for k, v in blobs]


#: integer dtype of each element size, for copying pool pages as raw bits
_RAW = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _to_host(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Host copies of ``ts``: views into ONE pinned buffer (each pinned
    allocation has a fixed cost, paid once per swap, not per layer),
    filled asynchronously from the card; the caller synchronises once."""
    if not ts or ts[0].device.type == "cpu":
        return list(ts)
    sizes = [t.numel() * t.element_size() for t in ts]
    buf = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=True)
    out, off = [], 0
    for t, n in zip(ts, sizes):
        h = buf[off:off + n].view(t.dtype).view(t.shape)
        out.append(h.copy_(t, non_blocking=True))
        off += n
    return out


@dataclasses.dataclass(frozen=True)
class Request:
    """One queued generation request.  ``arrival`` and ``deadline`` are in
    decode rounds (the engine's clock); higher ``priority`` admits first
    and preempts lower; ``no_degrade`` refuses the fp8 swap store;
    ``no_escalate`` refuses KV-precision escalation (the row keeps its
    rung, saturated but cheap).  ``spec_k`` caps this request's
    speculative drafts below the engine's (None: the engine's) and
    ``no_speculate`` opts it out of drafting: it still rides the
    speculative burst, emitting one verified token a round."""
    rid: int
    tokens: Sequence[int]          # prompt token ids (>= 1)
    max_new: int                   # generation budget incl. the first token
    arrival: int = 0
    priority: int = 0
    deadline: Optional[int] = None
    no_degrade: bool = False
    no_escalate: bool = False
    spec_k: Optional[int] = None
    no_speculate: bool = False

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass
class Finished:
    """A served request: ``tokens`` holds the generated ids (first token
    included; a ``stop_token`` hit keeps the stop as the last element),
    with its robustness trail (``escalated``: its final ladder rung)."""
    rid: int
    prompt_len: int
    tokens: List[int]
    admit_round: int
    finish_round: int
    slot: int
    preemptions: int = 0
    sheds: int = 0
    degraded: bool = False
    deadline: Optional[int] = None
    deadline_miss: bool = False
    escalated: int = 0


@dataclasses.dataclass
class _Resume:
    """A preempted request's continuation.  ``blobs`` present: the swap
    path (per-layer (k, v) host page payloads covering ``written`` tokens,
    maybe in the degrade format, with their CRC32s and pool tag).
    ``blobs`` absent: re-ingest prompt + all but the last emitted token,
    then re-feed the last one through the decode round."""
    emitted: List[int]
    blobs: Optional[list]
    written: int
    degraded: bool
    checksums: Optional[list] = None
    tag: Optional[SwapBlobTag] = None


@dataclasses.dataclass
class _QEntry:
    """Queue bookkeeping around a Request: backoff gate, shed/preempt
    counters and (after a preemption) the resume state.  ``esc_level`` /
    ``esc_pressure`` carry the request's ladder rung and OF / UF pressure
    across preemptions (the rung belongs to the request, not its slot)."""
    req: Request
    not_before: int
    sheds: int = 0
    preemptions: int = 0
    degraded: bool = False
    resume: Optional[_Resume] = None
    esc_level: int = 0
    esc_pressure: tuple = (0, 0)
    esc_refused: bool = False


def _finished_from_record(rec: dict) -> Finished:
    """Rebuild a ``Finished`` from its journal ``finish`` record — the
    restart path for a request that completed before the crash."""
    return Finished(
        rid=rec["rid"], prompt_len=rec.get("prompt_len", 0),
        tokens=list(rec["toks"]),
        admit_round=rec.get("admit_round", 0),
        finish_round=rec.get("finish_round", 0),
        slot=rec.get("slot", -1),
        preemptions=rec.get("preemptions", 0),
        sheds=rec.get("sheds", 0),
        degraded=bool(rec.get("degraded", False)),
        deadline=rec.get("deadline"),
        deadline_miss=bool(rec.get("deadline_miss", False)),
        escalated=rec.get("escalated", 0))


def synthetic_trace(n_req: int, slots: int, prompt_len: int, gen: int,
                    vocab: int, seed: int = 2,
                    flavor: str = "chat") -> List[Request]:
    """The JAX package's deterministic workloads.

    ``chat``: every 8th request in the first 3/4 of the queue is LONG
    (budget ``gen``), the rest cycle ``gen/16``, ``gen/8``, ``gen/4``;
    prompt lengths cycle 1/4 .. 4/4 of ``prompt_len``; the first ``slots``
    requests arrive at round 0, then clumps of four every ``gen/16``
    rounds.

    ``soak`` (the overload trace): arrivals in bursts of eight, every 5th
    request a full-length prompt, every 4th a long budget, priorities over
    {0, 1, 2}, deadlines on the priority-2 tier, every 11th request
    ``no_degrade``.

    ``session`` (the HA soak's): multi-turn chat, sessions of up to three
    turns over a growing shared prefix — turn ``t``'s prompt is turn
    ``t-1``'s prompt + its simulated answer + a fresh user chunk, and it
    arrives once turn ``t-1``'s budget could have drained.  The longest
    prompt is ``prompt_len + 2 * (gen // 4 + max(1, prompt_len // 4))``;
    the third turn has priority 1, every session ``s % 5 == 3`` is
    ``no_degrade``."""
    rng = np.random.RandomState(seed)
    fr_len = (0.25, 0.5, 0.75, 1.0)
    shorts = (gen // 16, gen // 8, gen // 4)
    reqs = []
    if flavor == "session":
        step_gap = max(2, gen // 8)
        rid = s = 0
        while rid < n_req:
            base_len = max(1, int(prompt_len * fr_len[s % 4]))
            hist = rng.randint(0, vocab, size=base_len).tolist()
            arrival = (s // max(1, slots)) * step_gap
            for t in range(min(3, n_req - rid)):
                budget = max(2, shorts[(s + t) % 3])
                reqs.append(Request(
                    rid=rid, tokens=list(hist), max_new=budget,
                    arrival=arrival, priority=(1 if t == 2 else 0),
                    no_degrade=(s % 5 == 3)))
                rid += 1
                # the turn's answer and the next user message extend the
                # prefix the following turn re-sends
                hist += rng.randint(0, vocab, size=budget).tolist()
                hist += rng.randint(0, vocab,
                                    size=max(1, prompt_len // 4)).tolist()
                arrival += budget + step_gap
            s += 1
        return reqs
    if flavor == "soak":
        for i in range(n_req):
            plen = (prompt_len if i % 5 == 0
                    else max(1, int(prompt_len * fr_len[i % 4])))
            budget = gen if i % 4 == 0 else max(2, shorts[i % 3])
            arrival = (i // 8) * max(2, gen // 8)
            pri = 2 if i % 7 == 3 else (1 if i % 3 == 0 else 0)
            deadline = (arrival + 4 * budget + 2 * max(2, gen // 8)
                        if pri == 2 else None)
            reqs.append(Request(
                rid=i, tokens=rng.randint(0, vocab, size=plen).tolist(),
                max_new=budget, arrival=arrival, priority=pri,
                deadline=deadline, no_degrade=(i % 11 == 7)))
        return reqs
    if flavor != "chat":
        raise ValueError(f"flavor must be chat|soak|session, got {flavor!r}")
    for i in range(n_req):
        is_long = (i % 8 == 0) and i < (3 * n_req) // 4
        budget = gen if is_long else max(2, shorts[i % 3])
        plen = max(1, int(prompt_len * fr_len[i % 4]))
        arrival = (0 if i < slots
                   else ((i - slots) // 4 + 1) * max(2, gen // 16))
        reqs.append(Request(
            rid=i, tokens=rng.randint(0, vocab, size=plen).tolist(),
            max_new=budget, arrival=arrival))
    return reqs


_FAR = 1 << 30          # "no deadline" sort key

#: the counters of ``stats``, the JAX package's (``faults_overflow``
#: appears once an injected overflow fired, as in the JAX engine)
COUNTERS = ("preemptions", "preempt_swap", "preempt_reingest",
            "preempt_restart", "resumed", "degraded", "swap_out_bytes",
            "shed_events", "poisoned_rounds", "nonfinite_prefill",
            "stragglers", "faults_exhaust", "faults_slow",
            "escalations", "esc_deferred", "esc_refused",
            "sdc_injected", "sdc_detected", "sdc_reingest",
            "spec_rounds", "spec_emitted",
            "migrated_in", "journal_replayed")

#: the port's host clocks in ``stats`` (not in the JAX package's): host
#: time around prefill waves / decode bursts (each ends in a
#: device-to-host copy of its result), around swaps (each ends in a
#: synchronise) and around the swap payloads' CRC32s
CLOCKS = ("prefill_s", "decode_s", "swap_out_s", "swap_in_s",
          "swap_in_bytes", "swap_crc_s")


class ContinuousEngine:
    """Continuous-batching scheduler over ``slots`` paged batch rows on
    the model's device.  The model must be paged (``cfg.paged_kv``).
    Requests must satisfy ``prompt_len + max_new <= max_len``.  The page
    pools are updated in place across bursts.

    ``preempt`` picks the eviction mechanism (``"free"`` re-ingests,
    ``"swap"`` round-trips live pages through host memory);
    ``degrade_fmt`` stores swapped pages in a narrow format unless the
    request opted out; ``shed=False`` restores blocking admission (no
    backoff deferrals); ``fault_plan`` injects deterministic faults; the
    watchdog aborts after ``watchdog_patience`` iterations without
    progress.  A shed entry backs off ``shed_base * 2**sheds`` rounds,
    capped at ``shed_cap``, plus as much jitter; a row resident for fewer
    than ``min_resident`` rounds is never preempted.
    ``escalate`` (an ``EscalationPolicy``) turns on flag-driven
    KV-precision escalation; it needs an f32 pool with no ``kv_fmt``.
    ``spec_k`` > 0 turns on greedy speculative decoding with a draft of
    ``draft_repeats`` pattern groups (None: full depth) under
    ``draft_policy`` (None: the model's); requests then need
    ``prompt_len + max_new + spec_k <= max_len``.

    Fleet membership: ``replica_id`` names this engine in its fleet (in
    journal records and on swap-blob tags), ``replica_fault`` (a
    ``ReplicaFaultPlan``) is consulted at every burst dispatch, and
    ``journal`` (a ``RequestJournal``) records the run and, when it
    already holds records, is replayed by ``start``.

    ``mesh``: tensor parallel over its ``model`` axis; ``params`` are the
    FULL tree, of which the engine keeps this rank's shards."""

    def __init__(self, model, params, *, slots: int, max_len: int,
                 chunk: int = 32, n_pages: Optional[int] = None,
                 stop_token: Optional[int] = None, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 seed: int = 0, burst_cap: int = 64,
                 prefill_rounds: int = 2, admit_wave: int = 2,
                 repetition_penalty: Optional[float] = None,
                 presence_penalty: Optional[float] = None,
                 preempt: str = "free", degrade_fmt: Optional[str] = None,
                 shed: bool = True, shed_base: int = 2, shed_cap: int = 64,
                 min_resident: int = 2,
                 fault_plan: Optional[ServeFaultPlan] = None,
                 watchdog_patience: int = 200,
                 escalate: Optional[EscalationPolicy] = None,
                 spec_k: int = 0, draft_repeats: Optional[int] = None,
                 draft_policy=None, replica_id: int = 0,
                 replica_fault: Optional[ReplicaFaultPlan] = None,
                 journal=None, mesh=None):
        cfg = model.cfg
        if not cfg.paged_kv:
            raise ValueError("ContinuousEngine requires cfg.paged_kv "
                             "(admission allocates pages, not batch rows)")
        why = cfg.paged_unsupported_reason()
        if why is not None:
            raise ValueError(f"continuous batching is unsupported for "
                             f"{cfg.name}: {why} cannot page its cache")
        check_mesh(mesh)
        if preempt not in ("free", "swap"):
            raise ValueError(f"preempt must be free|swap, got {preempt!r}")
        assert slots >= 1 and chunk >= 1 and burst_cap >= 1
        self.model, self.device = model, model.device
        self.mesh = mesh
        self.params = (shard_params(params, mesh, cfg)
                       if model_size(mesh) > 1 else params)
        self.slots, self.max_len, self.chunk = slots, max_len, chunk
        self.page = cfg.page_size
        self.max_pages = num_pages(max_len, self.page)
        self.n_pages = (slots * self.max_pages + 1 if n_pages is None
                        else n_pages)
        self.stop_token = stop_token
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.seed, self.burst_cap = seed, burst_cap
        self.prefill_rounds = prefill_rounds
        self.admit_wave = max(1, admit_wave)
        self.repetition_penalty = repetition_penalty
        self.presence_penalty = presence_penalty
        self._use_pen = _penalized(repetition_penalty, presence_penalty)
        self.preempt_mode = preempt
        self.degrade_fmt = degrade_fmt
        self._swap_dtype = (kv_swap_dtype(degrade_fmt)
                            if degrade_fmt is not None else None)
        self._pool_dtype = dtype_name(kv_store_dtype(model.policy))
        self.shed, self.shed_base, self.shed_cap = shed, shed_base, shed_cap
        self.min_resident = max(0, min_resident)
        self.fault_plan = fault_plan
        self.watchdog_patience = watchdog_patience
        # fleet membership: identity (journal records, swap-blob tags), the
        # kill plan consulted at every burst dispatch, the shared journal
        self.replica_id = int(replica_id)
        self.replica_fault = replica_fault
        self.journal = one_writer(journal, mesh)
        self.escalate = escalate
        self._esc_fmts = None
        if escalate is not None:
            if not isinstance(escalate, EscalationPolicy):
                raise TypeError(f"escalate must be an EscalationPolicy, "
                                f"got {type(escalate).__name__}")
            pool_dt = kv_store_dtype(model.policy)
            if model.policy.kv_fmt is not None or pool_dt != torch.float32:
                raise ValueError(
                    f"escalation needs an f32 KV pool with no kv_fmt (the "
                    f"write path snaps each row to its own ladder rung "
                    f"inside a shared wide container); policy "
                    f"{model.policy.name!r} stores KV as {pool_dt}")
            self._esc_fmts = escalate.formats
        self.spec_k = int(spec_k)
        self.draft_repeats = draft_repeats
        self.draft_policy = (get_policy(draft_policy)
                             if draft_policy is not None else None)
        if self.spec_k:
            if self.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            model.speculate_check()
            if temperature > 0.0:
                raise ValueError(
                    "speculative decoding is greedy-only (acceptance is "
                    "defined against the verify argmax); temperature "
                    f"{temperature} would change the sampled stream")
            if self._use_pen:
                raise ValueError(
                    "speculative decoding does not compose with "
                    "repetition/presence penalties yet: the verify chunk "
                    "scores k+1 positions against ONE histogram snapshot, "
                    "so mid-chunk accepts would see stale counts")

        self.alloc = PageAllocator(self.n_pages)
        self.scratch = self.alloc.alloc(1)[0]      # dead-write sink, forever
        self._table = np.full((slots, self.max_pages), self.scratch,
                              np.int32)
        self._table_dev = None
        self.caches = model.init_caches(slots, max_len,
                                        page_table=self._table,
                                        n_pages=self.n_pages, mesh=mesh)
        self.pos = np.full((slots,), max_len - 1, np.int32)
        self.lens = np.zeros((slots,), np.int32)
        self.done = np.ones((slots,), bool)
        self.limit = np.zeros((slots,), np.int32)
        self.tok = np.zeros((slots, 1), np.int32)
        self._req: List[Optional[Request]] = [None] * slots
        self._entry: List[Optional[_QEntry]] = [None] * slots
        self._owned: List[List[int]] = [[] for _ in range(slots)]
        self._prog = np.zeros((slots,), np.int32)   # prefill progress
        self._emitted: List[List[int]] = [[] for _ in range(slots)]
        # tokens chunked prefill consumes: the prompt, or on a reingest
        # resume the prompt + previously emitted tokens (minus the last)
        self._ingest: List[List[int]] = [[] for _ in range(slots)]
        self._resume_tok: List[Optional[int]] = [None] * slots
        self._admit_round = np.zeros((slots,), np.int32)
        self._cnt = (np.zeros((slots, model.vocab_out), np.int32)
                     if self._use_pen else None)
        # numerical health: each slot's ladder rung and its accumulated
        # OF / UF write pressure (host mirror of what the bursts return)
        self.kv_levels = np.zeros((slots,), np.int32)
        self.flag_pressure = np.zeros((slots, 2), np.int64)
        # each slot's speculative draft cap (0: a plain decode row inside
        # the speculative batch)
        self._spec_rows = np.zeros((slots,), np.int32)
        self._pending: List[_QEntry] = []
        self._held: List[int] = []      # fault-plan page grab
        self._release_at: Optional[int] = None
        self._results: Dict[int, Finished] = {}
        self._counters: Dict[str, int] = {}
        self._gen: Optional[torch.Generator] = None
        self._round_no = self._decode_rounds = 0
        self._occ_accum = self._bursts = 0
        self._clock = {}
        self.reset_monitors()

    # -- helpers ----------------------------------------------------------
    def reset_monitors(self) -> None:
        """Fresh watchdog + straggler-monitor state (at every ``start``)."""
        self.watchdog = ServeWatchdog(self.watchdog_patience)
        self.monitor = StragglerMonitor()

    def _worst_pages(self, r: Request) -> int:
        """A request's worst-case pages: prompt + budget, and with
        speculation the ``spec_k`` slots a verify chunk writes past the
        budget (dead until accepted)."""
        return num_pages(r.prompt_len + r.max_new + self.spec_k, self.page)

    def _reserved_pages(self) -> int:
        """Worst-case pages of every admitted-but-unfinished request."""
        return sum(self._worst_pages(r) for r in self._req if r is not None)

    def _ensure_pages(self, b: int, last_idx: int) -> bool:
        """Lazily allocate slot ``b``'s pages covering token slots up to
        ``last_idx``; False when the pool cannot supply them (the caller
        preempts a victim or slot ``b`` itself and retries)."""
        want = min(last_idx, self.max_len - 1) // self.page + 1
        while len(self._owned[b]) < want:
            got = self.alloc.try_alloc(1)
            if got is None:
                return False
            self._table[b, len(self._owned[b])] = got[0]
            self._owned[b].append(got[0])
            self._table_dev = None
        return True

    def _table_device(self):
        """Device copy of the block table, re-uploaded only after the host
        table changed (admission, lazy page allocs, recycling)."""
        if self._table_dev is None:
            self._table_dev = torch.as_tensor(self._table, device=self.device)
        return self._table_dev

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prompt_hist(self, b: int) -> None:
        """Seed slot ``b``'s penalty histogram: prompt + already-emitted
        tokens (resume) — the count state an un-preempted run holds."""
        if not self._use_pen:
            return
        v = self._cnt.shape[1]
        seen = list(self._req[b].tokens) + list(self._emitted[b])
        self._cnt[b] = np.bincount(np.asarray(seen, np.int64) % v,
                                   minlength=v).astype(np.int32)

    def _sampling(self) -> dict:
        return dict(generator=self._gen, temperature=self.temperature,
                    top_k=self.top_k, top_p=self.top_p)

    # -- priorities, deadlines, victims -----------------------------------
    def _pending_need(self, e: _QEntry) -> int:
        """Pages an entry needs AT ADMISSION (its resume/prompt length)."""
        if e.resume is not None:
            if e.resume.blobs is not None:
                return num_pages(e.resume.written, self.page)
            n = e.req.prompt_len + len(e.resume.emitted) - 1
            return num_pages(max(1, n), self.page)
        return num_pages(e.req.prompt_len, self.page)

    def _eff_pending(self, e: _QEntry, round_no: int) -> int:
        """Effective priority of a queued entry: its class, +1 when its
        deadline can no longer absorb any further waiting."""
        p = e.req.priority
        if e.req.deadline is not None:
            emitted = len(e.resume.emitted) if e.resume is not None else 0
            chunks = -(-e.req.prompt_len // self.chunk)
            need = (e.req.max_new - emitted) + chunks
            if round_no + need >= e.req.deadline:
                p += 1
        return p

    def _eff_resident(self, b: int, round_no: int) -> int:
        """Effective priority of a resident row (the same +1 boost)."""
        r = self._req[b]
        p = r.priority
        if r.deadline is not None:
            if self.done[b]:        # still prefilling
                rem = len(self._ingest[b]) - int(self._prog[b])
                need = r.max_new + -(-max(0, rem) // self.chunk)
            else:
                need = int(self.limit[b]) - int(self.pos[b]) + 1
            if round_no + need >= r.deadline:
                p += 1
        return p

    def _victims_for(self, eff: int, round_no: int, exclude=()):
        """Resident rows preemptible by effective priority ``eff``,
        weakest first; rows resident under ``min_resident`` rounds are
        protected (anti-thrash).  Ties prefer the row donating the most
        pages, then the lowest slot."""
        cands = [b for b in range(self.slots)
                 if self._req[b] is not None and b not in exclude
                 and round_no - int(self._admit_round[b]) >= self.min_resident
                 and self._eff_resident(b, round_no) < eff]
        return sorted(cands, key=lambda b: (self._eff_resident(b, round_no),
                                            -len(self._owned[b]), b))

    def _backoff(self, e: _QEntry, round_no: int) -> None:
        """Shed: defer the entry with jittered exponential backoff —
        deterministic in (seed, rid, attempt), so replays are exact."""
        delay = min(self.shed_cap, self.shed_base * (2 ** min(e.sheds, 16)))
        rng = np.random.RandomState(
            (self.seed * 1000003 + e.req.rid * 9973 + e.sheds * 97)
            & 0x7FFFFFFF)
        e.not_before = round_no + delay + int(rng.randint(0, max(1, delay)))
        e.sheds += 1
        self._counters["shed_events"] += 1
        if self.fault_plan is not None:
            self.fault_plan.note("shed", round=round_no, rid=e.req.rid,
                                 until=e.not_before)

    # -- preemption / swap ------------------------------------------------
    def _swap_out(self, ids: List[int], degrade: bool):
        """Copy pages ``ids`` of every layer to host memory — cast to the
        degrade format on the device first when allowed.  Returns
        ``(blobs, nbytes, checksums)``; the CRC32s are taken here, so a
        later bit flip in host memory is caught at swap-in."""
        t0 = time.perf_counter()
        idx = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        pages = []
        for c in self.caches:
            for pool in (c.k_pool, c.v_pool):
                x = pool.index_select(0, idx)
                pages.append(x.to(self._swap_dtype) if degrade else x)
        host = _to_host(pages)
        blobs = list(zip(host[0::2], host[1::2]))
        self._sync()
        t1 = time.perf_counter()
        sums = _crc_blobs(blobs)
        self._clock["swap_out_s"] += t1 - t0
        self._clock["swap_crc_s"] += time.perf_counter() - t1
        return blobs, sum(x.numel() * x.element_size() for x in host), sums

    @staticmethod
    def _flip_bit(blobs: list, rid: int) -> None:
        """Deterministic single-bit corruption of a swap payload (SDC
        injection): byte and bit derive from the rid alone."""
        k, v = blobs[0]
        flat = k.clone().view(torch.uint8).reshape(-1)
        flat.numpy()[(rid * 2654435761) % flat.numel()] ^= np.uint8(
            1 << (rid % 8))
        blobs[0] = (flat.view(k.dtype).reshape(k.shape), v)

    def _swap_in(self, blobs: list, ids: List[int]) -> None:
        """Write swapped payloads back into every layer's pools at the
        victim's NEW page ids, widened to the pool dtype on the device."""
        t0 = time.perf_counter()
        idx = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        for c, pair in zip(self.caches, blobs):
            for pool, x in zip((c.k_pool, c.v_pool), pair):
                # copied as raw bits: index_copy_ has no fp8 kernel
                raw = _RAW[pool.element_size()]
                # the host payload's bytes: what crosses PCIe
                self._clock["swap_in_bytes"] += x.numel() * x.element_size()
                x = x.to(self.device, non_blocking=True).to(pool.dtype)
                pool.view(raw).index_copy_(0, idx, x.view(raw))
        self._sync()
        self._clock["swap_in_s"] += time.perf_counter() - t0

    def _preempt(self, b: int, round_no: int, reason: str,
                 force_reingest: bool = False) -> None:
        """Evict resident row ``b``: capture its continuation (swap-out or
        reingest state), free its pages and slot, and re-queue it.
        ``force_reingest`` bypasses the swap path even in swap mode: an
        escalating row recomputes its K/V at the wider rung, never restores
        the saturated bytes its flags condemned."""
        e, req = self._entry[b], self._req[b]
        counters, plan = self._counters, self.fault_plan
        e.preemptions += 1
        counters["preemptions"] += 1
        e.esc_level = int(self.kv_levels[b])
        e.esc_pressure = (int(self.flag_pressure[b, 0]),
                          int(self.flag_pressure[b, 1]))
        if (not self.done[b] and self.preempt_mode == "swap"
                and not force_reingest):
            written = int(self.lens[b])
            keep = self._owned[b][:num_pages(written, self.page)]
            degrade = self.degrade_fmt is not None and not req.no_degrade
            blobs, nbytes, sums = self._swap_out(keep, degrade)
            if plan is not None and plan.take_corrupt():
                self._flip_bit(blobs, req.rid)
                counters["sdc_injected"] += 1
                plan.note("sdc_inject", round=round_no, rid=req.rid, slot=b)
            e.resume = _Resume(emitted=list(self._emitted[b]), blobs=blobs,
                               written=written, degraded=degrade,
                               checksums=sums,
                               tag=SwapBlobTag(replica=self.replica_id,
                                               dtype=self._pool_dtype,
                                               page=self.page))
            if degrade:
                e.degraded = True
                counters["degraded"] += 1
            counters["preempt_swap"] += 1
            counters["swap_out_bytes"] += nbytes
        elif self._emitted[b]:
            e.resume = _Resume(emitted=list(self._emitted[b]), blobs=None,
                               written=0, degraded=False)
            counters["preempt_reingest"] += 1
        else:
            e.resume = None         # mid-prefill: restart from the prompt
            counters["preempt_restart"] += 1
        mode = ("swap" if e.resume is not None
                and e.resume.blobs is not None else "reingest")
        if plan is not None:
            plan.note("preempt", round=round_no, rid=req.rid, slot=b,
                      reason=reason, mode=mode)
        if self.journal is not None:
            self.journal.append("preempt", rid=req.rid,
                                replica=self.replica_id, round=round_no,
                                reason=reason, mode=mode)
        self._release(b)
        e.not_before = max(e.not_before, round_no)
        self._pending.append(e)

    def _release(self, b: int) -> None:
        """Slot ``b``'s pages back to the allocator, its table row to
        scratch, its state to idle."""
        self.alloc.free(self._owned[b])
        self._owned[b] = []
        self._table[b, :] = self.scratch
        self._table_dev = None
        self._req[b], self._entry[b] = None, None
        self._emitted[b], self._ingest[b] = [], []
        self._prog[b], self._resume_tok[b] = 0, None
        self.pos[b], self.lens[b] = self.max_len - 1, 0
        self.done[b], self.limit[b] = True, 0
        self.kv_levels[b], self.flag_pressure[b] = 0, 0
        self._spec_rows[b] = 0
        if self._use_pen:
            self._cnt[b] = 0

    # -- admission --------------------------------------------------------
    def _admit_one(self, e: _QEntry, b: int, pages: List[int],
                   round_no: int) -> None:
        """Install entry ``e`` into free slot ``b`` with its admission
        pages, restoring resume state.  Swap-in is CRC-checked first; a
        mismatch falls back to re-ingest, which needs exactly the pages
        already allocated (``lens == prompt + emitted - 1``)."""
        req, counters = e.req, self._counters
        self._table[b, :len(pages)] = pages
        self._table_dev = None
        self._owned[b] = pages
        self._req[b], self._entry[b] = req, e
        self._admit_round[b] = round_no
        self._resume_tok[b] = None
        k = 0
        if self.spec_k and not req.no_speculate:
            k = (self.spec_k if req.spec_k is None
                 else max(0, min(self.spec_k, req.spec_k)))
        self._spec_rows[b] = k
        self.kv_levels[b] = e.esc_level
        self.flag_pressure[b] = np.asarray(e.esc_pressure, np.int64)
        rs, e.resume = e.resume, None
        if rs is not None and rs.blobs is not None:
            check_blob_tag(rs.tag, dtype=self._pool_dtype, page=self.page)
            t0 = time.perf_counter()
            intact = (rs.checksums is None
                      or _crc_blobs(rs.blobs) == rs.checksums)
            self._clock["swap_crc_s"] += time.perf_counter() - t0
            if not intact:
                counters["sdc_detected"] += 1
                counters["sdc_reingest"] += 1
                if self.fault_plan is not None:
                    self.fault_plan.note("sdc_detect", round=round_no,
                                         rid=req.rid, slot=b)
                rs.blobs, rs.checksums = None, None
        if rs is None:
            self._ingest[b] = list(req.tokens)
            self._prog[b] = 0
            self._emitted[b] = []
        elif rs.blobs is not None:
            self._swap_in(rs.blobs, pages)
            self._emitted[b] = list(rs.emitted)
            self._ingest[b] = []
            self._prog[b] = req.prompt_len
            self.tok[b, 0] = rs.emitted[-1]
            self.pos[b] = self.lens[b] = rs.written
            self.limit[b] = req.prompt_len + req.max_new - 1
            self.done[b] = False
            counters["resumed"] += 1
        else:
            self._ingest[b] = list(req.tokens) + list(rs.emitted[:-1])
            self._prog[b] = 0
            self._emitted[b] = list(rs.emitted)
            self._resume_tok[b] = rs.emitted[-1]
            counters["resumed"] += 1
        self._prompt_hist(b)
        if self.journal is not None:
            self.journal.append("admit", rid=req.rid,
                                replica=self.replica_id, round=round_no,
                                slot=b, resumed=rs is not None,
                                emitted=len(self._emitted[b]))

    def _admission(self, round_no: int) -> int:
        """One admission pass: visible entries in (effective priority,
        deadline, arrival, rid) order; a candidate that does not fit may
        preempt strictly weaker residents, else — with ``shed`` and a free
        slot — it is deferred with backoff.  It never blocks the entries
        behind it."""
        admitted = 0
        vis = [e for e in self._pending if e.not_before <= round_no]
        vis.sort(key=lambda e: (
            -self._eff_pending(e, round_no),
            e.req.deadline if e.req.deadline is not None else _FAR,
            e.req.arrival, e.req.rid))
        for e in vis:
            worst = self._worst_pages(e.req)
            need = self._pending_need(e)

            def fits():
                free_slots = [b for b in range(self.slots)
                              if self._req[b] is None]
                ok = (bool(free_slots)
                      and self._reserved_pages() + worst <= self.n_pages - 1
                      and self.alloc.n_free >= need)
                return free_slots[0] if ok else None

            b = fits()
            if b is None:
                eff = self._eff_pending(e, round_no)
                for v in self._victims_for(eff, round_no):
                    self._preempt(v, round_no, reason="pressure")
                    b = fits()
                    if b is not None:
                        break
                if b is None:
                    # shed only under page pressure (a slot sits free);
                    # all-slots-busy just waits for a finish
                    if self.shed and any(self._req[s] is None
                                         for s in range(self.slots)):
                        self._backoff(e, round_no)
                    continue
            pages = self.alloc.try_alloc(need)
            if pages is None:       # raced an injected hold: treat as shed
                if self.shed:
                    self._backoff(e, round_no)
                continue
            self._pending.remove(e)
            self._admit_one(e, b, pages, round_no)
            admitted += 1
        return admitted

    # -- finish -----------------------------------------------------------
    def _finish(self, b: int, round_no: int) -> None:
        """Page recycling the round the request finishes, with deadline
        accounting and the robustness trail on its ``Finished``."""
        req, e = self._req[b], self._entry[b]
        fin = Finished(
            rid=req.rid, prompt_len=req.prompt_len,
            tokens=list(self._emitted[b]),
            admit_round=int(self._admit_round[b]), finish_round=round_no,
            slot=b, preemptions=e.preemptions, sheds=e.sheds,
            degraded=e.degraded, deadline=req.deadline,
            deadline_miss=(req.deadline is not None
                           and round_no > req.deadline),
            escalated=int(self.kv_levels[b]))
        self._results[req.rid] = fin
        if self.journal is not None:
            self.journal.append(
                "finish", rid=req.rid, replica=self.replica_id,
                prompt_len=fin.prompt_len, toks=fin.tokens,
                admit_round=fin.admit_round, finish_round=fin.finish_round,
                slot=fin.slot, preemptions=fin.preemptions, sheds=fin.sheds,
                degraded=fin.degraded, deadline=fin.deadline,
                deadline_miss=fin.deadline_miss, escalated=fin.escalated)
        self._release(b)

    # -- escalation -------------------------------------------------------
    def _maybe_escalate(self, active: List[int], round_no: int) -> None:
        """Flag-pressure check after a burst: a live row whose OF or UF
        pressure crossed its threshold moves one rung up the ladder by a
        forced free-and-reingest.  Refusable per request (counted once);
        deferred while the free list is shorter than the policy's
        ``min_free_pages`` (an escalating row re-prefills its whole
        history)."""
        esc, plan, counters = self.escalate, self.fault_plan, self._counters
        for b in active:
            if self._req[b] is None or self.done[b]:
                continue                    # finished or evicted this round
            lvl = int(self.kv_levels[b])
            of, uf = (int(self.flag_pressure[b, 0]),
                      int(self.flag_pressure[b, 1]))
            if of < esc.of_threshold and uf < esc.uf_threshold:
                continue
            if lvl >= esc.top():
                continue                    # already at the widest rung
            e = self._entry[b]
            if self._req[b].no_escalate:
                if not e.esc_refused:
                    e.esc_refused = True
                    counters["esc_refused"] += 1
                continue
            if self.alloc.n_free < esc.min_free_pages:
                counters["esc_deferred"] += 1
                continue
            rid = self._req[b].rid
            self._preempt(b, round_no, reason="escalate", force_reingest=True)
            e.esc_level = lvl + 1
            e.esc_pressure = (0, 0)
            counters["escalations"] += 1
            if plan is not None:
                plan.note("escalate", round=round_no, rid=rid, slot=b,
                          level=lvl + 1, of=of, uf=uf)
            if self.journal is not None:
                self.journal.append("escalate", rid=rid,
                                    replica=self.replica_id, round=round_no,
                                    level=lvl + 1)

    # -- the serving state machine ----------------------------------------
    def start(self, requests: Sequence[Request]) -> None:
        """Validate and enqueue ``requests``; arm the run state (fault
        plan, monitors, counters, the sampling generator).  With a
        journal that already holds records (a restart), a request with a
        ``finish`` record is answered from it, one whose journaled stream
        is whole gets its missing ``finish`` (``recovered=True``), and
        any other with journaled tokens re-enters the queue at round 0 to
        resume from its last one through the reingest path."""
        for r in requests:
            if r.prompt_len < 1 or r.max_new < 1:
                raise ValueError(f"request {r.rid}: empty prompt or budget")
            if r.prompt_len + r.max_new + self.spec_k > self.max_len:
                hint = (f" (+{self.spec_k} speculative lookahead: the "
                        f"verify chunk writes spec_k slots past the "
                        f"budget)" if self.spec_k else "")
                raise ValueError(
                    f"request {r.rid}: prompt {r.prompt_len} + budget "
                    f"{r.max_new}{hint} exceeds max_len {self.max_len}")
            worst = self._worst_pages(r)
            if worst > self.n_pages - 1:
                raise ValueError(
                    f"request {r.rid} can never fit the pool: needs "
                    f"{worst} pages, pool has {self.n_pages - 1} "
                    f"(+1 scratch)")
        self._results = {}
        self.alloc.reset_peak()
        if self.fault_plan is not None:
            self.fault_plan.reset()
        self._held, self._release_at = [], None
        self.reset_monitors()
        self._counters = {k: 0 for k in COUNTERS}
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._round_no = self._decode_rounds = 0
        self._occ_accum = self._bursts = 0
        self._clock = {k: 0 for k in CLOCKS}
        jr = self.journal
        pend: List[_QEntry] = []
        for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            e = _QEntry(req=r, not_before=r.arrival)
            if jr is not None and jr.records:
                fr = jr.finish_record(r.rid)
                if fr is not None:
                    self._results[r.rid] = _finished_from_record(fr)
                    continue
                em = jr.emitted(r.rid)
                if em:
                    if (len(em) >= r.max_new
                            or (self.stop_token is not None
                                and em[-1] == self.stop_token)):
                        # the crash fell between the last tokens record and
                        # its finish record: recover the completion fact
                        self._results[r.rid] = Finished(
                            rid=r.rid, prompt_len=r.prompt_len,
                            tokens=list(em), admit_round=0,
                            finish_round=0, slot=-1)
                        jr.append("finish", rid=r.rid,
                                  replica=self.replica_id,
                                  prompt_len=r.prompt_len, toks=list(em),
                                  recovered=True)
                        continue
                    e.resume = _Resume(emitted=list(em), blobs=None,
                                       written=0, degraded=False)
                    e.not_before = 0        # arrived before the crash
                    self._counters["journal_replayed"] += 1
                    jr.append("replay", rid=r.rid,
                              replica=self.replica_id, from_tok=len(em))
            pend.append(e)
        self._pending = pend

    def has_work(self) -> bool:
        return bool(self._pending or any(r is not None for r in self._req))

    def _diag(self) -> dict:
        return {"round": self._round_no,
                "replica": self.replica_id,
                "pending": [(e.req.rid, e.not_before, e.sheds)
                            for e in self._pending],
                "resident": [r.rid for r in self._req if r is not None],
                "pool": self.alloc.stats(),
                "held_pages": len(self._held),
                "counters": dict(self._counters)}

    # -- migration (the fleet host's dead-replica API) --------------------
    def evacuate(self, *, readable: bool = True,
                 mode: str = "swap") -> List[_QEntry]:
        """Every in-flight and queued request as portable queue entries.
        Residents leave through the preemption capture: with the device
        memory ``readable`` (a hang) and ``mode="swap"`` (and a swap
        engine) their live pages travel as tagged, CRC-carrying host
        blobs; otherwise (a kill, or ``mode="reingest"``) the continuation
        is the emitted-token list and the receiver recomputes the K/V.
        Queued entries drain as they are."""
        force = (not readable) or mode != "swap"
        for b in range(self.slots):
            if self._req[b] is not None:
                self._preempt(b, self._round_no, reason="migrate",
                              force_reingest=force)
        out, self._pending = self._pending, []
        return out

    def adopt(self, entries: Sequence[_QEntry]) -> int:
        """Enqueue another replica's evacuated entries into this engine,
        admissible at once on its round clock.  A swap payload's tag is
        checked against this pool (``check_blob_tag``: a foreign dtype or
        page size raises ``ValueError``) and the entry is journaled as a
        ``swap`` migration; its CRC32s are checked once, at admission, as
        for any swap-in — a payload damaged in host memory is dropped
        there and the entry re-ingests (``sdc_detect`` with its slot)."""
        n = 0
        for e in entries:
            rs = e.resume
            if rs is not None and rs.blobs is not None:
                check_blob_tag(rs.tag, dtype=self._pool_dtype,
                               page=self.page)
            e.not_before = self._round_no
            self._pending.append(e)
            self._counters["migrated_in"] += 1
            if self.journal is not None:
                self.journal.append(
                    "migrate", rid=e.req.rid, to=self.replica_id,
                    mode=("swap" if rs is not None
                          and rs.blobs is not None else "reingest"),
                    emitted=len(rs.emitted) if rs is not None else 0)
            n += 1
        return n

    def _fault_holds(self) -> None:
        """Release an expired exhaustion hold; start a due one (grab the
        whole free list)."""
        plan = self.fault_plan
        if self._held and self._round_no >= self._release_at:
            self.alloc.free(self._held)
            if plan is not None:
                plan.note("exhaust_release", round=self._round_no,
                          pages=len(self._held))
            self._held, self._release_at = [], None
        if plan is not None and not self._held:
            dur = plan.take_exhaustion(self._round_no)
            if dur is not None:
                grab = self.alloc.n_free
                self._held = self.alloc.alloc(grab) if grab else []
                self._release_at = self._round_no + max(1, dur)
                self._counters["faults_exhaust"] += 1
                plan.note("exhaust", round=self._round_no, pages=grab,
                          until=self._release_at)

    def _prefill_waves(self) -> int:
        """One prefill chunk per admitting slot, same-offset slots batched
        into one call; a row whose last chunk ran samples its first token
        (or, on a reingest resume, goes back to decoding from its last
        emitted token).  Returns the progress made."""
        model, params = self.model, self.params
        plan, counters = self.fault_plan, self._counters
        progress = 0
        prefilling = [b for b in range(self.slots)
                      if self._req[b] is not None and self.done[b]]
        waves: Dict[int, List[int]] = {}
        for b in prefilling:
            waves.setdefault(int(self._prog[b]), []).append(b)
        for off, rows in sorted(waves.items()):
            m = len(rows)
            buf = np.zeros((m, self.chunk), np.int32)
            lens = np.zeros((m,), np.int32)
            for i, b in enumerate(rows):
                piece = self._ingest[b][off:off + self.chunk]
                buf[i, :len(piece)] = piece
                lens[i] = len(piece)
            caches = caches_with_table(self.caches, self._table_device())
            esc_kw = ({} if self._esc_fmts is None else
                      dict(esc_fmts=self._esc_fmts,
                           kv_levels=self._tensor(self.kv_levels[rows])))
            r = model.prefill_chunk(
                params, self._tensor(buf), caches, q_offset=off,
                row=self._tensor(rows), chunk_lens=self._tensor(lens),
                mesh=self.mesh, **esc_kw)
            lg = r[0]
            if self._esc_fmts is not None:
                # prefill write flags feed the same per-slot pressure
                self.flag_pressure[rows] += r[2].cpu().numpy().astype(
                    np.int64)
            cnts = self._tensor(self._cnt[rows]) if self._use_pen else None
            tok0, badp = _pick(
                lg[:, -1], counts=cnts, guard=True,
                penalties=dict(repetition_penalty=self.repetition_penalty,
                               presence_penalty=self.presence_penalty),
                mesh=self.mesh, **self._sampling())
            tok0, badp = tok0.cpu().numpy(), badp.cpu().numpy()
            progress += 1
            for i, b in enumerate(rows):
                req = self._req[b]
                self._prog[b] += int(lens[i])
                if int(self._prog[b]) != len(self._ingest[b]):
                    continue
                if badp[i]:
                    if plan is not None and plan.mask_poison:
                        counters["nonfinite_prefill"] += 1
                    else:
                        raise PoisonedLogitsError(
                            f"non-finite prefill logits for request "
                            f"{req.rid} (slot {b}, round {self._round_no})")
                if self._resume_tok[b] is not None:
                    # reingest resume: the re-fed tokens only rebuild K/V
                    self.tok[b, 0] = self._resume_tok[b]
                    self._resume_tok[b] = None
                    self.pos[b] = self.lens[b] = len(self._ingest[b])
                    self.limit[b] = req.prompt_len + req.max_new - 1
                    self.done[b] = False
                    continue
                t0 = int(tok0[i])
                self._emitted[b] = [t0]
                if self.journal is not None:
                    self.journal.append("tokens", rid=req.rid,
                                        replica=self.replica_id, toks=[t0])
                if self._use_pen:
                    self._cnt[b, t0 % self._cnt.shape[1]] += 1
                hit_stop = (self.stop_token is not None
                            and t0 == self.stop_token)
                if hit_stop or req.max_new == 1:
                    self._finish(b, self._round_no)
                    progress += 1
                else:
                    self.tok[b, 0] = t0
                    self.pos[b] = self.lens[b] = req.prompt_len
                    self.limit[b] = req.prompt_len + req.max_new - 1
                    self.done[b] = False
        return progress

    def _burst_len(self, active: List[int], still_prefilling: bool):
        """``(n_max, wave)`` of the next burst: short while a prompt is
        prefilling, else up to ``burst_cap`` rounds, cut at the next queue
        event and near the wave-th soonest budget finish."""
        wave = (min(self.admit_wave, len(self._pending))
                if self._pending else 0)
        if still_prefilling:
            return self.prefill_rounds, wave
        n_max = self.burst_cap
        if self._pending:
            till = (min(e.not_before for e in self._pending)
                    - self._round_no)
            if till > 0:
                n_max = max(1, min(n_max, till))
            rem = sorted(int(self.limit[b]) - int(self.pos[b]) + 1
                         for b in active)
            k = min(wave, len(rem)) - 1
            n_max = max(1, min(n_max, rem[k] + 1))
        return n_max, wave

    def _grow_pages(self, active: List[int], n_max: int) -> None:
        """Lazy page growth for the burst; a failed allocation preempts a
        weaker resident, or the row itself when none exists.  A
        speculative round advances up to ``spec_k + 1`` tokens and its
        chunk writes ``spec_k`` slots past the accepted frontier."""
        look = self.spec_k
        for b in list(active):
            if b not in active:
                continue
            tgt = min(int(self.pos[b]) + n_max * (look + 1) - 1 + look,
                      int(self.limit[b]) - 1 + look)
            while not self._ensure_pages(b, tgt):
                vs = self._victims_for(self._eff_resident(b, self._round_no),
                                       self._round_no, exclude=(b,))
                if not vs:
                    self._preempt(b, self._round_no, reason="pages")
                    active.remove(b)
                    break
                self._preempt(vs[0], self._round_no, reason="pages")
                if vs[0] in active:
                    active.remove(vs[0])

    def _burst(self, active: List[int], n_max: int, wave: int) -> int:
        """One decode burst over every slot, with the fault plan's stall
        and poison; returns the progress made."""
        plan, counters = self.fault_plan, self._counters
        poison_rel = ovf_rel = -1
        if plan is not None:
            p = plan.next_poison(self._round_no, self._round_no + int(n_max))
            if p is not None:
                poison_rel = p - self._round_no
            o = plan.next_overflow(self._round_no, self._round_no + int(n_max))
            if o is not None:
                ovf_rel = o - self._round_no
        t_start = time.perf_counter()
        if plan is not None:
            stall = plan.take_slow(self._round_no)
            if stall > 0.0:
                counters["faults_slow"] += 1
                plan.note("slow", round=self._round_no, seconds=stall)
                time.sleep(stall)
        t0 = time.perf_counter()
        caches = caches_with_table(self.caches, self._table_device())
        dev = self._tensor
        cnts = dev(self._cnt) if self._use_pen else None
        esc_kw = ({} if self._esc_fmts is None else
                  dict(esc_fmts=self._esc_fmts, kv_levels=dev(self.kv_levels),
                       ovf_at=ovf_rel,
                       ovf_scale=(plan.overflow_scale if plan is not None
                                  else 1.0)))
        state = (self.params, dev(self.tok), caches, dev(self.pos),
                 dev(self.lens), dev(self.done), dev(self.limit))
        if self.spec_k:
            r = self.model.speculate_burst(
                *state, spec_k=self.spec_k, draft_repeats=self.draft_repeats,
                k_rows=dev(self._spec_rows),
                out_width=self.burst_cap * (self.spec_k + 1), n_max=n_max,
                exit_on_finish=wave, stop_token=self.stop_token,
                poison_at=poison_rel, guard=True,
                draft_policy=self.draft_policy, mesh=self.mesh, **esc_kw)
            spec = r[-1].cpu().numpy()
            counters["spec_rounds"] += int(spec[0])
            counters["spec_emitted"] += int(spec[1])
            r = r[:-1]
        else:
            r = self.model.decode_burst(
                *state, max_len=self.max_len, out_width=self.burst_cap,
                n_max=n_max, exit_on_finish=wave, stop_token=self.stop_token,
                counts=cnts, repetition_penalty=self.repetition_penalty,
                presence_penalty=self.presence_penalty, poison_at=poison_rel,
                guard=True, mesh=self.mesh, **esc_kw, **self._sampling())
        out, n, tok, _, pos, lens, done, _, bad = r[:9]
        bad = bad.cpu().numpy()
        new_tok = tok.cpu().numpy().astype(np.int32)
        new_pos = pos.cpu().numpy().astype(np.int32)
        new_lens = lens.cpu().numpy().astype(np.int32)
        new_done = done.cpu().numpy().astype(bool)
        # a speculative burst packs each row's tokens: download up to the
        # widest row's growth; a plain one writes a column a round
        w = (max(1, int((new_lens - self.lens).max())) if self.spec_k
             else n)
        outs = out[:, :w].cpu().numpy()
        now = time.perf_counter()
        self._clock["decode_s"] += now - t0
        if self.monitor.record(self._bursts, now - t_start):
            counters["stragglers"] += 1
        if bad.sum():
            if plan is not None and plan.mask_poison:
                counters["poisoned_rounds"] += int(bad.max())
                plan.note("poison", round=self._round_no,
                          rows=np.nonzero(bad)[0].tolist())
            else:
                raise PoisonedLogitsError(
                    f"non-finite decode logits at round {self._round_no} "
                    f"(rows {np.nonzero(bad)[0].tolist()}); no masking "
                    f"fault harness is active")
        self.tok, self.pos = new_tok, new_pos
        total_ran = 0
        for b in active:
            # rounds this row ran = its live-length growth
            ran = int(new_lens[b]) - int(self.lens[b])
            emitted = [int(t) for t in outs[b, :ran]]
            self._emitted[b].extend(emitted)
            if self.journal is not None and emitted:
                # the per-burst delta is the crash-consistency quantum: at
                # most one burst of tokens is lost, and regenerated
                self.journal.append("tokens", rid=self._req[b].rid,
                                    replica=self.replica_id, toks=emitted)
            if self._use_pen and emitted:
                v = self._cnt.shape[1]
                np.add.at(self._cnt[b], np.asarray(emitted, np.int64) % v, 1)
            self._occ_accum += ran
            total_ran += ran
        if n > 0 and total_ran == 0:
            raise EngineStuckError(
                f"decode burst executed {n} rounds without advancing any "
                f"of {len(active)} live rows", self._diag())
        if self._esc_fmts is not None:
            self.flag_pressure += r[-1].cpu().numpy().astype(np.int64)
            if plan is not None and 0 <= ovf_rel < n:
                counters["faults_overflow"] = counters.get(
                    "faults_overflow", 0) + 1
                plan.note("overflow", round=self._round_no + ovf_rel,
                          scale=plan.overflow_scale)
        self.lens, self.done = new_lens, new_done
        self._round_no += n
        self._decode_rounds += n
        self._bursts += 1
        progress = n
        for b in active:
            if self.done[b]:
                self._finish(b, self._round_no)
                progress += 1
        return progress

    def step(self) -> bool:
        """ONE scheduler iteration: fault holds -> admission -> prefill
        chunks -> at most one decode burst -> finish and escalation
        accounting -> the watchdog's tick.  Returns ``has_work()``.
        Raises ``ReplicaLostError`` at the burst dispatch when this
        replica's ``replica_fault`` kill is due: after host scheduling,
        before any launch of the burst."""
        if not self.has_work():
            return False
        self._fault_holds()
        progress = self._admission(self._round_no)
        t0 = time.perf_counter()
        progress += self._prefill_waves()
        self._clock["prefill_s"] += time.perf_counter() - t0

        active = [b for b in range(self.slots) if not self.done[b]]
        still_prefilling = any(self._req[b] is not None and self.done[b]
                               for b in range(self.slots))
        n_max = wave = 0
        if active:
            n_max, wave = self._burst_len(active, still_prefilling)
            self._grow_pages(active, n_max)
        if active:
            if (self.replica_fault is not None
                    and self.replica_fault.take_kill(self.replica_id,
                                                     self._bursts)):
                raise ReplicaLostError(
                    f"replica {self.replica_id} lost at burst "
                    f"{self._bursts} (round {self._round_no}): simulated "
                    f"device failure",
                    replica=self.replica_id, burst=self._bursts)
            progress += self._burst(active, n_max, wave)
            if self.escalate is not None:
                self._maybe_escalate(active, self._round_no)
        elif still_prefilling:
            self._round_no += 1    # prefill-only round (no decoders yet)
        elif self._pending:
            # idle: jump to the next event (an arrival, a backoff window
            # expiring, or an exhaustion hold releasing)
            nxt = [e.not_before for e in self._pending]
            if self._held:
                nxt.append(self._release_at)
            self._round_no = max(self._round_no + 1, min(nxt))
        self.watchdog.tick(progress > 0, self._diag)
        return self.has_work()

    def finalize(self):
        """Release fault-plan holds; returns ``(results_by_rid, stats)``."""
        if self._held:              # plan outlived the queue: tidy up
            self.alloc.free(self._held)
            self._held, self._release_at = [], None
        dl = [f for f in self._results.values() if f.deadline is not None]
        misses = sum(1 for f in dl if f.deadline_miss)
        stats = {
            "rounds": self._round_no,
            "decode_rounds": self._decode_rounds,
            "bursts": self._bursts,
            "occupancy": (self._occ_accum
                          / (self.slots * self._decode_rounds)
                          if self._decode_rounds else 0.0),
            # request-KV pages only (the scratch page is bookkeeping)
            "peak_live_pages": self.alloc.peak_live - 1,
            "n_pages": self.n_pages,
            "fixed_equiv_pages": self.slots * self.max_pages,
            "pages_live_end": self.alloc.n_live - 1,
            "deadline_total": len(dl),
            "deadline_misses": misses,
            "deadline_miss_rate": (misses / len(dl)) if dl else 0.0,
            "straggler_ewma_s": self.monitor.ewma,
            **self._counters,
            **self._spec_stats(),
            **self._clock,
        }
        return dict(self._results), stats

    def _spec_stats(self) -> dict:
        """``spec_k`` and ``spec_accept_rate``, emitted tokens over
        live-row rounds times the chunk width: the bonus token keeps every
        live row's yield at one or more a round, so the rate lies in (0, 1]
        once a speculative round ran."""
        if not self.spec_k:
            return {}
        lr = self._counters["spec_rounds"]
        return {"spec_k": self.spec_k,
                "spec_accept_rate": (self._counters["spec_emitted"]
                                     / (lr * (self.spec_k + 1))
                                     if lr else 0.0)}

    def run(self, requests: Sequence[Request]):
        """Serve ``requests`` to completion: ``(finished in input order,
        stats)``."""
        self.start(requests)
        while self.step():
            pass
        res, stats = self.finalize()
        return [res[r.rid] for r in requests], stats


class ReplicatedEngine:
    """A fleet of data-parallel ``ContinuousEngine`` replicas over a
    ``(data, model)`` serving mesh, or, with ``mesh=None, replicas=N``, a
    meshless fleet of ``N`` replicas time-slicing one device, sharing one
    ``params`` (one copy of the weights), each with its own
    ``PageAllocator`` over a disjoint pool and its own block tables.

    On a mesh each data row is ONE engine, tensor parallel over its own
    ``("model",)`` sub-mesh (``replica_meshes``) and run by that row's
    ranks: this process builds and steps its row's engine only, and ``run``
    gathers every row's finished requests, stats and allocator from the
    row's first rank.  Replica faults and the journal run there as on the
    meshless fleet, to the same streams, heartbeats, ``ha_*`` counters and
    journal bytes (``_run_sharded``); global rank 0 writes the journal's
    file (``journal.one_writer``), every rank keeps the records.

    The queue is partitioned on the host, round-robin in ``(arrival,
    rid)`` order.  ``run`` interleaves the replicas one ``step`` at a
    time, which is what makes a replica's loss survivable mid-run:

      * every completed step is a heartbeat; a ``ReplicaFaultPlan`` hang
        stops the victim stepping, and after ``hang_patience`` missed
        beats in a row the host declares it dead with its device memory
        still readable — its residents evacuate as tagged swap blobs
        (``migrate="swap"``) or as emitted-token reingest state;
      * a kill raises ``ReplicaLostError`` at the victim's burst dispatch:
        device memory is gone, so evacuation always re-ingests;
      * evacuated entries are ``adopt``ed round-robin by the survivors;
        if none survives, the loss re-raises for
        ``train.fault.run_with_restarts`` and the request journal.

    Stats merge as in the JAX package: ``pool`` is ``aggregate_stats``
    over the allocators, ``replicas`` each replica's own stats,
    ``heartbeats`` and the ``ha_*`` counters the fleet's fault story,
    occupancy is weighted by decode rounds, and every other integer
    field is summed (the port's host clocks too)."""

    def __init__(self, model, params, *, mesh=None, replicas=None,
                 migrate: str = "swap", hang_patience: int = 3, **kw):
        if migrate not in ("swap", "reingest"):
            raise ValueError(f"migrate must be swap|reingest, "
                             f"got {migrate!r}")
        subs = replica_meshes(mesh, replicas)
        self.mesh = mesh
        self.migrate = migrate
        self.hang_patience = max(1, hang_patience)
        self.replica_fault = kw.pop("replica_fault", None)
        self.journal = one_writer(kw.pop("journal", None), mesh)
        # one engine a data row, this process running its own row's
        self._rows = len(subs) if mesh is not None and len(subs) > 1 else 0
        if self._rows:
            row = mesh.coords["data"]
            self.row = row
            self._tap = (JournalTap(self.journal)
                         if self.journal is not None else None)
            self.engines = [ContinuousEngine(
                model, params, mesh=subs[row], replica_id=row,
                replica_fault=self.replica_fault, journal=self._tap, **kw)]
        else:
            self._tap = None
            self.engines = [ContinuousEngine(
                model, params, mesh=m, replica_id=i,
                replica_fault=self.replica_fault, journal=self.journal,
                **kw) for i, m in enumerate(subs)]
        self._bound: Optional[List[Request]] = None
        self.reset_monitors()

    @property
    def allocators(self):
        return [e.alloc for e in self.engines]

    def reset_monitors(self) -> None:
        """The ``run_with_restarts`` contract, fanned out: every
        replica's watchdog and straggler monitor are rebuilt, and the
        heartbeat view starts fresh (a restarted fleet has no dead
        replica; the fault plan decides whether one dies again)."""
        for e in self.engines:
            e.reset_monitors()
        self.heartbeats = [{"beats": 0, "missed": 0, "status": "live"}
                           for _ in self.engines]
        self._ha = {k: 0 for k in (
            "ha_kills", "ha_hangs", "ha_migrations",
            "ha_migrated_swap", "ha_migrated_reingest")}

    def bind(self, requests: Sequence[Request]) -> "ReplicatedEngine":
        """Keep a queue so ``run()`` needs no argument (the runner
        contract of ``run_with_restarts``).  Returns self."""
        self._bound = list(requests)
        return self

    def partition(self, requests: Sequence[Request]) -> List[List[Request]]:
        """Round-robin split in ``(arrival, rid)`` order: deterministic,
        and each sub-queue keeps the arrival order admission expects."""
        n = getattr(self, "_rows", 0) or len(self.engines)
        parts: List[List[Request]] = [[] for _ in range(n)]
        for i, r in enumerate(sorted(requests,
                                     key=lambda r: (r.arrival, r.rid))):
            parts[i % len(parts)].append(r)
        return parts

    # -- failure handling -------------------------------------------------
    def _survivors(self) -> List[int]:
        return [i for i, h in enumerate(self.heartbeats)
                if h["status"] == "live"]

    # -- the fleet loop ---------------------------------------------------
    def run(self, requests: Optional[Sequence[Request]] = None):
        """Serve ``requests`` (or the ``bind``-ed queue) across the
        replicas, one step of each in turn.  Returns ``(finished in input
        order, stats)``."""
        if requests is None:
            if self._bound is None:
                raise ValueError("run() needs requests (or bind() first)")
            requests = self._bound
        self._ha = {k: 0 for k in self._ha}
        self.heartbeats = [{"beats": 0, "missed": 0, "status": "live"}
                           for _ in range(self._rows or len(self.engines))]
        # what moved, on this process: the swap blobs' bytes and CRC32s by
        # rid, evacuated (victim) and adopted (survivor)
        self._moved = {"evacuate_ms": 0.0, "migrated_bytes": 0,
                       "evacuated": {}, "adopted": {}}
        if self._rows:
            return self._run_sharded(requests)
        for eng, part in zip(self.engines, self.partition(requests)):
            eng.start(part)
        while True:
            stepped = False
            for i in range(len(self.engines)):
                msg = self._turn(i)
                self._count(msg)
                stepped = stepped or "stepped" in msg
                if "lost" in msg:
                    self._settle(i, msg["lost"])
            work = [i for i in self._survivors()
                    if self.engines[i].has_work()]
            if not work:
                break
            if not stepped:     # defensive: nothing can advance
                raise EngineStuckError(
                    "replicated loop made no progress",
                    {"heartbeats": self.heartbeats,
                     "pending": [len(self.engines[i]._pending)
                                 for i in work]})
        results: Dict[int, Finished] = {}
        per = []
        for i, eng in enumerate(self.engines):
            res, st = eng.finalize()
            results.update(res)
            st["replica_status"] = self.heartbeats[i]["status"]
            per.append(st)
        stats = self._fleet_stats(per, self.allocators)
        stats["migration"] = dict(self._moved)
        return [results[r.rid] for r in requests], stats

    def _run_sharded(self, requests: Sequence[Request]):
        """The meshless fleet's loop with each replica in its own row of
        ranks, the rows stepping at the same time.

        A sweep gives every row its turn (a step, a missed beat, or a
        loss), in the meshless loop's order: replica ``i``'s loss is
        adopted before the replicas after it step in that sweep, and by
        those before it after theirs.  Every rank holds the same fault
        plan, so before a sweep every rank knows from the plan which
        replicas can be lost in it (``might_lose``, from a replica's burst
        count and missed beats); the sweep runs as phases that end at each
        of them, the rows of a phase stepping together, and a phase ends
        with one exchange over the data axis (``_sync``): turns taken,
        plan calls, the journal records held, and a loss's evacuated
        entries.  A kill's entries are reingest state, the same host
        objects on every rank of the victim row; a hang's swap blobs are
        each rank's own KV heads, and the data axis carries each to the
        survivor row's rank of the same model coordinate.  Survivors adopt
        by ``alive[j % len(alive)]``; with none, every rank raises
        ``ReplicaLostError`` together, after a barrier (the journal on
        file is then whole).  Every row's results, stats and allocator
        come back from its first rank."""
        eng, me, n = self.engines[0], self.row, self._rows
        if self._tap is not None:
            self._tap.key = (-1, me, 0)
        eng.start(self.partition(requests)[me])
        msgs = self._sync({})
        while True:
            stepped, lo = False, 0
            plan = self.replica_fault
            cands = [i for i in range(n) if plan is not None
                     and self.heartbeats[i]["status"] == "live"
                     and plan.might_lose(i, msgs[i]["bursts"],
                                         self.heartbeats[i]["missed"],
                                         self.hang_patience)]
            for v in cands + [n]:
                hi = min(v, n - 1)
                msgs = self._sync(self._turn(me) if lo <= me <= hi else {})
                stepped = stepped or any(m.get("stepped") for m in msgs)
                for m in msgs:
                    if "lost" in m:
                        if m["row"] != v:
                            raise RuntimeError(
                                f"replica {m['row']} was lost in a phase "
                                f"that ends at {v}: the plan's "
                                f"might_lose missed it")
                        self._settle(m["row"], m["lost"])
                lo = hi + 1
            work = [i for i in self._survivors() if msgs[i]["work"]]
            if not work:
                break
            if not stepped:     # defensive: nothing can advance
                raise EngineStuckError(
                    "replicated loop made no progress",
                    {"heartbeats": self.heartbeats, "pending": work})
        res, st = eng.finalize()
        st["replica_status"] = self.heartbeats[me]["status"]
        mine = (me, self.mesh.coords["model"], res, st, eng.alloc)
        rows = sorted((g for g in spmd.gather_objects(
            mine, self.mesh.everyone) if g[1] == 0), key=lambda g: g[0])
        results: Dict[int, Finished] = {}
        for g in rows:
            results.update(g[2])
        stats = self._fleet_stats([g[3] for g in rows], [g[4] for g in rows])
        stats["migration"] = dict(self._moved)
        return [results[r.rid] for r in requests], stats

    def _local(self, i: int):
        """Replica ``i``'s engine in this process, or None: a sharded
        fleet runs only this rank's row."""
        if not self._rows:
            return self.engines[i]
        return self.engines[0] if i == self.row else None

    def _turn(self, i: int) -> dict:
        """Replica ``i``'s turn of a sweep, as a message (on a mesh, the
        one ``_sync`` carries to every row): a step is a heartbeat; a
        ``ReplicaFaultPlan`` hang stops the victim stepping, a missed beat
        a sweep, and after ``hang_patience`` of them the replica is lost
        with its memory still readable; a kill raises at the victim's
        burst dispatch, its memory gone.  A loss's entries are evacuated
        (``lost``) for ``_settle``."""
        eng, hb, plan = self._local(i), self.heartbeats[i], self.replica_fault
        if hb["status"] == "dead" or not eng.has_work():
            return {}
        if self._tap is not None:
            self._tap.key = (i, 0, 0)
        if plan is not None and plan.hang_due(i, eng._bursts):
            hb["missed"] += 1
            msg = {"stepped": True, "calls": [("hang", i, eng._bursts)],
                   "hangs": int(hb["missed"] == 1)}
            if hb["missed"] >= self.hang_patience:
                msg["lost"] = self._evacuate(i, True, eng._bursts, "hung")
            return msg
        try:
            eng.step()
            hb["beats"] += 1
            return {"stepped": True}
        except ReplicaLostError as err:
            return {"stepped": True, "calls": [("kill", i, err.burst)],
                    "kills": 1,
                    "lost": self._evacuate(i, False, err.burst, "killed")}

    def _evacuate(self, i: int, readable: bool, burst: int,
                  why: str) -> dict:
        """The victim's side of a loss: its entries (on a mesh, this
        rank's swap blobs in them) and the journal's ``replica_lost``."""
        t0 = time.perf_counter()
        eng = self._local(i)
        entries = eng.evacuate(readable=readable, mode=self.migrate)
        if eng.journal is not None:
            eng.journal.append("replica_lost", replica=i, why=why,
                               burst=burst, evacuated=len(entries))
        for e in entries:
            rs = e.resume
            if rs is not None and rs.blobs is not None:
                if self._rows:
                    # the blobs are views of one pinned buffer, and pickle
                    # carries a view's whole buffer: each gets its own
                    rs.blobs = [tuple(x.clone() for x in kv)
                                for kv in rs.blobs]
                self._moved["evacuated"][e.req.rid] = rs.checksums
        return {"why": why, "burst": burst, "entries": entries,
                "ms": (time.perf_counter() - t0) * 1e3}

    def _count(self, msg: dict) -> None:
        self._ha["ha_hangs"] += msg.get("hangs", 0)
        self._ha["ha_kills"] += msg.get("kills", 0)

    def _sync(self, msg: dict) -> List[dict]:
        """One exchange over the data axis: every row's ``msg`` with its
        burst count, whether it has work, its beats and its held journal
        records; merges the records into the journal, mirrors the other
        rows' plan calls on this rank's plan and their beats and ``ha_*``
        counts into the fleet's view.  Returns the messages in row
        order."""
        eng = self.engines[0]
        hb = self.heartbeats[self.row]
        msg = dict(msg, row=self.row, bursts=eng._bursts,
                   work=eng.has_work(), beats=hb["beats"],
                   missed=hb["missed"],
                   held=self._tap.take() if self._tap is not None else [])
        msgs = spmd.gather_objects(msg, self.mesh.group("data"))
        if self.journal is not None:
            merge_journal(self.journal, [m["held"] for m in msgs])
        for m in msgs:
            r = m["row"]
            if r != self.row:
                for kind, i, b in m.get("calls", ()):
                    if kind == "hang":
                        self.replica_fault.hang_due(i, b)
                    else:
                        self.replica_fault.take_kill(i, b)
            self.heartbeats[r].update(beats=m["beats"], missed=m["missed"])
            self._count(m)
        return msgs

    def _settle(self, v: int, lost: dict) -> None:
        """Every process's side of replica ``v``'s loss: the victim is
        dead, the survivors adopt its entries by ``alive[j % len(alive)]``
        (on a mesh, this row its share, each entry's swap blobs this
        rank's model coordinate's), or with none the loss re-raises — on
        a mesh on every rank together, after a barrier — for
        ``train.fault.run_with_restarts``; the journal then holds every
        token emitted so far."""
        entries = lost["entries"]
        self.heartbeats[v]["status"] = "dead"
        self._moved["evacuate_ms"] += lost["ms"]
        alive = self._survivors()
        if not alive:
            if self._rows:
                spmd.barrier(self.mesh.everyone)
            raise ReplicaLostError(
                f"replica {v} {lost['why']} at burst {lost['burst']} and "
                f"no replica survives to adopt its {len(entries)} requests "
                f"— restart and replay the journal",
                replica=v, burst=lost["burst"])
        for j, e in enumerate(entries):
            swap = e.resume is not None and e.resume.blobs is not None
            eng = self._local(alive[j % len(alive)])
            if eng is not None:
                if self._tap is not None:
                    self._tap.key = (v, 1, j)
                eng.adopt([e])
                if swap:
                    self._moved["adopted"][e.req.rid] = e.resume.checksums
            if swap:
                self._moved["migrated_bytes"] += sum(
                    x.numel() * x.element_size()
                    for kv in e.resume.blobs for x in kv)
            self._ha["ha_migrations"] += 1
            self._ha["ha_migrated_swap" if swap
                     else "ha_migrated_reingest"] += 1

    def _fleet_stats(self, per: List[dict], allocs) -> dict:
        """The fleet's stats from each replica's (in row order)."""
        dr = sum(s["decode_rounds"] for s in per)
        stats = {
            "replicas_n": len(per),
            "rounds": max((s["rounds"] for s in per), default=0),
            "decode_rounds": dr,
            "bursts": sum(s["bursts"] for s in per),
            "occupancy": (sum(s["occupancy"] * s["decode_rounds"]
                              for s in per) / dr if dr else 0.0),
            "peak_live_pages": sum(s["peak_live_pages"] for s in per),
            "n_pages": sum(s["n_pages"] for s in per),
            "fixed_equiv_pages": sum(s["fixed_equiv_pages"] for s in per),
            "deadline_total": sum(s["deadline_total"] for s in per),
            "deadline_misses": sum(s["deadline_misses"] for s in per),
            "pool": aggregate_stats(allocs),
            "replicas": per,
            "heartbeats": [dict(h) for h in self.heartbeats],
            **self._ha,
        }
        dl = stats["deadline_total"]
        stats["deadline_miss_rate"] = (stats["deadline_misses"] / dl
                                       if dl else 0.0)
        if any("spec_accept_rate" in s for s in per):
            sr = sum(s.get("spec_rounds", 0) for s in per)
            se = sum(s.get("spec_emitted", 0) for s in per)
            k1 = max(s.get("spec_k", 0) for s in per) + 1
            stats["spec_rounds"], stats["spec_emitted"] = sr, se
            stats["spec_accept_rate"] = se / (sr * k1) if sr else 0.0
        for k in CLOCKS:
            stats[k] = sum(s[k] for s in per)
        for k in per[0] if per else ():
            if k not in stats and isinstance(per[0][k], (int, np.integer)):
                stats[k] = sum(s[k] for s in per)
        return stats
