"""Continuous-batching serving engine: admission, chunked prefill, decode
bursts and page recycling (the base path of the JAX package's
``repro.launch.engine``).

  * **Admission** — host-side, over a request queue in (priority, arrival,
    rid) order with head-of-line semantics: an entry that does not
    fit waits, and admission goes on with the entries behind it.  A
    finished row's pages go back to the ``PageAllocator`` the round it
    finishes and its slot is refilled from the queue mid-generation.
  * **Chunked prefill** — an admitted prompt is consumed in fixed-width
    chunks through the paged flash read path (``Model.prefill_chunk``), one
    chunk per round, same-offset slots batched into one call, interleaved
    with short decode bursts so ongoing streams are not stalled.
  * **Page accounting** — prompt pages at admission, one page per row as
    its length crosses a page boundary; admission reserves each request's
    worst case (``num_pages(prompt + budget)``) against the pool, so
    ``peak_live`` tracks the sum of live lengths.

Dead-slot discipline: idle slots are parked at ``max_len - 1`` on a
reserved scratch page; every other garbage write lands on a slot that a
real write overwrites before any mask lets it be read.

Greedy only.  Not ported yet, and refused when asked for: sampling,
penalties, deadlines, preemption / swap / degradation, shedding with
backoff, fault injection and the watchdog, precision escalation,
speculative decoding, replicas and the request journal.  Without
preemption a higher-priority request only jumps the queue; it never
evicts a resident row.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.paged import PageAllocator, num_pages
from ..models.transformer import caches_with_table


@dataclasses.dataclass(frozen=True)
class Request:
    """One queued generation request (``arrival`` in decode rounds)."""
    rid: int
    tokens: Sequence[int]          # prompt token ids (>= 1)
    max_new: int                   # generation budget incl. the first token
    arrival: int = 0
    priority: int = 0

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass
class Finished:
    """A served request: ``tokens`` holds the generated ids (first token
    included; a ``stop_token`` hit keeps the stop as the last element)."""
    rid: int
    prompt_len: int
    tokens: List[int]
    admit_round: int
    finish_round: int
    slot: int


def synthetic_trace(n_req: int, slots: int, prompt_len: int, gen: int,
                    vocab: int, seed: int = 2,
                    flavor: str = "chat") -> List[Request]:
    """The JAX package's deterministic ``chat`` workload: every 8th
    request in the first 3/4 of the queue is LONG (budget ``gen``), the
    rest cycle ``gen/16``, ``gen/8``, ``gen/4``; prompt lengths cycle 1/4
    .. 4/4 of ``prompt_len``; the first ``slots`` requests arrive at round
    0, then clumps of four every ``gen/16`` rounds."""
    if flavor != "chat":
        raise NotImplementedError(f"trace flavor {flavor!r} is not ported")
    rng = np.random.RandomState(seed)
    fr_len = (0.25, 0.5, 0.75, 1.0)
    shorts = (gen // 16, gen // 8, gen // 4)
    reqs = []
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


class ContinuousEngine:
    """Continuous-batching scheduler over ``slots`` paged batch rows on
    the model's device.  The model must be paged (``cfg.paged_kv``).
    Requests must satisfy ``prompt_len + max_new <= max_len``.  The page
    pools are updated in place across bursts."""

    def __init__(self, model, params, *, slots: int, max_len: int,
                 chunk: int = 32, n_pages: Optional[int] = None,
                 stop_token: Optional[int] = None, burst_cap: int = 64,
                 prefill_rounds: int = 2, admit_wave: int = 2,
                 shed: bool = False, temperature: float = 0.0, **unported):
        cfg = model.cfg
        if not cfg.paged_kv:
            raise ValueError("ContinuousEngine requires cfg.paged_kv "
                             "(admission allocates pages, not batch rows)")
        if shed or temperature > 0.0 or any(
                v not in (None, False, 0, 0.0) for v in unported.values()):
            raise NotImplementedError(
                "only the base engine path is ported (greedy, shed=False); "
                f"not ported: shed={shed}, temperature={temperature}, "
                f"{sorted(k for k, v in unported.items() if v)}")
        assert slots >= 1 and chunk >= 1 and burst_cap >= 1
        self.model, self.params, self.device = model, params, model.device
        self.slots, self.max_len, self.chunk = slots, max_len, chunk
        self.page = cfg.page_size
        self.max_pages = num_pages(max_len, self.page)
        self.n_pages = (slots * self.max_pages + 1 if n_pages is None
                        else n_pages)
        self.stop_token = stop_token
        self.burst_cap = burst_cap
        self.prefill_rounds = prefill_rounds
        self.admit_wave = max(1, admit_wave)

        self.alloc = PageAllocator(self.n_pages)
        self.scratch = self.alloc.alloc(1)[0]      # dead-write sink, forever
        self._table = np.full((slots, self.max_pages), self.scratch,
                              np.int32)
        self._table_dev = None
        self.caches = model.init_caches(slots, max_len,
                                        page_table=self._table,
                                        n_pages=self.n_pages)
        self.pos = np.full((slots,), max_len - 1, np.int32)
        self.lens = np.zeros((slots,), np.int32)
        self.done = np.ones((slots,), bool)
        self.limit = np.zeros((slots,), np.int32)
        self.tok = np.zeros((slots, 1), np.int32)
        self._req: List[Optional[Request]] = [None] * slots
        self._owned: List[List[int]] = [[] for _ in range(slots)]
        self._prog = np.zeros((slots,), np.int32)   # prefill progress
        self._emitted: List[List[int]] = [[] for _ in range(slots)]
        self._admit_round = np.zeros((slots,), np.int32)
        self._pending: List[Request] = []
        self._results: Dict[int, Finished] = {}
        self._round_no = self._decode_rounds = 0
        self._occ_accum = self._bursts = 0
        self._prefill_s = self._decode_s = 0.0

    # -- helpers ----------------------------------------------------------
    def _reserved_pages(self) -> int:
        """Worst-case pages of every admitted-but-unfinished request."""
        return sum(num_pages(r.prompt_len + r.max_new, self.page)
                   for r in self._req if r is not None)

    def _ensure_pages(self, b: int, last_idx: int) -> None:
        """Lazily allocate slot ``b``'s pages covering token slots up to
        ``last_idx`` (the reservation at admission guarantees they exist)."""
        want = min(last_idx, self.max_len - 1) // self.page + 1
        while len(self._owned[b]) < want:
            got = self.alloc.alloc(1)[0]
            self._table[b, len(self._owned[b])] = got
            self._owned[b].append(got)
            self._table_dev = None

    def _table_device(self):
        """Device copy of the block table, re-uploaded only after the host
        table changed (admission, lazy page allocs, recycling)."""
        if self._table_dev is None:
            self._table_dev = torch.as_tensor(self._table, device=self.device)
        return self._table_dev

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    # -- admission --------------------------------------------------------
    def _admission(self, round_no: int) -> int:
        admitted = 0
        vis = [r for r in self._pending if r.arrival <= round_no]
        vis.sort(key=lambda r: (-r.priority, r.arrival, r.rid))
        for req in vis:
            worst = num_pages(req.prompt_len + req.max_new, self.page)
            need = num_pages(req.prompt_len, self.page)
            free_slots = [b for b in range(self.slots) if self._req[b] is None]
            if not (free_slots
                    and self._reserved_pages() + worst <= self.n_pages - 1
                    and self.alloc.n_free >= need):
                continue
            b = free_slots[0]
            pages = self.alloc.alloc(need)
            self._pending.remove(req)
            self._table[b, :len(pages)] = pages
            self._table_dev = None
            self._owned[b] = pages
            self._req[b] = req
            self._admit_round[b] = round_no
            self._prog[b] = 0
            self._emitted[b] = []
            admitted += 1
        return admitted

    # -- finish -----------------------------------------------------------
    def _finish(self, b: int, round_no: int) -> None:
        """Page recycling: the slot's pages go back to the allocator the
        round its request finishes; the table row falls back to scratch."""
        req = self._req[b]
        self._results[req.rid] = Finished(
            rid=req.rid, prompt_len=req.prompt_len,
            tokens=list(self._emitted[b]),
            admit_round=int(self._admit_round[b]), finish_round=round_no,
            slot=b)
        self.alloc.free(self._owned[b])
        self._owned[b] = []
        self._table[b, :] = self.scratch
        self._table_dev = None
        self._req[b] = None
        self._emitted[b] = []
        self.pos[b], self.lens[b] = self.max_len - 1, 0
        self.done[b], self.limit[b] = True, 0

    # -- the serving state machine ----------------------------------------
    def start(self, requests: Sequence[Request]) -> None:
        for r in requests:
            if r.prompt_len < 1 or r.max_new < 1:
                raise ValueError(f"request {r.rid}: empty prompt or budget")
            if r.prompt_len + r.max_new > self.max_len:
                raise ValueError(
                    f"request {r.rid}: prompt {r.prompt_len} + budget "
                    f"{r.max_new} exceeds max_len {self.max_len}")
            worst = num_pages(r.prompt_len + r.max_new, self.page)
            if worst > self.n_pages - 1:
                raise ValueError(
                    f"request {r.rid} can never fit the pool: needs "
                    f"{worst} pages, pool has {self.n_pages - 1} "
                    f"(+1 scratch)")
        self._results = {}
        self.alloc.reset_peak()
        self._round_no = self._decode_rounds = 0
        self._occ_accum = self._bursts = 0
        self._prefill_s = self._decode_s = 0.0
        self._pending = sorted(requests, key=lambda r: (r.arrival, r.rid))

    def has_work(self) -> bool:
        return bool(self._pending or any(r is not None for r in self._req))

    def _prefill_waves(self) -> None:
        """One prefill chunk per admitting slot, same-offset slots batched
        into one call; a row whose last chunk ran emits its first token."""
        model, params = self.model, self.params
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
                piece = list(self._req[b].tokens)[off:off + self.chunk]
                buf[i, :len(piece)] = piece
                lens[i] = len(piece)
            caches = caches_with_table(self.caches, self._table_device())
            lg, _ = model.prefill_chunk(
                params, self._tensor(buf), caches, q_offset=off,
                row=self._tensor(rows), chunk_lens=self._tensor(lens))
            tok0 = torch.argmax(lg[:, -1], dim=-1).cpu().numpy()
            for i, b in enumerate(rows):
                req = self._req[b]
                self._prog[b] += int(lens[i])
                if int(self._prog[b]) != req.prompt_len:
                    continue
                t0 = int(tok0[i])
                self._emitted[b] = [t0]
                hit_stop = (self.stop_token is not None
                            and t0 == self.stop_token)
                if hit_stop or req.max_new == 1:
                    self._finish(b, self._round_no)
                else:
                    self.tok[b, 0] = t0
                    self.pos[b] = self.lens[b] = req.prompt_len
                    self.limit[b] = req.prompt_len + req.max_new - 1
                    self.done[b] = False

    def step(self) -> bool:
        """ONE scheduler iteration: admission -> prefill chunks -> at most
        one decode burst -> finish accounting.  Returns ``has_work()``."""
        if not self.has_work():
            return False
        self._admission(self._round_no)
        t0 = time.perf_counter()
        self._prefill_waves()
        self._prefill_s += time.perf_counter() - t0

        active = [b for b in range(self.slots) if not self.done[b]]
        still_prefilling = any(self._req[b] is not None and self.done[b]
                               for b in range(self.slots))
        if active:
            wave = (min(self.admit_wave, len(self._pending))
                    if self._pending else 0)
            if still_prefilling:
                n_max = self.prefill_rounds
            else:
                n_max = self.burst_cap
                if self._pending:
                    till = (min(r.arrival for r in self._pending)
                            - self._round_no)
                    if till > 0:
                        n_max = max(1, min(n_max, till))
                    rem = sorted(int(self.limit[b]) - int(self.pos[b]) + 1
                                 for b in active)
                    k = min(wave, len(rem)) - 1
                    n_max = max(1, min(n_max, rem[k] + 1))
            for b in active:
                self._ensure_pages(b, min(int(self.pos[b]) + n_max - 1,
                                          int(self.limit[b]) - 1))
            t0 = time.perf_counter()
            caches = caches_with_table(self.caches, self._table_device())
            dev = lambda a: self._tensor(a)
            out, n, tok, _, pos, lens, done = self.model.decode_burst(
                self.params, dev(self.tok), caches, dev(self.pos),
                dev(self.lens), dev(self.done), dev(self.limit),
                max_len=self.max_len, out_width=self.burst_cap, n_max=n_max,
                exit_on_finish=wave, stop_token=self.stop_token)
            outs = out[:, :n].cpu().numpy()
            self.tok = tok.cpu().numpy().astype(np.int32)
            self.pos = pos.cpu().numpy().astype(np.int32)
            new_lens = lens.cpu().numpy().astype(np.int32)
            for b in active:
                ran = int(new_lens[b]) - int(self.lens[b])
                self._emitted[b].extend(int(t) for t in outs[b, :ran])
                self._occ_accum += ran
            self.lens = new_lens
            self.done = done.cpu().numpy().astype(bool)
            self._decode_s += time.perf_counter() - t0
            self._round_no += n
            self._decode_rounds += n
            self._bursts += 1
            for b in active:
                if self.done[b]:
                    self._finish(b, self._round_no)
        elif still_prefilling:
            self._round_no += 1    # prefill-only round (no decoders yet)
        elif self._pending:
            # idle: jump to the next arrival
            self._round_no = max(self._round_no + 1,
                                 min(r.arrival for r in self._pending))
        return self.has_work()

    def finalize(self):
        """Returns ``(results_by_rid, stats)``."""
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
            # host clock around prefill waves / decode bursts; each ends in
            # a device-to-host copy of its result, so the device work is in
            "prefill_s": self._prefill_s,
            "decode_s": self._decode_s,
        }
        return dict(self._results), stats

    def run(self, requests: Sequence[Request]):
        """Serve ``requests`` to completion: ``(finished in input order,
        stats)``."""
        self.start(requests)
        while self.step():
            pass
        res, stats = self.finalize()
        return [res[r.rid] for r in requests], stats
