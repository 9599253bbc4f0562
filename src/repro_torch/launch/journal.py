"""Crash-consistent request journal for the serving engine (the port of
the JAX package's ``repro.launch.journal``, byte for byte: the same
records give the same file, and each side ``load``s the other's).

The continuous-batching engine is a pure function of its request queue —
same queue, same tokens — but that determinism only helps RECOVERY if
someone remembers how far each request got before the crash.  This module
is that memory: a host-side, append-only journal of scheduler FACTS
(admissions, per-burst emitted-token deltas, preempt/swap/escalation/
migration events, completions) that a restarted engine replays to resume
every unfinished request from its last journaled token.

  * **Append-only, facts only.**  A record is written AFTER the work it
    describes completed on the host (a burst's tokens are journaled once
    the burst returned, an admission once the slot is installed), so
    replay never has to undo anything.
  * **Atomic-enough appends.**  File-backed journals write one JSON line
    per record (``separators=(",", ":")``) and flush+fsync before
    ``append`` returns.  A crash can tear at most the line being written;
    :meth:`RequestJournal.load` discards a torn tail and everything before
    it is intact.
  * **Replay = re-ingest.**  ``emitted(rid)`` reconstructs each request's
    journaled token stream; a recovering engine resumes it through the
    free-and-reingest path (prompt + emitted[:-1] re-prefilled, the last
    journaled token re-fed).  A request whose ``finish`` record made it
    to the journal is answered from the record.

The journal does not checkpoint device state: K/V pages are derived data,
recomputed from tokens.  An engine on a mesh has ONE writer: every rank
keeps the records, and only global rank 0 keeps the file (``one_writer``).
A fleet sharded over processes appends through a ``JournalTap`` a row and
merges every row's records in the meshless fleet's order at each of its
exchanges, which are then its durability points.  Plain Python: no torch.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional


class RequestJournal:
    """Append-only journal of serving events, optionally file-backed.

    ``path=None`` keeps the journal in memory (tests, single-process
    recovery: the object outlives the engine).  With a path, every
    record is appended as one JSON line and fsync'd, so the journal
    survives a process crash; :meth:`load` recovers it, discarding a
    torn tail line.

    Record shape: ``{"kind": <str>, ...payload}``.  Kinds written by the
    engine: ``admit``, ``tokens`` (the per-burst emitted delta),
    ``preempt``, ``migrate``, ``escalate``, ``finish``, ``replay``.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[dict] = []
        self._fh = open(path, "a", encoding="utf-8") if path else None

    # -- write side -------------------------------------------------------
    def append(self, kind: str, **payload) -> None:
        rec = {"kind": kind, **payload}
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- recovery side ----------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "RequestJournal":
        """Recover a file-backed journal.  A torn tail (crash mid-append:
        the last line fails to parse, or parses but its newline never
        landed) is dropped AND truncated from the file — otherwise the
        recovery run's first append would concatenate onto the
        half-written line and corrupt the journal for the NEXT recovery.
        A torn line anywhere else means the file was damaged by something
        other than an append crash and is a hard error."""
        j = cls.__new__(cls)
        j.path = path
        j.records = []
        j._fh = None
        with open(path, "rb") as f:
            data = f.read()
        off, n = 0, len(data)
        while off < n:
            nl = data.find(b"\n", off)
            end = n if nl < 0 else nl
            line = data[off:end]
            if line.strip():
                try:
                    rec = json.loads(line.decode("utf-8"))
                except ValueError:
                    if nl >= 0 and data[end + 1:].strip():
                        raise ValueError(
                            f"journal {path} corrupt at byte {off} (not "
                            f"the tail): {line[:80]!r}")
                    break               # torn tail: the crash-torn append
                if nl < 0:
                    break   # whole record, torn newline: same lost quantum
                j.records.append(rec)
            if nl < 0:
                off = n
                break
            off = nl + 1
        if off < n:
            with open(path, "r+b") as f:    # drop the torn tail from the
                f.truncate(off)             # file, not just from memory
        j._fh = open(path, "a", encoding="utf-8")
        return j

    # -- digests ----------------------------------------------------------
    def emitted(self, rid: int) -> List[int]:
        """The request's journaled token stream so far: every ``tokens``
        delta in append order.  This is the replay frontier — a recovery
        run resumes generation immediately after these tokens."""
        out: List[int] = []
        for r in self.records:
            if r["kind"] == "tokens" and r["rid"] == rid:
                out.extend(r["toks"])
        return out

    def finish_record(self, rid: int) -> Optional[dict]:
        """The ``finish`` record, if the request completed before the
        crash (its tokens need no re-serving at all)."""
        for r in self.records:
            if r["kind"] == "finish" and r["rid"] == rid:
                return r
        return None

    def unfinished(self, rids) -> List[int]:
        done = {r["rid"] for r in self.records if r["kind"] == "finish"}
        return [rid for rid in rids if rid not in done]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r["kind"]] = out.get(r["kind"], 0) + 1
        return out


def one_writer(journal: Optional[RequestJournal], mesh):
    """``journal`` as a rank of ``mesh`` keeps it.  Every rank of a mesh
    runs the same scheduler and appends the same records: each keeps them
    (a restart replays them on every rank), and only global rank 0 keeps
    the file, so the file holds each record once."""
    if journal is not None and mesh is not None and mesh.rank != 0:
        journal.close()
    return journal


class JournalTap:
    """One row's view of the journal of a fleet sharded over processes
    (``ReplicatedEngine`` on a mesh with more than one data row).  Reads
    (``records``, ``emitted``, ``finish_record``, ...) go to the fleet's
    ``journal``; appends are held, each with the sort ``key`` the fleet
    set for the turn it belongs to in the meshless fleet's order, until
    the fleet ``take``s every row's and appends them, merged, to the
    journal (``merge``)."""

    def __init__(self, journal: RequestJournal):
        self.journal = journal
        self.key: tuple = ()
        self.held: list = []

    def append(self, kind: str, **payload) -> None:
        self.held.append((self.key, len(self.held),
                          {"kind": kind, **payload}))

    def take(self) -> list:
        out, self.held = self.held, []
        return out

    def __getattr__(self, name):
        return getattr(self.journal, name)


def merge(journal: RequestJournal, rows: List[list]) -> None:
    """Append the held records of every row (``JournalTap.take``, in row
    order) to ``journal`` sorted by ``(key, row, order held)``."""
    recs = sorted(((key, row, i), rec) for row, held in enumerate(rows)
                  for key, i, rec in held)
    for _, rec in recs:
        payload = dict(rec)
        journal.append(payload.pop("kind"), **payload)
