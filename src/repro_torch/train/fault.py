"""Fault tolerance (the port of the JAX package's ``train/fault.py``):

  * :class:`StragglerMonitor` — per-step (training) or per-burst
    (serving) wall-clock EWMA + deviation flagging,
  * :class:`FailurePlan` — deterministic node-failure injection at chosen
    training steps (:class:`SimulatedFailure`, each raised once),
  * :class:`ServeFaultPlan` — deterministic injection of page-pool
    exhaustion episodes, slow-burst stragglers, NaN-poisoned logits and
    swap-payload bit flips at chosen rounds (one plan + one queue -> one
    trajectory),
  * :class:`ServeWatchdog` — consecutive no-progress detector that turns
    a livelocked scheduler loop into a clean :class:`EngineStuckError`,
  * :class:`PoisonedLogitsError` — non-finite logits reached a sampler
    outside a masking fault harness.

``ServeFaultPlan.overflow_at`` / ``overflow_scale`` scale the K/V writes
of the listed decode rounds before the escalation quantizer, when the
engine runs an ``EscalationPolicy`` (without one they inject nothing, as
in the JAX package); the engine notes each ``overflow`` event.

Replica-level counterparts (the fleet of
``launch/engine.py::ReplicatedEngine``):

  * :class:`ReplicaFaultPlan` — deterministically KILLS a replica at a
    chosen burst (:class:`ReplicaLostError` raised at the burst dispatch:
    device memory unreachable) or HANGS it (the fleet's heartbeat view
    declares it dead after missed beats, device memory still readable),
    and :class:`ReplicaFaultPlans`, several of them as one,
  * :class:`ReplicaLostError` — a :class:`SimulatedFailure`, so a loss
    with no surviving replica propagates into :func:`run_with_restarts`,
    whose ``attempt_log`` names the replica behind each attempt,
  * :func:`run_with_restarts` — the supervisor: run, and on a
    :class:`SimulatedFailure` rebuild and run again, bounded.

Plain Python: no torch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


class StragglerMonitor:
    """EWMA of step wall-clock; flags steps slower than ``threshold`` x the
    running mean (after a warmup)."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.n = 0
        self.flagged: list = []

    def record(self, step: int, dt: float) -> bool:
        self.n += 1
        straggler = False
        if self.ewma is None:
            self.ewma = dt
        else:
            if self.n > self.warmup and dt > self.threshold * self.ewma:
                straggler = True
                self.flagged.append((step, dt, self.ewma))
            # EWMA update excludes flagged outliers (keeps baseline honest)
            if not straggler:
                self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return straggler


class SimulatedFailure(RuntimeError):
    """Injected node failure."""


@dataclasses.dataclass
class FailurePlan:
    """Deterministic fault injection: raise at the listed step indices
    (global step count, each raised once)."""
    fail_at: tuple = ()
    raised: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.raised:
            self.raised.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


class ReplicaLostError(SimulatedFailure):
    """A serving replica died (simulated device loss).  Raised through
    the victim's burst dispatch by a :class:`ReplicaFaultPlan` kill, or
    by the replicated host loop when a hung replica exhausts its
    heartbeat patience — and re-raised by ``ReplicatedEngine`` when NO
    replica survives to absorb the victim's requests (at which point
    recovery is a full restart: :func:`run_with_restarts` + the request
    journal).  ``replica`` / ``burst`` locate the failure."""

    def __init__(self, msg: str, *, replica: int, burst: int = -1):
        super().__init__(msg)
        self.replica = replica
        self.burst = burst


@dataclasses.dataclass
class ReplicaFaultPlan:
    """Deterministic replica-level failure injection for the data-parallel
    serving fleet, keyed to the VICTIM's burst counter (each replica's
    burst sequence is deterministic for a given queue partition, so one
    plan + one queue replays to the identical failure point).

    ``replica`` picks the victim, ``at_burst`` the burst index (0-based:
    the fault fires when the victim is ABOUT to dispatch that burst).
    ``mode="kill"`` raises :class:`ReplicaLostError` through the burst
    dispatch — the device is gone, its pool pages are UNREACHABLE, so
    in-flight rows can only migrate by free-and-reingest (recompute).
    ``mode="hang"`` makes the replica unresponsive from that burst on:
    the host loop's heartbeat view counts missed beats and declares the
    replica dead after its patience — device memory is still READABLE,
    so live pages can migrate as swap-out payloads (no recompute).

    A kill fires ONCE per plan (a restarted fleet does not re-die unless
    :meth:`reset` is called — that is what lets ``run_with_restarts``
    recover); a hang is sticky for the plan's lifetime.  ``events`` logs
    what actually fired, like :class:`ServeFaultPlan`."""
    replica: int = 0
    at_burst: int = 1
    mode: str = "kill"

    def __post_init__(self):
        if self.mode not in ("kill", "hang"):
            raise ValueError(f"mode must be kill|hang, got {self.mode!r}")
        self.reset()

    def reset(self) -> None:
        self._killed = False
        self._hung = False
        self.events: list = []

    def note(self, kind: str, **kw) -> None:
        self.events.append((kind, kw))

    def take_kill(self, replica: int, burst: int) -> bool:
        """True exactly once: the victim replica reaching (or jumping
        past) the planned burst in kill mode."""
        if (self.mode != "kill" or self._killed
                or replica != self.replica or burst < self.at_burst):
            return False
        self._killed = True
        self.note("kill", replica=replica, burst=burst)
        return True

    def hang_due(self, replica: int, burst: int) -> bool:
        """True (sticky) once the victim reaches the planned burst in
        hang mode — the replica stops responding from here on."""
        if self.mode != "hang" or replica != self.replica:
            return False
        if not self._hung:
            if burst < self.at_burst:
                return False
            self._hung = True
            self.note("hang", replica=replica, burst=burst)
        return True

    def might_lose(self, replica: int, burst: int, missed: int,
                   patience: int) -> bool:
        """Whether ``replica`` (at ``burst``, ``missed`` beats behind)
        can be lost at its next turn of the fleet loop: a kill still due
        at its next dispatch, or a hang whose next missed beat exhausts
        ``patience``.  Changes nothing (a sharded fleet asks it of every
        replica before a sweep)."""
        if replica != self.replica:
            return False
        if self.mode == "kill":
            return not self._killed and burst >= self.at_burst
        return ((self._hung or burst >= self.at_burst)
                and missed + 1 >= patience)


class ReplicaFaultPlans:
    """Several :class:`ReplicaFaultPlan` as one (a fleet that loses more
    than one replica, each plan its own victim): every call asks each
    plan in turn; ``events`` lists theirs in plan order."""

    def __init__(self, plans):
        self.plans = list(plans)

    def reset(self) -> None:
        for p in self.plans:
            p.reset()

    @property
    def events(self) -> list:
        return [e for p in self.plans for e in p.events]

    def take_kill(self, replica: int, burst: int) -> bool:
        return any([p.take_kill(replica, burst) for p in self.plans])

    def hang_due(self, replica: int, burst: int) -> bool:
        return any([p.hang_due(replica, burst) for p in self.plans])

    def might_lose(self, replica: int, burst: int, missed: int,
                   patience: int) -> bool:
        return any(p.might_lose(replica, burst, missed, patience)
                   for p in self.plans)


class PoisonedLogitsError(RuntimeError):
    """Non-finite logits reached a sampling site with no fault harness
    masking them — the serving loop fails fast instead of silently
    emitting argmax-of-garbage token 0."""


class EngineStuckError(RuntimeError):
    """The serving watchdog tripped: the scheduler kept iterating without
    admitting, prefilling, decoding or finishing anything.  ``diag``
    carries the engine's slot/queue/pool snapshot at abort time."""

    def __init__(self, msg: str, diag: Optional[dict] = None):
        super().__init__(msg)
        self.diag = diag or {}


@dataclasses.dataclass
class ServeFaultPlan:
    """Deterministic serving-path fault injection, keyed to the engine's
    decode-round clock (the logical time admission/preemption already run
    on, so a plan + a queue replays to the same trajectory bit for bit).

    ``exhaust_at``: rounds at which the engine grabs the allocator's
    entire free list and holds it for ``exhaust_for`` rounds — admission
    and lazy page growth must survive ``try_alloc`` returning ``None``.
    ``slow_at``: rounds before whose burst the engine sleeps ``slow_s``
    seconds — a slow-burst straggler the :class:`StragglerMonitor` must
    flag.  ``poison_at``: decode rounds whose logits are overwritten with
    NaN inside the decode burst; ``mask_poison=True`` lets the guard
    mask-and-count them, ``False`` makes the engine raise
    :class:`PoisonedLogitsError` (fail-fast mode).

    Numerical-health injections: ``overflow_at`` lists decode
    rounds whose K/V writes are scaled by ``overflow_scale`` before
    write-time quantization — values that overflow the narrow KV rung and
    drive the escalation path (the write-side twin of ``poison_at``).
    ``corrupt_swap_at`` lists swap-out EVENTS (0-based, in the order the
    engine swaps victims out) whose host page payloads get one
    deterministic bit flipped — a silent-data-corruption the checksum
    verification at swap-in must catch and recover from via reingest.

    The plan is reusable: the engine calls :meth:`reset` at run start, so
    replaying the same plan object is deterministic.  ``events`` logs
    every injection actually fired (round, kind, payload)."""
    exhaust_at: tuple = ()
    exhaust_for: int = 4
    slow_at: tuple = ()
    slow_s: float = 0.05
    poison_at: tuple = ()
    mask_poison: bool = True
    overflow_at: tuple = ()
    overflow_scale: float = 65536.0
    corrupt_swap_at: tuple = ()

    def __post_init__(self):
        self.reset()

    def reset(self) -> None:
        self._fired_exhaust: set = set()
        self._fired_slow: set = set()
        self._swap_seen: int = 0
        self.events: list = []

    def note(self, kind: str, **kw) -> None:
        self.events.append((kind, kw))

    def take_exhaustion(self, round_no: int) -> Optional[int]:
        """Duration of an exhaustion episode starting by ``round_no``
        (each listed round fires once; catch-up included — the engine's
        round clock can jump over idle stretches), else None."""
        due = [r for r in self.exhaust_at
               if r <= round_no and r not in self._fired_exhaust]
        if not due:
            return None
        self._fired_exhaust.update(due)
        return self.exhaust_for

    def take_slow(self, round_no: int) -> float:
        """Seconds of straggler stall due at ``round_no`` (0.0 if none)."""
        due = [r for r in self.slow_at
               if r <= round_no and r not in self._fired_slow]
        self._fired_slow.update(due)
        return self.slow_s * len(due)

    def next_poison(self, lo: int, hi: int) -> Optional[int]:
        """First poisoned round in ``[lo, hi)`` — the engine converts it
        to a burst-relative index.  Stateless: the round window advances
        monotonically, and a burst that exits before reaching the round
        re-schedules it in the next window."""
        hits = [r for r in self.poison_at if lo <= r < hi]
        return min(hits) if hits else None

    def next_overflow(self, lo: int, hi: int) -> Optional[int]:
        """First overflow-injection round in ``[lo, hi)`` (stateless
        window scan, same contract as :meth:`next_poison`)."""
        hits = [r for r in self.overflow_at if lo <= r < hi]
        return min(hits) if hits else None

    def take_corrupt(self) -> bool:
        """True when the CURRENT swap-out event (0-based, counted per
        call) is listed in ``corrupt_swap_at`` — the engine flips one bit
        in that victim's host payload.  Stateful: each call consumes one
        swap-event index, so the plan replays exactly."""
        idx = self._swap_seen
        self._swap_seen += 1
        return idx in self.corrupt_swap_at


class ServeWatchdog:
    """Turns scheduler livelock into a clean abort: ``tick(False)`` for
    ``patience`` consecutive loop iterations (no admission, no prefill
    progress, no decode rounds, no finishes) raises
    :class:`EngineStuckError` with the caller's diagnostics snapshot.
    Any real progress resets the counter — waiting out backoff windows or
    a bounded exhaustion episode is fine; waiting forever is not."""

    def __init__(self, patience: int = 200):
        assert patience >= 1
        self.patience = patience
        self.stalled = 0

    def tick(self, progressed: bool, diag=None) -> None:
        if progressed:
            self.stalled = 0
            return
        self.stalled += 1
        if self.stalled >= self.patience:
            d = diag() if callable(diag) else (diag or {})
            raise EngineStuckError(
                f"serving loop made no progress for {self.stalled} "
                f"consecutive iterations: {d}", d)


def run_with_restarts(make_runner: Callable[[], "object"],
                      max_restarts: int = 3):
    """Supervisor: build a runner (which restores from the latest
    checkpoint), run it; on failure rebuild and continue.  Returns the
    final runner and the number of restarts consumed.

    A restarted attempt must not inherit the previous attempt's health
    baselines: a pre-crash straggler EWMA would mis-flag the restart's
    warm-up steps, and stale watchdog stall counts would trip spuriously.
    ``make_runner`` usually builds a fresh runner, but factories that
    (re)use a long-lived runner object are common in restore-from-latest
    setups — so the supervisor explicitly calls the runner's
    ``reset_monitors()`` (when it has one) before every attempt.  For a
    ``ReplicatedEngine`` that call fans out to every replica's watchdog
    and straggler monitor.

    Each failed attempt is recorded in ``attempt_log`` — a list of
    ``(attempt_index, error_type_name, replica_or_None, message)``
    tuples attached to the error that is finally re-raised when the
    restart budget is exhausted, so the diagnostics name which replica
    triggered each restart (``ReplicaLostError.replica``; ``None`` for
    non-replica failures)."""
    restarts = 0
    attempt_log: list = []
    while True:
        runner = make_runner()
        reset = getattr(runner, "reset_monitors", None)
        if callable(reset):
            reset()
        try:
            runner.run()
            return runner, restarts
        except SimulatedFailure as err:
            attempt_log.append((restarts, type(err).__name__,
                                getattr(err, "replica", None), str(err)))
            restarts += 1
            if restarts > max_restarts:
                err.attempt_log = attempt_log
                raise
