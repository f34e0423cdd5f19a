"""Continuous-batching serve loop: the control plane for Lasso-path
serving, the reference's ``src/repro/launch/serve_loop.py`` over the
port's sessions. Pure Python: the only device work is the executor's
``session.path(Y)`` call.

  admission   a bounded queue over an arrival source; when it is full the
              loop stops pulling (backpressure: arrivals wait upstream,
              per-ticket ``t_admit > t_arrive`` counts the stalls);
  formation   dispatch the oldest ``min(b_max, queued)`` queries when the
              fill target ``b_max`` is reached ("fill"), when the oldest
              admitted query has waited ``deadline_s`` ("deadline"), or
              when the source is exhausted and waiting can only add
              latency ("drain");
  padding     live batches are padded up to the next power of two
              (repeating the last query; padded lanes are dropped), so the
              set of batch shapes stays O(log B), and a batch that
              degenerates to ONE live query dispatches unpadded, which the
              session routes through its single-query driver;
  pipelining  dispatch is decoupled from completion: up to
              ``max_in_flight`` batches ride concurrently, the loop polls
              handles instead of blocking, retires them in COMPLETION
              order (out-of-order is fine), and the padded query buffer is
              released at dispatch, once the executor has handed it to the
              device;
  isolation   a batch whose dispatch fails (a NaN query makes a NaN λ
              grid, which the path driver refuses) is split and re-served
              one query at a time ("isolate" dispatches), so one bad query
              is reported on its own ticket instead of taking down its
              neighbours or the loop;
  accounting  every ticket records admission → completion latency; the
              report carries p50/p99 (:func:`percentile`), queries/sec,
              batch-fill and dispatch-reason telemetry, and merges into a
              bench JSON file (:func:`merge_bench_section`).

Everything time-shaped is injectable: the loop takes a ``clock`` (a
:class:`VirtualClock` advances only when the loop decides to wait: no
sleeps in the tests), an arrival source (:class:`ScriptedArrivals` replays
an exact (t, y) script; the real driver wraps
:class:`repro_torch.data.QueryStream`), and an executor
(:class:`SessionExecutor` runs ``session.path``; :class:`DelayedExecutor`
scripts service times so pipelining, deadlines and out-of-order
completion are exercised deterministically). Replays of the same (seed,
step, shard) stream produce identical per-query results AND an identical
:class:`DispatchRecord` trace.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import time

import numpy as np

from ..core.device import as_tensor


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------

class WallClock:
    """Real time. ``advance_to`` sleeps — the production driver never needs
    it (eager arrivals + synchronous executors keep the loop progressing),
    but a scripted future arrival under real time would."""

    def now(self) -> float:
        return time.perf_counter()

    def advance_to(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


class VirtualClock:
    """Deterministic test clock: time moves ONLY via ``advance_to`` (which
    the loop calls with the next scheduled event). No sleeps, no wall-clock
    reads — the whole policy surface becomes replayable."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance_to(self, t: float) -> None:
        if t < self._t:
            raise ValueError(f"clock cannot go backwards: {t} < {self._t}")
        self._t = float(t)


# ---------------------------------------------------------------------------
# arrivals
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Query:
    """One request: an id, a response vector y, and its arrival time."""
    qid: int
    y: object                     # (n,) host array
    t_arrive: float


class ScriptedArrivals:
    """An exact arrival script: [(t_0, y_0), (t_1, y_1), ...] with
    non-decreasing times. The loop pulls a query only once the clock has
    reached its arrival time AND the admission queue has room — queries
    the queue cannot take yet wait here (that wait is the backpressure
    stall, visible as ``t_admit > t_arrive`` on the ticket)."""

    def __init__(self, script):
        script = list(script)
        times = [float(t) for t, _ in script]
        if any(b < a for a, b in zip(times, times[1:])):
            raise ValueError("arrival times must be non-decreasing")
        self._queries = collections.deque(
            Query(qid=i, y=y, t_arrive=float(t))
            for i, (t, y) in enumerate(script))

    def peek_time(self):
        """Arrival time of the next query, or None when exhausted."""
        return self._queries[0].t_arrive if self._queries else None

    def pop(self, now: float) -> Query:
        q = self._queries[0]
        if q.t_arrive > now:
            raise RuntimeError(f"query {q.qid} has not arrived yet")
        return self._queries.popleft()


def stream_arrivals(stream, count: int, *, rate: float = 0.0,
                    start: float = 0.0, dtype=None) -> ScriptedArrivals:
    """Arrival script over ``data.pipeline.QueryStream``: the first
    ``count`` queries in stream order, arriving at ``start + i/rate``
    (``rate = 0`` → all eager at ``start``, the steady-state-load shape the
    bench uses). Determinism is inherited from the stream's (seed, step,
    shard) keying, so a replay is bit-identical."""
    kw = {} if dtype is None else {"dtype": dtype}
    ys = list(stream.queries(count, **kw)) if hasattr(stream, "queries") \
        else [np.asarray(y) for y in stream][:count]
    dt = 0.0 if rate <= 0 else 1.0 / rate
    return ScriptedArrivals([(start + i * dt, y) for i, y in enumerate(ys)])


# ---------------------------------------------------------------------------
# policy + tickets + trace
# ---------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """The batch-formation knobs.

    ``pad`` picks the padded batch shape for a partial batch of k live
    queries: "pow2" → next power of two ≥ k (capped at ``b_max``; the
    continuous default: O(log B) batch shapes), "full" → always
    ``b_max`` (the fixed-B server), "none" → k as-is (one variant
    per fill level; only sane for tiny ``b_max``).
    """

    b_max: int = 8                    # fill target: dispatch at this size
    deadline_s: float = 0.02          # oldest-admitted latency deadline
    queue_cap: int = 64               # bounded admission queue (backpressure)
    max_in_flight: int = 2            # pipelined dispatch window
    pad: str = "pow2"                 # "pow2" | "full" | "none"
    validate_admission: bool = True   # reject non-finite queries at admit

    def __post_init__(self):
        if self.b_max < 1:
            raise ValueError(f"b_max must be ≥ 1, got {self.b_max}")
        if self.queue_cap < self.b_max:
            raise ValueError(
                f"queue_cap ({self.queue_cap}) must be ≥ b_max "
                f"({self.b_max}) or the fill target can never be reached")
        if self.deadline_s < 0:
            raise ValueError("deadline_s must be ≥ 0")
        if self.max_in_flight < 1:
            raise ValueError("max_in_flight must be ≥ 1")
        if self.pad not in ("pow2", "full", "none"):
            raise ValueError(f"pad must be pow2|full|none, got {self.pad!r}")

    def padded_size(self, n_live: int) -> int:
        if self.pad == "full":
            return self.b_max
        if self.pad == "pow2":
            return min(_next_pow2(n_live), self.b_max)
        return n_live


@dataclasses.dataclass
class Ticket:
    """Per-query lifecycle + accounting. ``t_arrive`` is when the source
    offered the query; ``t_admit`` when the bounded queue took it
    (``t_admit > t_arrive`` ⇔ the query stalled under backpressure);
    latency is admission → completion, the window the policy controls."""

    qid: int
    y: object
    t_arrive: float
    t_admit: float | None = None
    t_dispatch: float | None = None
    t_complete: float | None = None
    batch_id: int | None = None
    error: str | None = None
    converged: bool | None = None
    result: object | None = None      # per-query payload from the executor

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def latency_s(self) -> float:
        return self.t_complete - self.t_admit

    @property
    def stalled(self) -> bool:
        return self.t_admit is not None and self.t_admit > self.t_arrive


@dataclasses.dataclass(frozen=True)
class DispatchRecord:
    """One line of the dispatch trace — the replay-determinism artifact:
    identical streams must produce identical traces (tested)."""
    batch_id: int
    reason: str                   # "fill" | "deadline" | "drain" | "isolate"
    qids: tuple
    n_live: int
    padded_b: int
    t: float
    version: int = 0              # executor's dictionary version at dispatch
    #                               time: a batch in flight across a
    #                               session.update retires under the OLD
    #                               version — the trace attributes every
    #                               result to the dictionary that served it


# ---------------------------------------------------------------------------
# executors + handles
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LaneResult:
    """Per-query outcome of one dispatched batch lane."""
    result: object = None
    converged: bool = True
    error: str | None = None


class ImmediateHandle:
    """A batch that completed at dispatch (synchronous executors)."""

    done_at = None

    def __init__(self, lanes=None, failure: Exception | None = None):
        self._lanes = lanes
        self._failure = failure

    def done(self, now: float) -> bool:
        return True

    def result(self):
        if self._failure is not None:
            raise self._failure
        return self._lanes


class DelayedHandle:
    """Wrap a handle so it reports completion at ``done_at`` on the loop's
    clock — the scripted-service-time harness for pipelining/out-of-order
    tests (the inner work already ran; only *when the loop may see it* is
    scripted)."""

    def __init__(self, inner, done_at: float):
        self._inner = inner
        self.done_at = float(done_at)

    def done(self, now: float) -> bool:
        return now >= self.done_at and self._inner.done(now)

    def result(self):
        return self._inner.result()


class SessionExecutor:
    """The real executor: one dispatched batch = one ``session.path(Y)``
    call (the batched driver; a 1-live batch arrives as (1, n) and takes
    the session's single-query driver). The padded host buffer is handed
    to the session's device by :func:`~repro_torch.core.device.as_tensor`
    and dropped here: the loop never retains it. Failures are captured
    into the handle so the loop's isolation path owns recovery."""

    def __init__(self, session, *, num_lambdas: int = 16,
                 lo_frac: float = 0.1, hi_frac: float = 0.95):
        self.session = session
        self.num_lambdas = int(num_lambdas)
        self.lo_frac = float(lo_frac)
        self.hi_frac = float(hi_frac)

    @property
    def version(self) -> int:
        """The session's dictionary version — stamped into each
        :class:`DispatchRecord` so trace lines survive ``session.update``
        with the right attribution."""
        return int(getattr(self.session, "version", 0))

    def dispatch(self, Y, n_live: int, batch_id: int, now: float):
        try:
            res = self.session.path(
                as_tensor(Y, self.session.device, self.session.X.dtype),
                num_lambdas=self.num_lambdas, lo_frac=self.lo_frac,
                hi_frac=self.hi_frac)
        except Exception as e:               # surfaces at retire → isolate
            return ImmediateHandle(failure=e)
        qc = res.query_converged
        lanes = []
        for b in range(n_live):
            view = res.query(b)
            if not np.isfinite(view.betas).all():
                lanes.append(LaneResult(result=view, converged=False,
                                        error="non-finite result"))
                continue
            lanes.append(LaneResult(
                result=view,
                converged=bool(qc[b]) if qc is not None else True))
        return ImmediateHandle(lanes=lanes)


class DelayedExecutor:
    """Scripted service times over any inner executor: completion is
    reported at ``now + service_time(n_live, batch_id)``. With a virtual
    clock this makes every pipelining branch deterministic — e.g. a slow
    batch 0 and a fast batch 1 retire out of order."""

    def __init__(self, inner, service_time):
        self.inner = inner
        self.service_time = service_time    # (n_live, batch_id) -> seconds

    @property
    def version(self) -> int:
        return int(getattr(self.inner, "version", 0))

    def dispatch(self, Y, n_live: int, batch_id: int, now: float):
        h = self.inner.dispatch(Y, n_live, batch_id, now)
        return DelayedHandle(h, now + float(self.service_time(n_live,
                                                              batch_id)))


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _InFlight:
    batch_id: int
    handle: object
    tickets: list
    n_live: int
    t_dispatch: float


class ServeLoop:
    """Single-threaded, event-driven continuous-batching loop.

    Each iteration runs admission → retirement → dispatch until no step
    can make progress, then advances the clock to the next scheduled event
    (next arrival, oldest admission deadline, earliest known completion).
    With a :class:`VirtualClock` that advance is a jump: the tests exercise
    every branch with zero sleeps; with :class:`WallClock` and eager
    arrivals the loop never waits at all.
    """

    def __init__(self, arrivals, executor, *, policy: ServePolicy = None,
                 clock=None, on_dispatch=None, on_complete=None):
        self.arrivals = arrivals
        self.executor = executor
        self.policy = policy if policy is not None else ServePolicy()
        self.clock = clock if clock is not None else WallClock()
        self.on_dispatch = on_dispatch
        self.on_complete = on_complete

        self.queue: collections.deque[Ticket] = collections.deque()
        self.in_flight: list[_InFlight] = []
        self.tickets: list[Ticket] = []
        self.trace: list[DispatchRecord] = []
        self.max_queue_len = 0
        self._next_batch_id = 0

    # ------------------------------------------------------------- steps
    def _admit(self) -> bool:
        """Pull every arrived query the bounded queue has room for."""
        now = self.clock.now()
        progressed = False
        while (self.arrivals.peek_time() is not None
               and self.arrivals.peek_time() <= now
               and len(self.queue) < self.policy.queue_cap):
            q = self.arrivals.pop(now)
            t = Ticket(qid=q.qid, y=q.y, t_arrive=q.t_arrive, t_admit=now)
            self.tickets.append(t)
            progressed = True
            if (self.policy.validate_admission
                    and not np.isfinite(np.asarray(q.y)).all()):
                # poison screened at the door: reported on its own ticket,
                # never joins a batch
                t.error = "non-finite query rejected at admission"
                t.t_complete = now
                if self.on_complete:
                    self.on_complete(t)
                continue
            self.queue.append(t)
            self.max_queue_len = max(self.max_queue_len, len(self.queue))
        return progressed

    def _dispatch_reason(self):
        if not self.queue or len(self.in_flight) >= self.policy.max_in_flight:
            return None
        if len(self.queue) >= self.policy.b_max:
            return "fill"
        now = self.clock.now()
        if (self.policy.deadline_s != math.inf
                and now - self.queue[0].t_admit >= self.policy.deadline_s):
            return "deadline"
        if self.arrivals.peek_time() is None:
            # source exhausted: nothing can join this batch, waiting for
            # the deadline would only add latency
            return "drain"
        return None

    def _dispatch(self, tickets: list, reason: str) -> None:
        now = self.clock.now()
        n_live = len(tickets)
        padded = max(self.policy.padded_size(n_live), n_live)
        batch_id = self._next_batch_id
        self._next_batch_id += 1
        ys = [np.asarray(t.y) for t in tickets]
        ys += [ys[-1]] * (padded - n_live)   # pad: repeat the last query
        Y = np.stack(ys)
        for t in tickets:
            t.t_dispatch = now
            t.batch_id = batch_id
        rec = DispatchRecord(batch_id=batch_id, reason=reason,
                             qids=tuple(t.qid for t in tickets),
                             n_live=n_live, padded_b=padded, t=now,
                             version=int(getattr(self.executor, "version",
                                                 0)))
        self.trace.append(rec)
        if self.on_dispatch:
            self.on_dispatch(rec)
        handle = self.executor.dispatch(Y, n_live, batch_id, now)
        del Y, ys                            # buffer ownership is handed off
        self.in_flight.append(_InFlight(batch_id, handle, tickets, n_live,
                                        now))

    def _maybe_dispatch(self) -> bool:
        progressed = False
        while True:
            reason = self._dispatch_reason()
            if reason is None:
                return progressed
            k = min(self.policy.b_max, len(self.queue))
            self._dispatch([self.queue.popleft() for _ in range(k)], reason)
            progressed = True

    def _retire(self) -> bool:
        """Retire every completed in-flight batch, in completion order —
        a later batch finishing first is retired first."""
        now = self.clock.now()
        ready = [f for f in self.in_flight if f.handle.done(now)]
        for f in ready:
            self.in_flight.remove(f)
            try:
                lanes = f.handle.result()
            except Exception as e:
                self._fail_batch(f, e)
                continue
            for t, lane in zip(f.tickets, lanes):
                t.result = lane.result
                t.converged = lane.converged
                t.error = lane.error
                t.t_complete = now
                if self.on_complete:
                    self.on_complete(t)
        return bool(ready)

    def _fail_batch(self, f: _InFlight, exc: Exception) -> None:
        """Fault isolation: a failed multi-query batch is split and each
        query re-served alone ("isolate" dispatches — these are recovery
        work and bypass the in-flight window); a failed single query is
        the fault, reported on its ticket."""
        now = self.clock.now()
        if f.n_live == 1:
            t = f.tickets[0]
            t.error = f"{type(exc).__name__}: {exc}"
            t.t_complete = now
            if self.on_complete:
                self.on_complete(t)
            return
        for t in f.tickets:
            self._dispatch([t], "isolate")

    # --------------------------------------------------------------- run
    def _finished(self) -> bool:
        return (self.arrivals.peek_time() is None and not self.queue
                and not self.in_flight)

    def _next_event_time(self):
        cands = []
        if (self.arrivals.peek_time() is not None
                and len(self.queue) < self.policy.queue_cap):
            cands.append(self.arrivals.peek_time())
        if (self.queue and len(self.in_flight) < self.policy.max_in_flight
                and self.policy.deadline_s != math.inf):
            cands.append(self.queue[0].t_admit + self.policy.deadline_s)
        for f in self.in_flight:
            done_at = getattr(f.handle, "done_at", None)
            if done_at is not None:
                cands.append(done_at)
        cands = [t for t in cands if math.isfinite(t)]
        return min(cands) if cands else None

    def run(self) -> "ServeReport":
        t_start = self.clock.now()
        while True:
            progressed = True
            while progressed:
                progressed = self._admit()
                progressed |= self._retire()
                progressed |= self._maybe_dispatch()
            if self._finished():
                break
            t = self._next_event_time()
            now = self.clock.now()
            if t is None or t <= now:
                raise RuntimeError(
                    "serve loop stalled: no progress and no scheduled "
                    f"event (queue={len(self.queue)}, "
                    f"in_flight={len(self.in_flight)})")
            self.clock.advance_to(t)
        return ServeReport(tickets=self.tickets, trace=self.trace,
                           policy=self.policy, t_start=t_start,
                           t_end=self.clock.now(),
                           max_queue_len=self.max_queue_len)


# ---------------------------------------------------------------------------
# accounting + report
# ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """Linear-interpolation percentile (numpy's default convention; the
    port's own copy of the reference's definition): with sorted values
    v_0..v_{m-1}, p_q = v at rank (m-1)·q/100,
    linearly interpolated between the two bracketing ranks."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return float("nan")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    pos = (len(vals) - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


@dataclasses.dataclass
class ServeReport:
    """Everything the run produced: tickets (results + timelines), the
    dispatch trace, and derived latency/throughput accounting."""

    tickets: list
    trace: list
    policy: ServePolicy
    t_start: float
    t_end: float
    max_queue_len: int = 0

    @property
    def ok_tickets(self) -> list:
        return [t for t in self.tickets if t.ok]

    @property
    def latencies_s(self) -> list:
        """Admission → completion, successfully served tickets only."""
        return [t.latency_s for t in self.ok_tickets]

    @property
    def wall_time_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def queries_per_sec(self) -> float:
        return len(self.ok_tickets) / max(self.wall_time_s, 1e-12)

    def summary(self) -> dict:
        lats = self.latencies_s
        reasons = collections.Counter(r.reason for r in self.trace)
        fills = [r.n_live / r.padded_b for r in self.trace]
        return {
            "n_queries": len(self.tickets),
            "n_ok": len(self.ok_tickets),
            "n_errors": sum(not t.ok for t in self.tickets),
            "n_unconverged": sum(1 for t in self.ok_tickets
                                 if t.converged is False),
            "queries_per_sec": self.queries_per_sec,
            "p50_latency_s": percentile(lats, 50.0),
            "p99_latency_s": percentile(lats, 99.0),
            "wall_time_s": self.wall_time_s,
            "n_dispatches": len(self.trace),
            "mean_batch_fill": (sum(fills) / len(fills)) if fills else 0.0,
            "deadline_dispatch_frac": (reasons["deadline"] / len(self.trace)
                                       if self.trace else 0.0),
            "dispatch_reasons": dict(reasons),
            "backpressure_waits": sum(t.stalled for t in self.tickets),
            "max_queue_len": self.max_queue_len,
        }


def merge_bench_section(path: str, section: str, meta: dict,
                        rows: list) -> None:
    """Merge ``{section: {meta, rows}}`` into the bench JSON file at
    ``path`` (the reference's layout: ``{"sections": {name: {"meta",
    "rows"}}}``)."""
    doc = {"sections": {}}
    if os.path.exists(path):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (json.JSONDecodeError, OSError):
            doc = {"sections": {}}
    doc.setdefault("sections", {})[section] = {"meta": meta, "rows": rows}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
