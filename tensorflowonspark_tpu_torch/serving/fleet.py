"""ServingFleet: a driver-side router over N ServingEngine replicas.

The port's copy of ``tensorflowonspark_tpu/serving/fleet.py`` over the
port's :class:`~tensorflowonspark_tpu_torch.serving.engine.ServingEngine`.
One engine is a single loop: a terminal loop death, an unresponsive
replica or a weight swap is an outage. The fleet keeps N engines behind
one ``submit``; replicas are interchangeable because greedy decode is
bit-identical, which makes any replica's answer *the* answer and
cross-replica failover provably correct, exactly as it makes the
engine's own crash replay correct.

The fleet keeps serving through:

* **load imbalance** — dispatch is load-aware off the engines' host-side
  telemetry (queued token mass, queue depth, the live tokens/s EMA,
  instantaneous occupancy): a request goes to the replica with the
  shortest estimated backlog-clear time, and each replica's own
  admission bounds (``TOS_SERVE_MAX_QUEUE``/``MAX_QUEUED_TOKENS``) still
  apply;
* **overload** — when every live replica rejects with
  ``ServingOverloaded``, ``submit`` retries with backoff honouring the
  smallest ``retry_after`` hint, bounded by the request's own TTL or
  ``TOS_FLEET_ADMIT_TIMEOUT``;
* **replica death** — a replica that dies terminally or fails its health
  probe ``probe_fails`` times running is EJECTED, and every request it
  accepted but did not finish is resubmitted to a live replica from its
  prompt (failover replay, at most ``TOS_FLEET_MAX_FAILOVERS`` times a
  request). ``stream()`` gives each position exactly once across the hop:
  the fleet suppresses the already-delivered prefix and verifies it
  (``replay_mismatches``);
* **rolling weight swaps** — :meth:`rolling_swap` drains one replica at a
  time through the engine's zero-shed ``drain()`` while dispatch shifts
  to the others, then swaps in a fresh engine from the factory.

Every ejection, failover and swap is a structured event (:attr:`events`,
the ``fleet.*`` counters and gauges the obs plane's ``fleet_degraded`` /
``fleet_saturated`` detectors and the availability SLO read, recorder
instants), and the fleet-minted trace id rides every replica attempt, so
a failover hop stays one trace. Replica faults ride ``TOS_CHAOS_FLEET``
(``dispatch[@replica][#nth]:kill`` / ``...:stall:seconds``,
``utils.chaos``). The canary and scaling surface (``set_canary``,
``set_replica_version``, ``add_replica``, ``on_saturated``) is what a
deploy controller drives.

Usage::

    fleet = ServingFleet(lambda: ServingEngine(params, cfg, eos_id=2),
                         num_replicas=2).start()
    frid = fleet.submit(prompt_ids, max_new_tokens=128, ttl=30.0)
    tokens = fleet.result(frid, timeout=60)
    fleet.rolling_swap(timeout=30.0,          # zero-shed re-weighting
                       engine_factory=lambda: ServingEngine(
                           new_params, cfg, eos_id=2))
    fleet.drain(timeout=30)                   # or fleet.stop()

Every wait is bounded by a timeout; the monitor thread is a daemon; the
knobs are ``TOS_FLEET_*`` environment variables.
"""

import collections
import contextlib
import itertools
import logging
import os
import queue as std_queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from tensorflowonspark_tpu_torch.obs import metrics as obs_metrics
from tensorflowonspark_tpu_torch.obs import spans as obs_spans
from tensorflowonspark_tpu_torch.serving import engine as engine_mod
from tensorflowonspark_tpu_torch.serving import scheduler as sched
from tensorflowonspark_tpu_torch.utils import chaos

logger = logging.getLogger(__name__)

#: replica count when the ctor passes ``num_replicas=None``
ENV_FLEET_REPLICAS = "TOS_FLEET_REPLICAS"
#: fleet monitor cadence in seconds — the bound on every fleet wait
ENV_FLEET_POLL = "TOS_FLEET_POLL"
#: cross-replica failovers tolerated per request before it is failed
#: (the fleet-level poison analogue: a request that kills every replica
#: it lands on must not chew through the whole fleet)
ENV_FLEET_MAX_FAILOVERS = "TOS_FLEET_MAX_FAILOVERS"
#: consecutive health-probe failures before a replica is ejected
ENV_FLEET_PROBE_FAILS = "TOS_FLEET_PROBE_FAILS"
#: submit retry bound in seconds for requests with NO deadline of their
#: own — with one, the request's deadline bounds the retries instead
ENV_FLEET_ADMIT_TIMEOUT = "TOS_FLEET_ADMIT_TIMEOUT"
#: replica-count ceiling for the ``on_saturated`` scale-up hook. UNSET
#: (and no ``max_replicas`` arg) means the hook is OFF — saturation
#: stays signal-only (the ``fleet_saturated`` detector), exactly as
#: before. Set it and a saturated submit may add replicas (from the
#: fleet's current factory — the deploy controller keeps that pointed at
#: the promoted version) up to this bound.
ENV_FLEET_MAX_REPLICAS = "TOS_FLEET_MAX_REPLICAS"

_DEFAULT_REPLICAS = 2
_DEFAULT_POLL = 0.05
_DEFAULT_MAX_FAILOVERS = 3
_DEFAULT_PROBE_FAILS = 3
_DEFAULT_ADMIT_TIMEOUT = 30.0
#: retry sleep when a rejection carries no usable retry_after hint
_DEFAULT_RETRY_SLEEP = 0.1
#: bounded structured-event log (ejections, failovers, swaps)
_EVENT_CAP = 256

ACTIVE = "active"
DRAINING = "draining"
EJECTED = "ejected"

_fleet_request_ids = itertools.count(1)


def _env_int(name: str, default: int) -> int:
  return int(os.environ.get(name, str(default)))


def _env_float(name: str, default: float) -> float:
  return float(os.environ.get(name, str(default)))


class Replica(object):
  """One engine slot in the fleet: the engine plus routing state."""

  __slots__ = ("rid", "engine", "state", "reason", "probe_fails",
               "dispatches", "generation")

  def __init__(self, rid: int, engine):
    self.rid = rid
    self.engine = engine
    self.state = ACTIVE
    self.reason: Optional[str] = None      # why ejected
    self.probe_fails = 0                   # consecutive failed probes
    self.dispatches = 0                    # requests routed here
    self.generation = 0                    # bumped per rolling swap


class FleetRequest(object):
  """One logical request as the FLEET sees it: the prompt/budget/deadline
  plus the chain of replica attempts it rode. Clients hold this handle;
  the engine-side :class:`~.scheduler.Request` objects underneath it are
  disposable (a failover abandons one and creates the next).

  ``prev_tokens`` records the longest generated prefix any dead attempt
  produced — the successful attempt's output is verified against it
  (greedy ⇒ bit-identical; disagreement counts ``replay_mismatches``
  instead of being trusted blindly), and ``stream()`` uses its own
  delivered history the same way to keep each position exactly-once
  across the replica hop.

  The fleet mints the request's ``trace_id`` at submit and hands it to
  EVERY engine attempt (``ServingEngine.submit(trace_id=...)``), so a
  cross-replica failover hop stays ONE trace — the spans both replicas
  emitted share it, so a trace renders the hop. ``first_token_at`` is the timing-ledger TTFT stamp: the
  EARLIEST first token any attempt delivered to the client — a failover
  replay regenerates positions the client already holds, so it never
  moves this stamp (the engine-side crash-replay rule, applied across
  replicas)."""

  __slots__ = ("frid", "prompt", "max_new_tokens", "deadline", "done",
               "error", "output", "cancelled", "submitted_at",
               "finished_at", "first_token_at", "trace_id",
               "attempts", "cur_replica", "cur_rid",
               "cur_req", "attempt_seq", "prev_tokens", "failovers",
               "next_try", "model_version")

  def __init__(self, prompt, max_new_tokens: int, deadline=None):
    self.frid = next(_fleet_request_ids)
    self.prompt = np.asarray(prompt, np.int32).ravel()
    self.max_new_tokens = int(max_new_tokens)
    self.deadline = None if deadline is None else float(deadline)
    self.done = threading.Event()
    self.error: Optional[BaseException] = None
    self.output: Optional[np.ndarray] = None
    self.cancelled = threading.Event()
    self.submitted_at = time.monotonic()
    self.finished_at: Optional[float] = None
    self.first_token_at: Optional[float] = None
    self.trace_id = sched.new_trace_id()
    self.attempts: List[tuple] = []        # (replica_id, engine_rid)
    self.cur_replica: Optional[int] = None
    self.cur_rid: Optional[int] = None
    self.cur_req = None                    # engine-side Request handle
    self.attempt_seq = 0
    self.prev_tokens: List[int] = []
    self.failovers = 0
    self.next_try = 0.0                    # earliest failover re-place
    #: registry version of the replica that SERVED this request (the
    #: deploy plane's stamp; None when no version map is set) — rides
    #: the timing ledger and the fleet.dispatch span so every trace
    #: names the model that answered it
    self.model_version = None

  def expired(self, now: Optional[float] = None) -> bool:
    if self.deadline is None:
      return False
    return (time.monotonic() if now is None else now) >= self.deadline

  def note_first_token(self, at: Optional[float]) -> None:
    """Fold one attempt's first-token stamp into the ledger (earliest
    wins; a replayed attempt's later stamp never resets TTFT)."""
    if at is not None and (self.first_token_at is None
                           or at < self.first_token_at):
      self.first_token_at = at

  @property
  def ttft(self) -> Optional[float]:
    if self.first_token_at is None:
      return None
    return self.first_token_at - self.submitted_at

  def timing(self) -> dict:
    """The fleet-level timing ledger (the engine ``Request.timing``
    shape, plus ``failovers``/``attempts``)."""
    return {"trace_id": self.trace_id, "frid": self.frid,
            "submitted": self.submitted_at,
            "first_token": self.first_token_at,
            "finished": self.finished_at,
            "ttft": self.ttft, "e2e": self.latency,
            "failovers": self.failovers,
            "attempts": list(self.attempts),
            "model_version": self.model_version,
            "replica": self.cur_replica}

  def finish(self, error: Optional[BaseException],
             output: Optional[np.ndarray] = None) -> bool:
    """Idempotent single verdict (the engine Request.finish rule).
    Returns True only for the call that SET the verdict — completion
    accounting keys on it, since the monitor sweep and a stream()
    consumer can both observe the same clean finish."""
    if self.done.is_set():
      return False
    self.error = error
    self.output = output
    self.finished_at = time.monotonic()
    self.done.set()
    return True

  @property
  def latency(self) -> Optional[float]:
    if self.finished_at is None:
      return None
    return self.finished_at - self.submitted_at


class ServingFleet(object):
  """Route requests across N ServingEngine replicas; keep serving
  through replica failure, overload and rolling param swaps."""

  def __init__(self, engine_factory: Callable[[], object],
               num_replicas: Optional[int] = None,
               poll_interval: Optional[float] = None,
               max_failovers: Optional[int] = None,
               probe_fails: Optional[int] = None,
               admit_timeout: Optional[float] = None,
               health_probe: Optional[Callable[[Replica], bool]] = None,
               max_replicas: Optional[int] = None):
    # explicit arguments beat the env knobs (the num_slots rule)
    n = int(num_replicas if num_replicas is not None
            else _env_int(ENV_FLEET_REPLICAS, _DEFAULT_REPLICAS))
    if n < 1:
      raise ValueError("num_replicas must be >= 1, got %d" % n)
    #: scale-up ceiling for :meth:`on_saturated`; None (knob unset, no
    #: arg) keeps the hook OFF — saturation stays signal-only
    cap = int(max_replicas if max_replicas is not None
              else _env_int(ENV_FLEET_MAX_REPLICAS, 0))
    self.max_replicas = cap if cap > 0 else None
    if self.max_replicas is not None and self.max_replicas < n:
      raise ValueError("max_replicas %d < num_replicas %d"
                       % (self.max_replicas, n))
    self._factory = engine_factory
    self._poll = float(poll_interval if poll_interval is not None
                       else _env_float(ENV_FLEET_POLL, _DEFAULT_POLL))
    self.max_failovers = int(
        max_failovers if max_failovers is not None
        else _env_int(ENV_FLEET_MAX_FAILOVERS, _DEFAULT_MAX_FAILOVERS))
    self.probe_fails = max(1, int(
        probe_fails if probe_fails is not None
        else _env_int(ENV_FLEET_PROBE_FAILS, _DEFAULT_PROBE_FAILS)))
    self.admit_timeout = float(
        admit_timeout if admit_timeout is not None
        else _env_float(ENV_FLEET_ADMIT_TIMEOUT, _DEFAULT_ADMIT_TIMEOUT))
    #: optional liveness probe ``(Replica) -> bool`` consulted every
    #: monitor pass — the in-process stand-in for "answers HEALTH": an
    #: out-of-process deployment points this at the replica's HEALTH
    #: round-trip. ``probe_fails`` CONSECUTIVE False/raising probes
    #: eject the replica; the engine's own ``alive`` flag is always
    #: checked first and needs no probe.
    self.health_probe = health_probe
    self._replicas: Dict[int, Replica] = {
        rid: Replica(rid, engine_factory()) for rid in range(n)}
    self.num_replicas = n
    self._lock = threading.Lock()
    self._stats_lock = threading.Lock()
    self._requests: Dict[int, FleetRequest] = {}
    self._pending: collections.deque = collections.deque()
    self._draining = False
    self._stop_evt = threading.Event()
    self._thread: Optional[threading.Thread] = None
    #: bounded structured event log: {"event": eject|failover|swap, ...}
    self.events: collections.deque = collections.deque(maxlen=_EVENT_CAP)
    # counters ONLY (the engine stats rule: StatsSnapshot subtracts).
    # "submitted" counts CLIENT requests at the fleet boundary — the
    # availability SLO's denominator (obs.slo): engine-level
    # serve.submitted counts dispatch ATTEMPTS, which fleet
    # retries/failovers inflate, and a total-outage submit never
    # reaches an engine at all
    self.stats = {"submitted": 0, "dispatched": 0, "completed": 0,
                  "rejected": 0,
                  "retries": 0, "failovers": 0, "replays": 0,
                  "replay_mismatches": 0, "ejections": 0, "swaps": 0,
                  "shed": 0, "monitor_failures": 0, "scale_ups": 0,
                  "canary_dispatches": 0}
    #: canary routing state: {"rid", "every", "counter"} while a deploy
    #: canary holds one replica (serving.deploy), else None
    self._canary: Optional[dict] = None
    #: replica id -> registry model version (the deploy plane's map;
    #: stamps requests/spans, read back by version-consistency checks)
    self._versions: Dict[int, object] = {}
    self._rec = obs_spans.active()
    reg = obs_metrics.active()
    self._obs_m = None if reg is None else {
        k: reg.counter("fleet." + k) for k in self.stats}
    self._obs_g = None if reg is None else {
        "replicas_total": reg.gauge("fleet.replicas_total"),
        "replicas_active": reg.gauge("fleet.replicas_active"),
        "replicas_draining": reg.gauge("fleet.replicas_draining"),
        "queue_depth": reg.gauge("fleet.queue_depth"),
        "occupancy": reg.gauge("fleet.occupancy"),
    }

  # -- bookkeeping -----------------------------------------------------------

  def _count(self, key: str, n: int = 1) -> None:
    with self._stats_lock:
      self.stats[key] += n
    if self._obs_m is not None:
      self._obs_m[key].inc(n)

  def stats_snapshot(self) -> obs_metrics.StatsSnapshot:
    """Subtraction baseline over the live stats dict."""
    return obs_metrics.snapshot_stats(self.stats)

  def _event(self, kind: str, **fields) -> None:
    rec = dict(fields, event=kind, t=time.monotonic())
    self.events.append(rec)
    logger.warning("fleet %s: %s", kind, fields)
    if self._rec is not None:
      self._rec.event("fleet." + kind, **{
          k: v for k, v in fields.items()
          if isinstance(v, (int, float, str, bool))})

  # -- lifecycle -------------------------------------------------------------

  def start(self) -> "ServingFleet":
    if self._thread is not None and self._thread.is_alive():
      return self
    self._stop_evt.clear()
    self._draining = False
    for rep in self._replicas.values():
      if rep.state != EJECTED:
        rep.engine.start()
    self._thread = threading.Thread(target=self._monitor, daemon=True,
                                    name="tos-torch-serving-fleet")
    self._thread.start()
    return self

  def stop(self, timeout: float = 30.0) -> None:
    """Stop the monitor and every replica; unfinished requests fail.
    Idempotent, safe before :meth:`start`."""
    self._stop_evt.set()
    t = self._thread
    if t is not None:
      t.join(timeout=timeout)
    err = RuntimeError("serving fleet stopped")
    for rep in self._replicas.values():
      if rep.state != EJECTED:
        rep.engine.stop(timeout=max(1.0, timeout / max(1, len(
            self._replicas))))
    with self._lock:
      reqs = list(self._requests.values())
      self._pending.clear()
    for freq in reqs:
      freq.finish(err)

  def drain(self, timeout: float) -> bool:
    """Graceful fleet shutdown: close admission, finish every accepted
    request (on whichever replica holds it, failing over if one dies
    mid-drain), then stop. True when all accepted work completed inside
    ``timeout``. ``timeout`` required (TOS001, the engine drain rule)."""
    deadline = time.monotonic() + max(0.0, float(timeout))
    self._draining = True
    while time.monotonic() < deadline:
      if self._idle():
        break
      if self._thread is None or not self._thread.is_alive():
        break
      time.sleep(min(0.05, self._poll))
    completed = self._idle()
    self.stop(timeout=max(1.0, deadline - time.monotonic()))
    return completed

  def _idle(self) -> bool:
    with self._lock:
      if self._pending:
        return False
      return all(freq.done.is_set() for freq in self._requests.values())

  def __enter__(self):
    return self.start()

  def __exit__(self, *exc):
    self.stop()

  @property
  def alive(self) -> bool:
    """False once the fleet is stopped or has no live replica left."""
    t = self._thread
    if t is not None and not t.is_alive() and self._stop_evt.is_set():
      return False
    return any(rep.state != EJECTED and rep.engine.alive
               for rep in self._replicas.values())

  def replica_states(self) -> Dict[int, str]:
    return {rid: rep.state for rid, rep in self._replicas.items()}

  @property
  def active_replicas(self) -> int:
    return sum(1 for rep in self._replicas.values()
               if rep.state == ACTIVE and rep.engine.alive)

  # -- dispatch --------------------------------------------------------------

  def _score(self, rep: Replica):
    """Load score: estimated seconds to clear the replica's queued
    token backlog at its live decode rate (a cold replica competes on
    raw backlog — comparable enough: an idle cold replica scores 0),
    tie-broken by queue depth, instantaneous occupancy, replica id."""
    eng = rep.engine
    backlog = eng.queued_tokens
    rate = eng.tokens_per_sec
    wait = backlog / rate if rate > 0 else float(backlog)
    return (wait, eng.queue_depth, eng.occupancy_now, rep.rid)

  def _dispatch_order(self) -> List[Replica]:
    with self._lock:
      live = [rep for rep in self._replicas.values()
              if rep.state == ACTIVE and rep.engine.alive]
    return sorted(live, key=self._score)

  def _canary_order(self) -> List[Replica]:
    """Dispatch order under an active canary: every ``every``-th
    placement round tries the canary replica FIRST (the configured
    traffic slice); all other rounds try it LAST — baseline traffic
    stays off the candidate, but a fully-overloaded baseline can still
    fall back to the canary rather than shed (zero-shed beats slice
    purity)."""
    order = self._dispatch_order()
    with self._lock:
      can = self._canary
      if can is None:
        return order
      rid = can["rid"]
      can["counter"] += 1
      take = can["every"] > 0 and can["counter"] % can["every"] == 0
    canary = [r for r in order if r.rid == rid]
    others = [r for r in order if r.rid != rid]
    if not canary:
      return order
    return canary + others if take else others + canary

  def _try_place(self, freq: FleetRequest) -> Optional[float]:
    """One dispatch round over every live replica, best-scored first
    (canary-slice-aware while a canary is set). Returns None when
    placed; the smallest ``retry_after`` hint when every replica
    rejected (inf when none was even reachable)."""
    hint = None
    for rep in self._canary_order():
      if chaos.fleet_fault("dispatch", rep.rid) == "kill":
        # replica-granularity chaos: this replica dies AT this dispatch
        # (mid-decode for everything it already accepted) — eject now so
        # the request lands on a live peer and failover replays begin
        self._kill_replica(rep, chaos.InjectedFault(
            "chaos: fleet replica %d killed at dispatch" % rep.rid))
        continue
      rep.dispatches += 1
      t0 = time.monotonic()
      try:
        # the fleet's trace_id rides every attempt: a failover hop's
        # spans on the NEXT replica join the same trace
        erid = rep.engine.submit(freq.prompt,
                                 max_new_tokens=freq.max_new_tokens,
                                 deadline=freq.deadline,
                                 trace_id=freq.trace_id)
      except sched.ServingOverloaded as e:
        ra = e.retry_after
        if ra is not None and (hint is None or ra < hint):
          hint = ra
        continue
      except sched.DeadlineExceeded:
        raise
      except RuntimeError:
        # the replica died between the order snapshot and the submit —
        # the monitor's next pass ejects it; try the next one
        continue
      if self._rec is not None:
        # the routing phase of the waterfall: which replica took it,
        # whether this was a fresh dispatch or a failover re-place, and
        # (deploy plane) which model version answers it
        attrs = {"trace": freq.trace_id, "replica": rep.rid,
                 "attempt": freq.attempt_seq + 1}
        ver = self._versions.get(rep.rid)
        if ver is not None:
          attrs["model_version"] = ver
        self._rec.record_span("fleet.dispatch", t0,
                              time.monotonic() - t0, **attrs)
      self._assign(freq, rep, erid)
      return None
    return hint if hint is not None else float("inf")

  def _assign(self, freq: FleetRequest, rep: Replica, erid: int) -> None:
    handle = rep.engine.request(erid)
    with self._lock:
      freq.attempts.append((rep.rid, erid))
      freq.cur_replica = rep.rid
      freq.cur_rid = erid
      freq.cur_req = handle
      freq.attempt_seq += 1
      freq.model_version = self._versions.get(rep.rid)
      can = self._canary
      if freq.cancelled.is_set():
        handle.cancelled.set()             # cancel raced the placement
    self._count("dispatched")
    if can is not None and can["rid"] == rep.rid:
      self._count("canary_dispatches")

  def submit(self, prompt, max_new_tokens: Optional[int] = None,
             deadline: Optional[float] = None,
             ttl: Optional[float] = None) -> int:
    """Queue one prompt on the least-loaded live replica; returns the
    fleet request id.

    When every replica rejects (:class:`ServingOverloaded`), retries
    with backoff honoring the smallest structured ``retry_after``,
    bounded by the request's own deadline (or ``TOS_FLEET_ADMIT_TIMEOUT``
    without one) — then re-raises a fleet-level ``ServingOverloaded``
    carrying the hint. Validation errors (empty/oversized prompt) and
    dead-on-arrival deadlines surface immediately, as on the engine.
    """
    if deadline is not None and ttl is not None:
      raise ValueError("pass deadline OR ttl, not both")
    now = time.monotonic()
    if ttl is not None:
      deadline = now + float(ttl)
    if len(np.asarray(prompt, np.int32).ravel()) < 1:
      # the engine's empty-prompt rule, checked at the fleet boundary:
      # a malformed request is a caller bug, not traffic, and must stay
      # out of BOTH sides of the availability ratio
      raise ValueError("prompt must contain at least one token")
    # "submitted" is the availability SLO's denominator — client traffic
    # counted at the fleet boundary, at every OUTCOME point below (never
    # on a validation error, and paired with "rejected" on every
    # client-visible admission failure, including a dead fleet: a total
    # outage must move the ratio it exists to burn)
    if max_new_tokens is None:
      # replicas share one config; any live engine's default applies
      rep = next((r for r in self._replicas.values()
                  if r.state != EJECTED), None)
      if rep is None:
        self._count("submitted")
        self._count("rejected")
        raise RuntimeError("serving fleet has no replicas left")
      max_new_tokens = rep.engine.default_max_new_tokens
    freq = FleetRequest(prompt, max_new_tokens, deadline=deadline)
    if freq.expired(now):
      # traffic, but not unavailability: the engine's expired rule
      self._count("submitted")
      raise sched.DeadlineExceeded(
          "request dead on arrival: its deadline already passed at "
          "submit")
    if self._draining:
      self._count("submitted")
      self._count("rejected")
      # a usable hint, never None (the engine's draining-rejection
      # rule): this fleet is going away, so the bounded cold-start
      # default is the honest "come back shortly, elsewhere" signal
      raise sched.ServingOverloaded(
          "serving fleet is draining — admission is closed",
          retry_after=engine_mod._COLD_RETRY_AFTER, draining=True)
    if not self.alive:
      self._count("submitted")
      self._count("rejected")
      raise RuntimeError("serving fleet is stopped or has no live "
                         "replicas")
    admit_deadline = min(
        freq.deadline if freq.deadline is not None else float("inf"),
        now + self.admit_timeout)
    with self._lock:
      self._requests[freq.frid] = freq
    first = True
    while True:
      try:
        hint = self._try_place(freq)
      except BaseException as e:
        with self._lock:
          self._requests.pop(freq.frid, None)
        # engine-side validation (ValueError: e.g. a prompt the paged
        # pool can never host) is a caller bug — everything else that
        # escapes the placement loop was real traffic
        if not isinstance(e, ValueError):
          self._count("submitted")
          if not isinstance(e, sched.DeadlineExceeded):
            self._count("rejected")
        raise
      if hint is None:
        self._count("submitted")
        return freq.frid
      if not first:
        self._count("retries")
      first = False
      if self.on_saturated():
        continue             # a fresh replica may take it — retry now
      sleep = hint if hint not in (None, float("inf")) \
          else _DEFAULT_RETRY_SLEEP
      remaining = admit_deadline - time.monotonic()
      if remaining <= 0 or not self.alive:
        with self._lock:
          self._requests.pop(freq.frid, None)
        self._count("submitted")
        self._count("rejected")
        if not self.alive:
          raise RuntimeError("serving fleet has no live replicas")
        raise sched.ServingOverloaded(
            "every replica rejected for the whole fleet admission "
            "window (%d live)" % self.active_replicas,
            retry_after=sleep if sleep != float("inf") else None)
      # bounded, stop-interruptible backoff honoring retry_after
      if self._rec is not None:
        self._rec.event("fleet.backoff", trace=freq.trace_id,
                        retry_after=float(sleep)
                        if sleep != float("inf") else None)
      self._stop_evt.wait(min(max(sleep, self._poll), remaining))

  # -- client read side ------------------------------------------------------

  def _freq(self, frid: int) -> FleetRequest:
    with self._lock:
      try:
        return self._requests[frid]
      except KeyError:
        raise KeyError("unknown fleet request id %r" % (frid,))

  def request(self, frid: int) -> FleetRequest:
    """The live FleetRequest handle (latency/attempt fields ride it).
    Hold it before :meth:`result` — that pops the registry entry."""
    return self._freq(frid)

  def _raise_if_dead(self, what: str) -> None:
    if not self.alive:
      raise RuntimeError("serving fleet is stopped or has no live "
                         "replicas; %s cannot finish" % what)

  def result(self, frid: int, timeout: float = 600.0) -> np.ndarray:
    """Block (bounded) for one request's output (prompt + generated).
    Fails fast when the fleet is dead, like the engine's waiters."""
    freq = self._freq(frid)
    deadline = time.monotonic() + timeout
    chunk = max(0.05, self._poll)
    while not freq.done.is_set():
      remaining = deadline - time.monotonic()
      if remaining <= 0:
        raise TimeoutError("fleet request %d not finished within %.1fs"
                           % (frid, timeout))
      if not freq.done.wait(timeout=min(chunk, remaining)):
        self._raise_if_dead("fleet request %d" % frid)
    with self._lock:
      self._requests.pop(frid, None)
    err = freq.error
    if isinstance(err, (sched.DeadlineExceeded, sched.RequestCancelled,
                        sched.PoisonedRequest)):
      raise err
    if err is not None:
      raise RuntimeError("fleet request %d failed" % frid) from err
    return freq.output

  def stream(self, frid: int, timeout: float = 600.0):
    """Yield generated tokens as they are produced (EOS inclusive),
    exactly once per position — across engine crash replays (the engine
    suppresses those) AND across fleet failovers to another replica:
    a new attempt regenerates from the prompt, and this relay suppresses
    (verifying) the prefix it already delivered."""
    freq = self._freq(frid)
    deadline = time.monotonic() + timeout
    t_attach = time.monotonic()
    chunk = max(0.05, self._poll)
    delivered: List[int] = []
    er = None
    er_done = False
    pos = 0
    while True:
      if time.monotonic() >= deadline:
        raise TimeoutError("stream for fleet request %d stalled" % frid)
      with self._lock:
        cur = freq.cur_req
      if cur is not er:
        er, pos, er_done = cur, 0, False   # failover: new attempt stream
      if er is None or er_done:
        if freq.done.is_set():
          break                            # terminal verdict below
        self._raise_if_dead("fleet request %d" % frid)
        time.sleep(chunk)
        continue
      try:
        tok = er.stream_q.get(timeout=chunk)
      except std_queue.Empty:
        self._raise_if_dead("fleet request %d" % frid)
        continue
      if tok is None:
        if er.error is None:
          break                            # attempt completed cleanly
        if isinstance(er.error, (sched.DeadlineExceeded,
                                 sched.RequestCancelled,
                                 sched.PoisonedRequest)):
          break                            # structured verdict below
        er_done = True                     # crashed: await the failover
        continue
      if pos < len(delivered):
        # replayed position from the new replica: suppress, but VERIFY
        # — greedy bit-identity says it matches what we delivered
        if int(tok) != delivered[pos]:
          self._count("replay_mismatches")
        pos += 1
        continue
      if not delivered:
        freq.note_first_token(time.monotonic())
      delivered.append(int(tok))
      pos += 1
      yield int(tok)
    # record the verdict ourselves instead of racing the monitor's next
    # sweep: a consumer that breaks on the sentinel and popped the
    # registry before that sweep would otherwise leave the request
    # without a terminal verdict (done never set, completed uncounted,
    # a concurrent cancel() parked until its timeout)
    if not freq.done.is_set() and er is not None and er.done.is_set():
      if er.error is None:
        self._finish_ok(freq, er)
      else:
        freq.finish(er.error)
    if self._rec is not None:
      # the delivery phase, fleet-side: the relay that survived the
      # replica hop (tokens = client-visible positions, exactly once)
      self._rec.record_span("fleet.stream", t_attach,
                            time.monotonic() - t_attach,
                            trace=freq.trace_id, frid=frid,
                            tokens=len(delivered),
                            failovers=freq.failovers)
    with self._lock:
      self._requests.pop(frid, None)
    err = freq.error if freq.done.is_set() else \
        (er.error if er is not None else None)
    if isinstance(err, (sched.DeadlineExceeded, sched.RequestCancelled,
                        sched.PoisonedRequest)):
      raise err
    if err is not None:
      raise RuntimeError("fleet request %d failed after %d token(s)"
                         % (frid, len(delivered))) from err

  def generate(self, prompts: Sequence,
               max_new_tokens: Optional[int] = None,
               timeout: float = 600.0, detailed: bool = False) -> List:
    """Submit a batch and wait for all outputs in order; a mid-list
    rejection cancels the already-submitted prefix (the engine rule).
    ``detailed=True`` returns ``{"tokens", "trace_id", "timing"}`` per
    prompt (the fleet timing ledger incl. ``failovers``), mirroring
    ``ServingEngine.generate``."""
    frids = []
    try:
      for p in prompts:
        frids.append(self.submit(p, max_new_tokens=max_new_tokens))
    except BaseException:
      for frid in frids:
        with contextlib.suppress(Exception):
          self.cancel(frid, timeout=1.0)
      raise
    deadline = time.monotonic() + timeout
    outs = []
    for frid in frids:
      freq = self._freq(frid)   # hold the handle: result() pops the map
      out = self.result(frid,
                        timeout=max(0.001, deadline - time.monotonic()))
      if detailed:
        outs.append({"tokens": out, "trace_id": freq.trace_id,
                     "timing": freq.timing()})
      else:
        outs.append(out)
    return outs

  def cancel(self, frid: int, timeout: float) -> bool:
    """Cancel a fleet request wherever it currently lives (queued on a
    replica, in flight, or between replicas awaiting failover). Blocks
    (bounded) until it finished; ``timeout`` required (TOS001)."""
    freq = self._freq(frid)
    if freq.done.is_set():
      return True
    freq.cancelled.set()
    with self._lock:
      er = freq.cur_req
    if er is not None:
      er.cancelled.set()                   # the replica reaps it
    freq.done.wait(timeout=timeout)
    return freq.done.is_set()

  # -- rolling swap & the deploy-plane surface -------------------------------

  def swap_replica(self, rid: int, timeout: float,
                   engine_factory: Optional[Callable] = None,
                   version=None) -> dict:
    """Zero-shed swap of ONE replica: mark it DRAINING (dispatch shifts
    to the others), drain it through the engine's zero-shed ``drain()``
    contract, then swap in a fresh engine from ``engine_factory``
    (default: the fleet's own factory). The canary move in the deploy
    state machine — and the unit :meth:`rolling_swap` iterates.
    ``version`` (when given) updates the replica's entry in the served-
    version map. A drain that times out still sheds nothing: leftovers
    fail over to live replicas and replay. ``timeout`` required
    (TOS001, the drain rule)."""
    rep = self._replicas[rid]
    if rep.state == EJECTED:
      return {"replica": rid, "skipped": "ejected"}
    factory = engine_factory if engine_factory is not None \
        else self._factory
    with self._lock:
      rep.state = DRAINING                 # dispatch skips it from here
    self._event("swap_start", replica=rid)
    drained = rep.engine.drain(timeout=timeout)
    new_eng = factory()
    new_eng.start()
    with self._lock:
      rep.engine = new_eng
      rep.state = ACTIVE
      rep.probe_fails = 0
      rep.generation += 1
      if version is not None:
        self._versions[rid] = version
    self._count("swaps")
    self._event("swap_done", replica=rid, drained=bool(drained),
                generation=rep.generation,
                **({} if version is None else {"model_version": version}))
    return {"replica": rid, "drained": bool(drained),
            "generation": rep.generation}

  def rolling_swap(self, timeout: float,
                   engine_factory: Optional[Callable] = None,
                   version=None) -> dict:
    """Fleet-wide zero-shed param swap: one replica at a time through
    :meth:`swap_replica` — pass an ``engine_factory`` closing over new
    params to re-param the whole fleet with zero accepted requests shed.
    ``timeout`` bounds EACH replica's drain and is required (TOS001)."""
    if engine_factory is not None:
      self._factory = engine_factory       # future ejection rebuilds too
    report = [self.swap_replica(rid, timeout,
                                engine_factory=engine_factory,
                                version=version)
              for rid in sorted(self._replicas)]
    return {"swapped": sum(1 for r in report if "drained" in r),
            "replicas": report}

  def set_canary(self, rid: int, every: int) -> None:
    """Route every ``every``-th placement round to replica ``rid`` first
    (the canary traffic slice, deterministic by construction); all other
    rounds keep baseline traffic off it. ``every=4`` ≈ a 25% slice."""
    if rid not in self._replicas:
      raise KeyError("unknown replica id %r" % (rid,))
    if every < 1:
      raise ValueError("canary slice divisor must be >= 1, got %d" % every)
    with self._lock:
      self._canary = {"rid": int(rid), "every": int(every), "counter": 0}

  def clear_canary(self) -> None:
    with self._lock:
      self._canary = None

  @property
  def canary_rid(self) -> Optional[int]:
    with self._lock:
      return None if self._canary is None else self._canary["rid"]

  def set_replica_version(self, rid: int, version) -> None:
    """Record which registry version replica ``rid`` serves — stamped
    onto every request it answers (timing ledger + dispatch span)."""
    with self._lock:
      self._versions[int(rid)] = version

  def served_versions(self) -> Dict[int, object]:
    """{replica id: model version} over non-ejected replicas (None for
    replicas never stamped) — the deploy controller's consistency read."""
    with self._lock:
      return {rid: self._versions.get(rid)
              for rid, rep in self._replicas.items()
              if rep.state != EJECTED}

  def add_replica(self, engine_factory: Optional[Callable] = None,
                  version=None) -> int:
    """Grow the fleet by one replica (from ``engine_factory`` or the
    fleet's current factory); returns the new replica id. Started
    immediately when the fleet runs. Unbounded on purpose — the CAPPED
    entry point is :meth:`on_saturated`."""
    factory = engine_factory if engine_factory is not None \
        else self._factory
    eng = factory()
    t = self._thread
    if t is not None and t.is_alive():
      eng.start()
    with self._lock:
      rid = (max(self._replicas) + 1) if self._replicas else 0
      self._replicas[rid] = Replica(rid, eng)
      self.num_replicas += 1
      if version is not None:
        self._versions[rid] = version
    self._count("scale_ups")
    self._event("scale_up", replica=rid, total=self.num_replicas)
    return rid

  def on_saturated(self, engine_factory: Optional[Callable] = None) -> bool:
    """Capped scale-up hook: when the fleet is saturated (every live
    replica rejecting — the condition the ``fleet_saturated`` detector
    alerts on), add ONE replica, bounded by ``max_replicas`` /
    ``TOS_FLEET_MAX_REPLICAS``. OFF unless that bound is configured
    (saturation stays signal-only, the pre-existing behavior). Called
    automatically from the submit retry path; also callable by an
    external actuator reacting to the detector's alert. Returns True
    when a replica was added."""
    if self.max_replicas is None:
      return False
    with self._lock:
      live = sum(1 for rep in self._replicas.values()
                 if rep.state != EJECTED)
    if live >= self.max_replicas:
      return False
    self.add_replica(engine_factory)
    return True

  # -- ejection & failover ---------------------------------------------------

  def _kill_replica(self, rep: Replica, cause: BaseException) -> None:
    """Chaos/test seam: terminal replica death + immediate ejection."""
    rep.engine.kill(cause)
    self._eject(rep, "chaos-kill", cause)

  def _eject(self, rep: Replica, reason: str,
             cause: Optional[BaseException]) -> None:
    """Remove a replica from dispatch and fail over everything it had
    accepted but not finished. Idempotent (check-and-set under the
    fleet lock): the monitor and a chaos kill can race here safely."""
    with self._lock:
      if rep.state == EJECTED:
        return
      rep.state = EJECTED
      rep.reason = reason
      victims = [freq for freq in self._requests.values()
                 if freq.cur_replica == rep.rid
                 and not freq.done.is_set()]
    self._count("ejections")
    self._event("eject", replica=rep.rid, reason=reason,
                victims=len(victims), cause=repr(cause)[:200])
    err = cause if cause is not None else RuntimeError(
        "replica %d ejected (%s)" % (rep.rid, reason))
    for freq in victims:
      self._begin_failover(freq, err)
    self._place_pending(time.monotonic())
    # best-effort isolation AND resource release: stop() is idempotent
    # and safe on a dead engine, and it is what drops the engine's KV
    # slab (kill/_die leave it allocated) — skipping it for an
    # already-dead replica would pin a full slab's device memory for the
    # fleet's remaining lifetime while it serves degraded
    with contextlib.suppress(Exception):
      rep.engine.stop(timeout=1.0)

  def _begin_failover(self, freq: FleetRequest, cause: BaseException,
                      expect=None) -> None:
    """Detach a request from its dead replica and queue it for
    resubmission — capturing the emitted prefix first so the stream
    relay and the final-output verification can hold the exactly-once /
    bit-identical line across the hop.

    Exactly-once per attempt: the ejection path (which can run on a
    CLIENT thread via a chaos kill) and the monitor's completion sweep
    can both reach here for the same request — an already-detached
    request (``cur_req`` None) or one the sweep saw under a STALE
    handle (``expect`` no longer current) is left alone, so a request
    is never queued for failover twice off one death."""
    with self._lock:
      er = freq.cur_req
      if er is None or (expect is not None and er is not expect):
        return
      if len(er.tokens) > len(freq.prev_tokens):
        freq.prev_tokens = list(er.tokens)
      freq.note_first_token(er.first_token_at)
      freq.cur_req = None
      freq.cur_replica = None
      freq.cur_rid = None
      freq.failovers += 1
      over = freq.failovers > self.max_failovers
    if over:
      self._count("shed")
      err = RuntimeError(
          "fleet request %d failed over %d times (max %d) — not "
          "resubmitted" % (freq.frid, freq.failovers - 1,
                           self.max_failovers))
      err.__cause__ = cause
      freq.finish(err)
      return
    self._count("failovers")
    self._event("failover", frid=freq.frid, attempt=freq.failovers,
                emitted=len(freq.prev_tokens), trace=freq.trace_id)
    with self._lock:
      self._pending.append(freq)

  def _place_pending(self, now: float) -> None:
    """Resubmit failed-over requests to live replicas. Rejections keep
    the request pending with a ``retry_after``-honoring next-try time
    (the monitor cadence is the backoff floor), so failover replay
    respects the same admission bounds as fresh traffic without ever
    busy-spinning."""
    with self._lock:
      pending, self._pending = list(self._pending), collections.deque()
    keep = []
    for freq in pending:
      if freq.done.is_set():
        continue
      if freq.cancelled.is_set():
        freq.finish(sched.RequestCancelled(
            "fleet request %d cancelled" % freq.frid))
        continue
      if freq.expired(now):
        freq.finish(sched.DeadlineExceeded(
            "fleet request %d deadline passed awaiting failover"
            % freq.frid))
        continue
      if now < freq.next_try:
        keep.append(freq)
        continue
      if self.active_replicas == 0:
        if all(rep.state == EJECTED for rep in self._replicas.values()):
          self._count("shed")
          freq.finish(RuntimeError(
              "fleet request %d lost its replica and no live replica "
              "remains" % freq.frid))
          continue
        keep.append(freq)                  # draining swap: wait it out
        continue
      hint = self._try_place(freq)
      if hint is None:
        self._count("replays")
        continue
      self._count("retries")
      freq.next_try = now + (hint if hint != float("inf")
                             else _DEFAULT_RETRY_SLEEP)
      keep.append(freq)
    if keep:
      with self._lock:
        self._pending.extend(keep)

  # -- the monitor loop ------------------------------------------------------

  def _monitor(self) -> None:
    while not self._stop_evt.wait(self._poll):
      try:
        now = time.monotonic()
        self._check_replicas(now)
        self._place_pending(now)
        self._check_completions()
        self._update_gauges()
      except Exception:  # noqa: BLE001 - the monitor must outlive any
        # single pass's bug (the ClusterSupervisor._loop rule); the
        # engines keep serving without it, and the failure is VISIBLE:
        # counted + logged with the trace
        self._count("monitor_failures")
        logger.exception("fleet monitor pass failed")

  def _check_replicas(self, now: float) -> None:
    for rep in list(self._replicas.values()):
      if rep.state == EJECTED:
        continue
      eng = rep.engine
      if not eng.alive:
        if rep.state == DRAINING:
          continue   # a swap owns this engine's lifecycle right now
        self._eject(rep, "died", eng._loop_error
                    or RuntimeError("replica %d engine stopped"
                                    % rep.rid))
        continue
      if self.health_probe is None:
        continue
      try:
        ok = bool(self.health_probe(rep))
      except Exception:  # noqa: BLE001 - a raising probe IS a failed
        ok = False                         # probe, not a monitor crash
      if ok:
        rep.probe_fails = 0
        continue
      rep.probe_fails += 1
      if rep.probe_fails >= self.probe_fails:
        self._eject(rep, "unresponsive", RuntimeError(
            "replica %d failed %d consecutive health probes"
            % (rep.rid, rep.probe_fails)))

  def _check_completions(self) -> None:
    with self._lock:
      snapshot = [(freq, freq.cur_req) for freq in
                  self._requests.values()
                  if not freq.done.is_set() and freq.cur_req is not None]
    for freq, er in snapshot:
      if not er.done.is_set():
        continue
      err = er.error
      if err is None:
        self._finish_ok(freq, er)
      elif isinstance(err, (sched.DeadlineExceeded,
                            sched.RequestCancelled,
                            sched.PoisonedRequest)):
        freq.finish(err)
      else:
        # the replica died/stopped under it: replay it elsewhere (the
        # expect guard makes this a no-op if the ejection path already
        # detached it, or if it was re-placed since the snapshot)
        self._begin_failover(freq, err, expect=er)

  def _finish_ok(self, freq: FleetRequest, er) -> None:
    toks = list(er.tokens)
    freq.note_first_token(er.first_token_at)
    if not freq.finish(None, output=np.concatenate(
        [freq.prompt, np.asarray(toks, np.int32)])):
      return    # someone else (monitor vs stream consumer) got here first
    prev = freq.prev_tokens
    if prev and toks[:len(prev)] != prev[:len(toks)]:
      # the replayed output must re-derive what the dead attempt
      # emitted (greedy bit-identity) — count divergence, never hide it
      self._count("replay_mismatches")
    self._count("completed")

  def _update_gauges(self) -> None:
    if self._obs_g is None:
      return
    active = [rep for rep in self._replicas.values()
              if rep.state == ACTIVE and rep.engine.alive]
    draining = sum(1 for rep in self._replicas.values()
                   if rep.state == DRAINING)
    self._obs_g["replicas_total"].set(self.num_replicas)
    self._obs_g["replicas_active"].set(len(active))
    # a DRAINING replica is a healthy swap in progress, not lost
    # capacity: the fleet_degraded detector keys on active + draining
    # so a routine rolling swap never reads as an ejection
    self._obs_g["replicas_draining"].set(draining)
    self._obs_g["queue_depth"].set(
        sum(rep.engine.queue_depth for rep in active))
    if active:
      self._obs_g["occupancy"].set(
          sum(rep.engine.occupancy_now for rep in active) / len(active))
