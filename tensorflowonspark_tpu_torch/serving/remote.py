"""Driver-side half of the cross-host serving plane.

The port's copy of ``tensorflowonspark_tpu/serving/remote.py``, on the
same wire. With ``serving/host.py`` (the executor half) it moves the
fleet's replicas out of the driver: a :class:`ServingHostPlane` attaches
to the rendezvous :class:`~..control.rendezvous.Server` and serves three
wire verbs, ``SHREG`` (a ServingHost announces itself), ``SHSYNC`` (the
host's heartbeat with payload: it pushes request events and load stats,
and pulls queued commands) and ``SHBYE`` (clean departure), while a
:class:`RemoteReplica` proxy satisfies the replica surface
:class:`~.fleet.ServingFleet` dispatches against (``submit``/``request``/
``result``/``stream``/``cancel``/``drain``/``kill``/``stop``/``start``/
``generate``, ``alive``, ``_loop_error``, and the load-score properties
``queue_depth``/``queued_tokens``/``tokens_per_sec``/``occupancy_now``).
So the fleet routes, retries, ejects, replays and swaps across process
boundaries without modification.

Wire discipline: the rendezvous server refuses frames over
``MAX_MESSAGE_BYTES`` (4 MB), so nothing here ships a fat message.
Prompts larger than ``TOS_HOST_CHUNK`` tokens are staged in parts
(``stage`` commands reassembled host-side), command pulls and token
pushes are budgeted per sync frame, and everything else on the wire is
small structured metadata.

Greedy decode is bit-identical, so replicas stay interchangeable whether
they share the driver's address space or not. A host that dies (SIGKILL,
OOM, preemption, or ``TOS_CHAOS_HOST``) simply stops syncing; its
:class:`RemoteReplica` reads ``alive`` False after ``TOS_HOST_TIMEOUT``
silent seconds, the fleet ejects it, and the mirror's received-token
prefix feeds the fleet's failover replay with exactly-once stream
positions.

Structured exceptions cross the wire as field dicts and are rebuilt
driver-side (``ServingOverloaded`` keeps ``queue_depth``/
``queued_tokens``/``retry_after``/``draining``; ``DeadlineExceeded``/
``RequestCancelled``/``PoisonedRequest`` keep their types). Deadlines
are absolute ``time.monotonic()`` values, and monotonic clocks do not
travel: the proxy converts to a remaining TTL at send time and the host
re-anchors it (``ServingEngine.submit(ttl=...)``).

Usage (driver)::

    server = rendezvous.Server(...); addr = server.start()
    plane = remote.attach_serving_plane(server)
    # ... ServingHost processes dial in (serving/host.py) ...
    plane.await_hosts(2, timeout=60)
    fleet = ServingFleet(remote.remote_engine_factory(plane),
                         num_replicas=2,
                         health_probe=remote.wire_health_probe(addr))
"""

import collections
import itertools
import logging
import os
import queue as std_queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from tensorflowonspark_tpu_torch.obs import metrics as obs_metrics
from tensorflowonspark_tpu_torch.serving import scheduler as sched

logger = logging.getLogger(__name__)

#: seconds of SHSYNC silence after which a serving host is presumed dead
#: (its RemoteReplicas flip ``alive`` False and the fleet ejects them)
ENV_HOST_TIMEOUT = "TOS_HOST_TIMEOUT"
#: bound on the proxy's wait for a submit's accept/reject ack
ENV_HOST_ADMIT = "TOS_HOST_ADMIT_TIMEOUT"
#: bound on ``RemoteReplica.start()`` — the host-side engine build
#: (registry watch + params load + engine start) must ack within this
ENV_HOST_START = "TOS_HOST_START_TIMEOUT"
#: max payload tokens per wire frame (prompt parts, token pushes,
#: command pulls are all budgeted against it) — the chunked-framing
#: knob that keeps every frame far under ``MAX_MESSAGE_BYTES``
ENV_HOST_CHUNK = "TOS_HOST_CHUNK"

_DEFAULT_TIMEOUT = 2.0
_DEFAULT_ADMIT = 10.0
_DEFAULT_START = 120.0
_DEFAULT_CHUNK = 65536
#: fallback generation budget before the host's build ack reports the
#: real engine default (fleet.submit only consults it when the caller
#: passed no ``max_new_tokens``)
_FALLBACK_MAX_NEW_TOKENS = 64
#: done mirrors kept for late ``request()`` lookups before pruning
_MIRROR_KEEP = 1024

_tids = itertools.count(1)
_bids = itertools.count(1)


def _env_float(name: str, default: float) -> float:
  return float(os.environ.get(name, str(default)))


def _env_int(name: str, default: int) -> int:
  return int(os.environ.get(name, str(default)))


def encode_error(e: BaseException) -> dict:
  """Structured serving exception -> wire fields (msgpack-safe)."""
  if isinstance(e, sched.ServingOverloaded):
    return {"kind": "overloaded", "msg": str(e),
            "queue_depth": e.queue_depth, "queued_tokens": e.queued_tokens,
            "retry_after": e.retry_after, "draining": bool(e.draining)}
  if isinstance(e, sched.DeadlineExceeded):
    return {"kind": "deadline", "msg": str(e)}
  if isinstance(e, sched.RequestCancelled):
    return {"kind": "cancelled", "msg": str(e)}
  if isinstance(e, sched.PoisonedRequest):
    return {"kind": "poisoned", "msg": str(e)}
  if isinstance(e, ValueError):
    return {"kind": "value", "msg": str(e)}
  return {"kind": "runtime", "msg": repr(e)}


def decode_error(d: Optional[dict]) -> Optional[BaseException]:
  """Wire fields -> the structured exception, type preserved — the
  fleet's verdict handling (DeadlineExceeded/RequestCancelled/
  PoisonedRequest re-raised, everything else a failover cause) must
  behave identically for a remote replica."""
  if d is None:
    return None
  kind, msg = d.get("kind"), d.get("msg", "")
  if kind == "overloaded":
    return sched.ServingOverloaded(
        msg, queue_depth=d.get("queue_depth"),
        queued_tokens=d.get("queued_tokens"),
        retry_after=d.get("retry_after"),
        draining=bool(d.get("draining")))
  if kind == "deadline":
    return sched.DeadlineExceeded(msg)
  if kind == "cancelled":
    return sched.RequestCancelled(msg)
  if kind == "poisoned":
    return sched.PoisonedRequest(msg)
  if kind == "value":
    return ValueError(msg)
  return RuntimeError(msg)


class _CancelEvent(threading.Event):
  """An Event whose first ``set()`` also fires a callback — the fleet
  cancels by calling ``handle.cancelled.set()`` directly on the request
  handle (``ServingFleet.cancel`` / the ``_assign`` race path), and for
  a remote mirror that set must ALSO enqueue the cancel command."""

  def __init__(self, on_set: Callable[[], None]):
    super().__init__()
    self._on_set = on_set

  def set(self) -> None:  # noqa: A003 - Event API
    first = not self.is_set()
    super().set()
    if first:
      try:
        self._on_set()
      except Exception:  # noqa: BLE001 # tosa: ignore[TOS004] - a cancel
        # relay failure must not poison the caller (set() is called from
        # fleet routing paths); the host-side TTL still bounds the request
        logger.warning("remote cancel relay failed", exc_info=True)


class RemoteRequest(object):
  """Driver-side mirror of one host-side engine request — the handle
  shape ``ServingFleet`` consumes (``stream_q``/``tokens``/``done``/
  ``error``/``cancelled``/``first_token_at``), fed by SHSYNC events
  applied on the rendezvous serve thread. ``tokens`` is exactly the
  prefix the host streamed, so ``_begin_failover`` captures the same
  replay baseline it would from a local request."""

  __slots__ = ("tid", "prompt", "max_new_tokens", "trace_id", "stream_q",
               "tokens", "done", "error", "cancelled", "first_token_at",
               "admitted", "rejection", "submitted_at")

  def __init__(self, prompt: np.ndarray, max_new_tokens: int,
               trace_id, on_cancel: Callable[[], None]):
    self.tid = next(_tids)
    self.prompt = prompt
    self.max_new_tokens = int(max_new_tokens)
    self.trace_id = trace_id
    self.stream_q: std_queue.Queue = std_queue.Queue()
    self.tokens: List[int] = []
    self.done = threading.Event()
    self.error: Optional[BaseException] = None
    self.cancelled = _CancelEvent(on_cancel)
    self.first_token_at: Optional[float] = None
    #: admission verdict: set once the host acked (rejection None) or
    #: rejected (rejection holds the reconstructed exception)
    self.admitted = threading.Event()
    self.rejection: Optional[BaseException] = None
    self.submitted_at = time.monotonic()

  def _apply_tokens(self, pos: int, toks) -> None:
    """Apply a position-stamped token delta exactly once: ``pos`` is
    the stream index of ``toks[0]``, so a resend after a flaky sync
    (the host requeues unacked events) appends only the unseen suffix
    — stream positions stay exactly-once BY CONSTRUCTION, not by
    hoping the wire never retries."""
    skip = len(self.tokens) - int(pos)
    if skip < 0:
      # a gap would mean the host skipped an event — the wire is an
      # ordered per-host FIFO, so this is a protocol bug, not weather
      raise RuntimeError(
          "token gap for request %d: have %d, delta starts at %d"
          % (self.tid, len(self.tokens), int(pos)))
    fresh = toks[skip:] if skip else toks
    if self.first_token_at is None and fresh:
      self.first_token_at = time.monotonic()
    for t in fresh:
      t = int(t)
      self.tokens.append(t)
      self.stream_q.put_nowait(t)         # unbounded: never blocks

  def _finish(self, error: Optional[BaseException]) -> None:
    if self.done.is_set():
      return
    self.error = error
    self.stream_q.put_nowait(None)        # unbounded: never blocks
    self.done.set()


class _HostRecord(object):
  """One registered ServingHost as the plane sees it."""

  __slots__ = ("host_id", "meta", "last_sync", "stats", "cmds", "mirrors",
               "builds", "drains", "stops", "departed", "reserved")

  def __init__(self, host_id: int, meta: dict):
    self.host_id = int(host_id)
    self.meta = dict(meta or {})
    self.last_sync = time.monotonic()
    #: latest host-shipped load/liveness stats (SHSYNC payload)
    self.stats: dict = {}
    self.cmds: collections.deque = collections.deque()
    #: tid -> RemoteRequest mirror awaiting events
    self.mirrors: Dict[int, RemoteRequest] = {}
    #: bid -> {"done": Event, "reply": dict} build acks
    self.builds: Dict[int, dict] = {}
    self.drains: Dict[int, dict] = {}
    self.stops: Dict[int, threading.Event] = {}
    self.departed = False
    #: the RemoteReplica currently bound to this host (the swap
    #: allocator's bookkeeping), None when free
    self.reserved: Optional["RemoteReplica"] = None


class ServingHostPlane(object):
  """The driver-side state behind the SHREG/SHSYNC/SHBYE verbs.

  Passive by construction: everything happens inside :meth:`handle`
  calls on the rendezvous serve thread (which must never block) or
  inside proxy calls on fleet/client threads — there is no thread here.
  Host death is therefore an *absence*: :meth:`host_alive` compares the
  last SHSYNC age against ``TOS_HOST_TIMEOUT`` at read time.
  """

  def __init__(self, timeout: Optional[float] = None,
               chunk: Optional[int] = None):
    self.timeout = float(timeout if timeout is not None
                         else _env_float(ENV_HOST_TIMEOUT, _DEFAULT_TIMEOUT))
    self.chunk = max(256, int(chunk if chunk is not None
                              else _env_int(ENV_HOST_CHUNK, _DEFAULT_CHUNK)))
    self._lock = threading.Lock()
    self._hosts: Dict[int, _HostRecord] = {}
    self.stats = {"registrations": 0, "syncs": 0, "events": 0,
                  "commands": 0, "bad_messages": 0}
    reg = obs_metrics.active()
    self._g_total = None if reg is None else reg.gauge("serve.hosts_total")
    self._g_alive = None if reg is None else reg.gauge("serve.hosts_alive")

  # -- wire side (rendezvous serve thread) -----------------------------------

  def handle(self, msg: dict) -> dict:
    """Dispatch one serving-plane wire message; always returns a reply
    dict (the Server arm sends it verbatim)."""
    mtype = msg.get("type")
    try:
      if mtype == "SHREG":
        return self._handle_reg(msg)
      if mtype == "SHSYNC":
        return self._handle_sync(msg)
      if mtype == "SHBYE":
        return self._handle_bye(msg)
    except Exception as e:  # noqa: BLE001 - a malformed host payload must
      # degrade to an ERROR reply, never a dead rendezvous serve loop
      self.stats["bad_messages"] += 1
      logger.warning("serving plane failed on %s: %s", mtype, e)
      return {"type": "ERROR", "error": str(e)}
    return {"type": "ERROR", "error": "unknown serving verb %r" % mtype}

  def _handle_reg(self, msg: dict) -> dict:
    hid = int(msg["host_id"])
    with self._lock:
      rec = self._hosts.get(hid)
      if rec is None:
        self._hosts[hid] = _HostRecord(hid, msg.get("meta"))
      else:
        # a re-registration (lost reply, or a relaunched host process
        # reclaiming its slot): refresh liveness, keep queued commands
        rec.meta = dict(msg.get("meta") or {})
        rec.last_sync = time.monotonic()
        rec.departed = False
      self.stats["registrations"] += 1
    self._refresh_gauges()
    return {"type": "OK", "timeout": self.timeout, "chunk": self.chunk}

  def _handle_sync(self, msg: dict) -> dict:
    hid = int(msg["host_id"])
    with self._lock:
      rec = self._hosts.get(hid)
      if rec is None:
        # syncing without registering (plane restarted under the host):
        # tell it to re-register rather than invent a half-known host
        return {"type": "ERROR", "error": "unregistered host %d" % hid}
      rec.last_sync = time.monotonic()
      rec.departed = False
      if isinstance(msg.get("stats"), dict):
        rec.stats = msg["stats"]
      events = msg.get("events") or ()
      cmds = self._pop_cmds_locked(rec)
      self.stats["syncs"] += 1
      self.stats["events"] += len(events)
      self.stats["commands"] += len(cmds)
    # events are applied outside the hosts lock: they touch per-mirror
    # state only, and a waiter woken by an ack may immediately call back
    # into the plane (reserve/release) which takes the lock
    for ev in events:
      self._apply_event(rec, ev)
    self._refresh_gauges()
    return {"type": "OK", "cmds": cmds, "server_time": time.monotonic()}

  def _handle_bye(self, msg: dict) -> dict:
    hid = int(msg["host_id"])
    with self._lock:
      rec = self._hosts.get(hid)
      if rec is not None:
        rec.departed = True
    self._refresh_gauges()
    return {"type": "OK"}

  def _pop_cmds_locked(self, rec: _HostRecord) -> List[dict]:
    """Pop queued commands up to the per-frame chunk budget (prompt and
    stage payload tokens count against it; at least one command always
    ships so an oversized-looking queue can never wedge)."""
    out: List[dict] = []
    budget = self.chunk
    while rec.cmds:
      cmd = rec.cmds[0]
      cost = len(cmd.get("prompt") or ()) + len(cmd.get("part") or ())
      if out and cost > budget:
        break
      out.append(rec.cmds.popleft())
      budget -= cost
      if budget <= 0 or len(out) >= 64:
        break
    return out

  def _apply_event(self, rec: _HostRecord, ev: dict) -> None:
    kind = ev.get("ev")
    if kind == "tok":
      m = rec.mirrors.get(ev.get("tid"))
      if m is not None:
        m._apply_tokens(int(ev.get("pos", 0)), ev.get("toks") or ())
    elif kind == "done":
      m = rec.mirrors.get(ev.get("tid"))
      if m is not None:
        m._finish(decode_error(ev.get("error")))
    elif kind == "acc":
      m = rec.mirrors.get(ev.get("tid"))
      if m is not None:
        m.admitted.set()
    elif kind == "rej":
      m = rec.mirrors.get(ev.get("tid"))
      if m is not None:
        m.rejection = decode_error(ev.get("error")) or RuntimeError(
            "host %d rejected request" % rec.host_id)
        m.admitted.set()
        m._finish(m.rejection)
    elif kind == "built":
      slot = rec.builds.get(ev.get("bid"))
      if slot is not None:
        slot["reply"] = ev
        slot["done"].set()
    elif kind == "drained":
      slot = rec.drains.get(ev.get("did"))
      if slot is not None:
        slot["reply"] = ev
        slot["done"].set()
    elif kind == "stopped":
      done = rec.stops.get(ev.get("sid"))
      if done is not None:
        done.set()
    else:
      self.stats["bad_messages"] += 1
      logger.warning("serving plane: unknown host event %r from host %d",
                     kind, rec.host_id)

  # -- driver side (fleet / proxy threads) -----------------------------------

  def _rec(self, host_id: int) -> _HostRecord:
    with self._lock:
      try:
        return self._hosts[int(host_id)]
      except KeyError:
        raise KeyError("unknown serving host %r" % (host_id,))

  def enqueue(self, host_id: int, cmd: dict) -> None:
    self._rec(host_id).cmds.append(cmd)

  def host_alive(self, host_id: int) -> bool:
    with self._lock:
      rec = self._hosts.get(int(host_id))
      if rec is None or rec.departed:
        return False
      return (time.monotonic() - rec.last_sync) <= self.timeout

  def host_ids(self) -> List[int]:
    with self._lock:
      return sorted(self._hosts)

  def await_hosts(self, count: int, timeout: float) -> List[int]:
    """Block (bounded) until ``count`` hosts have registered and are
    syncing; returns their ids. The cross-host analogue of
    ``Server.await_reservations``."""
    deadline = time.monotonic() + float(timeout)
    while True:
      live = [h for h in self.host_ids() if self.host_alive(h)]
      if len(live) >= count:
        return live[:count]
      if time.monotonic() >= deadline:
        raise TimeoutError(
            "only %d/%d serving host(s) registered within %.1fs"
            % (len(live), count, timeout))
      time.sleep(0.05)

  def status(self) -> Dict[str, dict]:
    """{host_id: liveness + load row} — the HEALTH enrichment payload
    (``reply["hosts"]``) that ``obs_top`` renders and
    :func:`wire_health_probe` keys ejection on. String keys, matching
    the liveness snapshot convention."""
    now = time.monotonic()
    out: Dict[str, dict] = {}
    with self._lock:
      for hid, rec in self._hosts.items():
        age = now - rec.last_sync
        alive = (not rec.departed) and age <= self.timeout
        st = rec.stats
        out[str(hid)] = {
            "alive": bool(alive),
            "state": ("departed" if rec.departed
                      else ("live" if alive else "lost")),
            "age": round(age, 3),
            "engine_alive": bool(st.get("engine_alive", False)),
            "generation": int(st.get("generation", 0)),
            "version": st.get("version"),
            "queue_depth": int(st.get("queue_depth", 0)),
            "queued_tokens": int(st.get("queued_tokens", 0)),
            "tokens_per_sec": float(st.get("tokens_per_sec", 0.0)),
            "occupancy_now": float(st.get("occupancy_now", 0.0)),
            "requests": len(rec.mirrors),
        }
    return out

  def _refresh_gauges(self) -> None:
    if self._g_total is None:
      return
    now = time.monotonic()
    with self._lock:
      total = sum(1 for r in self._hosts.values() if not r.departed)
      alive = sum(1 for r in self._hosts.values()
                  if not r.departed and now - r.last_sync <= self.timeout)
    self._g_total.set(total)
    self._g_alive.set(alive)

  # -- host allocation (the swap/factory seam) -------------------------------

  def reserve(self, replica: "RemoteReplica",
              host_id: Optional[int] = None) -> int:
    """Bind a proxy to a free host (or the named one). Allocation
    prefers free+alive hosts in id order, so a freshly-constructed
    fleet maps replica k onto host k, and a ``swap_replica`` — whose
    drain released exactly one host — rebuilds on the host it drained.
    """
    with self._lock:
      if host_id is not None:
        rec = self._hosts.get(int(host_id))
        if rec is None:
          raise KeyError("unknown serving host %r" % (host_id,))
        if rec.reserved is not None and rec.reserved is not replica:
          raise RuntimeError("serving host %d already bound" % rec.host_id)
        rec.reserved = replica
        return rec.host_id
      now = time.monotonic()
      free = [r for r in sorted(self._hosts.values(),
                                key=lambda r: r.host_id)
              if r.reserved is None]
      live = [r for r in free
              if not r.departed and now - r.last_sync <= self.timeout]
      pick = (live or free or [None])[0]
      if pick is None:
        raise RuntimeError(
            "no free serving host for a new replica (%d registered, all "
            "bound)" % len(self._hosts))
      pick.reserved = replica
      return pick.host_id

  def release(self, replica: "RemoteReplica", host_id: int) -> None:
    with self._lock:
      rec = self._hosts.get(int(host_id))
      if rec is not None and rec.reserved is replica:
        rec.reserved = None

  def _prune_mirrors_locked(self, rec: _HostRecord) -> None:
    done = [tid for tid, m in rec.mirrors.items() if m.done.is_set()]
    if len(done) > _MIRROR_KEEP:
      for tid in sorted(done)[:-_MIRROR_KEEP]:
        rec.mirrors.pop(tid, None)


class RemoteReplica(object):
  """The engine-shaped proxy for one executor-resident ServingEngine.

  Satisfies the replica surface ``ServingFleet`` (and the deploy
  controller's VERIFY spot-checks) dispatch against; every method is
  timeout-bounded and host death fails waiters fast instead of hanging
  them (TOS001). One proxy binds one host *generation*: after a drain +
  rebuild (the swap path) the old proxy reads dead and a fresh proxy —
  from :func:`remote_engine_factory` — owns the host's new engine.
  """

  def __init__(self, plane: ServingHostPlane,
               host_id: Optional[int] = None, version: Optional[int] = None,
               admit_timeout: Optional[float] = None,
               start_timeout: Optional[float] = None):
    self._plane = plane
    self.version = version
    self.host_id = plane.reserve(self, host_id)
    self.admit_timeout = float(
        admit_timeout if admit_timeout is not None
        else _env_float(ENV_HOST_ADMIT, _DEFAULT_ADMIT))
    self.start_timeout = float(
        start_timeout if start_timeout is not None
        else _env_float(ENV_HOST_START, _DEFAULT_START))
    self._started = False
    self._dead = False
    self._gen: Optional[int] = None
    self.default_max_new_tokens = _FALLBACK_MAX_NEW_TOKENS
    self._lock = threading.Lock()

  # -- lifecycle -------------------------------------------------------------

  def start(self) -> "RemoteReplica":
    """Command the host to build (from its own registry view, at
    ``version`` — or the latest) and start a fresh engine; blocks until
    the build acks. Raises RuntimeError on failure/host death."""
    with self._lock:
      if self._started and not self._dead:
        return self
      if self._dead:
        raise RuntimeError("remote replica on host %d is dead"
                           % self.host_id)
      rec = self._plane._rec(self.host_id)
      bid = next(_bids)
      slot = {"done": threading.Event(), "reply": None}
      rec.builds[bid] = slot
      self._plane.enqueue(self.host_id, {
          "op": "build", "bid": bid,
          "version": None if self.version is None else int(self.version)})
      deadline = time.monotonic() + self.start_timeout
      while not slot["done"].is_set():
        if time.monotonic() >= deadline:
          rec.builds.pop(bid, None)
          raise RuntimeError(
              "serving host %d did not ack engine build within %.1fs"
              % (self.host_id, self.start_timeout))
        if not slot["done"].wait(timeout=0.05) \
            and not self._plane.host_alive(self.host_id):
          rec.builds.pop(bid, None)
          raise RuntimeError("serving host %d died during engine build"
                             % self.host_id)
      rec.builds.pop(bid, None)
      reply = slot["reply"] or {}
      if not reply.get("ok"):
        raise RuntimeError("engine build failed on host %d: %s"
                           % (self.host_id, reply.get("error")))
      self._gen = int(reply.get("generation", 0))
      self.version = reply.get("version", self.version)
      meta = reply.get("meta") or {}
      if meta.get("default_max_new_tokens"):
        self.default_max_new_tokens = int(meta["default_max_new_tokens"])
      self._started = True
      return self

  @property
  def alive(self) -> bool:
    """True before start (a constructed replica is startable — the
    engine contract); after it: the host is syncing, its engine loop is
    up, and the host still runs THIS proxy's generation."""
    if self._dead:
      return False
    if not self._started:
      return True
    if not self._plane.host_alive(self.host_id):
      return False
    st = self._plane._rec(self.host_id).stats
    return bool(st.get("engine_alive")) \
        and int(st.get("generation", -1)) == self._gen

  @property
  def _loop_error(self) -> Optional[BaseException]:
    if not self._started:
      return None
    if not self._plane.host_alive(self.host_id):
      return RuntimeError("serving host %d lost (no sync within %.1fs)"
                          % (self.host_id, self._plane.timeout))
    err = self._plane._rec(self.host_id).stats.get("loop_error")
    return None if not err else RuntimeError(str(err))

  def _mark_dead(self) -> None:
    self._dead = True
    self._plane.release(self, self.host_id)

  def kill(self, cause: Optional[BaseException] = None,
           timeout: float = 5.0) -> None:
    """Terminal-death relay: the host engine dies as if its loop
    exhausted restarts; this proxy reads dead immediately."""
    try:
      self._plane.enqueue(self.host_id, {
          "op": "kill", "cause": repr(cause) if cause else "killed"})
    except KeyError:
      pass
    self._mark_dead()

  def stop(self, timeout: float = 30.0) -> None:
    """Stop the host-side engine (idempotent, bounded, safe on a dead
    host — the ejection path calls this best-effort)."""
    if self._dead:
      return
    try:
      rec = self._plane._rec(self.host_id)
    except KeyError:
      self._dead = True
      return
    sid = next(_bids)
    done = threading.Event()
    rec.stops[sid] = done
    self._plane.enqueue(self.host_id, {"op": "stop", "sid": sid,
                                       "timeout": float(timeout)})
    deadline = time.monotonic() + max(0.1, float(timeout))
    while not done.is_set() and time.monotonic() < deadline:
      if not self._plane.host_alive(self.host_id):
        break
      done.wait(timeout=0.05)
    rec.stops.pop(sid, None)
    self._mark_dead()

  def drain(self, timeout: float) -> bool:
    """Zero-shed drain of the host engine (the swap move): close its
    admission, finish accepted work, stop. True when everything
    completed in time. The host reservation is released on return so
    the NEXT factory build lands on this freshly-drained host."""
    rec = self._plane._rec(self.host_id)
    did = next(_bids)
    slot = {"done": threading.Event(), "reply": None}
    rec.drains[did] = slot
    self._plane.enqueue(self.host_id, {"op": "drain", "did": did,
                                       "timeout": float(timeout)})
    # margin: the drain itself is bounded by ``timeout`` host-side; the
    # ack just needs one more sync hop (plus scheduling slack)
    deadline = time.monotonic() + float(timeout) + \
        max(1.0, 3 * self._plane.timeout)
    ok = False
    while time.monotonic() < deadline:
      if slot["done"].wait(timeout=0.05):
        ok = bool((slot["reply"] or {}).get("ok"))
        break
      if not self._plane.host_alive(self.host_id):
        break
    rec.drains.pop(did, None)
    self._mark_dead()
    return ok

  # -- client API ------------------------------------------------------------

  def submit(self, prompt, max_new_tokens: Optional[int] = None,
             deadline: Optional[float] = None,
             ttl: Optional[float] = None,
             trace_id: Optional[str] = None) -> int:
    """Queue one prompt on the remote engine; returns the request id.

    Blocks (bounded by ``TOS_HOST_ADMIT_TIMEOUT``) for the host's
    admission verdict so overload/validation surface EXACTLY like a
    local engine: ``ServingOverloaded`` with its structured hint,
    ``DeadlineExceeded`` for dead-on-arrival, RuntimeError when the
    host/engine is gone. The driver's absolute deadline travels as
    remaining-TTL (monotonic clocks don't cross processes)."""
    if self._dead or not self._started:
      raise RuntimeError("remote replica on host %d is not serving"
                         % self.host_id)
    arr = np.asarray(prompt, np.int32).ravel()
    if len(arr) < 1:
      raise ValueError("prompt must contain at least one token")
    if deadline is not None and ttl is not None:
      raise ValueError("pass deadline OR ttl, not both")
    if deadline is not None:
      ttl = deadline - time.monotonic()
    if ttl is not None and ttl <= 0:
      raise sched.DeadlineExceeded(
          "request dead on arrival: its deadline already passed at submit")
    rec = self._plane._rec(self.host_id)
    plist = [int(t) for t in arr]
    mirror = RemoteRequest(arr, max_new_tokens
                           if max_new_tokens is not None
                           else self.default_max_new_tokens, trace_id,
                           on_cancel=lambda: self._relay_cancel())
    rec.mirrors[mirror.tid] = mirror
    with self._plane._lock:
      self._plane._prune_mirrors_locked(rec)
    # chunked framing: a prompt over the per-frame budget is staged in
    # parts and reassembled host-side — no frame ever nears the 4 MB
    # rendezvous cap
    chunk = self._plane.chunk
    staged = 0
    if len(plist) > chunk:
      for seq, off in enumerate(range(0, len(plist), chunk)):
        self._plane.enqueue(self.host_id, {
            "op": "stage", "tid": mirror.tid, "seq": seq,
            "part": plist[off:off + chunk]})
        staged += 1
    cmd = {"op": "submit", "tid": mirror.tid,
           "max_new_tokens": int(mirror.max_new_tokens),
           "ttl": None if ttl is None else float(ttl),
           "trace_id": trace_id, "staged": staged}
    if not staged:
      cmd["prompt"] = plist
    self._plane.enqueue(self.host_id, cmd)
    mirror.cancelled._on_set = lambda: self._send_cancel(mirror.tid)
    admit_deadline = time.monotonic() + self.admit_timeout
    while not mirror.admitted.is_set():
      if time.monotonic() >= admit_deadline:
        rec.mirrors.pop(mirror.tid, None)
        raise RuntimeError(
            "serving host %d did not ack submit within %.1fs"
            % (self.host_id, self.admit_timeout))
      if not mirror.admitted.wait(timeout=0.05) and not self.alive:
        rec.mirrors.pop(mirror.tid, None)
        raise RuntimeError("remote replica on host %d died during submit"
                           % self.host_id)
    if mirror.rejection is not None:
      rec.mirrors.pop(mirror.tid, None)
      raise mirror.rejection
    return mirror.tid

  def _relay_cancel(self) -> None:
    # placeholder until the mirror's tid exists; submit() rebinds to
    # _send_cancel(tid) right after constructing the mirror
    pass

  def _send_cancel(self, tid: int) -> None:
    try:
      self._plane.enqueue(self.host_id, {"op": "cancel", "tid": tid})
    except KeyError:
      pass

  def request(self, rid: int) -> RemoteRequest:
    rec = self._plane._rec(self.host_id)
    try:
      return rec.mirrors[rid]
    except KeyError:
      raise KeyError("unknown remote request id %r" % (rid,))

  def result(self, rid: int, timeout: float = 600.0) -> np.ndarray:
    """Block (bounded) for one request's output (prompt + generated),
    failing fast when the host dies — the engine waiter contract."""
    m = self.request(rid)
    deadline = time.monotonic() + float(timeout)
    while not m.done.is_set():
      if time.monotonic() >= deadline:
        raise TimeoutError("remote request %d not finished within %.1fs"
                           % (rid, timeout))
      if not m.done.wait(timeout=0.05) and not self.alive:
        raise RuntimeError(
            "remote replica on host %d died; request %d cannot finish"
            % (self.host_id, rid))
    self._plane._rec(self.host_id).mirrors.pop(rid, None)
    err = m.error
    if isinstance(err, (sched.DeadlineExceeded, sched.RequestCancelled,
                        sched.PoisonedRequest)):
      raise err
    if err is not None:
      raise RuntimeError("remote request %d failed" % rid) from err
    return np.concatenate([m.prompt, np.asarray(m.tokens, np.int32)])

  def stream(self, rid: int, timeout: float = 600.0):
    """Yield generated tokens as they arrive over the wire (EOS
    inclusive), exactly the engine's stream contract."""
    m = self.request(rid)
    deadline = time.monotonic() + float(timeout)
    while True:
      if time.monotonic() >= deadline:
        raise TimeoutError("stream for remote request %d stalled" % rid)
      try:
        tok = m.stream_q.get(timeout=0.05)
      except std_queue.Empty:
        if not self.alive and not m.done.is_set():
          raise RuntimeError(
              "remote replica on host %d died mid-stream" % self.host_id)
        continue
      if tok is None:
        break
      yield int(tok)
    err = m.error
    if isinstance(err, (sched.DeadlineExceeded, sched.RequestCancelled,
                        sched.PoisonedRequest)):
      raise err
    if err is not None:
      raise RuntimeError("remote request %d failed mid-stream"
                         % rid) from err

  def cancel(self, rid: int, timeout: float) -> bool:
    m = self.request(rid)
    if m.done.is_set():
      return True
    m.cancelled.set()
    m.done.wait(timeout=timeout)
    return m.done.is_set()

  def generate(self, prompts, max_new_tokens: Optional[int] = None,
               timeout: float = 600.0) -> List[np.ndarray]:
    """Submit a batch and wait for outputs in order — the deploy
    controller's VERIFY spot-check surface."""
    rids = [self.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    deadline = time.monotonic() + float(timeout)
    return [self.result(r, timeout=max(0.001, deadline - time.monotonic()))
            for r in rids]

  # -- load telemetry (the fleet router's dispatch inputs) -------------------

  def _stat(self, name: str, default):
    try:
      return self._plane._rec(self.host_id).stats.get(name, default)
    except KeyError:
      return default

  @property
  def queue_depth(self) -> int:
    return int(self._stat("queue_depth", 0))

  @property
  def queued_tokens(self) -> int:
    return int(self._stat("queued_tokens", 0))

  @property
  def tokens_per_sec(self) -> float:
    return float(self._stat("tokens_per_sec", 0.0))

  @property
  def occupancy_now(self) -> float:
    return float(self._stat("occupancy_now", 0.0))


def attach_serving_plane(server,
                         timeout: Optional[float] = None,
                         chunk: Optional[int] = None) -> ServingHostPlane:
  """Create a :class:`ServingHostPlane` and attach it to a rendezvous
  ``Server`` (the ``sync_plane`` attachment pattern): the SHREG/SHSYNC/
  SHBYE arms delegate here, and HEALTH replies gain a ``hosts`` row."""
  plane = ServingHostPlane(timeout=timeout, chunk=chunk)
  server.serving_plane = plane
  return plane


def remote_engine_factory(plane: ServingHostPlane,
                          version: Optional[int] = None,
                          host_id: Optional[int] = None,
                          **proxy_kw) -> Callable[[], RemoteReplica]:
  """An engine factory for ``ServingFleet``/``swap_replica``: each call
  binds a fresh :class:`RemoteReplica` to a free host (allocation order
  makes fleet construction map replica k to host k, and a swap rebuild
  land on the host its drain just freed). ``version`` pins the registry
  version the host builds — the deploy controller's cross-process
  re-param seam."""
  def factory() -> RemoteReplica:
    return RemoteReplica(plane, host_id=host_id, version=version,
                         **proxy_kw)
  return factory


def wire_health_probe(server_addr, timeout: float = 5.0,
                      client_factory: Optional[Callable] = None):
  """A ``ServingFleet.health_probe`` that rides the real HEALTH verb:
  each probe polls the rendezvous server and keys the verdict on the
  serving plane's ``hosts`` row for the replica's host. Replicas whose
  engine has no ``host_id`` (local, in-process) fall back to the
  engine's own ``alive`` flag, so mixed fleets keep both paths."""
  from tensorflowonspark_tpu_torch.control import rendezvous as rv
  state = {"client": None}
  lock = threading.Lock()

  def probe(rep) -> bool:
    hid = getattr(rep.engine, "host_id", None)
    if hid is None:
      return bool(rep.engine.alive)
    with lock:
      if state["client"] is None:
        state["client"] = (client_factory() if client_factory is not None
                           else rv.Client(server_addr, timeout=timeout))
      resp = state["client"]._request({"type": "HEALTH"})
    row = (resp.get("hosts") or {}).get(str(hid))
    if row is None:
      return False
    return bool(row.get("alive")) and bool(row.get("engine_alive"))

  return probe
