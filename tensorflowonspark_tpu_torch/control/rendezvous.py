"""Cluster rendezvous: the discovery/control plane.

The port's copy of ``tensorflowonspark_tpu/control/rendezvous.py``, on
the same wire (a client of either package registers with a server of the
other). Capability parity with TensorFlowOnSpark's ``reservation.py``: a
driver-side ``Server`` collects one registration per executor, executors
``register`` and then ``await_reservations`` until the whole cluster is
present, and a ``STOP`` verb doubles as the graceful-stop signal for
streaming jobs. Differences, by design:

- Wire format is length-prefixed **msgpack** (the port's own subset,
  :mod:`._msgpack`), not pickle (framing parity with reservation.py:68-97,
  minus arbitrary-code-execution on receive).
- Registration is **idempotent by executor_id**: a retried task re-registers
  and replaces its previous entry (reference behavior at TFSparkNode.py:331-340),
  while true duplicates (two different addresses claiming one executor_id) are
  surfaced for the cluster layer's duplicate check (TFCluster.py:357-372).
- The server is also the process rendezvous used to synthesize
  ``torch.distributed.init_process_group(init_method, world_size, rank)``
  — the analog of synthesizing ``TF_CONFIG``.

Message verbs (parity with reservation.py:130-146): ``REG``, ``QINFO`` (count
registered), ``QUERY`` (done?), ``LIST`` (full reservation list), ``STOP``;
plus the liveness verbs ``BEAT`` (per-executor heartbeat; a ``bye`` beat
marks clean departure) and ``HEALTH`` (snapshot of the liveness table) —
the reference had no liveness detection at all: a hung executor stalled the
job until the 3-day shutdown watchdog fired (TFCluster.py:136-144).

Observability rides the same wire: ``OBS`` ships bounded metric/span
deltas from executors into the driver's ``Server.obs_sink``
(``obs.collector.ObsSink``; without a sink the verb is acked and
dropped), ``HEALTH`` replies carry the sink's per-executor summary and
the detector's alert ring, and ``BEAT``/``OBS`` replies carry
``server_time`` (the TIME exchange behind ``obs.spans.ClockOffset``).

Cross-host serving rides it too: ``SHREG`` (a serving host announces
itself), ``SHSYNC`` (its events out, commands in) and ``SHBYE`` (clean
departure) are delegated to ``Server.serving_plane``
(``serving.remote.ServingHostPlane``), and HEALTH replies then carry
its per-host ``hosts`` rows; with no plane attached the verbs get an
``ERROR`` reply. The verbs of the one plane the port does not have yet,
``SYNC``/``SYNCQ``/``GROUP`` (elastic groups), are answered with an
``ERROR`` reply that names ROADMAP item 10.

Env overrides (parity with reservation.py:25-26,190-206):
``TOS_TPU_SERVER_HOST`` pins the server bind/advertise host;
``TOS_TPU_SERVER_PORT`` pins the port, accepting either ``"9000"`` or a range
``"9000-9100"`` from which the first bindable port is taken.
"""

import logging
import os
import random
import select
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from tensorflowonspark_tpu_torch.control import _msgpack as msgpack
from tensorflowonspark_tpu_torch.obs import spans as obs_spans
from tensorflowonspark_tpu_torch.utils import chaos

logger = logging.getLogger(__name__)

ENV_SERVER_HOST = "TOS_TPU_SERVER_HOST"
ENV_SERVER_PORT = "TOS_TPU_SERVER_PORT"

_HEADER = struct.Struct(">I")

# rendezvous messages are small metadata dicts; anything larger is a protocol
# violation (or garbage bytes hitting the port) — refuse before buffering it
MAX_MESSAGE_BYTES = 4 * 1024 * 1024


class MessageSocket(object):
  """Length-prefixed msgpack messages over a TCP socket.

  Framing parity with the reference's MessageSocket (reservation.py:68-97):
  4-byte big-endian length + payload.
  """

  def receive(self, sock: socket.socket) -> dict:
    header = self._recv_exact(sock, _HEADER.size)
    (length,) = _HEADER.unpack(header)
    if length > MAX_MESSAGE_BYTES:
      raise ConnectionError(
          "oversized rendezvous message (%d bytes); dropping connection" % length)
    payload = self._recv_exact(sock, length)
    return msgpack.unpackb(payload)

  def send(self, sock: socket.socket, msg: dict) -> None:
    payload = msgpack.packb(msg)
    if len(payload) > MAX_MESSAGE_BYTES:
      # refuse before the wire: the receiver would drop the connection
      # anyway, and the sender deserves a diagnosable error instead of a
      # reconnect loop against a peer that keeps hanging up
      raise ValueError(
          "refusing to send oversized rendezvous message (%d bytes > %d)"
          % (len(payload), MAX_MESSAGE_BYTES))
    sock.sendall(_HEADER.pack(len(payload)) + payload)

  @staticmethod
  def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
      chunk = sock.recv(n - len(buf))
      if not chunk:
        raise ConnectionError("socket closed while reading message")
      buf += chunk
    return buf


class Reservations(object):
  """Thread-safe store of node reservations, keyed by executor_id.

  Parity: reservation.py:31-65, plus idempotent-replace semantics and
  duplicate tracking for the driver-side sanity check.
  """

  def __init__(self, required: int):
    self.required = required
    self._lock = threading.RLock()
    self._table: Dict[int, dict] = {}
    self.duplicates: List[dict] = []

  def add(self, meta: dict) -> None:
    executor_id = meta["executor_id"]
    with self._lock:
      prev = self._table.get(executor_id)
      if prev is not None:
        same_host = prev.get("host") == meta.get("host")
        same_proc = same_host and prev.get("pid") == meta.get("pid")
        # Legitimate replacements: the same process re-sending (lost reply),
        # or a retried task that RECLAIMED its predecessor's stale hub (it
        # proved the old owner is gone — node.py's live-hub check). A fresh
        # registration colliding with a live entry — same host or not — is a
        # concurrent duplicate (two tasks claiming one executor slot, the
        # reference's TFCluster.py:357-372 failure mode) and must surface.
        if not same_proc and not (same_host and meta.get("reclaimed")):
          self.duplicates.append(meta)
          logger.warning(
              "duplicate reservation for executor %d: %s pid=%s vs %s pid=%s",
              executor_id, prev.get("host"), prev.get("pid"),
              meta.get("host"), meta.get("pid"))
      self._table[executor_id] = meta

  def done(self) -> bool:
    with self._lock:
      return len(self._table) >= self.required

  def get(self) -> List[dict]:
    with self._lock:
      return [self._table[k] for k in sorted(self._table)]

  def remaining(self) -> int:
    with self._lock:
      return max(0, self.required - len(self._table))


class Liveness(object):
  """Per-executor heartbeat table (server side).

  States, derived from the age of the last beat at query time:

  - ``unknown``    — never beat (node hasn't registered/started yet)
  - ``live``       — beat within ``suspect_after`` intervals
  - ``suspect``    — missed (at least) one beat deadline
  - ``dead``       — silent for ``miss_limit`` intervals: the node's
    process is presumed gone (SIGKILL, OOM, preemption) and the
    supervisor may reclaim and relaunch it
  - ``departed``   — sent a clean goodbye (``bye`` beat); never flagged
  - ``restarting`` — a supervisor took ownership pending re-registration

  A registration counts as the first beat, so a node that dies between
  registering and its first heartbeat is still detected — but under the
  longer ``startup_grace`` deadline, not the 2-interval one: between
  registering and starting its own heartbeats a node legitimately blocks
  in cluster assembly (waiting for the full roster), and that gap must
  not read as death. Once a node's OWN first beat arrives, the strict
  missed-beat deadline applies. With ``interval=None`` the table is
  inert: no state ever becomes ``dead``.
  """

  def __init__(self, interval: Optional[float] = None,
               miss_limit: float = 2.0, suspect_after: float = 1.25,
               startup_grace: float = 30.0):
    self.interval = float(interval) if interval else None
    self.miss_limit = float(miss_limit)
    self.suspect_after = float(suspect_after)
    self.startup_grace = float(startup_grace)
    self._lock = threading.Lock()
    self._last: Dict[int, float] = {}
    self._progress: Dict[int, object] = {}
    self._departed: set = set()
    self._restarting: set = set()
    self._confirmed: set = set()   # sent a real beat (not just REG)

  def beat(self, executor_id: int, departing: bool = False,
           progress=None, registration: bool = False) -> None:
    with self._lock:
      self._last[executor_id] = time.monotonic()
      if registration:
        # a (re-)registration starts a new incarnation: it must confirm
        # with its own first beat before the strict deadline applies, so a
        # relaunched node gets the startup grace again
        self._confirmed.discard(executor_id)
      else:
        self._confirmed.add(executor_id)
      if progress is not None:
        self._progress[executor_id] = progress
      if departing:
        self._departed.add(executor_id)
      else:
        self._departed.discard(executor_id)
        self._restarting.discard(executor_id)

  def mark_restarting(self, executor_id: int) -> None:
    """Supervisor takes ownership: suppress dead-detection until the
    relaunched node re-registers (which beats, clearing the flag)."""
    with self._lock:
      self._restarting.add(executor_id)

  def rearm(self, executor_id: int) -> None:
    """Re-arm the startup grace for a fresh incarnation (relaunch/resize).

    ``mark_restarting`` suppresses dead-detection only until the next
    non-registration beat clears the flag — and a STALE beat from the old
    incarnation (a stalled-not-dead process flushing its send queue) does
    exactly that, re-confirming the executor so the strict 2-interval
    deadline applies while the NEW incarnation is still booting. The
    supervisor calls this at relaunch/readmit time: the beat clock resets
    and confirmation is dropped, so the next sweep sees at worst
    ``startup_grace`` headroom instead of instantly re-declaring death
    (which would burn a second restart attempt on one failure).
    """
    with self._lock:
      self._last[executor_id] = time.monotonic()
      self._confirmed.discard(executor_id)
      self._departed.discard(executor_id)

  def state(self, executor_id: int) -> str:
    with self._lock:
      return self._state_locked(executor_id, time.monotonic())

  def _state_locked(self, executor_id: int, now: float) -> str:
    if executor_id in self._departed:
      return "departed"
    if executor_id in self._restarting:
      return "restarting"
    last = self._last.get(executor_id)
    if last is None:
      return "unknown"
    if self.interval is None:
      return "live"
    age = now - last
    if executor_id not in self._confirmed:
      # registered but not yet heartbeating: bring-up blocks in cluster
      # assembly, so only the (long) startup grace applies
      grace = max(self.startup_grace, self.interval * self.miss_limit)
      return "live" if age <= grace else "dead"
    if age <= self.interval * self.suspect_after:
      return "live"
    if age <= self.interval * self.miss_limit:
      return "suspect"
    return "dead"

  def dead(self) -> List[int]:
    """Executor ids currently past the missed-beat deadline."""
    with self._lock:
      now = time.monotonic()
      return sorted(e for e in self._last
                    if self._state_locked(e, now) == "dead")

  def snapshot(self) -> Dict[int, dict]:
    """{executor_id: {"state", "age", "progress"}} for HEALTH queries."""
    with self._lock:
      now = time.monotonic()
      return {e: {"state": self._state_locked(e, now),
                  "age": now - self._last[e],
                  "progress": self._progress.get(e)}
              for e in self._last}


class HeartbeatSender(object):
  """Background thread beating ``BEAT`` every ``interval`` seconds.

  Runs inside the process executing the user main fn, so a SIGKILL, OOM
  kill or preemption stops the beats — exactly the signal the server's
  :class:`Liveness` table (and the driver's ClusterSupervisor) uses to
  declare the node dead. ``start()`` sends the first beat synchronously,
  so even a process killed immediately afterwards was seen alive once.
  On clean ``stop()`` a final ``bye`` beat marks the node departed so
  completed nodes are never flagged dead. Delivery failures are retried
  forever (throttled after ``max_failures`` consecutive misses) — a
  transient control-plane glitch must not silence a healthy node.

  ``set_progress`` attaches an application-level progress value (e.g. the
  training step) to subsequent beats — surfaced via ``HEALTH`` for
  observability and future stall detection.

  Each beat doubles as a TIME exchange: the reply's ``server_time``
  (driver monotonic) plus the beat's local send/receive timestamps feed
  ``clock`` — an :class:`obs.spans.ClockOffset` estimating this
  process's offset to the driver's clock. The obs shipper shares this
  estimator, so span timestamps anchor without extra round-trips.
  """

  def __init__(self, server_addr: Tuple[str, int], executor_id: int,
               interval: float = 5.0, max_failures: int = 5,
               clock: Optional[obs_spans.ClockOffset] = None):
    self.server_addr = (server_addr[0], int(server_addr[1]))
    self.executor_id = executor_id
    self.interval = float(interval)
    self.max_failures = max_failures
    self.clock = clock if clock is not None else obs_spans.ClockOffset()
    self._progress = None
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None
    self._client: Optional["Client"] = None
    self._failures = 0
    # serializes _beat (and the client teardown in stop) against the
    # loop thread: stop() joins with a TIMEOUT, so the bye beat can
    # overlap a wedged in-flight beat and race _client/_failures
    self._beat_lock = threading.Lock()

  def set_progress(self, value) -> None:
    # numpy/torch scalars are not msgpack-serializable; coerce to builtins
    # here so a beat can never die on the progress payload
    if hasattr(value, "item"):
      try:
        value = value.item()
      except Exception:  # noqa: BLE001 - non-scalar array etc.
        value = str(value)
    elif not isinstance(value, (int, float, str, bool, type(None))):
      value = str(value)
    self._progress = value

  def _beat(self, bye: bool = False) -> bool:
    with self._beat_lock:
      return self._beat_locked(bye)

  def _beat_locked(self, bye: bool) -> bool:
    try:
      if self._client is None:
        # short per-request deadline: a beat that cannot be delivered
        # within ~2 intervals is useless anyway (capped so the bye beat at
        # node exit never stalls shutdown against a stopped server)
        self._client = Client(self.server_addr,
                              timeout=max(0.5, min(2.0, 2 * self.interval)))
      msg = {"type": "BEAT", "executor_id": self.executor_id}
      if bye:
        msg["bye"] = True
      if self._progress is not None:
        msg["progress"] = self._progress
      t0 = time.monotonic()
      resp = self._client._request(msg)
      t1 = time.monotonic()
      if "server_time" in resp:
        # NTP-style offset sample piggybacked on the beat round-trip;
        # a load-delayed beat just yields a high-RTT sample the
        # min-RTT estimator ignores
        self.clock.update(t0, resp["server_time"], t1)
      self._failures = 0
      return True
    except Exception as e:  # noqa: BLE001 - the heartbeat thread must
      # survive ANYTHING (a dead thread reads as node death to the
      # supervisor); serialization surprises count as delivery failures
      self._failures += 1
      if self._failures == 1:
        logger.warning("heartbeat delivery failing for executor %d: %s",
                       self.executor_id, e)
      if self._client is not None:
        self._client.close()
        self._client = None
      return False

  def _run(self) -> None:
    while True:
      # after max_failures consecutive failures, throttle — but NEVER
      # stop, and never beyond 2×interval: the liveness deadline is 2
      # intervals, so a healthy node must get back on the wire within one
      # deadline of the server healing, or the supervisor would relaunch
      # a live node over a transient network blip
      delay = self.interval
      if self._failures >= self.max_failures:
        delay = 2 * self.interval
        if self._failures == self.max_failures:
          logger.warning("heartbeat delivery for executor %d failing "
                         "persistently (%d consecutive); throttling beats",
                         self.executor_id, self._failures)
      if self._stop.wait(delay):
        return
      self._beat()

  def start(self) -> "HeartbeatSender":
    self._beat()                        # guarantee at least one beat
    self._thread = threading.Thread(target=self._run, daemon=True,
                                    name="heartbeat-%d" % self.executor_id)
    self._thread.start()
    return self

  def stop(self) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=max(1.0, 2 * self.interval))
    self._beat(bye=True)                # best-effort clean departure
    with self._beat_lock:
      if self._client is not None:
        self._client.close()
        self._client = None


#: verbs of planes the port does not have yet -> what the ERROR reply says
_UNPORTED_VERBS = {
    verb: "%s is not ported yet (ROADMAP Queue 1 item %d)" % (what, item)
    for verbs, what, item in (
        (("SYNC", "SYNCQ", "GROUP"), "elastic multi-group training", 10),)
    for verb in verbs}
#: the cross-host serving verbs, delegated to ``Server.serving_plane``
_SERVING_VERBS = ("SHREG", "SHSYNC", "SHBYE")


def _parse_port_spec(spec: str) -> List[int]:
  """``"9000"`` → [9000]; ``"9000-9003"`` → [9000..9003]."""
  if "-" in spec:
    lo, hi = spec.split("-", 1)
    return list(range(int(lo), int(hi) + 1))
  return [int(spec)]


class Server(MessageSocket):
  """Driver-side rendezvous server (parity: reservation.py:100-231)."""

  def __init__(self, count: int, heartbeat_interval: Optional[float] = None,
               miss_limit: float = 2.0, startup_grace: float = 30.0):
    if count < 1:
      raise ValueError("a rendezvous needs at least one node, got %r"
                       % (count,))
    self.reservations = Reservations(count)
    self.liveness = Liveness(heartbeat_interval, miss_limit=miss_limit,
                             startup_grace=startup_grace)
    self.done = threading.Event()
    # streaming-stop flag (the STOP verb): "stop feeding after the current
    # round" — DISTINCT from ``done`` (serving ended). The server must keep
    # serving after a stop request: nodes still in bring-up poll
    # await_reservations, and heartbeats/goodbyes keep the liveness table
    # truthful until shutdown actually stops the server. Closing the
    # listener on STOP (the old behavior) made any bring-up that raced the
    # stop signal retry against ECONNREFUSED for its whole reservation
    # timeout and fail the node (the train_stream shutdown flake).
    self.stop_requested = threading.Event()
    #: driver-attached ``obs.collector.ObsSink`` consuming OBS deltas;
    #: None (the default) acks-and-drops so the obs plane is never a
    #: prerequisite for the control plane
    self.obs_sink = None
    #: driver-attached ``obs.anomaly.AnomalyDetector`` (or anything with
    #: ``recent_alerts(max_items)``): HEALTH replies then carry the live
    #: alert ring (and its ``slo_status``/``deploy_status`` when it has
    #: them). None = no ``alerts`` field.
    self.alert_source = None
    #: driver-attached ``serving.remote.ServingHostPlane`` serving the
    #: SHREG/SHSYNC/SHBYE verbs (executor-resident serving engines synced
    #: with driver-side ``RemoteReplica`` proxies). None (the default)
    #: answers those verbs with an ERROR reply: the control plane never
    #: requires the serving plane to exist.
    self.serving_plane = None
    #: HEALTH obs/alert enrichment failures (counted, never raised)
    self.health_obs_failures = 0
    self._listener: Optional[socket.socket] = None
    self.addr: Optional[Tuple[str, int]] = None
    # round -> set of arrived task ids; sets make re-sent arrivals (client
    # retries after a lost reply) idempotent
    self._barrier_arrivals: Dict[int, set] = {}
    self._barrier_lock = threading.Lock()

  def start(self) -> Tuple[str, int]:
    """Bind (honoring env pinning) and serve on a background thread."""
    host_env = os.environ.get(ENV_SERVER_HOST)
    port_env = os.environ.get(ENV_SERVER_PORT)
    bind_host = host_env if host_env else ""
    ports = _parse_port_spec(port_env) if port_env else [0]

    sock = None
    last_err = None
    for port in ports:
      candidate = None
      try:
        candidate = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        candidate.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        candidate.bind((bind_host, port))
        sock = candidate
        break
      except OSError as e:
        if candidate is not None:
          candidate.close()
        last_err = e
    if sock is None:
      raise OSError("unable to bind rendezvous server on ports {}: {}".format(
          ports, last_err))
    sock.listen(64)

    from tensorflowonspark_tpu_torch.utils.hostinfo import get_ip_address
    advertise_host = host_env if host_env else get_ip_address()
    self.addr = (advertise_host, sock.getsockname()[1])
    self._listener = sock

    t = threading.Thread(target=self._serve, name="rendezvous-server",
                         daemon=True)
    t.start()
    logger.info("rendezvous server listening at %s", self.addr)
    return self.addr

  @staticmethod
  def _drain_frames(buf: bytearray) -> List[dict]:
    """Pop every complete length-prefixed message from ``buf`` (mutates it).

    Partial frames stay buffered — a client that stalls mid-message costs
    nothing; its bytes wait here while other connections are served.
    """
    msgs = []
    while len(buf) >= _HEADER.size:
      (length,) = _HEADER.unpack(bytes(buf[:_HEADER.size]))
      if length > MAX_MESSAGE_BYTES:
        raise ConnectionError(
            "oversized rendezvous message (%d bytes); dropping connection"
            % length)
      if len(buf) < _HEADER.size + length:
        break
      payload = bytes(buf[_HEADER.size:_HEADER.size + length])
      del buf[:_HEADER.size + length]
      msgs.append(msgpack.unpackb(payload))
    return msgs

  def _serve(self) -> None:
    # per-connection receive buffers: reads are one recv() per select hit
    # (never a blocking read-to-completion), so one slow/stalled peer cannot
    # serialize the control plane for everyone else
    conns: Dict[socket.socket, bytearray] = {}
    while not self.done.is_set():
      try:
        readable, _, _ = select.select([self._listener] + list(conns),
                                       [], [], 0.25)
      except OSError:
        break
      for s in readable:
        if s is self._listener:
          try:
            client, _ = self._listener.accept()
            # bounds sendall toward a peer that never drains replies
            client.settimeout(30.0)
            conns[client] = bytearray()
          except OSError:
            pass
          continue
        try:
          chunk = s.recv(65536)
          if not chunk:
            raise ConnectionError("peer closed")
          buf = conns[s]
          buf += chunk
          for msg in self._drain_frames(buf):
            self._handle(s, msg)
        except Exception as e:  # noqa: BLE001 - a bad client (garbage
          # bytes, truncated msgpack, malformed REG) must never kill the
          # serve loop; drop only that connection
          if not isinstance(e, (ConnectionError, OSError)):
            logger.warning("dropping rendezvous connection after bad "
                           "message: %s", e)
          del conns[s]
          s.close()
    for s in conns:
      try:
        s.close()
      except OSError:
        pass
    # close the listener the moment serving ends: late clients (heartbeat
    # senders, stop requests) get instant ECONNREFUSED instead of a
    # connection parked forever in a never-accepted backlog
    if self._listener is not None:
      try:
        self._listener.close()
      except OSError:
        pass

  def _health_reply(self) -> dict:
    """The liveness snapshot, plus the obs extension: per-executor
    metric state and the detector's alert ring (with its SLO and deploy
    status). Every enrichment is bounded and best-effort — a telemetry
    bug must never break a HEALTH poll."""
    snap = {str(k): v for k, v in self.liveness.snapshot().items()}
    reply = {"type": "HEALTH", "data": snap, "server_time": time.monotonic()}
    sink = self.obs_sink
    if sink is not None:
      try:
        reply["obs"] = sink.top_summary()
      except Exception as e:  # noqa: BLE001 - reply stays liveness-only;
        # counted so a chronically failing summary is diagnosable
        self.health_obs_failures += 1
        logger.warning("obs summary for HEALTH failed: %s", e)
    shplane = self.serving_plane
    if shplane is not None:
      # per-host liveness and load: what wire_health_probe keys replica
      # ejection on
      try:
        reply["hosts"] = shplane.status()
      except Exception as e:  # noqa: BLE001 - reply stays hosts-free
        self.health_obs_failures += 1
        logger.warning("serving-plane status for HEALTH failed: %s", e)
    alerts = self.alert_source
    if alerts is None:
      return reply
    try:
      reply["alerts"] = alerts.recent_alerts()
    except Exception as e:  # noqa: BLE001 - reply stays alert-free
      self.health_obs_failures += 1
      logger.warning("alert ring for HEALTH failed: %s", e)
    for key in ("slo", "deploy"):
      status_fn = getattr(alerts, key + "_status", None)
      if status_fn is None:
        continue
      try:
        status = status_fn()
        if status is not None:
          reply[key] = status
      except Exception as e:  # noqa: BLE001 - reply stays without it
        self.health_obs_failures += 1
        logger.warning("%s status for HEALTH failed: %s", key, e)
    return reply

  def _handle(self, sock: socket.socket, msg: dict) -> None:
    mtype = msg.get("type")
    if mtype == "REG":
      self.reservations.add(msg["data"])
      # registration counts as the first beat (under the startup grace):
      # a node that dies before its first heartbeat is still detected
      if "executor_id" in msg["data"]:
        self.liveness.beat(msg["data"]["executor_id"], registration=True)
      self.send(sock, {"type": "OK"})
    elif mtype == "BEAT":
      self.liveness.beat(msg["executor_id"], departing=msg.get("bye", False),
                         progress=msg.get("progress"))
      # server_time turns every beat into a TIME exchange (clock-offset
      # estimation for the obs plane — see HeartbeatSender.clock)
      self.send(sock, {"type": "OK", "server_time": time.monotonic()})
    elif mtype == "OBS":
      sink = self.obs_sink
      accepted = False
      if sink is not None:
        # ingest is bounded and swallows its own malformed-payload cases;
        # a sink bug must not kill the serve loop, so the failure is
        # reported to the SENDER (accepted=False) instead of raised here
        try:
          accepted = bool(sink.ingest(msg))
        except Exception as e:  # noqa: BLE001 - reported via accepted flag
          accepted = False
          logger.warning("obs sink rejected a delta: %s", e)
      self.send(sock, {"type": "OK", "accepted": accepted,
                       "server_time": time.monotonic()})
    elif mtype == "HEALTH":
      self.send(sock, self._health_reply())
    elif mtype in _SERVING_VERBS:
      # delegated to the attached ServingHostPlane; a plane bug degrades
      # to an ERROR reply the host surfaces, never a dead serve loop
      shplane = self.serving_plane
      if shplane is None:
        self.send(sock, {"type": "ERROR",
                         "error": "no serving plane attached for %s" % mtype})
      else:
        try:
          self.send(sock, shplane.handle(msg))
        except Exception as e:  # noqa: BLE001 - reported to the caller
          logger.warning("serving plane failed on %s: %s", mtype, e)
          self.send(sock, {"type": "ERROR", "error": str(e)})
    elif mtype in _UNPORTED_VERBS:
      self.send(sock, {"type": "ERROR", "error": "%s: %s" % (
          mtype, _UNPORTED_VERBS[mtype])})
    elif mtype == "QINFO":
      self.send(sock, {"type": "COUNT",
                       "registered": self.reservations.required -
                       self.reservations.remaining(),
                       "required": self.reservations.required})
    elif mtype == "QUERY":
      self.send(sock, {"type": "DONE", "done": self.reservations.done()})
    elif mtype == "LIST":
      self.send(sock, {"type": "RESERVATIONS",
                       "data": self.reservations.get()})
    elif mtype == "BARRIER":
      # reusable barrier rounds for gang-scheduled tasks: each task announces
      # arrival at round r (idempotently, keyed by task id), then polls
      # BQUERY until everyone arrived
      rnd = int(msg["round"])
      with self._barrier_lock:
        self._barrier_arrivals.setdefault(rnd, set()).add(msg["task_id"])
        # prune long-completed rounds so streaming jobs syncing per-batch
        # don't grow the dict unboundedly
        if len(self._barrier_arrivals) > 16:
          for old in sorted(self._barrier_arrivals)[:-8]:
            if old < rnd - 2:
              del self._barrier_arrivals[old]
      self.send(sock, {"type": "OK"})
    elif mtype == "BQUERY":
      rnd = int(msg["round"])
      with self._barrier_lock:
        arrived = len(self._barrier_arrivals.get(rnd, ()))
      self.send(sock, {"type": "BDONE",
                       "done": arrived >= int(msg["required"])})
    elif mtype == "STOP":
      logger.info("rendezvous server received STOP")
      self.stop_requested.set()
      self.send(sock, {"type": "OK"})
    else:
      self.send(sock, {"type": "ERROR", "error": "unknown verb: %r" % mtype})

  def await_reservations(self, timeout: int = 600, status: Optional[dict] = None):
    """Block until all nodes registered; raise on timeout or reported error.

    ``status`` is the shared dict the launcher thread writes errors into
    (parity: tf_status error-abort, reservation.py:113-128 +
    TFCluster.py:328-330).
    """
    deadline = time.time() + timeout
    while not self.reservations.done():
      if status and status.get("error"):
        raise RuntimeError("cluster startup aborted: {}".format(status["error"]))
      if time.time() > deadline:
        raise TimeoutError(
            "timed out waiting for {} node(s) to register after {}s".format(
                self.reservations.remaining(), timeout))
      time.sleep(0.1)
    return self.reservations.get()

  def stop(self) -> None:
    self.stop_requested.set()
    self.done.set()
    if self._listener is not None:
      try:
        self._listener.close()
      except OSError:
        pass

  def stopping(self) -> bool:
    """Stop requested (STOP verb) or serving already ended — the flag the
    streaming feed loops check between rounds."""
    return self.stop_requested.is_set() or self.done.is_set()


class Client(MessageSocket):
  """Executor-side rendezvous client (parity: reservation.py:234-301).

  The request/reconnect loop is BOUNDED: exponential backoff with full
  jitter, capped per-sleep at ``backoff_cap`` and in total by ``timeout``
  (a hard deadline per request). A server that stays unreachable yields a
  clear :class:`ConnectionError` naming its address instead of an infinite
  retry loop wedging the node.
  """

  def __init__(self, server_addr: Tuple[str, int], timeout: float = 30.0,
               backoff_base: float = 0.05, backoff_cap: float = 2.0):
    self.server_addr = (server_addr[0], int(server_addr[1]))
    self.timeout = float(timeout)
    self.backoff_base = backoff_base
    self.backoff_cap = backoff_cap
    try:
      self._sock: Optional[socket.socket] = self._connect()
    except OSError:
      # retried (with backoff, against the deadline) at the first request
      self._sock = None

  def _connect(self) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
      # a per-operation socket deadline: a server that stopped serving (or
      # a half-open connection) must surface as a retryable timeout, never
      # as an unbounded recv() — request/reply exchanges here are all small
      # and fast, so a generous cap costs nothing
      s.settimeout(max(1.0, min(self.timeout, 10.0)))
      s.connect(self.server_addr)
    except BaseException:
      # the reconnect loop retries for the whole deadline budget; each
      # failed attempt must release its socket or the retries pile up fds
      # in a long-lived executor process (TOS006)
      s.close()
      raise
    return s

  def _request(self, msg: dict) -> dict:
    if chaos.enabled():
      drop, delay = chaos.message_fault(msg.get("type"))
      if delay:
        time.sleep(delay)
      if drop:
        # lost on the (simulated) wire: the server never sees it; callers
        # polling for state simply observe nothing changed
        return {"type": "DROPPED", "dropped": True, "done": False}
    deadline = time.monotonic() + self.timeout
    attempt = 0
    last = None
    while True:
      try:
        if self._sock is None:
          self._sock = self._connect()
        self.send(self._sock, msg)
        return self.receive(self._sock)
      except (ConnectionError, OSError) as e:
        last = e
        if attempt == 0:
          logger.warning("rendezvous request to %s failed (%s); retrying "
                         "with backoff", self.server_addr, e)
        if self._sock is not None:
          try:
            self._sock.close()
          except OSError:
            pass
          self._sock = None
        now = time.monotonic()
        if now >= deadline:
          raise ConnectionError(
              "unable to reach rendezvous server at %s:%d after %d "
              "attempt(s) over %.1fs: %s"
              % (self.server_addr[0], self.server_addr[1], attempt + 1,
                 self.timeout, last))
        # exponential backoff with full jitter, capped per-sleep and
        # clipped to the remaining deadline budget
        delay = min(self.backoff_cap, self.backoff_base * (2 ** attempt))
        delay *= 0.5 + random.random()
        time.sleep(max(0.0, min(delay, deadline - now)))
        attempt += 1

  def register(self, reservation: dict) -> None:
    self._request({"type": "REG", "data": reservation})

  def get_reservations(self) -> List[dict]:
    return self._request({"type": "LIST"})["data"]

  def await_reservations(self, timeout: int = 600) -> List[dict]:
    """Poll until the cluster is fully registered (1s poll cadence,
    parity: reservation.py:290-296)."""
    deadline = time.time() + timeout
    while True:
      if self._request({"type": "QUERY"})["done"]:
        return self.get_reservations()
      if time.time() > deadline:
        raise TimeoutError("timed out awaiting full cluster registration")
      time.sleep(1)

  def barrier_wait(self, round_num: int, required: int,
                   timeout: float = 600, task_id=None) -> None:
    """Announce arrival at a barrier round and wait for the full gang.

    ``task_id`` identifies this participant so retried announcements (after
    a lost reply) stay idempotent on the server.
    """
    if task_id is None:
      task_id = "%s:%d" % (socket.gethostname(), os.getpid())
    self._request({"type": "BARRIER", "round": round_num,
                   "task_id": task_id})
    deadline = time.time() + timeout
    while True:
      resp = self._request({"type": "BQUERY", "round": round_num,
                            "required": required})
      if resp["done"]:
        return
      if time.time() > deadline:
        raise TimeoutError("barrier round %d timed out" % round_num)
      time.sleep(0.05)

  def request_stop(self) -> None:
    try:
      self._request({"type": "STOP"})
    except ConnectionError:
      logger.warning("rendezvous server already gone on STOP")

  def close(self) -> None:
    if self._sock is None:
      return
    try:
      self._sock.close()
    except OSError:
      pass
    self._sock = None
