"""Driver-side aggregation + executor-side shipping for the obs plane.

The port's copy of ``tensorflowonspark_tpu/obs/collector.py``, plus
:meth:`ObsShipper.stamp_log`, which the port's feeder tasks call at
their end: a feeder process's shipper outlives its tasks, so without a
stamp its JSONL log (and its track in the merged trace) would wait for
a later cluster to re-point the shipper.

Executors ship bounded metric/span DELTAS to the driver through a new
rendezvous verb, ``OBS`` (control/rendezvous.py): the
:class:`ObsShipper` thread snapshots the process registry, subtracts the
last acknowledged snapshot, drains a bounded batch of spans, and sends
one msgpack message per interval. The server hands the message to the
:class:`ObsSink` the driver attached (``Server.obs_sink``); without a
sink the verb is acknowledged and dropped — observability is never a
prerequisite for the control plane.

Failure policy (TOS001 end to end):

- every wait is timeout-bounded; the ship socket rides a short-deadline
  rendezvous ``Client``;
- a failed ship NEVER raises into the instrumented process: the metric
  delta is retried next interval (the baseline snapshot only advances on
  ack), the drained spans are counted into ``spans_lost`` and given up —
  bounded memory beats completeness;
- the sink's span buffer is bounded; overflow increments a drop counter
  that the report surfaces.

The shipper also appends its drained spans to a per-process JSONL file
when ``TOS_OBS_DIR`` is set (``obs.export``), so the offline
Chrome-trace plane works even for processes the driver never hears from.
"""

import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from tensorflowonspark_tpu_torch.obs import metrics as metrics_mod
from tensorflowonspark_tpu_torch.obs import spans as spans_mod

logger = logging.getLogger(__name__)

#: seconds between OBS ship rounds (env registry: TOS008)
ENV_OBS_INTERVAL = "TOS_OBS_INTERVAL"
#: max spans per OBS message (bounds the wire frame; TOS008)
ENV_OBS_SHIP_SPANS = "TOS_OBS_SHIP_SPANS"
#: driver-side sink span-buffer capacity (TOS008)
ENV_OBS_SINK_SPANS = "TOS_OBS_SINK_SPANS"

_DEFAULT_INTERVAL = 2.0
_DEFAULT_SHIP_SPANS = 512
_DEFAULT_SINK_SPANS = 65536


class ObsShipper(object):
  """Background thread shipping metric/span deltas via the OBS verb."""

  def __init__(self, server_addr: Tuple[str, int], executor_id: int,
               registry: Optional[metrics_mod.MetricsRegistry] = None,
               recorder: Optional[spans_mod.SpanRecorder] = None,
               clock: Optional[spans_mod.ClockOffset] = None,
               interval: Optional[float] = None, label: str = "executor",
               jsonl_dir: Optional[str] = None):
    self.server_addr = (server_addr[0], int(server_addr[1]))
    self.executor_id = int(executor_id)
    self.label = label
    self.registry = registry if registry is not None else metrics_mod.active()
    self.recorder = recorder if recorder is not None else spans_mod.active()
    # the clock may be SHARED with the HeartbeatSender (the BEAT piggyback
    # is usually the higher-frequency sampler); OBS replies feed it too
    self.clock = clock if clock is not None else (
        self.recorder.clock if self.recorder is not None
        else spans_mod.ClockOffset())
    if interval is None:
      interval = float(os.environ.get(ENV_OBS_INTERVAL,
                                      str(_DEFAULT_INTERVAL)))
    self.interval = max(0.05, interval)
    self.max_spans = int(os.environ.get(ENV_OBS_SHIP_SPANS,
                                        str(_DEFAULT_SHIP_SPANS)))
    from tensorflowonspark_tpu_torch.obs import export as export_mod
    self._jsonl = export_mod.ProcessLog(
        jsonl_dir, label=label, executor_id=self.executor_id,
        clock=self.clock)
    self._client = None
    # baseline = NOW: ships deltas accrued since this shipper started. A
    # persistent FILES-mode executor reuses one process registry across
    # cluster runs; an empty baseline would re-ship the previous run's
    # totals into the next run's sink as fresh increments.
    self._last_acked: Dict[str, dict] = (
        self.registry.snapshot() if self.registry is not None else {})
    self._seq = 0
    self.ship_failures = 0
    self.ships_acked = 0
    self.spans_lost = 0
    self.sampler_failures = 0
    # pre-ship samplers (device-memory watermarks, …): run once per ship
    # round so gauges ride the normal delta wire on the shipper cadence
    self._samplers: List = []
    self._clock_gauges = None
    self._clock_last = None
    # serializes ship/obs_send (and the client teardown in stop) against
    # the loop thread: stop() joins with a TIMEOUT, so the final flush
    # can overlap a wedged in-flight ship and race _seq/_last_acked/
    # _client. RLock: ship() holds it across its obs_send() call.
    self._ship_lock = threading.RLock()
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None

  def add_sampler(self, fn) -> None:
    """Register a zero-arg callable run before every ship's snapshot
    (``obs.device.make_memory_sampler`` is the canonical one). Sampler
    exceptions are counted (``sampler_failures``), never raised."""
    self._samplers.append(fn)

  def _run_samplers(self) -> None:
    for fn in self._samplers:
      try:
        fn()
      except Exception:  # noqa: BLE001 - a broken sampler must not stop
        # the metric deltas that do work from shipping
        self.sampler_failures += 1
    if self.registry is not None:
      # clock-offset QUALITY rides the registry too (satellite of the
      # device tier): rtt_ms bounds the offset error (±rtt/2), samples
      # counts the TIME exchanges feeding the estimate — surfaced in
      # Prometheus exposition and obs_report without ad-hoc plumbing.
      # Gauges only move when the ELECTED estimate moves: every acked
      # ship is itself a TIME exchange, so per-sample updates would ship
      # a delta every round and the idle-wire short-circuit could never
      # fire again.
      snap = self.clock.snapshot()
      if snap["samples"] and \
          (snap["offset"], snap["rtt"]) != self._clock_last:
        self._clock_last = (snap["offset"], snap["rtt"])
        if self._clock_gauges is None:
          self._clock_gauges = (self.registry.gauge("clock.offset_ms"),
                                self.registry.gauge("clock.rtt_ms"),
                                self.registry.gauge("clock.samples"))
        self._clock_gauges[0].set(snap["offset"] * 1e3)
        self._clock_gauges[1].set((snap["rtt"] or 0.0) * 1e3)
        self._clock_gauges[2].set(snap["samples"])

  # -- wire ------------------------------------------------------------------

  def _ensure_client(self):
    if self._client is None:
      from tensorflowonspark_tpu_torch.control import rendezvous
      # short deadline: a ship that cannot land within ~2 intervals is
      # stale anyway, and the final flush must never stall teardown
      self._client = rendezvous.Client(
          self.server_addr, timeout=max(0.5, min(5.0, 2 * self.interval)))
    return self._client

  def obs_send(self, msg: dict, timeout: float) -> Optional[dict]:
    """One OBS request/ack round-trip, deadline-bounded; None on failure.

    Named into the analyzer's blocking-verb set (TOS001): callers must
    pass an explicit ``timeout``.
    """
    with self._ship_lock:
      return self._obs_send_locked(msg, timeout)

  def _obs_send_locked(self, msg: dict, timeout: float) -> Optional[dict]:
    t0 = time.monotonic()
    try:
      client = self._ensure_client()
      client.timeout = max(0.5, float(timeout))
      resp = client._request(msg)
    except Exception as e:  # noqa: BLE001 - the obs plane must never take
      # down the process it observes; failures are counted, not raised
      self.ship_failures += 1
      if self.ship_failures == 1:
        logger.warning("obs ship to %s failing: %s", self.server_addr, e)
      if self._client is not None:
        self._client.close()
        self._client = None
      return None
    t1 = time.monotonic()
    if resp.get("dropped"):          # chaos-injected message loss
      self.ship_failures += 1
      return None
    if "server_time" in resp:
      # even a rejected ship is a valid TIME exchange
      self.clock.update(t0, resp["server_time"], t1)
    if resp.get("accepted") is False:
      # the server answered but the sink rejected/was absent: NOT an ack
      # — the caller must keep its metrics baseline so deltas retry
      self.ship_failures += 1
      return None
    return resp

  # -- shipping --------------------------------------------------------------

  def ship(self, timeout: Optional[float] = None) -> bool:
    """Snapshot, subtract, drain, send. True when the driver acked."""
    if timeout is None:
      timeout = max(0.5, 2 * self.interval)
    with self._ship_lock:
      return self._ship_locked(timeout)

  def _ship_locked(self, timeout: float) -> bool:
    self._run_samplers()
    cur = self.registry.snapshot() if self.registry is not None else {}
    delta = metrics_mod.snapshot_delta(cur, self._last_acked)
    spans: List[dict] = []
    if self.recorder is not None:
      spans = self.recorder.drain(self.max_spans)
      self._jsonl.append_spans(spans)
    drops = dict(self.recorder.drop_counts()) if self.recorder is not None \
        else {}
    drops["spans_lost"] = self.spans_lost
    drops["ship_failures"] = self.ship_failures
    if not spans and self.ships_acked > 0 and \
        all(k.startswith("clock.") for k in delta):
      # idle: nothing to say, keep the wire quiet. Clock-quality gauges
      # alone never wake the wire — every acked ship is a TIME exchange,
      # so they'd otherwise ship a delta forever; they piggyback on the
      # next real delta instead (the baseline deliberately not advanced)
      return True
    self._seq += 1
    msg = {"type": "OBS", "executor_id": self.executor_id,
           "label": self.label, "pid": os.getpid(), "seq": self._seq,
           "metrics": delta, "spans": spans, "drops": drops,
           "clock": self.clock.snapshot()}
    resp = self.obs_send(msg, timeout=timeout)
    if resp is None:
      # metrics retry next round (baseline unchanged); spans are gone —
      # counted, so the loss is visible in the next successful ship
      self.spans_lost += len(spans)
      return False
    self._last_acked = cur
    self.ships_acked += 1
    return True

  def _run(self) -> None:
    while not self._stop.wait(self.interval):
      self.ship()

  def start(self) -> "ObsShipper":
    self._thread = threading.Thread(
        target=self._run, daemon=True,
        name="tos-obs-shipper-%d" % self.executor_id)
    self._thread.start()
    return self

  def stamp_log(self) -> None:
    """Append the current clock offset and a registry snapshot to this
    process's JSONL log (what :meth:`stop` ends with; the merge reads the
    last stamp)."""
    final = self.registry.snapshot() if self.registry is not None else {}
    self._jsonl.close(metrics_snapshot=final)

  def stop(self, timeout: float = 5.0) -> None:
    """Stop the thread, final-flush (bounded), close the socket and the
    JSONL log (stamping the final clock offset + registry snapshot)."""
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=timeout)
    self.ship(timeout=min(2.0, timeout))
    if self.recorder is not None:
      self._jsonl.append_spans(self.recorder.drain(None))
    self.stamp_log()
    with self._ship_lock:
      if self._client is not None:
        self._client.close()
        self._client = None


class ObsSink(object):
  """Driver-side accumulator fed by the rendezvous OBS handler.

  Per-executor metric totals (deltas re-applied), a bounded span buffer,
  clock/drop bookkeeping. ``ingest`` runs on the rendezvous serve thread:
  it must stay cheap, bounded, and exception-free.
  """

  def __init__(self, max_spans: Optional[int] = None):
    if max_spans is None:
      max_spans = int(os.environ.get(ENV_OBS_SINK_SPANS,
                                     str(_DEFAULT_SINK_SPANS)))
    self.max_spans = max(1, max_spans)
    self._cond = threading.Condition()
    self._spans: deque = deque()
    self.spans_dropped = 0
    self.executors: Dict[int, dict] = {}
    self.ingested = 0
    self.rejected = 0

  # -- ingestion (rendezvous serve thread) -----------------------------------

  def ingest(self, msg: dict) -> bool:
    try:
      eid = int(msg["executor_id"])
      delta = msg.get("metrics") or {}
      spans = msg.get("spans") or []
    except Exception:  # noqa: BLE001 - malformed OBS payloads are counted
      # and dropped; the serve loop (and the sender) must not care
      self.rejected += 1
      return False
    clock = msg.get("clock") or {}
    offset = float(clock.get("offset") or 0.0)
    with self._cond:
      entry = self.executors.setdefault(
          eid, {"metrics": {}, "clock": {}, "drops": {}, "ships": 0,
                "label": msg.get("label"), "pid": msg.get("pid")})
      metrics_mod.apply_delta(entry["metrics"], delta)
      entry["clock"] = clock
      entry["drops"] = msg.get("drops") or {}
      entry["ships"] += 1
      entry["label"] = msg.get("label") or entry["label"]
      entry["pid"] = msg.get("pid") or entry["pid"]
      entry["last_seen"] = time.monotonic()
      for rec in spans:
        if len(self._spans) >= self.max_spans:
          self.spans_dropped += 1
          continue
        out = dict(rec)
        out["executor_id"] = eid
        out["offset"] = offset
        self._spans.append(out)
      self.ingested += 1
      if spans:
        self._cond.notify_all()
    return True

  # -- read plane ------------------------------------------------------------

  def obs_recv(self, max_items: int = 256, block: bool = True,
               timeout: Optional[float] = None) -> List[dict]:
    """Pop up to ``max_items`` collected spans (driver-anchorable: each
    carries the shipper's clock ``offset``). Named into the analyzer's
    blocking-verb set (TOS001): blocking callers pass a ``timeout``.
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    with self._cond:
      while not self._spans:
        if not block:
          return []
        remaining = None if deadline is None \
            else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
          return []
        self._cond.wait(timeout=0.25 if remaining is None
                        else min(remaining, 0.25))
      out = []
      for _ in range(min(max_items, len(self._spans))):
        out.append(self._spans.popleft())
      return out

  def metrics(self, executor_id: Optional[int] = None) -> Dict:
    """One executor's cumulative metric totals, or all of them."""
    with self._cond:
      if executor_id is not None:
        entry = self.executors.get(int(executor_id))
        return dict(entry["metrics"]) if entry else {}
      return {eid: dict(e["metrics"]) for eid, e in self.executors.items()}

  def aggregate(self, name: str) -> float:
    """Sum one counter/gauge across executors (0.0 when absent)."""
    total = 0.0
    with self._cond:
      for e in self.executors.values():
        m = e["metrics"].get(name)
        if m and "value" in m:
          total += m["value"]
    return total

  #: the compact metric set the HEALTH verb / obs_top surface per
  #: executor: cumulative counters the poller turns into rates, plus the
  #: last-written gauges. Bounded and msgpack-safe by construction.
  TOP_METRICS = (
      "train.steps", "train.items",
      "feed.batches", "feed.rows", "feed.fetch_s", "feed.decode_s",
      "feed.assemble_s",
      "serve.tokens", "serve.completed", "serve.occupancy",
      "serve.queue_depth", "serve.slots_active",
      "serve.rejected", "serve.expired", "serve.cancelled",
      "serve.replays", "serve.engine_restarts",
      "xla.compiles",
      "device.bytes_in_use", "device.peak_bytes", "device.bytes_limit",
      "clock.offset_ms", "clock.rtt_ms", "clock.samples",
      "feed.autotune_moves",
      "obs.alerts",
  )

  #: dynamic-name metric families the summary also carries: the datapipe
  #: executor's per-stage gauges (one small set per declared graph stage
  #: — bounded by the graph, which is operator-declared)
  TOP_METRIC_PREFIXES = ("feed.stage.",)

  def top_summary(self) -> Dict[str, dict]:
    """{executor_id(str): compact per-executor state} for the HEALTH
    reply and the live monitor — string keys because this rides msgpack
    on the rendezvous wire (the HEALTH ``data`` convention)."""
    now = time.monotonic()
    out: Dict[str, dict] = {}
    with self._cond:
      for eid, e in self.executors.items():
        vals = {}
        for name in self.TOP_METRICS:
          m = e["metrics"].get(name)
          if m is not None and "value" in m:
            vals[name] = m["value"]
        for name, m in e["metrics"].items():
          if name.startswith(self.TOP_METRIC_PREFIXES) \
              and m is not None and "value" in m:
            vals[name] = m["value"]
        out[str(eid)] = {
            "label": e["label"], "pid": e["pid"], "ships": e["ships"],
            "last_seen_age": now - e.get("last_seen", now),
            "clock": dict(e["clock"]), "drops": dict(e["drops"]),
            "metrics": vals,
        }
    return out

  def summary(self) -> dict:
    now = time.monotonic()
    with self._cond:
      return {
          "executors": {
              eid: {"ships": e["ships"], "label": e["label"],
                    "pid": e["pid"], "drops": dict(e["drops"]),
                    "clock": dict(e["clock"]),
                    "last_seen_age": now - e.get("last_seen", now)}
              for eid, e in self.executors.items()},
          "spans_buffered": len(self._spans),
          "spans_dropped": self.spans_dropped,
          "ingested": self.ingested,
          "rejected": self.rejected,
      }
