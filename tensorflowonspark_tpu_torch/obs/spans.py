"""Span/event tracing on the monotonic clock, with driver-anchored offsets.

The port's copy of ``tensorflowonspark_tpu/obs/spans.py``, unchanged.

Every process records spans against its OWN ``time.monotonic()`` — the
only clock that never steps backwards under NTP. To land per-executor
traces on one timeline, each executor estimates its offset to the
DRIVER's monotonic clock with an NTP-style exchange piggybacked on
control-plane round-trips (the rendezvous ``BEAT``/``OBS`` replies carry
the server's monotonic timestamp): for a request sent at local ``t0``
and answered at ``t1`` carrying server time ``ts``, the offset sample is
``ts - (t0 + t1) / 2`` with uncertainty ``(t1 - t0) / 2``. The estimator
keeps the minimum-RTT sample of a sliding window, so chaos-injected (or
load-induced) delays inflate individual samples without poisoning the
estimate — one clean round-trip wins.

The recorder is BOUNDED and never blocks (TOS001 by construction): a
full buffer drops the newest record and counts it. Observability must
never wedge the runtime it observes.
"""

import contextlib
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

#: span-buffer capacity per process (records held between shipper drains;
#: env registry: TOS008)
ENV_OBS_SPAN_BUFFER = "TOS_OBS_SPAN_BUFFER"

_DEFAULT_CAPACITY = 4096


def new_trace_id() -> str:
  """A fresh request-scoped trace id (16 hex chars, unique across
  processes). Minted once per logical request at the submit boundary
  (``ServingFleet.submit`` / ``ServingEngine.submit``) and stamped onto
  every span the request touches — including across a cross-replica
  failover hop, which is what keeps one request ONE trace."""
  return uuid.uuid4().hex[:16]


def _coerce(v):
  """msgpack/json-safe attribute values (numpy scalars -> builtins)."""
  if isinstance(v, (str, int, float, bool, type(None))):
    return v
  if hasattr(v, "item"):
    try:
      return v.item()
    except Exception:  # noqa: BLE001 - non-scalar array etc.
      return str(v)
  return str(v)


class ClockOffset(object):
  """Min-RTT estimate of (driver monotonic − local monotonic).

  ``update`` is fed by whichever control-plane client sees server
  timestamps (HeartbeatSender beats, ObsShipper ships). ``offset`` is
  the current best estimate (0.0 until the first sample — a driver-side
  recorder simply never updates); ``rtt`` is the uncertainty of that
  sample (error is bounded by ±rtt/2).

  The last ``window`` samples are kept; once the elected sample ages
  out of the window, the minimum-RTT sample OF THE WINDOW is re-elected
  — so a one-off artificially-good sample from a past epoch cannot pin
  the estimate forever (process migration, clock-affecting events), and
  a re-election can never adopt a lone delayed sample while better
  recent ones exist.
  """

  def __init__(self, window: int = 64):
    self.window = int(window)
    self._lock = threading.Lock()
    self.offset = 0.0
    self.rtt = float("inf")
    self.samples = 0
    self._recent: deque = deque(maxlen=max(1, self.window))
    self._since_best = 0

  def update(self, t0: float, server_time: float, t1: float) -> None:
    rtt = max(0.0, t1 - t0)
    sample = server_time - 0.5 * (t0 + t1)
    with self._lock:
      self.samples += 1
      self._since_best += 1
      self._recent.append((rtt, sample))
      if rtt <= self.rtt:
        self.offset = sample
        self.rtt = rtt
        self._since_best = 0
      elif self._since_best >= self.window:
        # the elected sample aged out: re-elect the best RECENT one
        self.rtt, self.offset = min(self._recent, key=lambda rs: rs[0])
        self._since_best = 0

  def snapshot(self) -> dict:
    with self._lock:
      rtt = self.rtt if self.rtt != float("inf") else None
      return {"offset": self.offset, "rtt": rtt, "samples": self.samples}


class SpanRecorder(object):
  """Bounded per-process buffer of finished spans / instant events.

  Records are plain dicts (msgpack/json-safe)::

      {"name": "feed.batch", "ph": "X", "t0": <monotonic>, "dur": <s>,
       "tid": <thread name>, "attrs": {...}}       # span
      {"name": "cluster.stop", "ph": "i", "t0": <monotonic>, ...}  # event

  Request-scoped records additionally carry a TOP-LEVEL ``"trace"`` key
  (the :func:`new_trace_id` minted at submit): the export plane keys
  flow events and the ``obs_report --request`` waterfall on it, so it is
  a record field, not an attr. ``span``/``record_span``/``event`` take
  it as the ``trace=`` kwarg.

  ``add`` never blocks: past ``capacity`` the record is dropped and
  ``dropped`` incremented (the drop counter ships with every OBS delta,
  so lost spans are visible, not silent).
  """

  def __init__(self, capacity: Optional[int] = None,
               clock: Optional[ClockOffset] = None):
    if capacity is None:
      capacity = int(os.environ.get(ENV_OBS_SPAN_BUFFER,
                                    str(_DEFAULT_CAPACITY)))
    self.capacity = max(1, capacity)
    self.clock = clock if clock is not None else ClockOffset()
    self._buf: deque = deque()
    self.dropped = 0
    self.recorded = 0

  # -- hot path --------------------------------------------------------------

  def add(self, record: dict) -> None:
    # len/append under the GIL: worst case a burst briefly overshoots the
    # cap by a few records — bounded either way, and never a lock wait
    if len(self._buf) >= self.capacity:
      self.dropped += 1
      return
    self.recorded += 1
    self._buf.append(record)

  @contextlib.contextmanager
  def span(self, name: str, trace: Optional[str] = None, **attrs):
    t0 = time.monotonic()
    try:
      yield
    finally:
      dur = time.monotonic() - t0
      rec = {"name": name, "ph": "X", "t0": t0, "dur": dur,
             "tid": threading.current_thread().name}
      if trace is not None:
        rec["trace"] = trace
      if attrs:
        rec["attrs"] = {k: _coerce(v) for k, v in attrs.items()}
      self.add(rec)

  def record_span(self, name: str, t0: float, dur: float,
                  trace: Optional[str] = None, **attrs) -> None:
    """Record a span from caller-measured timestamps (for seams that
    already hold a ``perf_counter``-free monotonic pair)."""
    rec = {"name": name, "ph": "X", "t0": t0, "dur": dur,
           "tid": threading.current_thread().name}
    if trace is not None:
      rec["trace"] = trace
    if attrs:
      rec["attrs"] = {k: _coerce(v) for k, v in attrs.items()}
    self.add(rec)

  def event(self, name: str, trace: Optional[str] = None, **attrs) -> None:
    rec = {"name": name, "ph": "i", "t0": time.monotonic(),
           "tid": threading.current_thread().name}
    if trace is not None:
      rec["trace"] = trace
    if attrs:
      rec["attrs"] = {k: _coerce(v) for k, v in attrs.items()}
    self.add(rec)

  # -- drain plane -----------------------------------------------------------

  def __len__(self) -> int:
    return len(self._buf)

  def drain(self, max_records: Optional[int] = None) -> List[dict]:
    """Pop up to ``max_records`` oldest records (all, when None)."""
    out: List[dict] = []
    n = len(self._buf) if max_records is None else max_records
    for _ in range(n):
      try:
        out.append(self._buf.popleft())
      except IndexError:
        break
    return out

  def drop_counts(self) -> Dict[str, int]:
    return {"spans_dropped": self.dropped, "spans_recorded": self.recorded}


# -- the process-active recorder ----------------------------------------------

_active: Optional[SpanRecorder] = None
_active_lock = threading.Lock()


def active() -> Optional[SpanRecorder]:
  """The process recorder, or None when the obs plane is off (mirrors
  ``metrics.active``)."""
  from tensorflowonspark_tpu_torch.obs import metrics
  global _active
  if _active is None and metrics.enabled():
    with _active_lock:
      if _active is None:
        _active = SpanRecorder()
  return _active


def activate(recorder: Optional[SpanRecorder] = None) -> SpanRecorder:
  global _active
  with _active_lock:
    _active = recorder if recorder is not None else SpanRecorder()
    return _active


def deactivate() -> None:
  global _active
  with _active_lock:
    _active = None
