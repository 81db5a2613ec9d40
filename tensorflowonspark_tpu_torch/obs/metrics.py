"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

The port's copy of ``tensorflowonspark_tpu/obs/metrics.py``, unchanged.

The measurement plane's L0: every instrumented seam (DataFeed stages, the
ServingEngine loop, StepTimer, the ClusterSupervisor) records into ONE
per-process :class:`MetricsRegistry`. Design constraints, in order:

- **lock-cheap hot path**: recording must be safe to leave enabled inside
  the feed/serve/train loops. Metric objects are plain attribute updates
  guarded only by the GIL — no per-observation lock, no allocation. Under
  concurrent writers a counter may (rarely) lose an increment to a
  read-modify-write race; that is the documented trade for a hot path
  that costs tens of nanoseconds. Anything that must be exact (the
  parity/accounting state of the runtime itself) does NOT live here.
- **registration is the cold path**: ``counter()/gauge()/histogram()``
  take a lock and get-or-create; call them once at setup and keep the
  returned handle.
- **delta shipping**: snapshots are plain msgpack-able dicts;
  :func:`snapshot_delta` / :func:`apply_delta` turn them into the bounded
  increments the rendezvous ``OBS`` verb ships driver-ward (counters and
  histograms subtract; gauges report last-written value).

Enablement rides ``TOS_OBS`` (registered: :data:`ENV_OBS`): when set (and
not ``"0"``), :func:`active` lazily builds the process registry; when
unset it returns None and every instrumented seam stays on its zero-cost
``if reg is None`` guard. Tests (or embedding apps) can install a
registry explicitly with :func:`activate` regardless of the env.
"""

import bisect
import os
import threading
from typing import Dict, List, Optional, Sequence

from tensorflowonspark_tpu_torch.obs import quantiles as quantiles_mod

#: master switch for the observability plane (env registry: TOS008).
#: ``TOS_OBS=1`` activates the per-process registry/tracer and the
#: executor-side delta shipper; unset/``0`` keeps every hot-path hook on
#: its None guard.
ENV_OBS = "TOS_OBS"

#: default histogram bucket upper bounds (milliseconds-flavored: the
#: instrumented seams record durations in ms)
DEFAULT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)


def enabled() -> bool:
  """True when the observability plane is switched on (``TOS_OBS``)."""
  return os.environ.get(ENV_OBS, "") not in ("", "0")


class Counter(object):
  """Monotonic count. ``inc`` is the hot path: one GIL-guarded add."""

  __slots__ = ("name", "value")

  def __init__(self, name: str):
    self.name = name
    self.value = 0.0

  def inc(self, n=1) -> None:
    self.value += n

  def snapshot(self) -> dict:
    return {"type": "counter", "value": self.value}


class Gauge(object):
  """Last-written value (occupancy, queue depth, cumulative stage secs)."""

  __slots__ = ("name", "value")

  def __init__(self, name: str):
    self.name = name
    self.value = 0.0

  def set(self, v) -> None:
    self.value = float(v)

  def snapshot(self) -> dict:
    return {"type": "gauge", "value": self.value}


class Histogram(object):
  """Fixed-bucket histogram: cumulative-style bounds, per-bucket counts.

  ``observe`` is one bisect + three GIL-guarded updates; bounds are fixed
  at creation so deltas are an elementwise subtract and merges never have
  to re-bucket.
  """

  __slots__ = ("name", "bounds", "counts", "sum", "count")

  def __init__(self, name: str, bounds: Optional[Sequence[float]] = None):
    self.name = name
    self.bounds = tuple(sorted(bounds)) if bounds else DEFAULT_BUCKETS
    # one overflow bucket past the last bound
    self.counts = [0] * (len(self.bounds) + 1)
    self.sum = 0.0
    self.count = 0

  def observe(self, v) -> None:
    v = float(v)
    self.counts[bisect.bisect_left(self.bounds, v)] += 1
    self.sum += v
    self.count += 1

  def snapshot(self) -> dict:
    return {"type": "histogram", "bounds": list(self.bounds),
            "counts": list(self.counts), "sum": self.sum,
            "count": self.count}


class Quantiles(object):
  """Mergeable streaming-quantile metric (``obs.quantiles``): the
  first-class latency object — TTFT / per-output-token time / e2e /
  queue wait record here, and the driver merges per-executor sketches
  into cluster-true percentiles (fixed-bucket histograms can't: their
  p99 is whichever bucket edge it straddles).

  ``observe`` is the hot path: one sketch ``add`` (list append +
  occasional compaction), GIL-only like every other metric here.
  """

  __slots__ = ("name", "sketch")

  def __init__(self, name: str, k: Optional[int] = None):
    self.name = name
    self.sketch = quantiles_mod.QuantileSketch(
        k if k else quantiles_mod.DEFAULT_K)

  def observe(self, v) -> None:
    self.sketch.add(v)

  @property
  def count(self) -> int:
    return self.sketch.count

  def quantile(self, q: float):
    return self.sketch.quantile(q)

  def snapshot(self) -> dict:
    # the full sketch IS the snapshot: fixed memory, so shipping it
    # whole (see snapshot_delta) keeps the wire bounded and makes
    # retries idempotent (last-write at the sink, merge at read time)
    return {"type": "sketch", "count": self.sketch.count,
            "data": self.sketch.to_dict()}


class MetricsRegistry(object):
  """Get-or-create metric store; handles are the hot-path objects."""

  def __init__(self):
    self._lock = threading.Lock()
    self._metrics: Dict[str, object] = {}

  def _get(self, name: str, cls, *args):
    with self._lock:
      m = self._metrics.get(name)
      if m is None:
        m = cls(name, *args)
        self._metrics[name] = m
      elif not isinstance(m, cls):
        raise TypeError("metric %r already registered as %s"
                        % (name, type(m).__name__))
      return m

  def counter(self, name: str) -> Counter:
    return self._get(name, Counter)

  def gauge(self, name: str) -> Gauge:
    return self._get(name, Gauge)

  def histogram(self, name: str,
                bounds: Optional[Sequence[float]] = None) -> Histogram:
    return self._get(name, Histogram, bounds)

  def quantiles(self, name: str, k: Optional[int] = None) -> Quantiles:
    return self._get(name, Quantiles, k)

  def names(self) -> List[str]:
    with self._lock:
      return sorted(self._metrics)

  def snapshot(self) -> Dict[str, dict]:
    """{name: metric snapshot} — plain builtins, msgpack/json-safe."""
    with self._lock:
      metrics = list(self._metrics.items())
    return {name: m.snapshot() for name, m in metrics}


# -- delta arithmetic (the OBS-verb shipping format) --------------------------


def snapshot_delta(cur: Dict[str, dict],
                   prev: Dict[str, dict]) -> Dict[str, dict]:
  """What changed between two :meth:`MetricsRegistry.snapshot` calls.

  Counters/histograms subtract (a metric absent from ``prev`` ships its
  full value); gauges ship their current value when it changed. Quantile
  sketches (``"sketch"``) ship their FULL fixed-memory state whenever the
  observation count moved: a sketch cannot subtract, but it is bounded
  (~KiB) and last-write idempotent, so re-shipping after a failed ack is
  harmless and the read plane merges per-executor last-writes
  (``obs.quantiles.merge_snapshots``) into cluster-true percentiles.
  Metrics with no change are omitted — including settled gauges — so an
  idle process ships empty deltas and the shipper's keep-the-wire-quiet
  short-circuit can actually fire.
  """
  out: Dict[str, dict] = {}
  for name, snap in cur.items():
    old = prev.get(name)
    kind = snap["type"]
    if old is None or old.get("type") != kind:
      if kind in ("histogram", "sketch") and snap["count"] == 0:
        continue
      if kind not in ("histogram", "sketch") and snap["value"] == 0:
        continue
      out[name] = snap
      continue
    if kind == "sketch":
      if snap["count"] == old["count"]:
        continue
      out[name] = snap
    elif kind == "histogram":
      if snap["count"] == old["count"]:
        continue
      out[name] = {"type": kind, "bounds": snap["bounds"],
                   "counts": [a - b for a, b in zip(snap["counts"],
                                                    old["counts"])],
                   "sum": snap["sum"] - old["sum"],
                   "count": snap["count"] - old["count"]}
    elif kind == "counter":
      if snap["value"] == old["value"]:
        continue
      out[name] = {"type": kind, "value": snap["value"] - old["value"]}
    else:  # gauge: last-written value (not a delta), only when it moved
      if snap["value"] == old["value"]:
        continue
      out[name] = snap
  return out


def apply_delta(total: Dict[str, dict], delta: Dict[str, dict]) -> None:
  """Merge one shipped delta into a cumulative snapshot-shaped dict
  (the driver-side accumulation the ObsSink keeps per executor)."""
  for name, d in delta.items():
    cur = total.get(name)
    kind = d.get("type")
    if cur is None or cur.get("type") != kind:
      total[name] = {k: (list(v) if isinstance(v, list) else v)
                     for k, v in d.items()}
      continue
    if kind == "sketch":
      # last-write: the shipped sketch is the executor's full cumulative
      # state (cross-executor aggregation merges at read time)
      total[name] = {"type": "sketch", "count": d["count"],
                     "data": d["data"]}
    elif kind == "histogram":
      if list(cur["bounds"]) != list(d["bounds"]):
        total[name] = {k: (list(v) if isinstance(v, list) else v)
                       for k, v in d.items()}
        continue
      cur["counts"] = [a + b for a, b in zip(cur["counts"], d["counts"])]
      cur["sum"] += d["sum"]
      cur["count"] += d["count"]
    elif kind == "counter":
      cur["value"] += d["value"]
    else:
      cur["value"] = d["value"]


# -- live-stats snapshot-subtract helper --------------------------------------


class StatsSnapshot(object):
  """Point-in-time baseline over a LIVE stats dict mutated by daemon
  threads (``DataFeed.stats``, ``ServingEngine.stats``).

  Zeroing such a dict races the owning thread's read-modify-writes, and
  per-caller ``base = dict(stats)`` copies had already drifted apart
  across the benches — this is the ONE snapshot-subtract implementation.
  ``delta()`` reads the live dict again and returns current-minus-base
  for every key present at snapshot time (new keys are ignored: the
  caller asked about the keys it saw).

  NESTED dicts (``GraphExecutor.stats["stages"]`` — the datapipe
  executor's per-stage counters, each mutated by that stage's worker
  pool) snapshot and subtract recursively, so multi-stage bench
  readouts can't race live worker ``+=`` either.
  """

  def __init__(self, live: Dict[str, float]):
    self._live = live
    self._base = self._copy(live)

  @classmethod
  def _copy(cls, d: Dict) -> Dict:
    return {k: (cls._copy(v) if isinstance(v, dict) else v)
            for k, v in d.items()}

  @classmethod
  def _sub(cls, live: Dict, base: Dict) -> Dict:
    out = {}
    for k, v in base.items():
      cur = live.get(k, v)
      if isinstance(v, dict):
        out[k] = cls._sub(cur if isinstance(cur, dict) else v, v)
      else:
        out[k] = cur - v
    return out

  def delta(self) -> Dict[str, float]:
    return self._sub(self._live, self._base)


def snapshot_stats(live: Dict[str, float]) -> StatsSnapshot:
  """Take a subtraction baseline over a live stats dict."""
  return StatsSnapshot(live)


# -- the process-active registry ----------------------------------------------

_active: Optional[MetricsRegistry] = None
_active_lock = threading.Lock()


def active() -> Optional[MetricsRegistry]:
  """The process registry, or None when the obs plane is off.

  Lazily built on first call once ``TOS_OBS`` is set; instrumented seams
  cache the result and guard on None.
  """
  global _active
  if _active is None and enabled():
    with _active_lock:
      if _active is None:
        _active = MetricsRegistry()
  return _active


def activate(registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
  """Install (and return) the process registry, ignoring ``TOS_OBS``."""
  global _active
  with _active_lock:
    _active = registry if registry is not None else MetricsRegistry()
    return _active


def deactivate() -> None:
  """Drop the process registry (test isolation helper)."""
  global _active
  with _active_lock:
    _active = None
