"""Compile/device telemetry tier: recompile sentinel, cost gauges, memory.

Counterpart of ``tensorflowonspark_tpu/obs/device.py``, feeding the same
metric names into the process registry the rest of the obs plane ships
driver-ward, so the anomaly detectors (``obs.anomaly``) see them online.
An eager PyTorch program has no jit cache, so two of the reference's
three signals change meaning (ROADMAP Queue 3, "Known differences"):

- **Recompile sentinel** — :func:`note_trace` is called at the
  reference's seams (the train step and fused loop, the slot decoder's
  prefill / insert / step / step_many, the KV generate loop) with the
  arguments whose shapes the reference's jit keys on. It counts
  ``xla.compiles.<label>`` once per new (label, shape fingerprint) —
  exactly when the reference's jit retraces — and, there being no
  ``jax.monitoring``, also the global ``xla.compiles``, as the
  reference's fallback does. The port's real compile events are the
  builds of its native code at first use (``ops._build``: ``nvcc``; the
  shm ring and the TFRecord codec: ``g++``): :func:`note_build` records
  each as ``xla.compiles`` / ``xla.compile_ms`` with a retroactive
  ``compile`` span, and a library already on disk as ``xla.cache_hits``.
- **Cost gauges** — :func:`capture_cost` sets ``xla.cost.<label>.flops``
  / ``.bytes`` once per (label, shape fingerprint) from an analytic
  count the seam supplies. It never runs the step a second time (a train
  step mutates its state, and FLOP counters cannot see ``ctypes``
  kernels); each seam's docstring states its count.
- **Device-memory gauges** — :func:`make_memory_sampler` folds
  ``obs.profiler.device_memory_stats`` (``torch.cuda.memory_stats`` /
  ``mem_get_info``) into ``device.bytes_in_use`` / ``device.peak_bytes``
  / ``device.bytes_limit`` on the shipper cadence. Only a node's shipper
  installs it: a feeder process must never create a CUDA context.

Everything honours the plane's invariant: zero work when ``TOS_OBS=0``
(callers guard on a cached :func:`metrics.active`), failures counted not
raised. ``TOS_OBS_DEVICE=0`` switches just this tier off.
"""

import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

from tensorflowonspark_tpu_torch.obs import metrics as metrics_mod
from tensorflowonspark_tpu_torch.obs import spans as spans_mod

logger = logging.getLogger(__name__)

#: device/compile tier gate — default ON whenever ``TOS_OBS=1``; set to
#: ``0`` to keep the base plane without the sentinel and memory sampler
ENV_OBS_DEVICE = "TOS_OBS_DEVICE"

#: compile durations are ms-to-minutes: dedicated wide bucket bounds
COMPILE_MS_BUCKETS = (1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0,
                      5000.0, 15000.0, 60000.0, 300000.0)

_trace_seen: set = set()
_trace_lock = threading.Lock()
_cost_seen: set = set()
_cost_lock = threading.Lock()
#: sentinel-internal failures (counted, never raised — the tier must not
#: poison the step it observes)
SENTINEL_ERRORS = {"count": 0}


def device_tier_enabled() -> bool:
  """True when the obs plane is on AND the device tier isn't opted out."""
  return metrics_mod.enabled() and \
      os.environ.get(ENV_OBS_DEVICE, "1") not in ("0",)


def _tier_off() -> bool:
  return os.environ.get(ENV_OBS_DEVICE, "1") in ("0",)


def _fingerprint(args) -> str:
  """Stable fingerprint of the shapes a call keys on: (dtype, shape) of
  tensors and arrays, the value of Python scalars (the reference's static
  arguments: a horizon, a prompt length), recursing into dicts, lists and
  tuples; any other object by its type."""
  parts = []

  def walk(x):
    shape = getattr(x, "shape", None)
    if shape is not None:
      parts.append("%s%s" % (getattr(x, "dtype", ""), list(shape)))
    elif isinstance(x, dict):
      for k in sorted(x, key=str):
        parts.append(str(k))
        walk(x[k])
    elif isinstance(x, (list, tuple)):
      parts.append("(")
      for v in x:
        walk(v)
      parts.append(")")
    elif isinstance(x, (bool, int, float, str, type(None))):
      parts.append(repr(x))
    else:
      parts.append(type(x).__name__)

  walk(args)
  return ";".join(parts)


# -- recompile sentinel -------------------------------------------------------


def note_trace(label: str, *args, cache: Optional[set] = None) -> None:
  """Count ``xla.compiles.<label>`` (and ``xla.compiles``) once per new
  shape fingerprint of ``args`` — when the reference's jit would retrace.

  ``cache`` is the seam's own set of seen fingerprints (the counterpart
  of one jitted function's cache: a new step function starts empty); the
  default is one per-process set, for module-level seams. Callers guard
  on a cached registry, so with the plane off this is never reached.
  """
  reg = metrics_mod.active()
  if reg is None:
    return
  try:
    key = (label, _fingerprint(args))
    seen = _trace_seen if cache is None else cache
    with _trace_lock:
      if key in seen:
        return
      seen.add(key)
    reg.counter("xla.compiles." + label).inc()
    reg.counter("xla.compiles").inc()
    rec = spans_mod.active()
    if rec is not None:
      rec.event("compile.trace", label=label)
  except Exception:  # noqa: BLE001 - a telemetry bug must not break a step
    SENTINEL_ERRORS["count"] += 1


def note_build(label: str, seconds: float, cached: bool) -> None:
  """One native library for this process: built now in ``seconds``
  (``xla.compiles``, ``xla.compile_ms``, a retroactive ``compile`` span)
  or found already built (``xla.cache_hits``)."""
  reg = metrics_mod.active()
  if reg is None or _tier_off():
    return
  try:
    if cached:
      reg.counter("xla.cache_hits").inc()
      return
    reg.counter("xla.compiles").inc()
    reg.counter("xla.compiles." + label).inc()
    reg.histogram("xla.compile_ms", COMPILE_MS_BUCKETS).observe(
        seconds * 1e3)
    rec = spans_mod.active()
    if rec is not None:
      # retroactive span: the build ENDS now
      rec.record_span("compile", time.monotonic() - seconds, seconds,
                      label=label)
  except Exception:  # noqa: BLE001 - telemetry must never break a build
    SENTINEL_ERRORS["count"] += 1


def reset_trace_cache() -> None:
  """Forget the per-process trace fingerprints (test isolation helper)."""
  with _trace_lock:
    _trace_seen.clear()


# -- cost gauges --------------------------------------------------------------


def capture_cost(label: str, count_fn: Callable[..., Dict], *args,
                 **kwargs) -> Optional[dict]:
  """Record ``xla.cost.<label>.flops`` / ``.bytes`` once per distinct
  argument-shape fingerprint, from ``count_fn(*args, **kwargs)`` — an
  analytic ``{"flops", "bytes"}`` count of one call the seam supplies
  (the reference lowers the jitted function and reads XLA's
  ``cost_analysis``; nothing here runs the step).

  Also bumps ``xla.cost.captures``; failures are counted into
  ``xla.cost.failures`` and never raised. Returns the captured dict, or
  None (disabled / already seen / count failed).
  """
  reg = metrics_mod.active()
  if reg is None or _tier_off():
    return None
  key = (label, _fingerprint((args, kwargs)))
  with _cost_lock:
    if key in _cost_seen:
      return None
    _cost_seen.add(key)
  try:
    cost = count_fn(*args, **kwargs)
    flops = float(cost.get("flops", 0.0) or 0.0)
    nbytes = float(cost.get("bytes", 0.0) or 0.0)
    reg.gauge("xla.cost.%s.flops" % label).set(flops)
    reg.gauge("xla.cost.%s.bytes" % label).set(nbytes)
    reg.counter("xla.cost.captures").inc()
    rec = spans_mod.active()
    if rec is not None:
      rec.event("compile.cost", label=label, flops=flops, bytes=nbytes)
    return {"flops": flops, "bytes": nbytes}
  except Exception as e:  # noqa: BLE001 - cost counts are best-effort
    reg.counter("xla.cost.failures").inc()
    logger.debug("cost capture for %r failed: %s", label, e)
    return None


def reset_cost_cache() -> None:
  """Forget per-process cost fingerprints (test isolation helper)."""
  with _cost_lock:
    _cost_seen.clear()


# -- device-memory gauges -----------------------------------------------------


def make_memory_sampler(registry: metrics_mod.MetricsRegistry,
                        stats_fn: Optional[Callable[[], Dict]] = None
                        ) -> Callable[[], None]:
  """A sampler closure for :meth:`ObsShipper.add_sampler`: reads
  ``device_memory_stats`` and sets process-wide watermark gauges.

  ``device.bytes_in_use`` / ``device.bytes_limit`` sum across this
  process's cards; ``device.peak_bytes`` is the max single-card peak.
  A process that has not initialised CUDA reports nothing, and the
  sampler leaves the gauges untouched.
  """
  if stats_fn is None:
    from tensorflowonspark_tpu_torch.obs import profiler
    stats_fn = profiler.device_memory_stats
  g_use = registry.gauge("device.bytes_in_use")
  g_peak = registry.gauge("device.peak_bytes")
  g_limit = registry.gauge("device.bytes_limit")
  c_samples = registry.counter("device.mem_samples")
  last = {}

  def sample() -> None:
    stats = stats_fn()
    if not stats:
      return
    in_use = sum(d.get("bytes_in_use", 0) for d in stats.values())
    peak = max((d.get("peak_bytes_in_use", 0) for d in stats.values()),
               default=0)
    limit = sum(d.get("bytes_limit", 0) for d in stats.values())
    cur = (in_use, peak, limit)
    if last.get("v") == cur:
      # static memory on an idle executor: touch NOTHING, or the
      # per-round counter bump alone would wake the shipper's wire
      return
    last["v"] = cur
    g_use.set(in_use)
    if peak:
      g_peak.set(peak)
    if limit:
      g_limit.set(limit)
    c_samples.inc()

  return sample


def install(shipper=None) -> bool:
  """Bring the device tier up on a node's ``shipper``: the memory sampler
  on its cadence, so the gauges ride every delta. No-op (False) when the
  tier is disabled. Unlike the reference there is no compile hook to
  install: the sentinel's seams and the builds count through the live
  registry, so the driver calls nothing here.
  """
  if not device_tier_enabled():
    return False
  if shipper is not None and shipper.registry is not None:
    shipper.add_sampler(make_memory_sampler(shipper.registry))
  return True
