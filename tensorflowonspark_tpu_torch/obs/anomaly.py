"""Driver-side online anomaly & straggler detection over the ObsSink.

The port's copy of ``tensorflowonspark_tpu/obs/anomaly.py``, with one
change: ``mem_slope`` honours the executor's ``TOS_OBS_COMPILE_WARMUP``
grace, as ``recompile_storm`` does. A card's allocated bytes climb from
nothing through the weights, the optimizer state and the first steps'
activations while a healthy executor warms up, and the reference's
detector reads three such samples as a leak (ROADMAP Queue 3).

The obs plane records and ships telemetry; without a consumer online, a
recompile storm, a stalled feed stage, a straggling executor or a
device-memory creep was only visible after the run, in a Chrome trace a
human had to open. The :class:`AnomalyDetector` is the consumer: a
bounded, timeout-bounded driver thread that samples each executor's
cumulative totals from the :class:`obs.collector.ObsSink` on a fixed
cadence, keeps a rolling window per executor, and evaluates the detector
catalogue every pass:

==================  =========================================================
``straggler``       executor step rate below the cluster-median rate by more
                    than ``TOS_OBS_STRAGGLER_PCT`` percent (the tf.data /
                    TPU-concurrency papers' step-time-variance signal)
``feed_stall``      the consumer spent more than ``TOS_OBS_FEED_STALL_FRAC``
                    of the window blocked in the feed plane, with per-stage
                    attribution (fetch vs decode vs assemble — the tf.data
                    paper's input-bound diagnosis; under a ``data.datapipe``
                    graph the dominant GRAPH stage is named instead,
                    ``pipe:<stage>``, so the alert points at the starved
                    transform)
``recompile_storm`` ``xla.compiles`` still advancing after the executor's
                    ``TOS_OBS_COMPILE_WARMUP`` grace (a jit seam keying on
                    data-dependent shapes; obs.device is the source)
``serving_saturated`` request queue depth at/over ``TOS_OBS_QUEUE_SAT`` with
                    slot occupancy ~1: the engine is goodput-bound, admit
                    fewer or add slots
``serve_crash_loop`` ``serve.engine_restarts`` advanced by
                    ``TOS_OBS_CRASH_LOOP`` or more inside the window: the
                    serving engine is crash-replaying repeatedly — a poison
                    request slipped past detection, or the device/runtime
                    is genuinely failing (docs/ROBUSTNESS.md)
``kv_pages_exhausted`` ``serve.kv_pages_free`` pinned at 0 across the whole
                    window while the request queue is non-empty: the paged
                    KV pool is the admission bottleneck — raise
                    ``TOS_SERVE_NUM_PAGES``, shrink
                    ``TOS_SERVE_PREFIX_PAGES``, or shed load
                    (docs/PERFORMANCE.md §paged KV)
``fleet_degraded``  ``fleet.replicas_active`` + ``replicas_draining`` below
                    ``fleet.replicas_total``: one or more serving replicas
                    were EJECTED (terminal death or failed health probes;
                    a draining replica is a rolling swap, not lost
                    capacity) — failover replay keeps accepted requests
                    completing, but the fleet is running without
                    redundancy; restore capacity (docs/ROBUSTNESS.md
                    §Fleet)
``fleet_saturated`` the fleet-aggregate queue is at/over
                    ``TOS_OBS_QUEUE_SAT`` per active replica with mean
                    occupancy ~1 while at FULL replica strength: every
                    replica is goodput-bound — the scale-up signal (the
                    ``serving_saturated`` thresholds applied fleet-wide):
                    add a replica
``group_lost``      ``training.groups_active`` below ``training.groups_total``:
                    one or more elastic training groups were lost or evicted
                    (``parallel.groups``) — surviving groups keep stepping
                    with the sync denominator shrunk, but capacity is gone:
                    re-admit the group or commit the shrink
                    (docs/ROBUSTNESS.md §Elastic training)
``sync_lag``        ``training.sync_ms`` at/over ``TOS_OBS_SYNC_LAG_MS``: the
                    last cross-group sync round ran close to (or into) its
                    deadline — a slow, stalled or partitioned group is
                    dragging every boundary; find it before the miss limit
                    evicts it
``mem_slope``       ``device.bytes_in_use`` grew monotonically by more than
                    ``TOS_OBS_MEM_SLOPE_PCT`` percent across the window (a
                    leak-shaped creep toward OOM), past the executor's
                    ``TOS_OBS_COMPILE_WARMUP`` grace
``slo_burn``        an ``obs.slo`` objective (availability / p-quantile
                    TTFT / e2e) is burning its error budget at/over
                    ``TOS_SLO_BURN`` on BOTH the fast (``TOS_OBS_WINDOW``)
                    and slow (``TOS_SLO_SLOW_MULT`` ×) windows — the
                    service-level verdict the canary phase reads; cluster
                    scope, so ``executor_id`` is −1
``canary_degraded`` a deploy canary is live (``deploy.state`` at
                    CANARY/VERIFY) and either ``deploy.parity_failures``
                    advanced inside the window (the candidate's greedy
                    output diverged from the reference decode — the
                    sharpest possible wrongness signal) or the
                    canary-vs-baseline median-TTFT ratio
                    (``deploy.canary_ttft_ratio``) is at/over
                    ``TOS_OBS_CANARY_RATIO``: the rollout in flight is
                    hurting; the controller's VERIFY gate will roll it
                    back, this alert is the online operator signal
                    (docs/ROBUSTNESS.md §Continuous deployment)
==================  =========================================================

Every alert is a plain msgpack/json-safe dict (see :func:`make_alert`)
and is fanned out four ways, none of which can block the detector:
counted into the driver registry (``obs.alerts``, ``obs.alerts.<kind>``),
mirrored into the ClusterSupervisor's event stream (``alert-<kind>`` —
alerts land next to recoveries in ``supervisor.events``), appended to
the driver's obs JSONL (crash-safe post-mortem for
``tools/obs_report.py --alerts``), and kept in a bounded ring the
rendezvous HEALTH verb serves to out-of-process monitors
(``tools/obs_top.py``).

Invariants (the plane's contract): zero work when ``TOS_OBS=0`` (the cluster
never constructs a detector), every buffer bounded, every wait
timeout-bounded, detector failures counted (``eval_failures``) not
raised, and alerts are COUNTED, never raised — the detector diagnoses,
the supervisor (and the operator) decide.
"""

import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from tensorflowonspark_tpu_torch.obs import metrics as metrics_mod
from tensorflowonspark_tpu_torch.obs import slo as slo_mod
from tensorflowonspark_tpu_torch.obs import spans as spans_mod

logger = logging.getLogger(__name__)

#: detector-loop master gate (default ON with ``TOS_OBS=1``; ``0`` keeps
#: the plane shipping without online evaluation) — env registry: TOS008
ENV_OBS_DETECT = "TOS_OBS_DETECT"
#: seconds between detector passes (TOS008)
ENV_OBS_DETECT_INTERVAL = "TOS_OBS_DETECT_INTERVAL"
#: rolling evaluation window in seconds (TOS008)
ENV_OBS_WINDOW = "TOS_OBS_WINDOW"
#: straggler threshold: percent below the cluster-median step rate (TOS008)
ENV_OBS_STRAGGLER_PCT = "TOS_OBS_STRAGGLER_PCT"
#: recompile storm FIRES AT/ABOVE this many compiles per window after
#: warmup (i.e. up to limit−1 are tolerated) — TOS008
ENV_OBS_RECOMPILE_LIMIT = "TOS_OBS_RECOMPILE_LIMIT"
#: seconds after an executor is first seen before compiles count (TOS008)
ENV_OBS_COMPILE_WARMUP = "TOS_OBS_COMPILE_WARMUP"
#: feed stall: fraction of the window spent inside feed stages (TOS008)
ENV_OBS_FEED_STALL_FRAC = "TOS_OBS_FEED_STALL_FRAC"
#: serving saturation: queue depth at/over this with occupancy ~1 (TOS008)
ENV_OBS_QUEUE_SAT = "TOS_OBS_QUEUE_SAT"
#: serve crash loop FIRES AT/ABOVE this many engine restarts per window
#: (TOS008)
ENV_OBS_CRASH_LOOP = "TOS_OBS_CRASH_LOOP"
#: memory slope: percent in-use growth across the window that fires (TOS008)
ENV_OBS_MEM_SLOPE_PCT = "TOS_OBS_MEM_SLOPE_PCT"
#: cross-group sync round latency (ms) at/over which ``sync_lag`` fires
#: (TOS008)
ENV_OBS_SYNC_LAG_MS = "TOS_OBS_SYNC_LAG_MS"
#: per-(kind, executor) refire suppression in seconds (TOS008)
ENV_OBS_ALERT_COOLDOWN = "TOS_OBS_ALERT_COOLDOWN"
#: canary degradation: canary/baseline median-TTFT ratio at/over which
#: ``canary_degraded`` fires while a deploy canary is live (TOS008)
ENV_OBS_CANARY_RATIO = "TOS_OBS_CANARY_RATIO"

_DEFAULT_INTERVAL = 2.0
_DEFAULT_WINDOW = 20.0
_DEFAULT_STRAGGLER_PCT = 50.0
_DEFAULT_RECOMPILE_LIMIT = 3
_DEFAULT_COMPILE_WARMUP = 120.0
_DEFAULT_FEED_STALL_FRAC = 0.6
_DEFAULT_QUEUE_SAT = 8
_DEFAULT_CRASH_LOOP = 2
_DEFAULT_MEM_SLOPE_PCT = 10.0
_DEFAULT_COOLDOWN = 30.0
_DEFAULT_SYNC_LAG_MS = 2000.0
_DEFAULT_CANARY_RATIO = 10.0

#: bounded alert ring (driver memory; the JSONL keeps the full history)
MAX_ALERTS = 256
#: a straggler verdict needs the median executor to have made at least
#: this many steps inside the window — below it, rates are noise
MIN_WINDOW_STEPS = 5
#: memory slope needs at least this many samples across the window
MIN_MEM_SAMPLES = 3

#: the datapipe executor's per-stage busy gauges: ``feed.stage.<name>.busy_s``
#: (dynamic stage names — sampled by prefix, not by the fixed list below)
_PIPE_PREFIX = "feed.stage."
_PIPE_SUFFIX = ".busy_s"

#: the cumulative/gauge metric names one detector pass reads per executor
_SAMPLED = ("train.steps", "train.unroll", "feed.batches", "feed.fetch_s",
            "feed.decode_s", "feed.assemble_s", "xla.compiles",
            "serve.queue_depth", "serve.occupancy",
            "serve.engine_restarts", "serve.replays",
            "serve.kv_pages_free", "serve.kv_pages_in_use",
            "fleet.replicas_total", "fleet.replicas_active",
            "fleet.replicas_draining", "fleet.queue_depth",
            "fleet.occupancy",
            "serve.hosts_total", "serve.hosts_alive",
            "training.groups_total", "training.groups_active",
            "training.sync_ms",
            "deploy.state", "deploy.version", "deploy.candidate",
            "deploy.canary_ttft_ratio", "deploy.parity_failures",
            "deploy.canaries", "deploy.promotions", "deploy.rollbacks",
            "device.bytes_in_use")


def detect_enabled() -> bool:
  """True when the obs plane is on and the detector loop isn't opted out."""
  return metrics_mod.enabled() and \
      os.environ.get(ENV_OBS_DETECT, "1") not in ("0",)


def _env_float(name: str, default: float) -> float:
  try:
    return float(os.environ.get(name, default))
  except ValueError:
    return default


def make_alert(kind: str, executor_id: int, window_s: float,
               evidence: Dict, message: str, t: Optional[float] = None
               ) -> dict:
  """One structured alert record. ``alert`` (not ``kind``) carries the
  detector name so the record can ride the obs JSONL, whose per-line
  ``kind`` field is the record-type discriminator."""
  return {"alert": kind, "executor_id": int(executor_id),
          "t": time.monotonic() if t is None else t,
          "window_s": round(float(window_s), 3),
          "evidence": {k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in evidence.items()},
          "message": message}


class AnomalyDetector(object):
  """Rolling-window detector loop over a driver-side ObsSink.

  ``sink`` needs only ``metrics(eid) -> {name: snapshot}`` per executor
  and ``executors`` keys — tests drive synthetic sinks. ``supervisor``
  (optional) receives each alert via its ``_event`` stream;
  ``jsonl`` (optional, an ``obs.export.ProcessLog``) gets crash-safe
  per-alert appends. ``time_fn`` injects a clock for deterministic tests.
  """

  def __init__(self, sink, supervisor=None, jsonl=None,
               interval: Optional[float] = None,
               window: Optional[float] = None,
               registry=None, recorder=None, time_fn=time.monotonic,
               slo_tracker=None):
    self.sink = sink
    self.supervisor = supervisor
    self.jsonl = jsonl
    self.interval = max(0.05, interval if interval is not None else
                        _env_float(ENV_OBS_DETECT_INTERVAL,
                                   _DEFAULT_INTERVAL))
    self.window = max(2 * self.interval, window if window is not None else
                      _env_float(ENV_OBS_WINDOW, _DEFAULT_WINDOW))
    self.straggler_pct = _env_float(ENV_OBS_STRAGGLER_PCT,
                                    _DEFAULT_STRAGGLER_PCT)
    self.recompile_limit = _env_float(ENV_OBS_RECOMPILE_LIMIT,
                                      _DEFAULT_RECOMPILE_LIMIT)
    self.compile_warmup = _env_float(ENV_OBS_COMPILE_WARMUP,
                                     _DEFAULT_COMPILE_WARMUP)
    self.feed_stall_frac = _env_float(ENV_OBS_FEED_STALL_FRAC,
                                      _DEFAULT_FEED_STALL_FRAC)
    self.queue_sat = _env_float(ENV_OBS_QUEUE_SAT, _DEFAULT_QUEUE_SAT)
    self.crash_loop_limit = _env_float(ENV_OBS_CRASH_LOOP,
                                       _DEFAULT_CRASH_LOOP)
    self.mem_slope_pct = _env_float(ENV_OBS_MEM_SLOPE_PCT,
                                    _DEFAULT_MEM_SLOPE_PCT)
    self.sync_lag_ms = _env_float(ENV_OBS_SYNC_LAG_MS,
                                  _DEFAULT_SYNC_LAG_MS)
    self.canary_ratio = _env_float(ENV_OBS_CANARY_RATIO,
                                   _DEFAULT_CANARY_RATIO)
    self.cooldown = _env_float(ENV_OBS_ALERT_COOLDOWN, _DEFAULT_COOLDOWN)
    #: detectors only evaluate once a window's sample span reaches this —
    #: sub-second startup windows turn executor launch skew into phantom
    #: stragglers (seen in the bring-up drive: a 0.2 s window where one
    #: executor had stepped and the other hadn't yet)
    self.min_span = max(2 * self.interval, 0.5 * self.window)
    self._time = time_fn
    self._reg = registry if registry is not None else metrics_mod.active()
    self._rec = recorder if recorder is not None else spans_mod.active()
    #: the SLO plane (obs.slo): objectives declared via TOS_SLO_* ride
    #: this loop's cadence — sample + burn-rate evaluate per pass, with
    #: ``slo_burn`` fanned out exactly like every other alert. Falsy
    #: (no objectives) = the whole check is one truthiness test.
    self.slo = slo_tracker if slo_tracker is not None else \
        slo_mod.SLOTracker(window=self.window)
    # eid -> deque[(t, {name: float})]; capped well past window/interval
    self._samples: Dict[int, deque] = {}
    self._first_seen: Dict[int, float] = {}
    self._last_fired: Dict[tuple, float] = {}
    self._poll_lock = threading.Lock()
    self._cond = threading.Condition()
    self._alerts: deque = deque(maxlen=MAX_ALERTS)
    self.alerts_total = 0
    self.counts_by_kind: Dict[str, int] = {}
    self.eval_failures = 0
    # last pass's full per-executor metric snapshots (set by _sample)
    self._pass_metrics: Dict[int, Dict] = {}
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None

  # -- sampling --------------------------------------------------------------

  @staticmethod
  def _extract(metrics_snapshot: Dict[str, dict]) -> Dict[str, float]:
    vals = {}
    for name in _SAMPLED:
      m = metrics_snapshot.get(name)
      if m is not None and "value" in m:
        vals[name] = float(m["value"])
    # the datapipe executor's per-stage busy gauges (dynamic names —
    # one per declared graph stage) feed the feed_stall detector's
    # per-graph-stage attribution
    for name, m in metrics_snapshot.items():
      if name.startswith(_PIPE_PREFIX) and name.endswith(_PIPE_SUFFIX) \
          and m is not None and "value" in m:
        vals[name] = float(m["value"])
    return vals

  def _sample(self, now: float) -> None:
    # full per-executor snapshots for THIS pass: the scalar extract
    # below feeds the component detectors, while the SLO check needs
    # the raw state (quantile sketches aren't scalars) — one fetch
    # serves both
    self._pass_metrics = {}
    for eid in list(getattr(self.sink, "executors", {})):
      try:
        snap = self.sink.metrics(eid)
        vals = self._extract(snap)
      except Exception:  # noqa: BLE001 - a sink hiccup skips one sample
        self.eval_failures += 1
        continue
      self._pass_metrics[int(eid)] = snap
      dq = self._samples.setdefault(int(eid), deque(maxlen=4096))
      self._first_seen.setdefault(int(eid), now)
      dq.append((now, vals))
      # retire samples older than the window, always keeping the newest
      # pre-window sample as the delta baseline
      while len(dq) >= 2 and dq[1][0] <= now - self.window:
        dq.popleft()

  @staticmethod
  def _delta(dq, name: str) -> Optional[float]:
    first, last = dq[0][1].get(name), dq[-1][1].get(name)
    if first is None or last is None:
      return None
    return last - first

  # -- evaluation ------------------------------------------------------------

  def poll(self, now: Optional[float] = None) -> List[dict]:
    """One sample + evaluate pass; returns the alerts fired by THIS pass
    (they are also recorded/fanned out). The thread loop calls this; so
    do tests, with an injected ``now``."""
    if now is None:
      now = self._time()
    new: List[dict] = []
    # one evaluator at a time: a caller-driven poll (tests, the shutdown
    # final pass) must not interleave with the loop thread's — the
    # cooldown's check-then-set isn't atomic on its own
    with self._poll_lock:
      new.extend(self._poll_locked(now))
    return new

  def _poll_locked(self, now: float) -> List[dict]:
    new: List[dict] = []
    try:
      self._sample(now)
      windows = {}
      for eid, dq in self._samples.items():
        span = dq[-1][0] - dq[0][0]
        if len(dq) >= 2 and span >= self.min_span:
          windows[eid] = (dq, span)
      new.extend(self._check_stragglers(windows, now))
      for eid, (dq, span) in windows.items():
        new.extend(self._check_feed_stall(eid, dq, span, now))
        new.extend(self._check_recompiles(eid, dq, span, now))
        new.extend(self._check_serving(eid, dq, span, now))
        new.extend(self._check_serve_crash_loop(eid, dq, span, now))
        new.extend(self._check_kv_pages(eid, dq, span, now))
        new.extend(self._check_fleet(eid, dq, span, now))
        new.extend(self._check_hosts(eid, dq, span, now))
        new.extend(self._check_groups(eid, dq, span, now))
        new.extend(self._check_deploy(eid, dq, span, now))
        new.extend(self._check_mem_slope(eid, dq, span, now))
      new.extend(self._check_slo(now))
    except Exception:  # noqa: BLE001 - the detector must outlive any
      # single evaluation bug; failures are counted and visible
      self.eval_failures += 1
      logger.exception("anomaly evaluation pass failed")
    return new

  def _check_stragglers(self, windows, now) -> List[dict]:
    rates = {}
    for eid, (dq, span) in windows.items():
      d = self._delta(dq, "train.steps")
      if d is not None:
        rates[eid] = d / span
    # a lone executor has no cluster to straggle behind
    if len(rates) < 2:
      return []
    ordered = sorted(rates.values())
    median = ordered[len(ordered) // 2]
    span = max(s for _, s in windows.values())
    if median * span < MIN_WINDOW_STEPS:
      return []   # the cluster itself is barely stepping: rates are noise
    out = []
    threshold = median * (1.0 - self.straggler_pct / 100.0)
    for eid, rate in rates.items():
      if rate >= threshold:
        continue
      # fused-loop burst quantization (make_train_loop): steps arrive K
      # at a time, so an executor whose slab dispatch straddles the
      # window edge can show up to one slab (train.unroll) fewer steps
      # than its healthy peers — being behind by AT MOST one burst is
      # sampling noise, not straggling
      dq, span = windows[eid]
      burst = max(1.0, dq[-1][1].get("train.unroll", 1.0))
      behind_steps = (median - rate) * span
      if behind_steps <= burst:
        continue
      out.extend(self._fire(
          "straggler", eid, span, now,
          {"rate": rate, "cluster_median": median,
           "pct_behind": 100.0 * (1.0 - rate / median) if median else 0.0},
          "executor %d steps at %.2f/s vs cluster median %.2f/s "
          "(>%g%% behind)" % (eid, rate, median, self.straggler_pct)))
    return out

  def _check_feed_stall(self, eid, dq, span, now) -> List[dict]:
    stages = {s: self._delta(dq, "feed.%s" % s) or 0.0
              for s in ("fetch_s", "decode_s", "assemble_s")}
    # per-graph-stage attribution: a datapipe executor exports one
    # ``feed.stage.<name>.busy_s`` per declared stage (the classic
    # three stay zero in graph mode and vice versa, so the union never
    # double-counts). The alert then NAMES the starved transform
    # (``pipe:map0``), not just "fetch".
    for name in dq[-1][1]:
      if name.startswith(_PIPE_PREFIX) and name.endswith(_PIPE_SUFFIX):
        short = name[len(_PIPE_PREFIX):-len(_PIPE_SUFFIX)]
        stages["pipe:" + short] = self._delta(dq, name) or 0.0
    total = sum(stages.values())
    batches = self._delta(dq, "feed.batches")
    if batches is None:   # no DataFeed on this executor (FILES mode)
      return []
    if dq[-1][1].get("feed.batches", 0.0) <= 0:
      return []   # never delivered anything: bring-up, not a stall
    if batches > 0:
      return []   # fresh batches landed: the feed kept up. (The fetch
      # PIPELINE thread accrues fetch_s even while batches flow — stage
      # seconds alone cannot distinguish healthy overlap from a stall.)
    steps = self._delta(dq, "train.steps")
    if steps is not None and steps > 0:
      return []   # consumer progressed on buffered data: not starved yet
    if total < self.feed_stall_frac * span:
      return []
    stage = max(stages, key=stages.get)
    return self._fire(
        "feed_stall", eid, span, now,
        dict(stages, batches=batches, frac=total / span, stage=stage),
        "executor %d starved: zero fresh batches over %.0fs while the "
        "feed plane ran %.0f%% of it (dominant stage: %s) — input-bound "
        "or upstream stopped feeding" % (eid, span, 100 * total / span,
                                         stage))

  def _check_recompiles(self, eid, dq, span, now) -> List[dict]:
    if now - self._first_seen.get(eid, now) < self.compile_warmup:
      return []
    d = self._delta(dq, "xla.compiles")
    if d is None or d < self.recompile_limit:
      return []
    return self._fire(
        "recompile_storm", eid, span, now,
        {"compiles": d, "total": dq[-1][1].get("xla.compiles", 0.0)},
        "executor %d compiled %d time(s) in the last %.0fs, past its "
        "%.0fs warmup — a jit seam is keying on data-dependent shapes"
        % (eid, int(d), span, self.compile_warmup))

  def _check_serving(self, eid, dq, span, now) -> List[dict]:
    depth = dq[-1][1].get("serve.queue_depth")
    occ = dq[-1][1].get("serve.occupancy")
    if depth is None or occ is None:
      return []
    if depth < self.queue_sat or occ < 0.9:
      return []
    return self._fire(
        "serving_saturated", eid, span, now,
        {"queue_depth": depth, "occupancy": occ},
        "executor %d serving at occupancy %.2f with %d queued request(s) "
        "— goodput-bound; add slots or shed load" % (eid, occ, int(depth)))

  def _check_serve_crash_loop(self, eid, dq, span, now) -> List[dict]:
    d = self._delta(dq, "serve.engine_restarts")
    if d is None or d < self.crash_loop_limit:
      return []
    replays = self._delta(dq, "serve.replays") or 0.0
    return self._fire(
        "serve_crash_loop", eid, span, now,
        {"restarts": d, "replays": replays,
         "total_restarts": dq[-1][1].get("serve.engine_restarts", 0.0)},
        "executor %d serving engine restarted %d time(s) in the last "
        "%.0fs (%d request replays) — crash-looping: a poison request "
        "slipped past detection, or the device/runtime is failing"
        % (eid, int(d), span, int(replays)))

  def _check_kv_pages(self, eid, dq, span, now) -> List[dict]:
    """Paged-KV pool exhaustion: free pages PINNED at zero for the whole
    window (a transient dip to 0 between completions is normal — any
    sample above 0 clears the verdict) while requests are queued waiting
    for pages. The fix is capacity-shaped, not load-shaped, so this is
    its own kind rather than a ``serving_saturated`` variant."""
    frees = [v["serve.kv_pages_free"] for _, v in dq
             if "serve.kv_pages_free" in v]
    if len(frees) < 2:
      return []   # paging off, or not enough window to call it pinned
    if max(frees) > 0:
      return []
    depth = dq[-1][1].get("serve.queue_depth")
    if depth is None or depth <= 0:
      return []   # nothing waiting: a full pool at zero queue is just full
    in_use = dq[-1][1].get("serve.kv_pages_in_use", 0.0)
    return self._fire(
        "kv_pages_exhausted", eid, span, now,
        {"queue_depth": depth, "pages_in_use": in_use,
         "samples_at_zero": len(frees)},
        "executor %d KV page pool pinned at 0 free pages for %.0fs with "
        "%d queued request(s) — paging is the admission bottleneck: "
        "raise TOS_SERVE_NUM_PAGES, shrink TOS_SERVE_PREFIX_PAGES, or "
        "shed load" % (eid, span, int(depth)))

  def _check_fleet(self, eid, dq, span, now) -> List[dict]:
    """The serving-fleet pair: ``fleet_degraded`` when the router runs
    below its configured replica count (ejection visible online, not
    just in the event log), and ``fleet_saturated`` — the SCALE-UP
    signal — when the fleet is at full strength yet every replica is
    goodput-bound (the ``serving_saturated`` thresholds applied to the
    fleet aggregate: queue ≥ ``TOS_OBS_QUEUE_SAT`` per active replica at
    mean occupancy ~1). Degraded and saturated are different verdicts on
    purpose: the first says restore capacity, the second says add it."""
    latest = dq[-1][1]
    total = latest.get("fleet.replicas_total")
    active = latest.get("fleet.replicas_active")
    if total is None or active is None or total <= 0:
      return []
    # a DRAINING replica is a rolling swap in progress — healthy,
    # operator-initiated, zero-shed — not lost capacity: alarming on it
    # would train operators to ignore the real ejection signal
    draining = latest.get("fleet.replicas_draining") or 0.0
    if active + draining < total:
      return self._fire(
          "fleet_degraded", eid, span, now,
          {"replicas_active": active, "replicas_draining": draining,
           "replicas_total": total},
          "serving fleet on executor %d running %d/%d replicas — "
          "ejected replica(s) failed over; accepted requests keep "
          "completing but redundancy is gone: restore capacity"
          % (eid, int(active), int(total)))
    if active < total:
      return []   # mid-swap: saturation readings are perturbed anyway
    depth = latest.get("fleet.queue_depth")
    occ = latest.get("fleet.occupancy")
    if depth is None or occ is None:
      return []
    if depth < self.queue_sat * max(1.0, active) or occ < 0.9:
      return []
    return self._fire(
        "fleet_saturated", eid, span, now,
        {"queue_depth": depth, "occupancy": occ,
         "replicas_active": active},
        "serving fleet on executor %d saturated at full strength: %d "
        "queued request(s) across %d replicas at occupancy %.2f — "
        "scale up: add a replica" % (eid, int(depth), int(active), occ))

  def _check_hosts(self, eid, dq, span, now) -> List[dict]:
    """``host_lost``: the cross-host serving plane is syncing fewer
    ServingHosts than it has registered — a host process died, was
    preempted, or is partitioned past ``TOS_HOST_TIMEOUT``. Distinct
    from ``fleet_saturated`` on purpose: saturation fires only at FULL
    strength (every replica alive, goodput-bound — the scale-up
    signal); a lost host is missing capacity regardless of load (the
    restore-capacity signal), so this keys purely on the alive/total
    gap and carries the fleet's load gauges as evidence to make the
    distinction legible in the alert itself."""
    latest = dq[-1][1]
    total = latest.get("serve.hosts_total")
    alive = latest.get("serve.hosts_alive")
    if total is None or alive is None or total <= 0 or alive >= total:
      return []
    return self._fire(
        "host_lost", eid, span, now,
        {"hosts_alive": alive, "hosts_total": total,
         "fleet_queue_depth": latest.get("fleet.queue_depth") or 0.0,
         "fleet_occupancy": latest.get("fleet.occupancy") or 0.0},
        "cross-host serving plane on executor %d syncing %d/%d host(s) "
        "— a ServingHost died or is partitioned; its replica is being "
        "ejected and its accepted requests failover-replayed: restore "
        "the host (this is lost capacity, not saturation)"
        % (eid, int(alive), int(total)))

  def _check_groups(self, eid, dq, span, now) -> List[dict]:
    """The elastic-training pair (``parallel.groups``): ``group_lost``
    when the group set runs below its total — a group died or was
    evicted, surviving groups keep stepping with the sync denominator
    shrunk, but the lost throughput stays lost until someone re-admits
    the group or commits the shrink — and ``sync_lag`` when the last
    cross-group sync round took at/over ``TOS_OBS_SYNC_LAG_MS``: a
    slow or stalled group is dragging every boundary toward the round
    deadline, and past the miss limit the plane will evict it."""
    latest = dq[-1][1]
    out: List[dict] = []
    total = latest.get("training.groups_total")
    active = latest.get("training.groups_active")
    if total is not None and active is not None and total > 0 \
        and active < total:
      out.extend(self._fire(
          "group_lost", eid, span, now,
          {"groups_active": active, "groups_total": total},
          "elastic training on executor %d running %d/%d groups — "
          "lost group(s) shrank the sync denominator; training "
          "continues degraded: re-admit the group or commit the "
          "shrink" % (eid, int(active), int(total))))
    sync_ms = latest.get("training.sync_ms")
    if sync_ms is not None and sync_ms >= self.sync_lag_ms:
      out.extend(self._fire(
          "sync_lag", eid, span, now,
          {"sync_ms": sync_ms, "threshold_ms": self.sync_lag_ms},
          "cross-group weight sync on executor %d took %.0fms "
          "(threshold %.0fms) — a slow or stalled group is dragging "
          "rounds toward the deadline"
          % (eid, sync_ms, self.sync_lag_ms)))
    return out

  def _check_deploy(self, eid, dq, span, now) -> List[dict]:
    """``canary_degraded``: a rollout canary is live (``deploy.state``
    at CANARY/VERIFY) and hurting — parity spot-checks diverged inside
    the window, or the canary-vs-baseline median-TTFT ratio is at/over
    ``TOS_OBS_CANARY_RATIO``. The controller's own VERIFY gate decides
    the rollback; this is the ONLINE operator signal (and the one the
    bake-window check reads back through ``slo_status``-style plumbing),
    so it keys on the candidate version: a second candidate gets its own
    cooldown."""
    latest = dq[-1][1]
    state = latest.get("deploy.state")
    if state is None or int(state) not in (1, 2):   # CANARY, VERIFY
      return []
    candidate = int(latest.get("deploy.candidate") or 0)
    out: List[dict] = []
    parity = self._delta(dq, "deploy.parity_failures")
    ratio = latest.get("deploy.canary_ttft_ratio")
    if parity is not None and parity > 0:
      out.extend(self._fire(
          "canary_degraded", eid, span, now,
          {"candidate": candidate, "parity_failures": parity},
          "deploy canary for version %d diverged from the reference "
          "decode %d time(s) in the window — the candidate is serving "
          "wrong outputs; VERIFY will quarantine it"
          % (candidate, int(parity)),
          key=("canary_degraded", "parity", candidate)))
    if ratio is not None and ratio >= self.canary_ratio:
      out.extend(self._fire(
          "canary_degraded", eid, span, now,
          {"candidate": candidate, "ttft_ratio": ratio,
           "threshold": self.canary_ratio},
          "deploy canary for version %d running %.1fx baseline median "
          "TTFT (threshold %.1fx) — the candidate is slow; expect a "
          "rollback" % (candidate, ratio, self.canary_ratio),
          key=("canary_degraded", "ttft", candidate)))
    return out

  def deploy_status(self) -> Optional[dict]:
    """The HEALTH-wire deploy payload (None until some process ships
    ``deploy.*`` gauges): the newest sampled controller state, so
    ``obs_top`` can render the ``deploy[...]`` row without reaching the
    controller process. Read-side only — the authoritative state machine
    lives in ``serving.deploy``."""
    best = None
    best_t = None
    for dq in self._samples.values():
      if not dq:
        continue
      t, vals = dq[-1]
      if "deploy.state" not in vals:
        continue
      if best_t is None or t > best_t:
        best_t, best = t, vals
    if best is None:
      return None
    names = ("idle", "canary", "verify", "promote", "rollback")
    code = int(best.get("deploy.state") or 0)
    return {"state": names[code] if 0 <= code < len(names) else str(code),
            "state_code": code,
            "version": int(best.get("deploy.version") or 0) or None,
            "candidate": int(best.get("deploy.candidate") or 0) or None,
            "ttft_ratio": best.get("deploy.canary_ttft_ratio"),
            "canaries": int(best.get("deploy.canaries") or 0),
            "promotions": int(best.get("deploy.promotions") or 0),
            "rollbacks": int(best.get("deploy.rollbacks") or 0),
            "parity_failures": int(best.get("deploy.parity_failures")
                                   or 0)}

  def _check_slo(self, now) -> List[dict]:
    """Sample + burn-rate-evaluate the declared SLO objectives
    (``obs.slo``). Latency objectives read the cluster-MERGED quantile
    sketches straight off the sink's per-executor state (not the
    ``_SAMPLED`` float path — sketches aren't scalars), availability the
    summed serve counters; ``slo_burn`` fires per objective (its own
    cooldown key) at cluster scope, executor_id −1."""
    if not self.slo:
      return []
    self.slo.sample(now, self._pass_metrics)
    out = []
    for v in self.slo.evaluate(now):
      if not v.get("burning"):
        continue
      if v["kind"] == "latency":
        detail = ("%s=%.1fms over the %.0fms bound"
                  % (v["name"], v["observed"] or 0.0, v["threshold_ms"]))
      else:
        detail = "availability %.5f vs target %.5f" % (
            v["observed"] if v["observed"] is not None else 1.0,
            v["target"])
      out.extend(self._fire(
          "slo_burn", -1, v["window_slow"], now,
          {"objective": v["name"], "burn_fast": v["burn_fast"],
           "burn_slow": v["burn_slow"],
           "bad_frac_fast": v["bad_frac_fast"],
           "bad_frac_slow": v["bad_frac_slow"],
           "events_slow": v["events_slow"],
           "budget": v["budget"], "observed": v["observed"]},
          "SLO %s burning its error budget at %.1fx (fast) / %.1fx "
          "(slow) over the %.0fs/%.0fs windows — %s" % (
              v["name"], v["burn_fast"], v["burn_slow"],
              v["window_fast"], v["window_slow"], detail),
          key=("slo_burn", v["name"])))
    return out

  def slo_status(self) -> Optional[dict]:
    """The HEALTH-wire SLO payload (None when no objectives are
    declared) — ``Server`` attaches it to HEALTH replies next to the
    alert ring, and ``obs_top`` renders the ``slo[...]`` row off it."""
    if not self.slo:
      return None
    return self.slo.status(self._time())

  def _check_mem_slope(self, eid, dq, span, now) -> List[dict]:
    if now - self._first_seen.get(eid, now) < self.compile_warmup:
      return []   # weights, optimizer state, first activations: warm-up
    series = [(t, v["device.bytes_in_use"]) for t, v in dq
              if "device.bytes_in_use" in v]
    if len(series) < MIN_MEM_SAMPLES:
      return []
    values = [v for _, v in series]
    first, last = values[0], values[-1]
    if first <= 0 or last <= first or last < max(values):
      return []   # flat, shrinking, or already peaked — not a creep
    growth_pct = 100.0 * (last - first) / first
    if growth_pct < self.mem_slope_pct:
      return []
    return self._fire(
        "mem_slope", eid, span, now,
        {"first_bytes": first, "last_bytes": last,
         "growth_pct": growth_pct,
         "slope_bytes_per_s": (last - first) / span},
        "executor %d device memory grew %.1f%% over %.0fs (%.0f B/s) — "
        "leak-shaped creep" % (eid, growth_pct, span,
                               (last - first) / span))

  # -- alert fan-out ---------------------------------------------------------

  def _fire(self, kind, eid, span, now, evidence, message,
            key=None) -> List[dict]:
    # default cooldown key is (kind, executor); cluster-scope detectors
    # (slo_burn) pass their own so two objectives don't share a cooldown
    key = key if key is not None else (kind, int(eid))
    last = self._last_fired.get(key)
    if last is not None and now - last < self.cooldown:
      return []
    self._last_fired[key] = now
    alert = make_alert(kind, eid, span, evidence, message, t=now)
    logger.warning("obs alert: %s", message)
    with self._cond:
      self._alerts.append(alert)
      self.alerts_total += 1
      self.counts_by_kind[kind] = self.counts_by_kind.get(kind, 0) + 1
      self._cond.notify_all()
    if self._reg is not None:
      self._reg.counter("obs.alerts").inc()
      self._reg.counter("obs.alerts." + kind).inc()
    if self._rec is not None:
      self._rec.event("obs.alert", alert=kind, executor_id=int(eid))
    if self.supervisor is not None:
      try:
        # same stream as detected-dead/relaunched/recovered: the alert
        # IS a cluster event, and tests/operators already read this list
        self.supervisor._event("alert-" + kind, executor_id=int(eid),
                               message=message)
      except Exception:  # noqa: BLE001 - a supervisor in teardown must
        self.eval_failures += 1   # not take the detector with it
    if self.jsonl is not None:
      self.jsonl.append_alerts([alert])
    return [alert]

  # -- read plane ------------------------------------------------------------

  def recent_alerts(self, max_items: int = 64) -> List[dict]:
    """Newest-first bounded slice for HEALTH replies / obs_top."""
    with self._cond:
      items = list(self._alerts)[-max_items:]
    return list(reversed(items))

  def wait_alert(self, timeout: float, kind: Optional[str] = None
                 ) -> Optional[dict]:
    """Block (bounded) until an alert exists — newest matching one, or
    None on timeout. Named into the analyzer's blocking-verb set
    (TOS001): callers must pass an explicit ``timeout``."""
    deadline = time.monotonic() + timeout
    with self._cond:
      while True:
        for a in reversed(self._alerts):
          if kind is None or a["alert"] == kind:
            return dict(a)
        remaining = deadline - time.monotonic()
        if remaining <= 0:
          return None
        self._cond.wait(timeout=min(remaining, 0.25))

  def summary(self) -> dict:
    with self._cond:
      return {"alerts_total": self.alerts_total,
              "by_kind": dict(self.counts_by_kind),
              "eval_failures": self.eval_failures,
              "interval": self.interval, "window": self.window}

  # -- lifecycle -------------------------------------------------------------

  def _run(self) -> None:
    while not self._stop.wait(self.interval):
      self.poll()

  def start(self) -> "AnomalyDetector":
    self._thread = threading.Thread(target=self._run, daemon=True,
                                    name="tos-obs-anomaly")
    self._thread.start()
    return self

  def stop(self, timeout: float = 5.0) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=timeout)
      self._thread = None
