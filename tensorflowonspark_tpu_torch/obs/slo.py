"""Declarative SLO objectives + multi-window burn-rate evaluation.

The port's copy of ``tensorflowonspark_tpu/obs/slo.py``, unchanged.

The anomaly detectors (``obs.anomaly``) answer "is a component
misbehaving"; this module answers the operator/canary question "is the
SERVICE meeting its promises" — and does it with the two ingredients a
point threshold lacks:

- **principled latency objects**: a latency objective ("p99 TTFT ≤ X
  ms") is evaluated against the cluster-MERGED quantile sketches
  (``obs.quantiles``) the engines record per request, not against one
  process's histogram buckets. Internally every objective reduces to a
  *bad-fraction over an error budget*: "p99 ≤ X" means "at most 1% of
  requests may exceed X", so the SLI is the fraction over X — which a
  sketch answers with a rank query, and which DELTAS across a window
  (two cumulative (count, over-count) samples subtract) even though
  sketches themselves don't.
- **burn-rate alerting**: a point threshold pages on every blip and
  sleeps through slow leaks. The burn rate is ``bad_fraction /
  error_budget`` — how many times faster than sustainable the budget is
  being spent — and the alert fires only when BOTH a fast window and a
  slow window (the classic 5m/1h pair, here ``TOS_OBS_WINDOW`` and
  ``TOS_SLO_SLOW_MULT`` × it — 12× is exactly the 5m:1h ratio) exceed
  ``TOS_SLO_BURN``: the slow window proves it is sustained, the fast
  window proves it is still happening (so a recovered incident stops
  paging). A routine zero-shed rolling swap moves neither window's
  bad counts, so it stays quiet by construction — the ``fleet_degraded``
  false-positive lesson, re-applied to SLOs.

Objectives (all knobs TOS008-registered):

==========================  ==================================================
``TOS_SLO_AVAILABILITY``    availability target (default 0.999; ``0`` = off):
                            1 − bad/submitted at the CLIENT boundary — fleet
                            counters (``fleet.submitted`` vs ``fleet.rejected``
                            + ``fleet.shed``) when a fleet is present, else
                            engine counters (``serve.submitted`` vs
                            ``serve.rejected`` + ``serve.poisoned``)
``TOS_SLO_TTFT_MS``         p-quantile TTFT bound in ms (unset/0 = off) over
                            the merged ``serve.ttft_ms`` sketches
``TOS_SLO_E2E_MS``          p-quantile end-to-end latency bound in ms
                            (unset/0 = off) over ``serve.e2e_ms``
``TOS_SLO_QUANTILE``        the p in the latency objectives (default 0.99 —
                            the budget is 1 − p)
``TOS_SLO_BURN``            burn-rate threshold both windows must exceed
                            (default 14.4 — the classic page-level rate:
                            a 30-day budget gone in ~2 days)
``TOS_SLO_SLOW_MULT``       slow window as a multiple of the fast one
                            (default 12 = the 5m:1h ratio)
``TOS_SLO_MIN_EVENTS``      events the slow window must hold before a verdict
                            (default 10: one bad request out of one is a
                            sample, not an outage)
==========================  ==================================================

The :class:`SLOTracker` is driven by the :class:`~.anomaly
.AnomalyDetector` loop (sample + evaluate per pass; ``slo_burn`` rides
the detector's 4-way alert fan-out) and serves its status over the
rendezvous ``HEALTH`` verb (``reply["slo"]``) for ``obs_top`` and the
item-5 canary verdict. ``tools/slo_report.py`` replays the same
objectives over recorded JSONL/history for offline compliance.
"""

import os
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from tensorflowonspark_tpu_torch.obs import quantiles as quantiles_mod

#: availability SLO target (TOS008); 0 disables the objective
ENV_SLO_AVAILABILITY = "TOS_SLO_AVAILABILITY"
#: TTFT latency objective bound in ms (TOS008); unset/0 disables
ENV_SLO_TTFT_MS = "TOS_SLO_TTFT_MS"
#: end-to-end latency objective bound in ms (TOS008); unset/0 disables
ENV_SLO_E2E_MS = "TOS_SLO_E2E_MS"
#: the quantile latency objectives bound (TOS008)
ENV_SLO_QUANTILE = "TOS_SLO_QUANTILE"
#: burn-rate threshold both windows must exceed to fire (TOS008)
ENV_SLO_BURN = "TOS_SLO_BURN"
#: slow window = this multiple of the fast (detector) window (TOS008)
ENV_SLO_SLOW_MULT = "TOS_SLO_SLOW_MULT"
#: minimum events in the slow window before any verdict (TOS008)
ENV_SLO_MIN_EVENTS = "TOS_SLO_MIN_EVENTS"

_DEFAULT_AVAILABILITY = 0.999
_DEFAULT_QUANTILE = 0.99
_DEFAULT_BURN = 14.4
_DEFAULT_SLOW_MULT = 12.0
_DEFAULT_MIN_EVENTS = 10

#: the availability objective reads the CLIENT boundary. When a fleet
#: fronts the engines (``fleet.submitted`` moving), its counters are the
#: client-visible truth: engine-level ``serve.submitted``/``rejected``
#: count dispatch ATTEMPTS — a retry burst the fleet fully absorbs would
#: read as unavailability, a request that failed over N times would
#: dilute the denominator, and a TOTAL outage (no live replica) never
#: reaches an engine at all, so only fleet counters move. A poisoned
#: fleet request exhausts its failover budget and lands in
#: ``fleet.shed``. Engine-only deployments fall back to the engine tier,
#: where every rejection IS client-visible.
_AVAIL_FLEET_TOTAL = ("fleet.submitted",)
_AVAIL_FLEET_BAD = ("fleet.rejected", "fleet.shed")
_AVAIL_ENGINE_TOTAL = ("serve.submitted",)
_AVAIL_ENGINE_BAD = ("serve.rejected", "serve.poisoned")


def _env_float(name: str, default: float) -> float:
  try:
    return float(os.environ.get(name, default))
  except ValueError:
    return default


class Objective(object):
  """One declarative objective, reduced to bad-fraction-over-budget.

  ``kind == "latency"``: at most ``1 − quantile`` of requests may exceed
  ``threshold_ms`` on the merged ``metric`` sketch ("p99 ≤ X" form).
  ``kind == "availability"``: at most ``1 − target`` of submitted
  requests may end shed/rejected/poisoned.
  """

  __slots__ = ("name", "kind", "metric", "threshold_ms", "quantile",
               "target", "budget")

  def __init__(self, name: str, kind: str, metric: Optional[str] = None,
               threshold_ms: Optional[float] = None,
               quantile: float = _DEFAULT_QUANTILE,
               target: Optional[float] = None):
    if kind not in ("latency", "availability"):
      raise ValueError("objective kind must be latency|availability, "
                       "got %r" % (kind,))
    if kind == "latency":
      if not metric or not threshold_ms or threshold_ms <= 0:
        raise ValueError("latency objective %r needs a sketch metric "
                         "and a positive threshold_ms" % name)
      if not 0.5 <= quantile < 1.0:
        raise ValueError("latency quantile must be in [0.5, 1), got %r"
                         % (quantile,))
      budget = 1.0 - quantile
    else:
      if target is None or not 0.0 < target < 1.0:
        raise ValueError("availability objective %r needs a target in "
                         "(0, 1)" % name)
      budget = 1.0 - target
    self.name = name
    self.kind = kind
    self.metric = metric
    self.threshold_ms = None if threshold_ms is None \
        else float(threshold_ms)
    self.quantile = float(quantile)
    self.target = None if target is None else float(target)
    self.budget = budget

  def describe(self) -> dict:
    d = {"name": self.name, "kind": self.kind, "budget": self.budget}
    if self.kind == "latency":
      d.update(metric=self.metric, threshold_ms=self.threshold_ms,
               quantile=self.quantile)
    else:
      d.update(target=self.target)
    return d

  # -- cumulative (total, bad) extraction ------------------------------------

  def totals(self, metrics_by_eid: Dict) -> tuple:
    """``(total_events, bad_events, observed)`` cumulative across the
    cluster right now — two calls subtract into a window (the trick
    that makes sketches windowable: (count, over-count) pairs delta
    even though the sketch itself can't). ``observed`` additionally
    carries the point-in-time view for status displays (the merged
    sketch's current quantile value / the cumulative availability)."""
    if self.kind == "availability":
      def _sum(names):
        acc = 0.0
        for m in metrics_by_eid.values():
          for name in names:
            v = m.get(name)
            if v is not None and "value" in v:
              acc += v["value"]
        return acc

      # fleet tier wins when present (see _AVAIL_* above): the client
      # boundary, immune to retry/failover attempt inflation and live
      # through a total outage
      total = _sum(_AVAIL_FLEET_TOTAL)
      if total > 0:
        bad = _sum(_AVAIL_FLEET_BAD)
      else:
        total = _sum(_AVAIL_ENGINE_TOTAL)
        bad = _sum(_AVAIL_ENGINE_BAD)
      observed = 1.0 - (bad / total) if total > 0 else None
      return total, bad, observed
    merged = quantiles_mod.merge_snapshots(
        [m.get(self.metric) for m in metrics_by_eid.values()])
    total = float(merged.count)
    bad = total - merged.rank(self.threshold_ms) if total else 0.0
    observed = merged.quantile(self.quantile) if total else None
    return total, float(bad), observed


def objectives_from_env() -> List[Objective]:
  """The declared objective set (empty = SLO plane off). Availability
  defaults ON at 99.9% — the serving plane always has an availability
  promise; latency objectives need an explicit bound (nobody can guess
  a deployment's TTFT target)."""
  out: List[Objective] = []
  q = _env_float(ENV_SLO_QUANTILE, _DEFAULT_QUANTILE)
  avail = _env_float(ENV_SLO_AVAILABILITY, _DEFAULT_AVAILABILITY)
  if avail > 0:
    out.append(Objective("availability", "availability", target=avail))
  ttft = _env_float(ENV_SLO_TTFT_MS, 0.0)
  if ttft > 0:
    out.append(Objective("ttft_p%g" % (100 * q), "latency",
                         metric="serve.ttft_ms", threshold_ms=ttft,
                         quantile=q))
  e2e = _env_float(ENV_SLO_E2E_MS, 0.0)
  if e2e > 0:
    out.append(Objective("e2e_p%g" % (100 * q), "latency",
                         metric="serve.e2e_ms", threshold_ms=e2e,
                         quantile=q))
  return out


class SLOTracker(object):
  """Rolling multi-window burn-rate evaluation over cumulative samples.

  Driven by the detector loop: :meth:`sample` appends one cumulative
  ``(t, total, bad)`` point per objective from the sink's per-executor
  metric state; :meth:`evaluate` subtracts window edges into fast/slow
  bad-fractions and returns one verdict dict per objective —
  ``verdict["burning"]`` is the ``slo_burn`` trigger. No waits, no
  threads: the caller owns cadence (and its own locking).
  """

  def __init__(self, objectives: Optional[Sequence[Objective]] = None,
               window: float = 20.0,
               slow_mult: Optional[float] = None,
               burn_threshold: Optional[float] = None,
               min_events: Optional[int] = None):
    self.objectives = list(objectives if objectives is not None
                           else objectives_from_env())
    self.window = float(window)
    self.slow_mult = max(1.0, slow_mult if slow_mult is not None
                         else _env_float(ENV_SLO_SLOW_MULT,
                                         _DEFAULT_SLOW_MULT))
    self.burn_threshold = float(
        burn_threshold if burn_threshold is not None
        else _env_float(ENV_SLO_BURN, _DEFAULT_BURN))
    self.min_events = int(min_events if min_events is not None
                          else _env_float(ENV_SLO_MIN_EVENTS,
                                          _DEFAULT_MIN_EVENTS))
    self.slow_window = self.window * self.slow_mult
    # per-objective deque of (t, total, bad); retention covers the slow
    # window plus one pre-window baseline sample
    self._series: Dict[str, deque] = {
        o.name: deque(maxlen=8192) for o in self.objectives}
    self._observed: Dict[str, Optional[float]] = {}

  def __bool__(self) -> bool:
    return bool(self.objectives)

  # -- sampling --------------------------------------------------------------

  def sample(self, now: float, metrics_by_eid: Dict) -> None:
    """Append one cumulative sample per objective from the sink's
    ``{eid: {metric: snapshot}}`` state."""
    for obj in self.objectives:
      total, bad, observed = obj.totals(metrics_by_eid)
      dq = self._series[obj.name]
      dq.append((now, total, bad))
      self._observed[obj.name] = observed
      # retire samples past the slow window, keeping one baseline
      while len(dq) >= 2 and dq[1][0] <= now - self.slow_window:
        dq.popleft()

  @staticmethod
  def _window_frac(dq, now: float, window: float):
    """(bad_fraction, events) across the window ending at ``now`` —
    deltas between the newest sample and the newest sample at/before
    the window edge (or the oldest retained as baseline)."""
    if len(dq) < 2:
      return None, 0.0
    edge = now - window
    base = dq[0]
    for rec in dq:
      if rec[0] <= edge:
        base = rec
      else:
        break
    t1, total1, bad1 = dq[-1]
    dt_total = total1 - base[1]
    dt_bad = bad1 - base[2]
    if dt_total <= 0:
      return None, 0.0
    return max(0.0, dt_bad) / dt_total, dt_total

  # -- evaluation ------------------------------------------------------------

  def evaluate(self, now: float) -> List[dict]:
    """One verdict per objective (msgpack/json-safe). ``burning`` is
    True when BOTH windows' burn rates are at/over the threshold with
    enough events in the slow window to mean anything."""
    out = []
    for obj in self.objectives:
      dq = self._series[obj.name]
      frac_fast, n_fast = self._window_frac(dq, now, self.window)
      frac_slow, n_slow = self._window_frac(dq, now, self.slow_window)
      burn_fast = None if frac_fast is None \
          else frac_fast / obj.budget
      burn_slow = None if frac_slow is None \
          else frac_slow / obj.budget
      burning = (burn_fast is not None and burn_slow is not None
                 and n_slow >= self.min_events
                 and burn_fast >= self.burn_threshold
                 and burn_slow >= self.burn_threshold)
      v = dict(obj.describe(),
               observed=self._observed.get(obj.name),
               bad_frac_fast=frac_fast, bad_frac_slow=frac_slow,
               events_fast=n_fast, events_slow=n_slow,
               burn_fast=burn_fast, burn_slow=burn_slow,
               window_fast=self.window, window_slow=self.slow_window,
               burn_threshold=self.burn_threshold, burning=burning)
      out.append(v)
    return out

  def status(self, now: Optional[float] = None) -> dict:
    """The HEALTH-wire SLO payload: per-objective verdicts + the window
    geometry (msgpack-safe; floats and bools only)."""
    if now is None:
      now = time.monotonic()
    return {"objectives": self.evaluate(now),
            "window_fast": self.window, "window_slow": self.slow_window,
            "burn_threshold": self.burn_threshold}
