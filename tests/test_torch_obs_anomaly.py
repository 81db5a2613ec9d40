"""The port's online detector (``obs/anomaly.py``) held against the JAX
package's on the same synthetic sink series.

Each case is a detector scenario of ``tests/test_anomaly.py`` (one firing
case and one quiet neighbour per detector, the window guard, the burst
tolerance, the cooldowns): the same frames go through both packages'
``AnomalyDetector`` with the same injected clock, and the alerts they
fire — kind, executor id, evidence and message — must be equal, and
equal to the kinds the reference's test expects. Detectors over planes
the port does not have yet (paged KV, fleet, hosts, groups, canary) are
held the same way: they stay exempt when their metrics are absent.

The one deliberate difference, ``mem_slope``'s warm-up grace, is pinned
on its own at the end.
"""

import pytest

from tensorflowonspark_tpu.obs import anomaly as jax_anomaly
from tensorflowonspark_tpu.obs import metrics as jax_metrics
from tensorflowonspark_tpu.obs import spans as jax_spans
from tensorflowonspark_tpu_torch.obs import anomaly as port_anomaly
from tensorflowonspark_tpu_torch.obs import metrics as port_metrics
from tensorflowonspark_tpu_torch.obs import spans as port_spans

PACKAGES = {"jax": (jax_anomaly, jax_metrics),
            "torch": (port_anomaly, port_metrics)}


@pytest.fixture(autouse=True)
def clean_active():
  yield
  for mod in (jax_metrics, jax_spans, port_metrics, port_spans):
    mod.deactivate()


class FakeSink(object):
  """The sink surface the detector reads: ``executors`` and
  ``metrics(eid)``; values land as counters, as the reference's tests
  set them."""

  def __init__(self, eids):
    self.executors = {e: {} for e in eids}
    self.data = {e: {} for e in eids}

  def metrics(self, eid):
    return self.data[eid]

  def set(self, eid, values):
    self.data[eid] = {k: {"type": "counter", "value": float(v)}
                      for k, v in values.items()}


def run(pkg, eids, frames, **attrs):
  """Feed ``frames`` — ``(now, {eid: {metric: value}})`` — through one
  package's detector (interval 0.5, window 10, as the reference's tests
  build it); returns every alert fired and the detector."""
  anomaly, metrics = PACKAGES[pkg]
  sink = FakeSink(eids)
  det = anomaly.AnomalyDetector(sink, interval=0.5, window=10.0,
                                registry=metrics.MetricsRegistry(),
                                recorder=None)
  for k, v in attrs.items():
    setattr(det, k, v)
  fired = []
  for now, values in frames:
    for eid, vals in values.items():
      sink.set(eid, vals)
    fired.extend(det.poll(now=now))
  return fired, det


def _two(a0, a1, b0, b1, unroll=None):
  """Two executors' train.steps from (a0, a1) at t=0 to (b0, b1) at 10."""
  extra = {} if unroll is None else {"train.unroll": unroll}
  return [(0.0, {0: dict({"train.steps": a0}, **extra),
                 1: dict({"train.steps": a1}, **extra)}),
          (10.0, {0: dict({"train.steps": b0}, **extra),
                  1: dict({"train.steps": b1}, **extra)})]


def _one(first, last, t=10.0):
  return [(0.0, {0: first}), (t, {0: last})]


FEED0 = {"feed.batches": 5, "feed.fetch_s": 0.0, "feed.decode_s": 0.0,
         "feed.assemble_s": 0.0}

# (id, eids, frames, detector attrs, the kinds the reference expects,
#  executor id of the first alert or None)
SCENARIOS = [
    ("straggler_fires", (0, 1), _two(0, 0, 100, 10), {}, ["straggler"], 1),
    ("straggler_just_below", (0, 1), _two(0, 0, 100, 60), {}, [], None),
    ("straggler_single_executor", (0,),
     _one({"train.steps": 0}, {"train.steps": 0}), {}, [], None),
    ("straggler_idle_cluster", (0, 1), _two(0, 0, 3, 0), {}, [], None),
    ("straggler_cooldown", (0, 1),
     _two(0, 0, 100, 0) + [
         (20.0, {0: {"train.steps": 200}, 1: {"train.steps": 0}}),
         (120.0, {0: {"train.steps": 2000}, 1: {"train.steps": 0}})],
     {"cooldown": 100.0}, ["straggler", "straggler"], 1),
    ("window_guard", (0, 1),
     [(0.0, {0: {"train.steps": 0}, 1: {"train.steps": 0}}),
      (1.0, {0: {"train.steps": 50}, 1: {"train.steps": 0}}),
      (6.0, {0: {"train.steps": 50}, 1: {"train.steps": 0}})], {},
     ["straggler"], 1),
    ("burst_within_one_slab", (0, 1), _two(0, 0, 16, 6, unroll=16), {},
     [], None),
    ("burst_past_one_slab", (0, 1), _two(0, 0, 16, 6, unroll=8), {},
     ["straggler"], 1),
    ("burst_of_one_without_unroll", (0, 1), _two(0, 0, 16, 6), {},
     ["straggler"], 1),
    ("feed_stall_fires", (0,),
     _one(FEED0, dict(FEED0, **{"feed.fetch_s": 8.0, "feed.decode_s": 0.5,
                                "feed.assemble_s": 0.1})), {},
     ["feed_stall"], 0),
    ("feed_flowing_batches", (0,),
     _one(FEED0, {"feed.batches": 50, "feed.fetch_s": 9.5,
                  "feed.decode_s": 0.5, "feed.assemble_s": 0.1}), {},
     [], None),
    ("feed_below_fraction", (0,),
     _one(FEED0, dict(FEED0, **{"feed.fetch_s": 5.0, "feed.decode_s": 0.5,
                                "feed.assemble_s": 0.1})), {}, [], None),
    ("feed_buffered_progress", (0,),
     _one(dict(FEED0, **{"train.steps": 10}),
          dict(FEED0, **{"train.steps": 30, "feed.fetch_s": 9.0})), {},
     [], None),
    ("feed_never_delivered", (0,),
     _one(dict(FEED0, **{"feed.batches": 0}),
          dict(FEED0, **{"feed.batches": 0, "feed.fetch_s": 9.0})), {},
     [], None),
    ("feed_no_datafeed", (0,),
     _one({"train.steps": 0}, {"train.steps": 0}), {}, [], None),
    ("feed_graph_stage_named", (0,),
     _one(dict(FEED0, **{"feed.stage.src.busy_s": 0.0,
                         "feed.stage.map0.busy_s": 0.0,
                         "feed.stage.assemble.busy_s": 0.0}),
          dict(FEED0, **{"feed.fetch_s": 0.1, "feed.stage.src.busy_s": 0.4,
                         "feed.stage.map0.busy_s": 8.0,
                         "feed.stage.assemble.busy_s": 0.2})), {},
     ["feed_stall"], 0),
    ("feed_graph_flowing", (0,),
     _one(dict(FEED0, **{"feed.stage.map0.busy_s": 0.0}),
          dict(FEED0, **{"feed.batches": 60,
                         "feed.stage.map0.busy_s": 9.5})), {}, [], None),
    ("recompile_storm_fires", (0,),
     _one({"xla.compiles": 10}, {"xla.compiles": 14}),
     {"compile_warmup": 5.0}, ["recompile_storm"], 0),
    ("recompile_warmup_free", (0,),
     _one({"xla.compiles": 0}, {"xla.compiles": 50}),
     {"compile_warmup": 60.0}, [], None),
    ("recompile_below_limit", (0,),
     _one({"xla.compiles": 10}, {"xla.compiles": 12}),
     {"compile_warmup": 5.0}, [], None),
    ("serving_saturated", (0,),
     _one({"serve.queue_depth": 0, "serve.occupancy": 0.5},
          {"serve.queue_depth": 12, "serve.occupancy": 0.97}), {},
     ["serving_saturated"], 0),
    ("serving_deep_queue_low_occupancy", (0,),
     _one({"serve.queue_depth": 0, "serve.occupancy": 0.5},
          {"serve.queue_depth": 12, "serve.occupancy": 0.5}), {}, [], None),
    ("serve_crash_loop", (0,),
     _one({"serve.engine_restarts": 1, "serve.replays": 3},
          {"serve.engine_restarts": 3, "serve.replays": 9}), {},
     ["serve_crash_loop"], 0),
    ("serve_single_recovery", (0,),
     _one({"serve.engine_restarts": 0}, {"serve.engine_restarts": 1}), {},
     [], None),
    ("serve_no_serving", (0,),
     _one({"train.steps": 0}, {"train.steps": 50}), {}, [], None),
    ("kv_pages_exhausted", (0,),
     _one({"serve.kv_pages_free": 0, "serve.kv_pages_in_use": 36,
           "serve.queue_depth": 5},
          {"serve.kv_pages_free": 0, "serve.kv_pages_in_use": 36,
           "serve.queue_depth": 7}), {}, ["kv_pages_exhausted"], 0),
    ("kv_pages_transient_zero", (0,),
     _one({"serve.kv_pages_free": 1, "serve.kv_pages_in_use": 35,
           "serve.queue_depth": 5},
          {"serve.kv_pages_free": 0, "serve.kv_pages_in_use": 36,
           "serve.queue_depth": 7}), {}, [], None),
    ("kv_pages_unpaged_exempt", (0,),
     _one({"serve.queue_depth": 9, "serve.occupancy": 0.2},
          {"serve.queue_depth": 9, "serve.occupancy": 0.2}), {}, [], None),
    ("fleet_degraded", (0,),
     _one({"fleet.replicas_total": 3, "fleet.replicas_active": 3},
          {"fleet.replicas_total": 3, "fleet.replicas_active": 2}), {},
     ["fleet_degraded"], 0),
    ("fleet_saturated", (0,),
     _one({"fleet.replicas_total": 2, "fleet.replicas_active": 2,
           "fleet.queue_depth": 16, "fleet.occupancy": 0.95},
          {"fleet.replicas_total": 2, "fleet.replicas_active": 2,
           "fleet.queue_depth": 20, "fleet.occupancy": 0.97}), {},
     ["fleet_saturated"], 0),
    ("fleet_rolling_swap", (0,),
     _one({"fleet.replicas_total": 3, "fleet.replicas_active": 2,
           "fleet.replicas_draining": 1, "fleet.queue_depth": 99,
           "fleet.occupancy": 1.0},
          {"fleet.replicas_total": 3, "fleet.replicas_active": 2,
           "fleet.replicas_draining": 1, "fleet.queue_depth": 99,
           "fleet.occupancy": 1.0}), {}, [], None),
    ("fleet_no_fleet_exempt", (0,),
     _one({"serve.queue_depth": 9}, {"serve.queue_depth": 9}), {}, [],
     None),
    ("host_lost", (0,),
     _one({"serve.hosts_total": 2, "serve.hosts_alive": 2},
          {"serve.hosts_total": 2, "serve.hosts_alive": 1,
           "fleet.queue_depth": 4, "fleet.occupancy": 0.8}), {},
     ["host_lost"], 0),
    ("host_all_alive", (0,),
     _one({"serve.hosts_total": 2, "serve.hosts_alive": 2},
          {"serve.hosts_total": 2, "serve.hosts_alive": 2}), {}, [], None),
    ("group_lost", (0,),
     _one({"training.groups_total": 3, "training.groups_active": 3},
          {"training.groups_total": 3, "training.groups_active": 2}), {},
     ["group_lost"], 0),
    ("sync_lag", (0,),
     _one({"training.groups_total": 2, "training.groups_active": 2,
           "training.sync_ms": 10.0},
          {"training.groups_total": 2, "training.groups_active": 2,
           "training.sync_ms": 150.0}), {"sync_lag_ms": 100.0},
     ["sync_lag"], 0),
    ("sync_lag_below", (0,),
     _one({"training.groups_total": 2, "training.groups_active": 2,
           "training.sync_ms": 10.0},
          {"training.groups_total": 2, "training.groups_active": 2,
           "training.sync_ms": 99.0}), {"sync_lag_ms": 100.0}, [], None),
    # past the warm-up grace (the port's one difference): both fire
    ("mem_slope_creep", (0,),
     [(t, {0: {"device.bytes_in_use": 1e9 * (1 + 0.05 * i)}})
      for i, t in enumerate((0.0, 3.0, 6.0, 9.0))],
     {"compile_warmup": 0.0}, ["mem_slope"], 0),
    ("mem_slope_below", (0,),
     [(t, {0: {"device.bytes_in_use": 1e9 * (1 + 0.02 * i)}})
      for i, t in enumerate((0.0, 3.0, 6.0, 9.0))],
     {"compile_warmup": 0.0}, [], None),
    ("mem_slope_peak_then_shrink", (0,),
     [(t, {0: {"device.bytes_in_use": v * 1e6}})
      for v, t in ((100, 0.0), (200, 3.0), (150, 6.0), (160, 9.0))],
     {"compile_warmup": 0.0}, [], None),
    ("canary_parity", (0,),
     _one({"deploy.state": 2, "deploy.candidate": 5,
           "deploy.parity_failures": 0},
          {"deploy.state": 2, "deploy.candidate": 5,
           "deploy.parity_failures": 2}), {}, ["canary_degraded"], 0),
    ("canary_ttft_ratio", (0,),
     _one({"deploy.state": 1, "deploy.candidate": 7,
           "deploy.canary_ttft_ratio": 1.0},
          {"deploy.state": 1, "deploy.candidate": 7,
           "deploy.canary_ttft_ratio": 12.5}), {}, ["canary_degraded"], 0),
    ("canary_idle_controller", (0,),
     _one({"deploy.state": 0, "deploy.candidate": 5,
           "deploy.parity_failures": 0},
          {"deploy.state": 0, "deploy.candidate": 5,
           "deploy.parity_failures": 3}), {}, [], None),
]


@pytest.mark.parametrize("eids,frames,attrs,kinds,eid",
                         [s[1:] for s in SCENARIOS],
                         ids=[s[0] for s in SCENARIOS])
def test_detector_matches_the_reference(eids, frames, attrs, kinds, eid):
  jax_fired, jax_det = run("jax", eids, frames, **attrs)
  port_fired, port_det = run("torch", eids, frames, **attrs)
  assert [a["alert"] for a in jax_fired] == kinds
  assert port_fired == jax_fired
  if eid is not None:
    assert port_fired[0]["executor_id"] == eid
  assert port_det.summary() == jax_det.summary()
  assert port_det._reg.snapshot() == jax_det._reg.snapshot()


def test_alert_fan_out_and_status_match_the_reference():
  """The fan-out of one alert (ring, registry, summary) and the deploy
  status the HEALTH reply carries agree across the packages."""
  frames = [(0.0, {0: {"deploy.state": 1, "deploy.version": 4,
                       "deploy.candidate": 5,
                       "deploy.canary_ttft_ratio": 1.2,
                       "deploy.canaries": 1, "deploy.promotions": 3,
                       "deploy.rollbacks": 1,
                       "deploy.parity_failures": 0}})]
  got = {pkg: run(pkg, (0,), frames)[1] for pkg in PACKAGES}
  assert got["torch"].deploy_status() == got["jax"].deploy_status()
  assert got["torch"].deploy_status()["state"] == "canary"
  for det in got.values():
    det._fire("straggler", 4, 4.0, 100.0, {"rate": 0.0}, "synthetic")
  assert got["torch"].recent_alerts() == got["jax"].recent_alerts()
  assert got["torch"].summary() == got["jax"].summary()


def test_mem_slope_waits_out_the_warmup_grace():
  """A card's allocated bytes climb while a healthy executor builds its
  weights, optimizer state and first activations: inside the
  ``TOS_OBS_COMPILE_WARMUP`` grace the port stays quiet where the
  reference fires, and past it the port fires as the reference does."""
  frames = [(t, {0: {"device.bytes_in_use": 1e9 * (1 + 0.05 * i)}})
            for i, t in enumerate((0.0, 3.0, 6.0, 9.0))]
  assert [a["alert"] for a in run("jax", (0,), frames)[0]] == ["mem_slope"]
  assert run("torch", (0,), frames)[0] == []
  late = [(t + 200.0, v) for t, v in frames]
  port, det = run("torch", (0,), [(0.0, {0: {}})] + late)
  assert [a["alert"] for a in port] == ["mem_slope"]
  assert det.compile_warmup == port_anomaly._DEFAULT_COMPILE_WARMUP
