"""The port's observability plane held against the JAX package's, in one
process (no executors).

- the contract subset of ``tests/test_obs.py`` on both packages: delta
  shipping over the rendezvous ``OBS`` verb, the idle short-circuit, a
  rejected ship that retries its delta, the verb without a sink, the
  sink's bounded span buffer, a failed ship counted instead of raised,
  pre-ship samplers and clock gauges, ``HEALTH`` with the obs summary and
  the alert ring;
- the ``OBS`` wire across packages, both ways: a port shipper into a JAX
  server + sink, and a JAX shipper into the port's, give the aggregates
  a same-package pair gives;
- ``merge_jsonl``, ``anchored_window``, ``chrome_trace`` (with flow
  events) and ``prometheus_text`` equal to the JAX functions' output on
  the same logs and snapshots;
- ``obs.profiler``: ``StepTimer``'s summary and registry seam against the
  reference's, the MFU arithmetic, the card's peak table, the CPU-side
  ``device_memory_stats`` (no CUDA initialised), ``trace`` over
  ``torch.profiler``, ``start_server`` refused, the deprecation shim;
- ``obs.device``: the shape-keyed recompile sentinel, native builds as
  compile events, analytic cost gauges once per shape, the memory
  sampler's gauges equal to the reference sampler's on the same stats;
- ``obs.slo``: objectives from the env and tracker verdicts equal to the
  reference's on the same sketch series.
"""

import json
import os
import socket
import time
import warnings

import pytest

from tensorflowonspark_tpu.control import rendezvous as jax_rdv
from tensorflowonspark_tpu.obs import anomaly as jax_anomaly
from tensorflowonspark_tpu.obs import collector as jax_collector
from tensorflowonspark_tpu.obs import device as jax_device
from tensorflowonspark_tpu.obs import export as jax_export
from tensorflowonspark_tpu.obs import metrics as jax_metrics
from tensorflowonspark_tpu.obs import quantiles as jax_quantiles
from tensorflowonspark_tpu.obs import slo as jax_slo
from tensorflowonspark_tpu.obs import spans as jax_spans
from tensorflowonspark_tpu_torch.control import rendezvous as port_rdv
from tensorflowonspark_tpu_torch.obs import anomaly as port_anomaly
from tensorflowonspark_tpu_torch.obs import collector as port_collector
from tensorflowonspark_tpu_torch.obs import device as port_device
from tensorflowonspark_tpu_torch.obs import export as port_export
from tensorflowonspark_tpu_torch.obs import metrics as port_metrics
from tensorflowonspark_tpu_torch.obs import profiler as port_profiler
from tensorflowonspark_tpu_torch.obs import quantiles as port_quantiles
from tensorflowonspark_tpu_torch.obs import slo as port_slo
from tensorflowonspark_tpu_torch.obs import spans as port_spans


class _Pkg(object):
  def __init__(self, **mods):
    self.__dict__.update(mods)


PKGS = {
    "jax": _Pkg(rdv=jax_rdv, collector=jax_collector, export=jax_export,
                metrics=jax_metrics, spans=jax_spans, anomaly=jax_anomaly,
                device=jax_device, quantiles=jax_quantiles, slo=jax_slo),
    "torch": _Pkg(rdv=port_rdv, collector=port_collector,
                  export=port_export, metrics=port_metrics,
                  spans=port_spans, anomaly=port_anomaly,
                  device=port_device, quantiles=port_quantiles,
                  slo=port_slo),
}


@pytest.fixture(autouse=True)
def clean_active():
  """No test may leak a process registry or recorder of either package
  into the next test of this worker."""
  yield
  for p in PKGS.values():
    p.metrics.deactivate()
    p.spans.deactivate()
  port_device.reset_trace_cache()
  port_device.reset_cost_cache()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
  return PKGS[request.param]


class _SinkServer(object):
  """A real rendezvous server of ``p`` with an attached ObsSink."""

  def __init__(self, p, sink=None):
    self.server = p.rdv.Server(1)
    self.server.obs_sink = sink
    self.addr = self.server.start()

  def close(self):
    self.server.stop()


# -- the OBS verb and the collector (both packages) ----------------------------

def test_delta_shipping_end_to_end(pkg):
  sink = pkg.collector.ObsSink()
  srv = _SinkServer(pkg, sink)
  reg = pkg.metrics.MetricsRegistry()
  rec = pkg.spans.SpanRecorder(capacity=100)
  shipper = pkg.collector.ObsShipper(srv.addr, 7, registry=reg, recorder=rec,
                                     interval=60, label="exec")
  try:
    reg.counter("work").inc(5)
    rec.event("phase1")
    assert shipper.ship(timeout=10)
    reg.counter("work").inc(2)
    assert shipper.ship(timeout=10)
    assert sink.metrics(7)["work"]["value"] == 7      # 5 + 2, not 5 + 7
    got = sink.obs_recv(16, timeout=5)
    assert [s["name"] for s in got] == ["phase1"]
    assert got[0]["executor_id"] == 7 and "offset" in got[0]
    assert shipper.clock.samples >= 1                 # a TIME exchange too
    summary = sink.summary()
    assert summary["executors"][7]["ships"] == 2
    assert summary["rejected"] == 0
  finally:
    shipper.stop(timeout=2)
    srv.close()


def test_idle_shipper_keeps_wire_quiet(pkg):
  sink = pkg.collector.ObsSink()
  srv = _SinkServer(pkg, sink)
  reg = pkg.metrics.MetricsRegistry()
  shipper = pkg.collector.ObsShipper(
      srv.addr, 1, registry=reg, recorder=pkg.spans.SpanRecorder(capacity=4),
      interval=60)
  try:
    reg.counter("x").inc()
    assert shipper.ship(timeout=10)
    before = sink.summary()["ingested"]
    assert shipper.ship(timeout=10)      # nothing new: acked locally
    assert sink.summary()["ingested"] == before
  finally:
    shipper.stop(timeout=2)
    srv.close()


def test_rejected_ship_retries_its_delta(pkg):
  """accepted=False (no sink) must not advance the metrics baseline: the
  delta re-ships once a sink is there — metrics retry until acked."""
  srv = _SinkServer(pkg, sink=None)
  reg = pkg.metrics.MetricsRegistry()
  shipper = pkg.collector.ObsShipper(
      srv.addr, 3, registry=reg, recorder=pkg.spans.SpanRecorder(capacity=4),
      interval=60)
  try:
    reg.counter("work").inc(5)
    assert shipper.ship(timeout=10) is False
    assert shipper.ship_failures == 1 and shipper.ships_acked == 0
    sink = pkg.collector.ObsSink()
    srv.server.obs_sink = sink
    assert shipper.ship(timeout=10) is True
    assert sink.metrics(3)["work"]["value"] == 5     # nothing was lost
  finally:
    shipper.stop(timeout=2)
    srv.close()


def test_obs_verb_without_sink_is_acked_and_dropped(pkg):
  srv = _SinkServer(pkg, sink=None)
  try:
    c = pkg.rdv.Client(srv.addr, timeout=5)
    resp = c._request({"type": "OBS", "executor_id": 0, "metrics": {},
                       "spans": []})
    c.close()
    assert resp["type"] == "OK" and resp["accepted"] is False
    assert "server_time" in resp
  finally:
    srv.close()


def test_sink_span_buffer_is_bounded(pkg):
  sink = pkg.collector.ObsSink(max_spans=3)
  msg = {"type": "OBS", "executor_id": 0, "metrics": {},
         "spans": [{"name": "s%d" % i, "ph": "i", "t0": float(i)}
                   for i in range(5)]}
  assert sink.ingest(msg)
  assert sink.spans_dropped == 2
  assert len(sink.obs_recv(10, timeout=1)) == 3
  assert sink.obs_recv(10, block=False) == []
  assert not sink.ingest({"type": "OBS"})          # malformed: counted
  assert sink.rejected == 1


def test_failed_ship_counts_its_spans_lost(pkg):
  s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
  s.bind(("127.0.0.1", 0))
  port = s.getsockname()[1]
  s.close()                                        # nothing listens here
  rec = pkg.spans.SpanRecorder(capacity=10)
  rec.event("doomed")
  shipper = pkg.collector.ObsShipper(("127.0.0.1", port), 0,
                                     registry=pkg.metrics.MetricsRegistry(),
                                     recorder=rec, interval=60)
  assert shipper.ship(timeout=0.7) is False
  assert shipper.ship_failures >= 1
  assert shipper.spans_lost == 1
  shipper.stop(timeout=1)


def test_samplers_and_clock_gauges_ride_the_delta(pkg):
  sink = pkg.collector.ObsSink()
  srv = _SinkServer(pkg, sink)
  reg = pkg.metrics.MetricsRegistry()
  shipper = pkg.collector.ObsShipper(
      srv.addr, 3, registry=reg, recorder=pkg.spans.SpanRecorder(capacity=4),
      interval=60, label="exec")
  calls = []
  shipper.add_sampler(lambda: calls.append(1))

  def broken():
    raise RuntimeError("boom")

  shipper.add_sampler(broken)
  shipper.add_sampler(pkg.device.make_memory_sampler(
      reg, stats_fn=lambda: {"0": {"bytes_in_use": 42,
                                   "peak_bytes_in_use": 64}}))
  try:
    assert shipper.ship(timeout=10)
    reg.counter("work").inc()
    assert shipper.ship(timeout=10)
    assert len(calls) == 2 and shipper.sampler_failures == 2
    entry = sink.top_summary()["3"]
    assert entry["label"] == "exec"
    assert entry["metrics"]["device.bytes_in_use"] == 42
    assert entry["metrics"]["device.peak_bytes"] == 64
    assert entry["metrics"]["clock.samples"] >= 1
  finally:
    shipper.stop(timeout=2)
    srv.close()


def test_health_carries_obs_summary_and_alert_ring(pkg):
  sink = pkg.collector.ObsSink()
  sink.ingest({"executor_id": 4, "label": "exec", "pid": 1, "seq": 1,
               "metrics": {"train.steps": {"type": "counter",
                                           "value": 9.0}},
               "spans": [], "drops": {}, "clock": {}})
  srv = _SinkServer(pkg, sink)
  det = pkg.anomaly.AnomalyDetector(
      sink, registry=pkg.metrics.MetricsRegistry(), recorder=None,
      interval=1.0, window=4.0)
  det._fire("straggler", 4, 4.0, 100.0, {"rate": 0.0}, "synthetic")
  srv.server.alert_source = det
  try:
    c = pkg.rdv.Client(srv.addr, timeout=10)
    reply = c._request({"type": "HEALTH"})
    c.close()
    assert reply["type"] == "HEALTH"
    assert reply["obs"]["4"]["metrics"]["train.steps"] == 9.0
    assert [a["alert"] for a in reply["alerts"]] == ["straggler"]
    json.dumps(reply)
  finally:
    srv.close()


def test_health_without_obs_stays_liveness_only(pkg):
  srv = _SinkServer(pkg, None)
  try:
    c = pkg.rdv.Client(srv.addr, timeout=10)
    reply = c._request({"type": "HEALTH"})
    c.close()
    assert "obs" not in reply and "alerts" not in reply
  finally:
    srv.close()


def test_health_enrichment_failure_is_counted_not_raised():
  class Broken(object):
    def top_summary(self):
      raise RuntimeError("summary bug")

    def recent_alerts(self):
      raise RuntimeError("ring bug")

  srv = _SinkServer(PKGS["torch"], Broken())
  srv.server.alert_source = Broken()
  try:
    c = port_rdv.Client(srv.addr, timeout=10)
    reply = c._request({"type": "HEALTH"})
    c.close()
    assert reply["type"] == "HEALTH" and "data" in reply
    assert "obs" not in reply and "alerts" not in reply
    assert srv.server.health_obs_failures == 2
  finally:
    srv.close()


# -- the wire across packages ----------------------------------------------------

def _ship_run(server_pkg, shipper_pkg):
  """Two ships of one counter/gauge/histogram/sketch registry and two
  spans from ``shipper_pkg`` into ``server_pkg``'s server + sink; the
  sink's metric totals, span names and summary."""
  sp = PKGS[shipper_pkg]
  sink = PKGS[server_pkg].collector.ObsSink()
  srv = _SinkServer(PKGS[server_pkg], sink)
  reg = sp.metrics.MetricsRegistry()
  rec = sp.spans.SpanRecorder(capacity=16)
  shipper = sp.collector.ObsShipper(srv.addr, 2, registry=reg, recorder=rec,
                                    interval=60, label="exec")
  try:
    reg.counter("feed.rows").inc(32)
    reg.gauge("device.peak_bytes").set(1 << 30)
    reg.histogram("train.step_ms").observe(85.5)
    reg.quantiles("serve.ttft_ms").observe(12.0)
    rec.record_span("train.slab", 1.0, 0.25, steps=4)
    assert shipper.ship(timeout=10)
    reg.counter("feed.rows").inc(16)
    reg.quantiles("serve.ttft_ms").observe(30.0)
    rec.event("serve.restart", replayed=2)
    assert shipper.ship(timeout=10)
    spans = sink.obs_recv(16, timeout=5)
    # the clock gauges are measurements of this run: compared by name
    got = sink.metrics(2)
    clock = sorted(k for k in got if k.startswith("clock."))
    return ({k: v for k, v in got.items() if k not in clock}, clock,
            [(s["name"], s.get("attrs")) for s in spans],
            sink.aggregate("feed.rows"))
  finally:
    shipper.stop(timeout=2)
    srv.close()


@pytest.mark.parametrize("server_pkg,shipper_pkg",
                         [("jax", "torch"), ("torch", "jax")])
def test_obs_wire_across_packages(server_pkg, shipper_pkg):
  """A port shipper into a JAX server + sink, and a JAX shipper into the
  port's: the aggregates equal a same-package pair's."""
  got = _ship_run(server_pkg, shipper_pkg)
  want = _ship_run(server_pkg, server_pkg)
  assert got == want
  assert got[3] == 48.0


# -- the export plane -----------------------------------------------------------

def _logs(directory, export, spans):
  clk = spans.ClockOffset()
  clk.update(0.0, 2.0, 0.0)                        # rtt 0: exact offset
  log = export.ProcessLog(directory, label="exec", executor_id=3, clock=clk)
  log.append_spans([
      {"name": "feed.batch", "ph": "X", "t0": 1.0, "dur": 0.5,
       "tid": "MainThread", "attrs": {"rows": 8}},
      {"name": "serve.prefill", "ph": "X", "t0": 1.2, "dur": 0.3,
       "tid": "loop", "trace": "aaaa"},
      {"name": "serve.decode.slot", "ph": "X", "t0": 1.6, "dur": 0.2,
       "tid": "loop", "trace": "aaaa"},
      {"name": "serve.replay", "ph": "i", "t0": 1.7, "tid": "loop",
       "trace": "aaaa"}])
  log.append_alerts([{"alert": "straggler", "executor_id": 3, "t": 1.9}])
  log.close(metrics_snapshot={"c": {"type": "counter", "value": 4}})
  drv = export.ProcessLog(directory, label="driver", executor_id=0)
  drv.append_spans([{"name": "fleet.dispatch", "ph": "X", "t0": 0.9,
                     "dur": 0.1, "tid": "main", "trace": "aaaa"}])
  drv.close()


def test_merge_and_chrome_trace_equal_the_reference(tmp_path):
  """Logs written by each package merge the same, and the port's
  ``chrome_trace`` of either merge equals the reference's."""
  out = {}
  for name, p in PKGS.items():
    d = tmp_path / name
    d.mkdir()
    _logs(str(d), p.export, p.spans)
    procs = p.export.merge_jsonl(p.export.find_logs(str(d)))
    for proc in procs:      # the pid and the path differ between runs
      proc.pop("path")
      proc["meta"].pop("t_wall")
      proc["meta"].pop("t_mono")
    out[name] = procs
  assert out["torch"] == out["jax"]
  exec_proc = next(p for p in out["torch"] if p["meta"]["label"] == "exec")
  assert port_export.anchored_window(exec_proc) == \
      jax_export.anchored_window(exec_proc) == (3.0, 3.8)
  trace = port_export.chrome_trace(out["jax"])
  assert trace == jax_export.chrome_trace(out["jax"])
  flows = [e for e in trace["traceEvents"] if e.get("cat") == "trace"]
  assert sorted(f["ph"] for f in flows) == ["f", "s", "t"]
  json.dumps(trace)


@pytest.mark.parametrize("snap", [
    {"feed.batch_ms": {"type": "histogram", "bounds": [1.0, 5.0],
                       "counts": [2, 1, 1], "sum": 10.0, "count": 4}},
    {"train.steps": {"type": "counter", "value": 12},
     "device.peak_bytes": {"type": "gauge", "value": 3.5e10}},
    "sketch"], ids=["histogram", "counter_gauge", "sketch"])
def test_prometheus_text_equals_the_reference(snap):
  if snap == "sketch":
    sk = jax_quantiles.QuantileSketch()
    sk.extend(float(v) for v in range(1, 101))
    snap = {"serve.ttft_ms": {"type": "sketch", "count": 100,
                              "data": sk.to_dict()}}
  got = port_export.prometheus_text(snap, labels={"proc": "exec0"})
  assert got == jax_export.prometheus_text(snap, labels={"proc": "exec0"})
  for line in got.splitlines():       # every line parses as exposition
    assert line.startswith("# TYPE tos_") or \
        line.split(" ")[0].startswith("tos_") and float(line.split(" ")[-1]) \
        is not None


def test_process_log_without_dir_is_a_noop(monkeypatch):
  monkeypatch.delenv(port_export.ENV_OBS_DIR, raising=False)
  log = port_export.ProcessLog(label="exec", executor_id=0)
  log.append_spans([{"name": "s", "ph": "i", "t0": 0.0}])
  log.close()
  assert log.path is None


def test_stamp_log_gives_a_feeder_its_track(tmp_path):
  """A feeder's shipper outlives its task: ``stamp_log`` writes the log's
  meta, clock and metrics now, and the merge reads the last stamp."""
  reg = port_metrics.MetricsRegistry()
  shipper = port_collector.ObsShipper(("127.0.0.1", 1), 0, registry=reg,
                                      recorder=port_spans.SpanRecorder(4),
                                      interval=60, label="feeder",
                                      jsonl_dir=str(tmp_path))
  reg.counter("feed.wire_rows").inc(8)
  shipper.stamp_log()
  reg.counter("feed.wire_rows").inc(8)
  shipper.stamp_log()
  (proc,) = port_export.merge_jsonl(port_export.find_logs(str(tmp_path)))
  assert proc["meta"]["label"] == "feeder"
  assert proc["metrics"]["feed.wire_rows"]["value"] == 16
  names = [e["args"]["name"] for e in
           port_export.chrome_trace([proc])["traceEvents"]]
  assert names == ["feeder0"]


# -- obs.profiler -----------------------------------------------------------------

def _timed(profiler_mod, durations, monkeypatch, items=10, warmup=2):
  clock = iter(t for d in durations for t in (0.0, d))
  monkeypatch.setattr(profiler_mod.time, "perf_counter", lambda: next(clock))
  t = profiler_mod.StepTimer(warmup=warmup)
  for _ in durations:
    with t.step(items=items):
      pass
  return t.summary()


def test_step_timer_summary_equals_the_reference(monkeypatch):
  from tensorflowonspark_tpu.obs import profiler as jax_profiler
  durations = [0.2, 0.2, 0.011, 0.013, 0.009, 0.012, 0.010]
  got = _timed(port_profiler, durations, monkeypatch)
  want = _timed(jax_profiler, durations, monkeypatch)
  assert got == want and got["steps"] == 5
  assert port_profiler.StepTimer().summary() == {"steps": 0}


def test_step_timer_feeds_the_registry():
  reg = port_metrics.activate()
  rec = port_spans.activate()
  t = port_profiler.StepTimer(warmup=1)
  for _ in range(3):
    with t.step(items=10):
      time.sleep(0.001)
  snap = reg.snapshot()
  assert snap["train.steps"]["value"] == 2           # warmup excluded
  assert snap["train.items"]["value"] == 20
  assert snap["train.step_ms"]["count"] == 2
  got = [s for s in rec.drain(None) if s["name"] == "train.step"]
  assert len(got) == 2 and got[0]["attrs"]["items"] == 10


def test_mfu_arithmetic_equals_the_reference():
  from tensorflowonspark_tpu.obs import profiler as jax_profiler
  fpt = port_profiler.transformer_flops_per_token(124_000_000, 12, 768, 1024)
  assert fpt == jax_profiler.transformer_flops_per_token(
      124_000_000, 12, 768, 1024)
  assert port_profiler.mfu(fpt, 10_000, 989e12) == \
      jax_profiler.mfu(fpt, 10_000, 989e12)
  assert port_profiler.PEAK_BF16_FLOPS == {"h100": 989e12}
  assert port_profiler.resolve_chip_generation("NVIDIA H100 80GB HBM3") \
      == "h100"
  assert port_profiler.resolve_chip_generation("TPU v5 lite") is None
  assert port_profiler.resolve_chip_generation("") is None   # no card here


def test_device_memory_stats_never_initialises_cuda():
  import torch
  assert port_profiler.device_memory_stats() == {}
  assert not torch.cuda.is_initialized()


def test_trace_and_annotate_write_a_profile(tmp_path):
  import torch
  with port_profiler.trace(str(tmp_path)):
    with port_profiler.annotate("obs.test.region"):
      (torch.ones(8, 8) @ torch.ones(8, 8)).sum().item()
  found = [f for _, _, fs in os.walk(tmp_path) for f in fs]
  assert any(f.endswith(".json") for f in found), found
  text = "".join(open(os.path.join(tmp_path, f)).read() for f in found)
  assert "obs.test.region" in text


def test_start_server_is_refused_by_name():
  with pytest.raises(NotImplementedError, match="capture server"):
    port_profiler.start_server(9999)


def test_deprecated_import_path_still_works():
  import importlib
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always", DeprecationWarning)
    import tensorflowonspark_tpu_torch.utils.profiler as shim
    importlib.reload(shim)
  assert any(issubclass(w.category, DeprecationWarning) for w in caught)
  assert shim.StepTimer is port_profiler.StepTimer
  assert shim.mfu is port_profiler.mfu


# -- obs.device -------------------------------------------------------------------

def test_note_trace_counts_once_per_shape_fingerprint():
  import numpy as np
  import torch
  reg = port_metrics.activate()
  seen = set()
  for shape in ((4, 16), (4, 16), (2, 16), (4, 16)):
    port_device.note_trace("train.step", torch.zeros(shape), cache=seen)
  port_device.note_trace("train.step", np.zeros((4, 16), np.float32),
                         cache=seen)               # another dtype: new
  snap = reg.snapshot()
  assert snap["xla.compiles.train.step"]["value"] == 3
  assert snap["xla.compiles"]["value"] == 3
  # a new seam (a new step function) starts its own cache
  port_device.note_trace("train.step", torch.zeros((4, 16)), cache=set())
  assert reg.snapshot()["xla.compiles.train.step"]["value"] == 4
  # scalars key by value, as the reference's static arguments do
  for h in (4, 4, 8):
    port_device.note_trace("serve.step_many", h)
  assert reg.snapshot()["xla.compiles.serve.step_many"]["value"] == 2


def test_note_trace_without_registry_is_inert():
  port_device.note_trace("train.step", 1)
  assert port_metrics.active() is None


def test_native_builds_are_compile_events():
  reg = port_metrics.activate()
  rec = port_spans.activate()
  port_device.note_build("kernel.flash_attention", 12.5, cached=False)
  port_device.note_build("shmring", 0.0, cached=True)
  snap = reg.snapshot()
  assert snap["xla.compiles"]["value"] == 1
  assert snap["xla.compiles.kernel.flash_attention"]["value"] == 1
  assert snap["xla.compile_ms"]["count"] == 1
  assert snap["xla.compile_ms"]["sum"] == pytest.approx(12500.0)
  assert snap["xla.cache_hits"]["value"] == 1
  (span,) = [s for s in rec.drain(None) if s["name"] == "compile"]
  assert span["dur"] == pytest.approx(12.5)
  assert span["attrs"]["label"] == "kernel.flash_attention"


def test_capture_cost_once_per_shape_and_failures_counted():
  import torch
  reg = port_metrics.activate()
  calls = []

  def count(x):
    calls.append(1)
    return {"flops": 2.0 * x.numel(), "bytes": 4.0 * x.numel()}

  assert port_device.capture_cost("train.step", count, torch.zeros(3, 4)) \
      == {"flops": 24.0, "bytes": 48.0}
  assert port_device.capture_cost("train.step", count,
                                  torch.zeros(3, 4)) is None
  port_device.capture_cost("train.step", count, torch.zeros(5, 4))
  snap = reg.snapshot()
  assert len(calls) == 2
  assert snap["xla.cost.train.step.flops"]["value"] == 40.0
  assert snap["xla.cost.captures"]["value"] == 2
  port_device.capture_cost("bad", lambda: 1 / 0)
  assert reg.snapshot()["xla.cost.failures"]["value"] == 1


def test_memory_sampler_equals_the_reference_sampler():
  stats = [{"0": {"bytes_in_use": 10, "peak_bytes_in_use": 30,
                  "bytes_limit": 100},
            "1": {"bytes_in_use": 5, "peak_bytes_in_use": 50,
                  "bytes_limit": 100}},
           {"0": {"bytes_in_use": 10, "peak_bytes_in_use": 30,
                  "bytes_limit": 100},
            "1": {"bytes_in_use": 5, "peak_bytes_in_use": 50,
                  "bytes_limit": 100}},            # unchanged: no bump
           {}]                                     # no card: untouched
  snaps = {}
  for name, p in PKGS.items():
    reg = p.metrics.MetricsRegistry()
    it = iter(stats)
    sample = p.device.make_memory_sampler(reg, stats_fn=lambda: next(it))
    for _ in stats:
      sample()
    snaps[name] = reg.snapshot()
  assert snaps["torch"] == snaps["jax"]
  assert snaps["torch"]["device.peak_bytes"]["value"] == 50
  assert snaps["torch"]["device.mem_samples"]["value"] == 1


def test_install_wires_the_sampler_only_when_the_tier_is_on(monkeypatch):
  class Shipper(object):
    def __init__(self):
      self.registry = port_metrics.MetricsRegistry()
      self.samplers = []

    def add_sampler(self, fn):
      self.samplers.append(fn)

  monkeypatch.delenv(port_metrics.ENV_OBS, raising=False)
  assert port_device.install(Shipper()) is False
  monkeypatch.setenv(port_metrics.ENV_OBS, "1")
  monkeypatch.setenv(port_device.ENV_OBS_DEVICE, "0")
  assert port_device.install(Shipper()) is False
  monkeypatch.delenv(port_device.ENV_OBS_DEVICE)
  shipper = Shipper()
  assert port_device.install(shipper) is True
  assert len(shipper.samplers) == 1
  shipper.samplers[0]()          # no CUDA here: a no-op, gauges untouched
  assert "device.mem_samples" not in shipper.registry.snapshot() or \
      shipper.registry.snapshot()["device.mem_samples"]["value"] == 0


# -- obs.slo ----------------------------------------------------------------------

def _sketch_snap(p, values):
  sk = p.quantiles.QuantileSketch()
  sk.extend(values)
  return {"type": "sketch", "count": sk.count, "data": sk.to_dict()}


def test_objectives_from_env_equal_the_reference(monkeypatch):
  def names(p):
    return [(o.name, o.kind, o.threshold_ms, o.budget)
            for o in p.slo.objectives_from_env()]

  for name in (port_slo.ENV_SLO_AVAILABILITY, port_slo.ENV_SLO_TTFT_MS,
               port_slo.ENV_SLO_E2E_MS, port_slo.ENV_SLO_QUANTILE):
    monkeypatch.delenv(name, raising=False)
  assert names(PKGS["torch"]) == names(PKGS["jax"])
  monkeypatch.setenv(port_slo.ENV_SLO_TTFT_MS, "250")
  monkeypatch.setenv(port_slo.ENV_SLO_QUANTILE, "0.95")
  monkeypatch.setenv(port_slo.ENV_SLO_AVAILABILITY, "0")
  assert names(PKGS["torch"]) == names(PKGS["jax"]) == \
      [("ttft_p95", "latency", 250.0, pytest.approx(0.05))]


@pytest.mark.parametrize("series,burning", [
    ([[10.0] * 10, [10.0] * 10 + [500.0] * 10], True),
    ([[10.0], [10.0] + [500.0] * 10], False),        # under min_events
    ([[10.0] * 5, [10.0] * 5], None),                 # no traffic
], ids=["burns", "min_events", "no_traffic"])
def test_slo_tracker_verdicts_equal_the_reference(series, burning):
  verdicts = {}
  for name, p in PKGS.items():
    obj = p.slo.Objective("ttft_p90", "latency", metric="serve.ttft_ms",
                          threshold_ms=100.0, quantile=0.9)
    tr = p.slo.SLOTracker(objectives=[obj], window=10.0, slow_mult=3.0,
                          burn_threshold=5.0, min_events=5 if burning
                          is not False else 50)
    for i, values in enumerate(series):
      tr.sample(10.0 * i, {0: {"serve.ttft_ms": _sketch_snap(p, values)}})
    verdicts[name] = (tr.evaluate(10.0 * (len(series) - 1)),
                      tr.status(10.0 * (len(series) - 1)))
  assert verdicts["torch"] == verdicts["jax"]
  v = verdicts["torch"][0][0]
  assert v["burning"] is bool(burning)


def test_slo_burn_fires_through_both_detectors():
  fired = {}
  for name, p in PKGS.items():
    class Sink(object):
      executors = {0: {}}
      data = {0: {}}

      def metrics(self, eid):
        return self.data[eid]

    sink = Sink()
    obj = p.slo.Objective("ttft_p90", "latency", metric="serve.ttft_ms",
                          threshold_ms=100.0, quantile=0.9)
    tr = p.slo.SLOTracker(objectives=[obj], window=10.0, slow_mult=2.0,
                          burn_threshold=5.0, min_events=5)
    det = p.anomaly.AnomalyDetector(sink, interval=0.5, window=10.0,
                                    registry=p.metrics.MetricsRegistry(),
                                    recorder=None, slo_tracker=tr)
    sink.data[0] = {"serve.ttft_ms": _sketch_snap(p, [10.0] * 5)}
    det.poll(now=0.0)
    sink.data[0] = {"serve.ttft_ms": _sketch_snap(p, [10.0] * 5
                                                  + [900.0] * 10)}
    fired[name] = (det.poll(now=10.0), det.slo_status())
  assert fired["torch"] == fired["jax"]
  assert [a["alert"] for a in fired["torch"][0]] == ["slo_burn"]
