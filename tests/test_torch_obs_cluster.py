"""The observability plane on the port's cluster runtime (``TOS_OBS=1``),
with LocalEngine executors.

- fed training on 2 executors (InputMode.SPARK): the driver's sink
  aggregates ``feed.rows`` and ``feed.wire_rows`` exactly (the node's and
  the feeder's shippers both land), ``train.steps`` equals the steps the
  executors took, ``HEALTH`` carries each executor's obs summary, nothing
  is lost or dropped, the healthy run raises no alert, and the per-process
  JSONL logs merge into one Chrome trace with driver, executor and feeder
  tracks whose executor spans fall inside the driver's window;
- the port's twin of the reference's straggler acceptance test: an
  executor whose main fn sleeps every step trips ``straggler``, seen in
  the supervisor's events, the ``HEALTH`` wire and the driver's JSONL;
- with ``TOS_OBS`` unset, no registry, recorder, sink, detector or
  shipper thread exists in the driver or an executor.

Main fns are module-level: they travel by name.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.cluster import InputMode
from tensorflowonspark_tpu_torch.control import rendezvous
from tensorflowonspark_tpu_torch.engine import LocalEngine
from tensorflowonspark_tpu_torch.obs import anomaly, collector, export
from tensorflowonspark_tpu_torch.obs import device as obs_device
from tensorflowonspark_tpu_torch.obs import metrics, spans

ROWS, PARTS, BATCH = 96, 4, 6


@pytest.fixture(autouse=True)
def clean_active():
  """The cluster tests set TOS_OBS with monkeypatch only; the driver-side
  registry and recorder it lazily installed go with the test."""
  yield
  metrics.deactivate()
  spans.deactivate()


def _tiny_loop():
  """A one-layer linear model, AdamW and the port's TrainLoop: the obs
  seams of the train step without a transformer's cost."""
  import torch
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.parallel import sharding
  from tensorflowonspark_tpu_torch.train_state import TrainState
  torch.manual_seed(0)
  state = TrainState.create(torch.nn.Linear(4, 1), optim.make_optimizer(1e-2))
  loop = sharding.make_train_loop(
      lambda model, x: model(x).pow(2).mean(), unroll=1)
  return state, loop


# -- main fns -----------------------------------------------------------------

def _fed_main(out, ctx):
  from tensorflowonspark_tpu_torch.data import readers
  state, loop = _tiny_loop()
  feed = ctx.get_data_feed()
  steps = rows = 0
  for batch in readers.feed_batches(feed, BATCH):
    state, _ = loop(state, batch)
    steps += 1
    rows += len(batch)
  with open(os.path.join(out, "exec%d.json" % ctx.executor_id), "w") as f:
    json.dump({"steps": steps, "rows": rows,
               "sentinel_errors": obs_device.SENTINEL_ERRORS["count"]}, f)


def _paced_main(args, ctx):
  """Steps for ``args["seconds"]``, sleeping ``args["sleep"][eid]`` a
  step: the slow executor is this fn's own pacing."""
  state, loop = _tiny_loop()
  x = np.ones((2, 4), np.float32)
  pause = args["sleep"][ctx.executor_id]
  deadline = time.monotonic() + args["seconds"]
  while time.monotonic() < deadline:
    state, _ = loop(state, x)
    time.sleep(pause)


def _plane_off_main(out, ctx):
  rec = {"registry": metrics._active is None, "recorder": spans._active is None,
         "threads": sorted(t.name for t in threading.enumerate())}
  with open(os.path.join(out, "off.json"), "w") as f:
    json.dump(rec, f)


# -- tests --------------------------------------------------------------------

def _obs_env(monkeypatch, obs_dir, **extra):
  env = {metrics.ENV_OBS: "1", export.ENV_OBS_DIR: obs_dir,
         collector.ENV_OBS_INTERVAL: "0.2"}
  env.update(extra)
  for k, v in env.items():
    monkeypatch.setenv(k, v)
  return env


def test_fed_training_ships_exact_counts_and_one_trace(tmp_path, monkeypatch):
  obs_dir, out = str(tmp_path / "obs"), str(tmp_path)
  env = _obs_env(monkeypatch, obs_dir)
  engine = LocalEngine(num_executors=2, env=env)
  rows = [np.full(4, i, np.float32) for i in range(ROWS)]
  try:
    c = cluster.run(engine, _fed_main, out, input_mode=InputMode.SPARK,
                    reservation_timeout=60, heartbeat_interval=0.5)
    assert c.obs_sink is not None and c.detector is not None
    c.train([rows[i::PARTS] for i in range(PARTS)], num_epochs=1)
    client = rendezvous.Client(tuple(c.server.addr), timeout=10)
    health = client._request({"type": "HEALTH"})
    client.close()
    c.shutdown(timeout=120)
  finally:
    engine.stop()

  assert sorted(health["obs"]) == ["0", "1"] and health["alerts"] == []
  assert all(e["ships"] > 0 for e in health["obs"].values())
  sink = c.obs_sink
  assert sink.aggregate("feed.rows") == ROWS
  assert sink.aggregate("feed.wire_rows") == ROWS
  done = [json.load(open(os.path.join(out, "exec%d.json" % e)))
          for e in (0, 1)]
  assert sum(d["rows"] for d in done) == ROWS
  assert sink.aggregate("train.steps") == sum(d["steps"] for d in done)
  assert sink.aggregate("xla.compiles.train.step") >= 2
  assert all(d["sentinel_errors"] == 0 for d in done)
  summary = sink.summary()
  assert summary["spans_dropped"] == 0 and summary["rejected"] == 0
  for e in summary["executors"].values():
    assert e["drops"]["ship_failures"] == 0
    assert e["drops"]["spans_lost"] == 0
    assert e["drops"]["spans_dropped"] == 0
  assert c.alerts() == [] and c.detector.summary()["eval_failures"] == 0
  assert c.obs_summary()["obs"].keys() == {"0", "1"}

  procs = export.merge_jsonl(export.find_logs(obs_dir))
  trace = export.chrome_trace(procs)
  tracks = sorted(e["args"]["name"] for e in trace["traceEvents"]
                  if e.get("name") == "process_name")
  assert tracks == ["driver0", "exec0", "exec1", "feeder0", "feeder1"]
  by_name = {}
  for e in trace["traceEvents"]:
    if e.get("ph") == "X":
      by_name.setdefault(e["name"], []).append(e)
  steps = sum(d["steps"] for d in done)
  assert len(by_name["train.slab"]) == steps
  assert len(by_name["feed.batch"]) >= steps
  # the executors' spans sit inside the driver's window once each log's
  # clock offset is applied
  lo = min(e["ts"] for e in by_name["cluster.assemble"])
  hi = max(e["ts"] + e["dur"] for e in by_name["cluster.shutdown"])
  for e in by_name["train.slab"] + by_name["feed.batch"]:
    assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi


def test_a_sleeping_executor_trips_the_straggler_alert(tmp_path, monkeypatch):
  obs_dir = str(tmp_path / "obs")
  env = _obs_env(monkeypatch, obs_dir, **{
      anomaly.ENV_OBS_DETECT_INTERVAL: "0.25", anomaly.ENV_OBS_WINDOW: "2.0"})
  engine = LocalEngine(num_executors=2, env=env)
  try:
    c = cluster.run(engine, _paced_main,
                    {"seconds": 4.0, "sleep": {0: 0.01, 1: 0.4}},
                    input_mode=InputMode.TENSORFLOW, reservation_timeout=60,
                    heartbeat_interval=0.5)
    alert = c.detector.wait_alert(timeout=60, kind="straggler")
    assert alert is not None, "straggler alert never fired"
    assert alert["executor_id"] == 1
    client = rendezvous.Client(tuple(c.server.addr), timeout=10)
    reply = client._request({"type": "HEALTH"})
    client.close()
    assert any(a["alert"] == "straggler" and a["executor_id"] == 1
               for a in reply["alerts"]), reply.get("alerts")
    c.shutdown(timeout=120)
  finally:
    engine.stop()
  assert "alert-straggler" in [e["kind"] for e in c.supervisor.events]
  procs = export.merge_jsonl(export.find_logs(obs_dir))
  (driver,) = [p for p in procs if p["meta"]["label"] == "driver"]
  assert any(a["alert"] == "straggler" for a in driver["alerts"])


def test_plane_off_leaves_no_trace_of_itself(tmp_path, monkeypatch):
  monkeypatch.delenv(metrics.ENV_OBS, raising=False)
  engine = LocalEngine(num_executors=1)
  try:
    c = cluster.run(engine, _plane_off_main, str(tmp_path),
                    input_mode=InputMode.TENSORFLOW, reservation_timeout=60)
    c.shutdown(timeout=120)
  finally:
    engine.stop()
  assert c.obs_sink is None and c.detector is None and c.alerts() == []
  assert c.server.obs_sink is None and c.server.alert_source is None
  assert metrics._active is None and spans._active is None
  with open(os.path.join(str(tmp_path), "off.json")) as f:
    rec = json.load(f)
  assert rec["registry"] and rec["recorder"]
  assert not [t for t in rec["threads"] if "obs" in t]
  assert not [t.name for t in threading.enumerate() if "obs" in t.name]
