"""The port's cluster runtime in InputMode.TENSORFLOW, held against the JAX
package.

- the same role-reporting main fn under both packages' ``cluster.run``
  (3 executors, ``num_ps=1``, ``eval_node=True``) sees the same ``ctx``
  fields and cluster spec; the process table and `_build_cluster_spec`
  agree;
- a failing main fn's traceback reaches ``shutdown()`` under both, and a
  bring-up failure aborts ``run()`` well inside the reservation timeout;
- the contract subset of ``tests/test_cluster.py`` on the port: port
  reservation, ps/evaluator lifecycle, engine reuse, ``driver_ps_nodes``,
  the validation errors, TensorBoard spawn/kill;
- the engine feed plane (InputMode.SPARK / ENGINE) through each entry
  point: ``train`` (with epochs), ``train_stream``, ``train_dstream``,
  ``foreach_batch`` and ``inference``, on the shm ring and the hub queue;
- every path the port does not have yet is refused by name, and the
  checkpoint and export seams of ``ctx`` work on a node;
- the seams: card allocation through a fake ``nvidia-smi``,
  ``initialize_distributed`` on gloo, the supervisor's recovery decision;
- the slice: ``train_gpt`` under ``cluster.run`` gives the losses of the
  same run in-process.

Main fns are module-level functions: the port sends them by pickle, by
name, and the executors import this module to run them.
"""

import functools
import json
import os
import sys
import time

import numpy as np
import pytest

from tensorflowonspark_tpu_torch import cluster as port_cluster
from tensorflowonspark_tpu_torch import node as port_node
from tensorflowonspark_tpu_torch.cluster import ClusterSupervisor, InputMode
from tensorflowonspark_tpu_torch.control import rendezvous
from tensorflowonspark_tpu_torch.engine import LocalEngine
from tensorflowonspark_tpu_torch.engine.base import EXECUTOR_LOST, EngineJob

CTX_FIELDS = ("job_name", "task_index", "is_chief", "num_workers",
              "process_id", "num_processes", "executor_id", "restart_count")


# -- main fns (module level: they travel by name) -----------------------------

def _report_roles(args, ctx):
  rec = {k: getattr(ctx, k) for k in CTX_FIELDS}
  rec["cluster_spec"] = ctx.cluster_spec
  rec["coordinator"] = ctx.coordinator_address
  rec["argv"] = sys.argv[1:]
  with open("roles.json", "w") as f:
    json.dump(rec, f)


def _append_generation(args, ctx):
  with open("gen.txt", "a") as f:
    f.write("x")


def _fail_marked(args, ctx):
  raise RuntimeError("marked-failure-%s" % args)


def _check_reserved_port(args, ctx):
  import socket
  port = ctx.tmp_socket.getsockname()[1]
  probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
  try:
    probe.bind(("", port))
    bind_failed = False
  except OSError:
    bind_failed = True
  finally:
    probe.close()
  ctx.release_port()
  probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
  probe.bind(("", port))            # must succeed now
  probe.close()
  with open("ports.txt", "w") as f:
    f.write(str(bind_failed))


def _report_cards(args, ctx):
  with open("cards.txt", "w") as f:
    f.write(os.environ.get("CUDA_VISIBLE_DEVICES", "<unset>"))


def _all_reduce_gloo(args, ctx):
  import torch
  import torch.distributed as dist
  ctx.initialize_distributed(backend="gloo")
  try:
    t = torch.tensor([float(ctx.process_id + 1)])
    dist.all_reduce(t)
    with open("allreduce.txt", "w") as f:
      f.write("%d:%d:%s" % (ctx.process_id, dist.get_world_size(),
                            t.item()))
  finally:
    dist.destroy_process_group()


def _ctx_calls(args, ctx):
  """The feed, checkpoint and export seams of ``ctx`` on a node."""
  import torch
  mgr = ctx.checkpoint_manager("ck", save_interval_steps=1)
  saved = mgr.save(0, {"w": torch.arange(3.0)})
  out = {"get_data_feed": type(ctx.get_data_feed()).__name__,
         "checkpoint_manager": "%s.%s" % (type(mgr).__module__,
                                          type(mgr).__name__),
         "saved": saved, "steps": mgr.all_steps(),
         "restored": mgr.restore_or({"w": torch.zeros(3)})[0]["w"].tolist(),
         "is_chief": ctx.is_chief,
         "export_dir": ctx.export_model({"w": torch.ones(2)},
                                        os.path.abspath("ex")),
         "exported": sorted(os.listdir(os.path.join("ex", "model")))}
  with open("ctx_calls.json", "w") as f:
    json.dump(out, f)


def _sum_feed(tag, ctx):
  """Sum what the feed gives this node; InputMode.SPARK."""
  feed = ctx.get_data_feed()
  total = rows = 0
  while not feed.should_stop():
    batch = feed.next_batch(8)
    total += sum(int(x) for x in batch)
    rows += len(batch)
  with open("fed_%s.json" % tag, "w") as f:
    json.dump({"total": total, "rows": rows,
               "ring": ctx.hub.get("ring_name"),
               "channels": feed.channel_chunks()}, f)


def _double_feed(tag, ctx):
  """Inference: one result, twice the row, per row."""
  feed = ctx.get_data_feed(train_mode=False)
  while not feed.should_stop():
    batch = feed.next_batch(3)
    if batch:
      feed.batch_results([2 * x for x in batch])


def _train_gpt_main(args, ctx):
  import torch
  from tensorflowonspark_tpu_torch.examples import train_gpt
  torch.set_num_threads(1)
  losses = train_gpt.run(train_gpt.parse_args(args["argv"]))
  with open(args["out"], "w") as f:
    json.dump(losses, f)


# -- fixtures -----------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
  e = LocalEngine(num_executors=2)
  yield e
  e.stop()


def _read(engine, slot, name):
  with open(os.path.join(engine.executor_workdir(slot), name)) as f:
    return f.read()


# -- held against the JAX package ---------------------------------------------

def _roles_under(pkg_cluster, pkg_engine):
  eng = pkg_engine(num_executors=3)
  try:
    c = pkg_cluster.run(eng, _report_roles, ["--flag", "1"], num_ps=1,
                        eval_node=True, input_mode=InputMode.TENSORFLOW,
                        reservation_timeout=60)
    jobs = sorted(n["job_name"] for n in c.cluster_info)
    c.shutdown(timeout=120)
    recs = [json.loads(open(os.path.join(eng.executor_workdir(s),
                                         "roles.json")).read())
            for s in range(3)]
  finally:
    eng.stop()
  for r in recs:
    # ports are each run's own: compare the spec's shape and hosts
    r["cluster_spec"] = {k: [h.rsplit(":", 1)[0] for h in v]
                         for k, v in r["cluster_spec"].items()}
    r["coordinator"] = r["coordinator"].rsplit(":", 1)[0]
  return jobs, sorted(recs, key=lambda r: r["executor_id"])


def test_cluster_shape_matches_the_jax_package():
  from tensorflowonspark_tpu import cluster as jax_cluster
  from tensorflowonspark_tpu.engine import LocalEngine as JaxLocalEngine
  jax_jobs, jax_recs = _roles_under(jax_cluster, JaxLocalEngine)
  port_jobs, port_recs = _roles_under(port_cluster, LocalEngine)
  assert port_jobs == jax_jobs == ["evaluator", "ps", "worker"]
  assert port_recs == jax_recs
  assert [(r["job_name"], r["process_id"], r["num_processes"], r["is_chief"])
          for r in port_recs] == [("ps", -1, 1, False),
                                  ("evaluator", -1, 1, False),
                                  ("worker", 0, 1, True)]
  assert all(r["argv"] == ["--flag", "1"] for r in port_recs)


def _info(*nodes):
  return [{"executor_id": i, "job_name": job, "task_index": ti,
           "host": "h%d" % (i % 2), "port": 7000 + i}
          for i, (job, ti) in enumerate(nodes)]


@pytest.mark.parametrize("info", [
    _info(("worker", 0)),
    _info(("worker", 1), ("worker", 0), ("chief", 0)),
    _info(("ps", 0), ("master", 0), ("evaluator", 0), ("worker", 1),
          ("worker", 0)),
    _info(("ps", 0), ("ps", 1)),
], ids=["one", "chief", "master_ps_eval", "ps_only"])
def test_process_table_and_spec_match_the_jax_package(info):
  from tensorflowonspark_tpu import node as jax_node
  assert port_node._process_table(info) == jax_node._jax_process_table(info)
  assert port_node._build_cluster_spec(info) == \
      jax_node._build_cluster_spec(info)
  for job, ti in (("worker", 0), ("chief", 0), ("ps", 0)):
    assert port_node.is_chief(job, ti, {n["job_name"] for n in info}) == \
        jax_node.is_chief(job, ti, {n["job_name"] for n in info})
  with pytest.raises(RuntimeError, match="duplicate"):
    port_node._build_cluster_spec(info + info[:1])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_failing_main_fn_traceback_reaches_shutdown(pkg, engine):
  if pkg == "jax":
    from tensorflowonspark_tpu import cluster as pkg_cluster
    from tensorflowonspark_tpu.engine import LocalEngine as pkg_engine
    eng = pkg_engine(num_executors=1)
  else:
    pkg_cluster, eng = port_cluster, engine
  try:
    c = pkg_cluster.run(eng, _fail_marked, pkg, num_executors=1,
                        input_mode=InputMode.TENSORFLOW,
                        reservation_timeout=60)
    with pytest.raises(RuntimeError) as err:
      c.shutdown(timeout=120)
  finally:
    if pkg == "jax":
      eng.stop()
  text = str(err.value)
  assert "cluster shutdown with node error" in text
  assert "Traceback" in text and "marked-failure-%s" % pkg in text
  assert "_fail_marked" in text


def test_early_bringup_failure_surfaces_fast():
  """A node failing before registration aborts run() with its traceback
  well before the reservation timeout (the pinned node port does not
  parse, so every node task raises before registering)."""
  bad = LocalEngine(num_executors=2, env={"TOS_TPU_NODE_PORT": "notaport"})
  try:
    t0 = time.time()
    with pytest.raises(RuntimeError,
                       match="(?s)cluster startup aborted.*notaport"):
      port_cluster.run(bad, _append_generation, reservation_timeout=300)
    assert time.time() - t0 < 60
  finally:
    bad.stop()


# -- the contract subset of tests/test_cluster.py -----------------------------

def test_port_reservation_semantics(engine):
  c = port_cluster.run(engine, _check_reserved_port, release_port=False,
                       reservation_timeout=60)
  c.shutdown(timeout=120)
  assert [_read(engine, s, "ports.txt") for s in range(2)] == ["True"] * 2


def test_engine_reuse_two_clusters(tmp_path):
  eng = LocalEngine(num_executors=2, workdir=str(tmp_path))
  try:
    for _ in range(2):
      c = port_cluster.run(eng, _append_generation, reservation_timeout=60)
      c.shutdown(timeout=120)
    assert [_read(eng, s, "gen.txt") for s in range(2)] == ["xx", "xx"]
  finally:
    eng.stop()


def test_driver_ps_nodes():
  eng = LocalEngine(num_executors=2)
  try:
    c = port_cluster.run(eng, _report_roles, num_executors=3, num_ps=1,
                         driver_ps_nodes=True, reservation_timeout=60)
    assert sorted(n["job_name"] for n in c.cluster_info) == \
        ["ps", "worker", "worker"]
    c.shutdown(timeout=120)
    assert not c.driver_ps_procs[0].is_alive()
    for s in range(2):
      assert json.loads(_read(eng, s, "roles.json"))["job_name"] == "worker"
  finally:
    eng.stop()


def test_validation_errors(engine):
  with pytest.raises(ValueError, match="at least one worker"):
    port_cluster.run(engine, _report_roles, num_ps=2)
  with pytest.raises(ValueError, match="executors"):
    port_cluster.run(engine, _report_roles, num_executors=5)
  with pytest.raises(ValueError, match="train_unroll"):
    port_cluster.run(engine, _report_roles, train_unroll=0)


_FAKE_TB = """\
import argparse, os, signal, sys, time
p = argparse.ArgumentParser()
p.add_argument("--logdir"); p.add_argument("--port"); p.add_argument("--host")
a, _ = p.parse_known_args()


def _bye(sig, frame):
  with open(os.path.join(a.logdir, "tb_killed.txt"), "w") as f:
    f.write("killed")
  sys.exit(0)


signal.signal(signal.SIGTERM, _bye)
with open(os.path.join(a.logdir, "tb_started.txt"), "w") as f:
  f.write("%d %s" % (os.getpid(), a.port))
while True:
  time.sleep(0.2)
"""


def _wait_for(path, timeout=20):
  deadline = time.time() + timeout
  while not os.path.exists(path) and time.time() < deadline:
    time.sleep(0.1)
  return os.path.exists(path)


def test_tensorboard_spawned_on_chief_and_killed_on_shutdown(tmp_path,
                                                            monkeypatch):
  from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port
  fake_bin = tmp_path / "bin"
  fake_bin.mkdir()
  (fake_bin / "tensorboard").write_text(_FAKE_TB)
  log_dir = tmp_path / "logs"
  log_dir.mkdir()
  port = get_free_port()
  monkeypatch.setenv("PATH",
                     str(fake_bin) + os.pathsep + os.environ.get("PATH", ""))
  monkeypatch.setenv("TENSORBOARD_PORT", str(port))
  eng = LocalEngine(num_executors=2)
  try:
    c = port_cluster.run(eng, _append_generation, tensorboard=True,
                         log_dir=str(log_dir), reservation_timeout=60)
    url = c.tensorboard_url()
    assert url is not None and url.endswith(":%d" % port), url
    assert _wait_for(str(log_dir / "tb_started.txt"))
    tb_pid, tb_port = (log_dir / "tb_started.txt").read_text().split()
    assert tb_port == str(port)
    os.kill(int(tb_pid), 0)        # alive while the cluster runs
    c.shutdown(timeout=120)
    assert _wait_for(str(log_dir / "tb_killed.txt")), \
        "shutdown did not SIGTERM the tensorboard"
  finally:
    eng.stop()


def test_apply_node_env_retracts_only_its_own_export(monkeypatch):
  from tensorflowonspark_tpu_torch.parallel.sharding import ENV_TRAIN_UNROLL
  monkeypatch.delenv(ENV_TRAIN_UNROLL, raising=False)
  monkeypatch.setattr(port_node, "_applied_node_env", {})
  port_node._apply_node_env({"train_unroll": 8})       # run A exports
  assert os.environ[ENV_TRAIN_UNROLL] == "8"
  port_node._apply_node_env({"train_unroll": None})    # run B sets nothing
  assert ENV_TRAIN_UNROLL not in os.environ
  monkeypatch.setenv(ENV_TRAIN_UNROLL, "3")            # the user's own pin
  port_node._apply_node_env({"train_unroll": None})
  assert os.environ[ENV_TRAIN_UNROLL] == "3"


# -- refusals by name ---------------------------------------------------------

class _UntouchedEngine(object):
  """An engine that fails the test if the cluster layer touches it."""
  num_executors = 2

  def default_fs(self):
    return "file://"

  def run_on_executors(self, *args, **kwargs):
    raise AssertionError("an executor was touched before the refusal")


def _local_closure():
  def main_fn(args, ctx):
    return None
  return main_fn


@pytest.mark.parametrize("kwargs,env,exc,match", [
    # the observability plane is ported: TOS_OBS=1 is no longer refused,
    # and the run goes on to launch its nodes on the engine
    (dict(), {"TOS_OBS": "1"}, AssertionError, "executor was touched"),
    # elastic groups are ported (item 10c, part 2): group_map and elastic
    # are no longer refused, and the run goes on to its nodes
    (dict(group_map={0: 0, 1: 1}), {}, AssertionError,
     "executor was touched"),
    (dict(elastic=True), {}, AssertionError, "executor was touched"),
    (dict(feed_segment=object()), {}, NotImplementedError, "item 11"),
    (dict(main_fn=lambda args, ctx: None), {}, TypeError, "lambda"),
    (dict(main_fn=_local_closure()), {}, TypeError, "closure"),
], ids=["tos_obs", "group_map", "elastic", "feed_segment", "lambda",
        "closure"])
def test_unported_paths_are_refused_before_any_executor(kwargs, env, exc,
                                                        match, monkeypatch):
  from tensorflowonspark_tpu_torch.obs import metrics, spans
  for k, v in env.items():
    monkeypatch.setenv(k, v)
  main_fn = kwargs.pop("main_fn", _report_roles)
  try:
    with pytest.raises(exc, match=match):
      port_cluster.run(_UntouchedEngine(), main_fn, **kwargs)
  finally:
    metrics.deactivate()       # what TOS_OBS=1 installed in this process
    spans.deactivate()


# -- the engine feed plane ------------------------------------------------------

PARTS = [list(range(10 * p, 10 * p + 7)) for p in range(4)]


def _fed(engine, tag, nodes=2):
  """(sum, rows, records) that ``_sum_feed`` wrote on each node."""
  recs = []
  for s in range(nodes):
    path = os.path.join(engine.executor_workdir(s), "fed_%s.json" % tag)
    with open(path) as f:
      recs.append(json.load(f))
    os.remove(path)
  return (sum(r["total"] for r in recs), sum(r["rows"] for r in recs), recs)


@pytest.mark.parametrize("mode,transport", [
    (InputMode.ENGINE, "queue"), (InputMode.SPARK, "auto")],
    ids=["engine_mode", "spark_mode"])
def test_engine_input_mode_feeds_every_node(mode, transport, engine):
  """``cluster.run(input_mode=ENGINE/SPARK)``: both nodes run the fn in
  the background, ``train`` feeds them and ``shutdown`` ends their feeds;
  "auto" on a LocalEngine carries the input on each node's shm ring."""
  tag = "mode_%s" % transport
  c = port_cluster.run(engine, _sum_feed, tag, input_mode=mode,
                       feed_transport=transport, reservation_timeout=60)
  c.train(PARTS, num_epochs=1)
  c.shutdown(timeout=120)
  total, rows, recs = _fed(engine, tag)
  assert (total, rows) == (sum(map(sum, PARTS)), 28)
  if transport == "auto":
    assert all(r["ring"] for r in recs)
    assert sum(r["channels"]["ring"] for r in recs) >= 4 + 2
    assert all(r["channels"]["queue"] == 0 for r in recs)
  else:
    assert all(r["ring"] is None and r["channels"] is None for r in recs)


class _StandInDStream(object):
  """A DStream's one method: ``foreachRDD(fn)`` calls ``fn`` per
  micro-batch (here at once, for each of ``rdds``)."""

  def __init__(self, rdds):
    self.rdds = rdds

  def foreachRDD(self, fn):
    for rdd in self.rdds:
      fn(rdd)


@pytest.mark.parametrize("method", ["train", "inference", "train_stream",
                                    "train_dstream", "foreach_batch"])
def test_feed_plane_entry_points(method, engine):
  fn = _double_feed if method == "inference" else _sum_feed
  c = port_cluster.run(engine, fn, method, input_mode=InputMode.SPARK,
                       reservation_timeout=60)
  epochs = 2 if method == "train" else 1
  extra = (0, 0)          # (sum, rows) fed beyond the epochs of PARTS
  try:
    if method == "train":
      c.train(PARTS, num_epochs=epochs)
      # a one-shot stream of partitions, one a lazy handle the feeder
      # calls on the executor; it cannot replay epochs
      lazy = functools.partial(list, range(100, 107))
      with pytest.raises(ValueError, match="one-shot"):
        c.train(iter([lazy]), num_epochs=2)
      c.train(iter([PARTS[0], lazy]))
      extra = (sum(PARTS[0]) + sum(range(100, 107)), 14)
    elif method == "inference":
      want = [2 * x for p in PARTS for x in p]
      assert c.inference(PARTS) == want
      assert list(c.inference(iter(PARTS), collect=False)) == want
    elif method == "train_stream":
      def rounds():
        yield PARTS[:2]
        c.request_stop()
        yield PARTS[2:]
        yield [[1000]]                     # never pulled
      assert c.train_stream(rounds()) == 2
    elif method == "train_dstream":
      handle = c.train_dstream(_StandInDStream([PARTS[:2], PARTS[2:]]))
      assert (handle.rounds, handle.stopped) == (2, False)
    else:
      feed = c.foreach_batch()
      feed(PARTS[:2], 0)
      feed(PARTS[2:], 1)
      c.request_stop()
      feed([[1000]], 2)                    # skipped after the stop request
  finally:
    c.shutdown(timeout=120)
  if method != "inference":
    assert _fed(engine, method)[:2] == (
        epochs * sum(map(sum, PARTS)) + extra[0], epochs * 28 + extra[1])


def test_feed_plane_needs_engine_input_mode():
  c = port_cluster.Cluster(_UntouchedEngine(), [], {"queues": []}, None,
                           InputMode.TENSORFLOW, None, {"error": None})
  for call in (lambda: c.train([[1, 2]]), lambda: c.inference([[1, 2]]),
               lambda: c.train_stream(iter([])), c.foreach_batch,
               lambda: c.train_dstream(_StandInDStream([]))):
    with pytest.raises(RuntimeError, match="InputMode.ENGINE/SPARK"):
      call()


def test_ctx_feed_checkpoint_and_export_name_their_items(engine):
  c = port_cluster.run(engine, _ctx_calls, num_executors=1,
                       reservation_timeout=60)
  c.shutdown(timeout=120)
  got = json.loads(_read(engine, 0, "ctx_calls.json"))
  workdir = engine.executor_workdir(0)
  assert got == {
      "get_data_feed": "DataFeed",
      "checkpoint_manager":
          "tensorflowonspark_tpu_torch.utils.checkpoint.CheckpointManager",
      "saved": True, "steps": [0], "restored": [0.0, 1.0, 2.0],
      "is_chief": True, "export_dir": os.path.join(workdir, "ex"),
      "exported": ["state.json", "state.pt"]}
  assert os.path.exists(os.path.join(workdir, "ck", ".commit-0.json"))


# -- the seams ----------------------------------------------------------------

def _fake_nvidia_smi(directory, cards):
  lines = "".join("%d, GPU-%d, NVIDIA H100 80GB HBM3, 81559\\n" % (i, i)
                  for i in range(cards))
  path = os.path.join(directory, "nvidia-smi")
  with open(path, "w") as f:
    f.write("#!/bin/sh\nprintf '%s'\n" % lines)
  os.chmod(path, 0o755)


def test_card_allocation_through_nvidia_smi(tmp_path):
  """With test mode off and a fake one-card ``nvidia-smi`` first on PATH,
  a node gets ``CUDA_VISIBLE_DEVICES=0``; asking for 2 cards fails
  bring-up before the fn runs, naming the count."""
  _fake_nvidia_smi(str(tmp_path), 1)
  eng = LocalEngine(num_executors=1, env={
      "TOS_TPU_TEST_MODE": "",
      "PATH": str(tmp_path) + os.pathsep + os.environ.get("PATH", "")})
  try:
    c = port_cluster.run(eng, _report_cards, chips_per_node=1,
                         reservation_timeout=60)
    c.shutdown(timeout=120)
    assert _read(eng, 0, "cards.txt") == "0"
    os.remove(os.path.join(eng.executor_workdir(0), "cards.txt"))
    t0 = time.time()
    with pytest.raises(RuntimeError,
                       match=r"(?s)cluster startup aborted.*nvidia-smi "
                             r"counts 1 card\(s\)"):
      port_cluster.run(eng, _report_cards, chips_per_node=2,
                       reservation_timeout=300)
    assert time.time() - t0 < 60
    assert not os.path.exists(os.path.join(eng.executor_workdir(0),
                                           "cards.txt"))
  finally:
    eng.stop()


def test_initialize_distributed_on_gloo(engine):
  c = port_cluster.run(engine, _all_reduce_gloo, reservation_timeout=60)
  c.shutdown(timeout=120)
  got = sorted(_read(engine, s, "allreduce.txt") for s in range(2))
  assert got == ["0:2:3.0", "1:2:3.0"]


class _StandInServer(object):
  def __init__(self):
    self.done = _Flag()
    self.liveness = rendezvous.Liveness(interval=None)
    self.reservations = rendezvous.Reservations(1)


class _Flag(object):
  def is_set(self):
    return False


class _StandInEngine(object):
  """Relaunches by registering the new incarnation, as a node would."""

  def __init__(self, server):
    self.server = server
    self.relaunched = []

  def preempt_task(self, job, task_id):
    return False

  def relaunch_task(self, job, task_id, payload=None):
    self.relaunched.append((task_id, payload))
    job._task_restarted(task_id)
    self.server.reservations.add({"executor_id": payload["executor_id"],
                                  "host": "h0", "pid": 2,
                                  "restart": payload["restart"],
                                  "hub_addr": ["127.0.0.1", 1]})


def _supervisor(template, max_restarts):
  server = _StandInServer()
  job = EngineJob(1)
  job._task_finished(0, error="%s: executor died" % EXECUTOR_LOST)
  meta = {"cluster_template": template, "authkey": b"k",
          "reservation_timeout": 10}
  info = [{"executor_id": 0, "host": "h0", "hub_addr": ["127.0.0.1", 1]}]
  eng = _StandInEngine(server)
  sup = ClusterSupervisor(eng, server, job, meta, info, [0],
                          {"error": None}, max_restarts=max_restarts,
                          backoff=0.01, backoff_cap=0.02)
  return sup, eng, info


def test_supervisor_detects_relaunches_and_recovers():
  sup, eng, info = _supervisor({"worker": [0]}, max_restarts=1)
  assert sup._failed_executors() == [0]
  sup._recover(0)
  assert [e["kind"] for e in sup.events] == ["detected-dead", "relaunched",
                                             "recovered"]
  assert sup.restarts == {0: 1}
  assert eng.relaunched == [(0, {"executor_id": 0, "restart": 1})]
  assert info[0]["restart"] == 1          # cluster_info patched in place
  # the budget is spent: the next death gives up and fails the cluster
  sup.node_job._task_finished(0, error="%s: again" % EXECUTOR_LOST,
                              attempt=1)
  sup._recover(0)
  assert sup.events[-1]["kind"] == "gave-up"
  assert "max_restarts=1" in sup.tf_status["error"]


@pytest.mark.parametrize("template,kind", [({"worker": [0]}, "gave-up"),
                                           ({"ps": [0]}, "skipped-background")])
def test_supervisor_never_relaunches_without_budget_or_background(template,
                                                                  kind):
  sup, eng, _ = _supervisor(template, max_restarts=0)
  sup._recover(0)
  assert [e["kind"] for e in sup.events] == ["detected-dead", kind]
  assert eng.relaunched == [] and sup.restarts == {}
  assert sup.tf_status["error"]


# -- the slice: train_gpt under cluster.run -----------------------------------

def _write_tokens(path, rows=6, seq=64, vocab=64):
  from tensorflowonspark_tpu_torch.data import example_codec, tfrecord
  rng = np.random.default_rng(5)
  with tfrecord.TFRecordWriter(path) as w:
    for _ in range(rows):
      w.write(example_codec.encode_example(
          {"tokens": rng.integers(0, vocab, seq - int(rng.integers(0, 9)))
           .tolist()}))


def test_train_gpt_under_cluster_matches_in_process(tmp_path):
  import torch
  from tensorflowonspark_tpu_torch.examples import train_gpt
  data = str(tmp_path / "part-00000.tfrecord")
  _write_tokens(data)
  argv = ["--device", "cpu", "--data", data, "--layers", "2", "--d_model",
          "64", "--heads", "4", "--kv_heads", "2", "--seq_len", "64",
          "--vocab", "64", "--batch", "2", "--steps", "3"]
  out = str(tmp_path / "losses.json")
  eng = LocalEngine(num_executors=1)
  try:
    c = port_cluster.run(eng, _train_gpt_main, {"argv": argv, "out": out},
                         input_mode=InputMode.TENSORFLOW, max_restarts=0,
                         reservation_timeout=60)
    c.shutdown(timeout=300)
    assert c.supervisor.restarts == {}
  finally:
    eng.stop()
  with open(out) as f:
    got = json.load(f)
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    want = train_gpt.run(train_gpt.parse_args(argv))
  finally:
    torch.set_num_threads(threads)
  assert len(got) == 3 and all(np.isfinite(got))
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _die_once(args, ctx):
  """First launch: report the pid and wait to be killed; the supervised
  relaunch (``ctx.restart_count == 1``) finishes."""
  if ctx.restart_count == 0:
    with open("victim.pid", "w") as f:
      f.write(str(os.getpid()))
    time.sleep(120)
  with open("recovered.txt", "w") as f:
    f.write("%d:%d" % (ctx.restart_count, os.getpid()))


def test_sigkilled_node_is_relaunched_and_recovers(tmp_path):
  """End to end: SIGKILL the executor running a node; the supervisor sees
  it dead, relaunches it with ``restart_count=1`` on the respawned slot,
  and shutdown reports success."""
  import signal
  eng = LocalEngine(num_executors=1, workdir=str(tmp_path))
  try:
    c = port_cluster.run(eng, _die_once, heartbeat_interval=1.0,
                         restart_backoff=0.05, restart_backoff_cap=0.1,
                         max_restarts=1, reservation_timeout=60)
    pid_file = os.path.join(eng.executor_workdir(0), "victim.pid")
    assert _wait_for(pid_file)
    time.sleep(0.2)
    victim = int(open(pid_file).read())
    os.kill(victim, signal.SIGKILL)
    c.shutdown(timeout=120)
    assert c.supervisor.restarts == {0: 1}
    assert [e["kind"] for e in c.supervisor.events] == [
        "detected-dead", "relaunched", "recovered"]
    restart, pid = _read(eng, 0, "recovered.txt").split(":")
    assert restart == "1" and int(pid) != victim
  finally:
    eng.stop()
