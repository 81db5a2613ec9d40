"""L3' cluster lifecycle API: reserve → launch → (feed) → shutdown.

The port's copy of ``tensorflowonspark_tpu/cluster.py`` (TensorFlowOnSpark's
``TFCluster.py``), generalized over the engine abstraction and targeted at
PyTorch on CUDA cards:

- ``run()`` builds the role template mapping job names → executor ids
  (TFCluster.py:256-271), starts the rendezvous server (:283-285), launches
  the node bring-up job asynchronously (:318-336), awaits and validates
  reservations with duplicate detection (:357-372);
- ``train()`` / ``inference()`` implement the engine-pushes-rows input
  mode (InputMode.SPARK), with epochs by replicating the dataset (parity
  with epochs-via-RDD.union, :90-94); ``train_stream``, ``train_dstream``
  and ``foreach_batch`` feed micro-batches until a stop request;
- ``shutdown()`` pushes end-of-feed into the workers' input channels
  through a shutdown job (InputMode.SPARK, :174-176) or reaps the chief's
  TensorBoard (InputMode.TENSORFLOW), remotely stops ps/evaluator nodes
  through their driver-reachable hubs (:186-194), enforces a watchdog
  timeout (default 3 days, :136-144) and raises if any node failed
  (:179-183).

::

    c = cluster.run(LocalEngine(num_executors=1), main_fn, tf_args,
                    input_mode=InputMode.SPARK, chips_per_node=1)
    c.train(partitions, num_epochs=1)   # main_fn reads ctx.get_data_feed()
    c.shutdown()

With ``TOS_OBS=1`` the observability plane runs as in the JAX package:
every executor ships metric/span deltas over the rendezvous ``OBS`` verb
into the driver's ``Cluster.obs_sink``, the ``AnomalyDetector`` (and its
``SLOTracker``) watches the sink online (``Cluster.alerts()``,
``obs_summary()``, ``slo_status()``; ``HEALTH`` replies carry the same),
and ``TOS_OBS_DIR`` collects per-process JSONL logs that
``obs.export.merge_jsonl`` + ``chrome_trace`` turn into one trace.

``group_map={executor_id: group_id}`` declares elastic multi-group
training (``parallel.groups``): the rendezvous server carries a
``SyncPlane`` and the supervisor's events the group; with
``elastic=True`` a grouped executor past its restart budget commits a
shrink instead of failing the job.

Not ported yet, refused by name before any executor is touched: feeder
pushdown segments (``feed_segment``: item 11).
"""

import collections.abc
import contextlib
import logging
import os
import pickle
import random
import signal
import threading
import time
from typing import Dict, List, Optional, Sequence

from tensorflowonspark_tpu_torch import node as node_mod
from tensorflowonspark_tpu_torch.control import feedhub, rendezvous
from tensorflowonspark_tpu_torch.engine.base import Engine, is_executor_lost
from tensorflowonspark_tpu_torch.obs import metrics as obs_metrics
from tensorflowonspark_tpu_torch.obs import spans as obs_spans

logger = logging.getLogger(__name__)

class ClusterSupervisor(object):
  """Driver-side node babysitter: detect dead nodes, relaunch, requeue.

  Two failure signals are watched:

  - **liveness**: executors whose heartbeats stopped past the missed-beat
    deadline (``rendezvous.Liveness`` — a SIGKILL, OOM kill or preemption
    stops the beats without any traceback);
  - **engine**: node tasks that died WITH their executor (errors carrying
    the ``ExecutorLost`` marker from ``engine.base``; a device fault that
    aborts the process lands here).

  Application exceptions (a user fn raising) are NOT retried — they
  propagate exactly as without supervision. For restartable failures the
  recovery sequence is:

  1. back off (exponential with full jitter, capped at ``backoff_cap``;
     the attempt budget is ``max_restarts`` per executor);
  2. mark the dead node's hub ``dead`` so the relaunched node reclaims it,
     and (InputMode.SPARK) drain its undelivered feed rows
     (``datafeed.drain_pending_rows``) so blocked feeders complete and no
     delivered-but-unprocessed row is lost;
  3. relaunch the node task via ``Engine.relaunch_task``, handing the
     restart count to the new node (→ ``ctx.restart_count``);
  4. await re-registration, patch ``cluster_info`` in place (feed tasks
     submitted afterwards see the new hub), and refeed the drained rows
     through the engine feed path.

  Recoveries run serially on the supervisor thread. ``wait_idle()`` lets
  callers block until no recovery is active.
  """

  def __init__(self, engine: Engine, server: rendezvous.Server,
               node_job, cluster_meta: dict, cluster_info: List[dict],
               engine_ids: Sequence[int], tf_status: dict,
               max_restarts: int = 2, backoff: float = 0.5,
               backoff_cap: float = 5.0):
    self.engine = engine
    self.server = server
    self.node_job = node_job
    self.cluster_meta = cluster_meta
    self.cluster_info = cluster_info
    self.tf_status = tf_status
    self.max_restarts = max_restarts
    self.backoff = backoff
    self.backoff_cap = backoff_cap
    self._eid_task = {eid: i for i, eid in enumerate(engine_ids)}
    self._attempts: Dict[int, int] = {}
    self._given_up: set = set()
    #: executor_id -> completed restart count (observability)
    self.restarts: Dict[int, int] = {}
    #: executors whose group's shrink was committed (elastic resize):
    #: their lost node task is the resize, not a failure of the job
    self.shrunk: set = set()
    #: recovery event log: dicts with executor_id / kind / t (monotonic)
    self.events: List[dict] = []
    self._stop = threading.Event()
    self._idle = threading.Event()
    self._idle.set()
    self._thread: Optional[threading.Thread] = None
    # obs seam: recovery events mirror into driver-side counters
    # (cluster.detected_dead / relaunched / recovered / gave_up /
    # skipped_background) and each recovery records a span, when a
    # registry/recorder is active in this process
    self._obs_reg = obs_metrics.active()
    self._obs_rec = obs_spans.active()

  def _event(self, kind: str, **fields) -> None:
    self.events.append(dict(fields, kind=kind, t=time.monotonic()))
    if self._obs_reg is not None:
      self._obs_reg.counter("cluster." + kind.replace("-", "_")).inc()
    if self._obs_rec is not None:
      self._obs_rec.event("cluster." + kind,
                          **{k: v for k, v in fields.items()
                             if isinstance(v, (int, float, str, bool))})

  def _group_of(self, eid: int):
    """The training group this executor hosts (cluster_meta
    ``group_map``), or None for an ungrouped cluster. Keys may be str or
    int (the map may have round-tripped through JSON)."""
    gm = self.cluster_meta.get("group_map") or {}
    g = gm.get(eid, gm.get(str(eid)))
    return int(g) if g is not None else None

  # -- lifecycle -------------------------------------------------------------

  def start(self) -> "ClusterSupervisor":
    self._thread = threading.Thread(target=self._loop, daemon=True,
                                    name="cluster-supervisor")
    self._thread.start()
    return self

  def stop(self) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=30)

  def wait_idle(self, timeout: float = 60.0) -> bool:
    """Block until no recovery is in flight AND no failure is pending
    detection right now; True if idle within ``timeout``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
      if self._idle.is_set() and not self._failed_executors():
        return True
      time.sleep(0.05)
    return False

  # -- detection -------------------------------------------------------------

  def _failed_executors(self) -> List[int]:
    if self.server.done.is_set():
      # the rendezvous server stopped serving: beats — including goodbyes
      # — can no longer arrive, so silence is not death
      return []
    failed = set(self.server.liveness.dead())
    for task_id, err in enumerate(self.node_job.errors):
      if is_executor_lost(err):
        for eid, t in self._eid_task.items():
          if t == task_id:
            failed.add(eid)
    return sorted(e for e in failed
                  if e in self._eid_task and e not in self._given_up)

  def _loop(self) -> None:
    interval = self.cluster_meta.get("heartbeat_interval") or 5.0
    poll = max(0.05, min(1.0, interval / 4.0))
    while not self._stop.wait(poll):
      if self.server.done.is_set():
        continue
      for eid in self._failed_executors():
        if self._stop.is_set():
          return
        self._idle.clear()
        try:
          if self._obs_rec is not None:
            with self._obs_rec.span("cluster.recover", executor_id=eid):
              self._recover(eid)
          else:
            self._recover(eid)
        except Exception:  # noqa: BLE001 - supervisor must survive anything
          logger.exception("recovery of executor %d failed", eid)
        finally:
          self._idle.set()

  # -- recovery --------------------------------------------------------------

  def _recover(self, eid: int) -> None:
    attempt = self._attempts.get(eid, 0)
    group = self._group_of(eid)
    self._event("detected-dead", executor_id=eid, attempt=attempt,
                group=group)
    try:
      job_name, _ = node_mod._role_of(eid,
                                      self.cluster_meta["cluster_template"])
    except ValueError:
      job_name = "worker"
    if job_name in node_mod.BACKGROUND_ROLES:
      # ps/evaluator bring-up tasks park on the hub control queue for the
      # cluster's whole life — a pinned relaunch could never schedule
      # behind the (healthy) foreground owner. Surface the death instead.
      self._given_up.add(eid)
      msg = ("%s node on executor %d died (background-role nodes are not "
             "relaunched; failure will surface at shutdown)"
             % (job_name, eid))
      logger.error(msg)
      self._event("skipped-background", executor_id=eid, group=group)
      if self.tf_status.get("error") is None:
        self.tf_status["error"] = msg
      return
    if attempt >= self.max_restarts:
      self._given_up.add(eid)
      if group is not None and self.cluster_meta.get("elastic"):
        # elastic: a grouped executor past its restart budget is a
        # resize, not a job failure; the surviving groups stop waiting
        # for it (parallel.groups)
        self._commit_shrink(eid, group, attempt)
        return
      msg = ("executor %d declared dead after %d restart attempt(s); "
             "restart budget (max_restarts=%d) exhausted"
             % (eid, attempt, self.max_restarts))
      logger.error(msg)
      self._event("gave-up", executor_id=eid, attempts=attempt, group=group)
      if self.tf_status.get("error") is None:
        self.tf_status["error"] = msg
      return
    self._attempts[eid] = attempt + 1
    self.server.liveness.mark_restarting(eid)
    # exponential backoff with full jitter, hard-capped
    delay = min(self.backoff_cap, self.backoff * (2 ** attempt))
    delay *= 0.5 + random.random()
    if self._stop.wait(min(delay, self.backoff_cap)):
      return

    old_meta = next((n for n in self.cluster_info
                     if n["executor_id"] == eid), None)
    pending = self._quarantine_dead_hub(old_meta)

    task_id = self._eid_task[eid]
    if not self.node_job._completed[task_id]:
      # the node task never finished — a hung user fn (liveness-dead but
      # process alive) would keep its executor busy forever; kill the
      # executor so the engine fails the attempt and recycles the slot
      if self.engine.preempt_task(self.node_job, task_id):
        deadline = time.monotonic() + 10
        while not self.node_job._completed[task_id] \
            and time.monotonic() < deadline and not self._stop.is_set():
          time.sleep(0.05)
    logger.warning("relaunching node on executor %d (attempt %d/%d, %d feed "
                   "row(s) requeued)", eid, attempt + 1, self.max_restarts,
                   sum(map(len, pending.values())))
    self.engine.relaunch_task(self.node_job, task_id,
                              payload={"executor_id": eid,
                                       "restart": attempt + 1})
    # re-arm the startup grace from the relaunch instant, so a stale beat
    # of the old incarnation cannot re-declare death mid-bring-up
    self.server.liveness.rearm(eid)
    self._event("relaunched", executor_id=eid, attempt=attempt + 1,
                backoff_s=round(delay, 3), group=group)

    if self._await_reregistration(eid, attempt + 1):
      self.restarts[eid] = attempt + 1
      self._event("recovered", executor_id=eid, attempt=attempt + 1,
                  group=group)
    else:
      # liveness/ExecutorLost will re-fire and consume another attempt,
      # or the task error (a non-restartable bring-up failure) propagates
      logger.warning("executor %d did not re-register after relaunch", eid)
    if pending:
      # refeed regardless of the relaunch outcome: the rescued rows go to
      # whichever LIVE worker picks up the feed task
      self._refeed(pending)

  def _commit_shrink(self, eid: int, group: int, attempts: int) -> None:
    """Elastic resize, shrink: evict the dead executor's group from the
    sync plane, so rounds never wait for it and its stale contributions
    are rejected; the survivors train on with the denominator reduced.
    Only an empty group set is fatal."""
    plane = getattr(self.server, "sync_plane", None)
    active = None
    self.shrunk.add(eid)
    self._stop_dead_hub(next((n for n in self.cluster_info
                              if n["executor_id"] == eid), None))
    if plane is not None:
      plane.mark_lost(group, "executor %d dead past restart budget "
                      "(%d attempt(s))" % (eid, attempts))
      active = plane.status()["groups_active"]
    logger.error("executor %d (group %d) declared dead after %d restart "
                 "attempt(s); committing the shrink: %s group(s) remain",
                 eid, group, attempts, active)
    self._event("resize-shrink", executor_id=eid, group=group,
                attempts=attempts, groups_active=active)
    if active == 0 and self.tf_status.get("error") is None:
      self.tf_status["error"] = (
          "all training groups lost (last: group %d on executor %d)"
          % (group, eid))

  def _stop_dead_hub(self, old_meta: Optional[dict]) -> None:
    """Hard-stop the hub manager a SIGKILLed node left behind: no
    relaunch will reclaim it after a shrink, and an orphan keeps this
    driver's multiprocessing resource tracker from exiting. Best-effort:
    an unreachable hub died with its node."""
    if old_meta is None:
      return
    try:
      feedhub.connect(tuple(old_meta["hub_addr"]),
                      self.cluster_meta["authkey"]).force_exit()
    except Exception:  # noqa: BLE001 - hub died with the node
      pass

  def readmit(self, eid: int) -> None:
    """Elastic resize, grow: the executor's capacity came back after the
    supervisor gave up on it. Its restart budget resets and liveness
    re-arms the startup grace, so the rebooting node is not declared
    dead again mid-bring-up; its group re-joins the sync plane itself
    (``GroupSyncClient.join`` pulls the catch-up weights)."""
    self._given_up.discard(eid)
    self._attempts.pop(eid, None)
    self.shrunk.discard(eid)
    self.server.liveness.rearm(eid)
    self._event("resize-readmit", executor_id=eid,
                group=self._group_of(eid))

  def _quarantine_dead_hub(self, old_meta: Optional[dict]) -> Dict[str, List]:
    """Mark the dead node's hub unusable and rescue undelivered feed rows.

    The hub manager is a separate process and routinely survives its
    node's death; marking it ``dead`` makes the relaunched node's reclaim
    check (node.py) treat it as stale, and the drain (InputMode.SPARK)
    releases feeders blocked on ``queue.join``. Returns the rescued rows
    by queue name. Best-effort: an unreachable hub just died with its
    node. Rows already on a shared-memory ring are not rescued: the ring
    is at-most-once (only the hub queues are drained).
    """
    if old_meta is None:
      return {}
    try:
      hub = feedhub.connect(tuple(old_meta["hub_addr"]),
                            self.cluster_meta["authkey"])
      hub.set("state", "dead")
    except Exception:  # noqa: BLE001 - hub died with the node
      return {}
    pending: Dict[str, List] = {}
    if self.cluster_meta.get("input_mode") == InputMode.ENGINE:
      from tensorflowonspark_tpu_torch.datafeed import drain_pending_rows
      # inference feeds need their EndPartition markers kept in stream
      # order across the refeed, or per-partition result alignment is lost
      # (Cluster.inference stamps feed_kind on the shared meta)
      keep_markers = self.cluster_meta.get("feed_kind") == "inference"
      # every DATA queue, not just the default: train/inference accept a
      # custom qname
      for qname in self.cluster_meta.get("queues", ("input",)):
        if qname in ("error", "output", "control"):
          continue
        try:
          rows = drain_pending_rows(hub, qname, keep_markers=keep_markers)
        except Exception:  # noqa: BLE001 - manager vanished mid-drain
          logger.warning("draining queue %r of executor %d's dead hub "
                         "failed", qname, old_meta["executor_id"])
          continue
        if rows:
          pending[qname] = rows
    return pending

  def _refeed(self, pending: Dict[str, List]) -> None:
    """Requeue rescued feed rows through the engine feed path: one feed
    task per drained queue, back into the SAME qname, landing on whichever
    live worker picks the task up (at-least-once delivery for rows the
    dead worker never processed)."""
    for qname, rows in pending.items():
      fn = node_mod.TrainFeeder(self.cluster_info, self.cluster_meta,
                                qname=qname)
      try:
        self.engine.foreach_partition([rows], fn).wait(timeout=120)
        logger.info("requeued %d feed row(s) into %r from the dead node",
                    len(rows), qname)
      except Exception as e:  # noqa: BLE001 - best-effort; loss is logged
        logger.error("requeueing %d rescued feed row(s) into %r failed: %s",
                     len(rows), qname, e)

  def _await_reregistration(self, eid: int, generation: int,
                            timeout: float = 120.0) -> bool:
    """Poll the reservation table until the relaunched node registered its
    restart ``generation``; patch cluster_info in place on success."""
    deadline = time.monotonic() + min(
        timeout, self.cluster_meta.get("reservation_timeout", timeout))
    while time.monotonic() < deadline and not self._stop.is_set():
      for n in self.server.reservations.get():
        if n["executor_id"] == eid and n.get("restart") == generation:
          for meta in self.cluster_info:
            if meta["executor_id"] == eid:
              meta.update(n)
          return True
      # a relaunch that failed bring-up for an application reason (not an
      # executor loss) will never register — stop waiting and let the
      # task error propagate
      err = self.node_job.errors[self._eid_task[eid]]
      if err is not None and not is_executor_lost(err):
        return False
      time.sleep(0.05)
    return False


def _driver_obs_log(recorder=None):
  """The driver's per-process obs JSONL (anchored by the recorder's
  clock when one is live) — shared between the detector's per-alert
  appends and the shutdown span/metrics dump."""
  from tensorflowonspark_tpu_torch.obs import export as obs_export
  return obs_export.ProcessLog(
      label="driver", executor_id=0,
      clock=recorder.clock if recorder is not None else None)


class InputMode(object):
  """How the cluster gets training data (parity: TFCluster.py:43-46).

  ``FILES`` (alias ``TENSORFLOW``): each node reads its own data shard
  (TFRecord or other files from local disk); the engine only holds the
  executor slots.

  ``ENGINE`` (alias ``SPARK``): the engine pushes partitioned rows into each
  node's feed hub (or its shared-memory ring), consumed by the user fn
  through ``ctx.get_data_feed()``.
  """
  FILES = 0
  TENSORFLOW = 0
  ENGINE = 1
  SPARK = 1


class _StreamFeedHandle(object):
  """Progress of a hooked (D)Stream feed: micro-batches fed + stop flag."""

  def __init__(self):
    self.rounds = 0
    self.stopped = False


class Cluster(object):
  """Handle for a started cluster (the JAX package's ``TPUCluster``;
  parity: TFCluster.py:49-212)."""

  def __init__(self, engine: Engine, cluster_info: List[dict],
               cluster_meta: dict, server: rendezvous.Server,
               input_mode: int, node_job, tf_status: dict,
               driver_ps_procs: Sequence = (), supervisor=None,
               detector=None):
    self.engine = engine
    self.cluster_info = cluster_info
    self.cluster_meta = cluster_meta
    self.server = server
    self.input_mode = input_mode
    self.node_job = node_job
    self.tf_status = tf_status
    self.queues = cluster_meta["queues"]
    self.driver_ps_procs = list(driver_ps_procs)
    self.supervisor = supervisor
    #: the driver-side obs aggregation (obs.collector.ObsSink) when the
    #: obs plane is on (TOS_OBS=1) — executors ship metric/span deltas
    #: here through the rendezvous OBS verb; None when off. getattr:
    #: tests hand in stand-in servers without the field
    self.obs_sink = getattr(server, "obs_sink", None)
    #: the driver-side detector loop (obs.anomaly.AnomalyDetector)
    #: evaluating the sink online; None when the plane (or the detector,
    #: TOS_OBS_DETECT=0) is off
    self.detector = detector

  def alerts(self, max_items: int = 64) -> List[dict]:
    """Newest-first structured alerts from the online detector loop
    (empty when the obs plane / detector is off)."""
    if self.detector is None:
      return []
    return self.detector.recent_alerts(max_items)

  def obs_summary(self) -> dict:
    """The in-process equivalent of the HEALTH verb's obs payload:
    liveness snapshot + per-executor metric state + live alerts + SLO
    and deploy status."""
    out = {"data": {str(k): v for k, v in
                    self.server.liveness.snapshot().items()}}
    if self.obs_sink is not None:
      out["obs"] = self.obs_sink.top_summary()
    if self.detector is not None:
      out["alerts"] = self.detector.recent_alerts()
      for key in ("slo", "deploy"):
        status = getattr(self.detector, key + "_status")()
        if status is not None:
          out[key] = status
    return out

  def slo_status(self) -> Optional[dict]:
    """Live SLO burn-rate verdicts (``obs.slo``; None when the obs
    plane/detector is off or no objectives are declared)."""
    if self.detector is None:
      return None
    return self.detector.slo_status()

  def deploy_status(self) -> Optional[dict]:
    """Continuous-deployment state as the detector samples it (None
    when the obs plane/detector is off or nothing shipped ``deploy.*``)."""
    if self.detector is None:
      return None
    return self.detector.deploy_status()

  @staticmethod
  def span(name: str, **attrs):
    """Driver-side span, or a null context when the obs plane is off."""
    rec = obs_spans.active()
    if rec is None:
      return contextlib.nullcontext()
    return rec.span(name, **attrs)

  # -- data plane ------------------------------------------------------------

  def _require_engine_mode(self, what: str) -> None:
    if self.input_mode != InputMode.ENGINE:
      raise RuntimeError("%s requires InputMode.ENGINE/SPARK (this cluster "
                         "runs InputMode.TENSORFLOW: each node reads its own "
                         "files)" % what)

  def train(self, data_partitions: Sequence, num_epochs: int = 0,
            feed_timeout: float = 600, qname: str = "input"):
    """Feed partitioned data to the cluster (InputMode.SPARK only).

    Epochs replicate the dataset ``num_epochs`` times (parity with
    epochs-via-RDD.union, TFCluster.py:90-94). Returns None for bounded
    data; a DStream argument (anything with ``foreachRDD``) returns the
    stream feed handle of :meth:`train_dstream`.
    """
    if hasattr(data_partitions, "foreachRDD"):
      # a Spark DStream handed straight to train(), as TensorFlowOnSpark
      # accepted (TFCluster.py:83-85)
      return self.train_dstream(data_partitions, feed_timeout=feed_timeout,
                                qname=qname)
    logger.info("feeding training data")
    self._require_engine_mode("train()")
    self.cluster_meta["feed_kind"] = "train"
    epochs = max(1, num_epochs)
    parts = self._wrap_lazy(data_partitions)
    fn = node_mod.TrainFeeder(self.cluster_info, self.cluster_meta,
                              feed_timeout=feed_timeout, qname=qname)
    if isinstance(parts, collections.abc.Iterator):
      # a one-shot partition stream cannot be replayed (replicating it
      # would drain the generator on the driver, feeding epoch 1 and
      # starving epochs 2..N): route it through the engine's lazy path,
      # one window of partitions in flight on the driver
      if epochs > 1:
        raise ValueError(
            "train(num_epochs=%d) got a one-shot partition iterator; "
            "re-iterable input (a list, an RDD, or lazy handles) is "
            "required to replay epochs" % epochs)
      stream = self.engine.map_partitions_lazy(parts, fn,
                                               timeout=feed_timeout)
      if isinstance(stream, collections.abc.Iterator):
        for _ in stream:
          pass
      else:
        # an RDD-like lazy result: trigger the feed with a row-free action
        stream.count()
      return
    parts = self._replicate(parts, epochs)
    with self.span("cluster.train_feed", epochs=epochs):
      self.engine.foreach_partition(parts, fn).wait()

  def train_stream(self, batch_stream, feed_timeout: float = 600,
                   qname: str = "input") -> int:
    """Feed an unbounded stream of partitioned datasets (micro-batches).

    The analog of TensorFlowOnSpark's Spark Streaming support
    (DStream.foreachRDD feeding, TFCluster.py:83-85): each item of
    ``batch_stream`` is a list of partitions fed as one round. A stop
    request (:meth:`request_stop`, or a remote
    ``rendezvous.Client(addr).request_stop()``) ends the loop after the
    current round. Returns the number of rounds fed.
    """
    self._require_engine_mode("train_stream()")
    rounds = 0
    for partitions in batch_stream:
      # feed first, check after: a batch already pulled from the source is
      # never discarded (sources may commit offsets on yield)
      self.train(partitions, num_epochs=1, feed_timeout=feed_timeout,
                 qname=qname)
      rounds += 1
      if self.server.stopping():
        logger.info("stop signal received; ending stream after %d rounds",
                    rounds)
        break
    return rounds

  def train_dstream(self, dstream, feed_timeout: float = 600,
                    qname: str = "input"):
    """Hook a Spark (D)Stream so every micro-batch RDD is fed as one round
    (parity: TFCluster.train wiring ``dataRDD.foreachRDD(_train)``,
    TFCluster.py:83-85).

    Feeding happens on the stream's driver thread as batches arrive. After
    a stop request (:meth:`request_stop` or the rendezvous STOP verb) later
    micro-batches are skipped without being consumed. Returns a handle
    whose ``rounds`` counts the micro-batches fed and whose ``stopped``
    reports whether the stop signal has been observed.
    """
    self._require_engine_mode("train_dstream()")
    self.cluster_meta["feed_kind"] = "train"
    fn = node_mod.TrainFeeder(self.cluster_info, self.cluster_meta,
                              feed_timeout=feed_timeout, qname=qname)
    handle = _StreamFeedHandle()

    def _feed(rdd):
      if self.server.stopping():
        if not handle.stopped:
          logger.info("stop signal received; skipping further micro-batches "
                      "after %d rounds", handle.rounds)
        handle.stopped = True
        return
      self.engine.foreach_partition(rdd, fn).wait()
      handle.rounds += 1

    dstream.foreachRDD(_feed)
    return handle

  def foreach_batch(self, feed_timeout: float = 600, qname: str = "input"):
    """A ``(batch_df, batch_id) -> None`` callback for Structured
    Streaming: ``df.writeStream.foreachBatch(cluster.foreach_batch())``.
    Each micro-batch is fed as one round; after a stop request batches are
    skipped."""
    self._require_engine_mode("foreach_batch()")
    self.cluster_meta["feed_kind"] = "train"
    fn = node_mod.TrainFeeder(self.cluster_info, self.cluster_meta,
                              feed_timeout=feed_timeout, qname=qname)

    def _feed(batch_df, batch_id):
      if self.server.stopping():
        return
      self.engine.foreach_partition(batch_df, fn).wait()

    return _feed

  def request_stop(self) -> None:
    """Signal streaming feeds to stop after the current round. Sets the
    server's stop-REQUESTED flag only: the rendezvous keeps serving until
    ``shutdown()`` stops it."""
    self.server.stop_requested.set()

  def inference(self, data_partitions: Sequence, feed_timeout: float = 600,
                qname: str = "input", collect: bool = True):
    """Feed data for inference (parity: TFCluster.inference,
    TFCluster.py:96-115); the results come back in partition order.

    With ``collect=True`` (default) results are gathered into a
    driver-side list. With ``collect=False`` the return value is the
    engine's lazy handle (LocalEngine: a generator holding at most one
    window of partitions), so large outputs never materialize on the
    driver.
    """
    logger.info("feeding inference data")
    self._require_engine_mode("inference()")
    # recovery drains must keep EndPartition markers for inference feeds
    # (ClusterSupervisor._quarantine_dead_hub reads this off the shared meta)
    self.cluster_meta["feed_kind"] = "inference"
    fn = node_mod.InferenceFeeder(self.cluster_info, self.cluster_meta,
                                  feed_timeout=feed_timeout, qname=qname)
    data_partitions = self._wrap_lazy(data_partitions)
    if collect:
      with self.span("cluster.inference_feed"):
        return self.engine.map_partitions(data_partitions, fn)
    return self.engine.map_partitions_lazy(data_partitions, fn,
                                           timeout=feed_timeout)

  @staticmethod
  def _wrap_lazy(parts):
    """Bare-callable partitions (lazy handles) become single-item
    partitions the feeders resolve executor-side
    (``node._materialize_partition``). Engine-native handles and row
    partitions pass through untouched."""
    if hasattr(parts, "mapPartitions") or hasattr(parts, "rdd") \
        or hasattr(parts, "foreachRDD"):
      return parts
    if isinstance(parts, collections.abc.Iterator):
      # a one-shot stream of partitions stays a stream: the driver pulls
      # one window at a time
      return ([p] if callable(p) else p for p in parts)
    # a re-iterable collection wraps eagerly (epochs re-iterate it)
    return [[p] if callable(p) else p for p in parts]

  @staticmethod
  def _replicate(parts: Sequence, epochs: int):
    """Repeat the dataset ``epochs`` times without touching its rows: an
    engine-native handle (an RDD, or a DataFrame wrapping one) by
    ``union`` (TFCluster.py:90-94), a driver-side partition list by
    concatenation."""
    if hasattr(parts, "rdd"):           # DataFrame → its RDD
      parts = parts.rdd
    if hasattr(parts, "mapPartitions"):  # RDD-like: epochs via union
      out = parts
      for _ in range(epochs - 1):
        out = out.union(parts)
      return out
    out = []
    for _ in range(epochs):
      out.extend(parts)
    return out

  @property
  def server_addr(self):
    """Rendezvous address: HEALTH queries, and the streaming stop signal
    (``rendezvous.Client(addr).request_stop()``), go here."""
    return self.server.addr

  # -- lifecycle -------------------------------------------------------------

  def shutdown(self, grace_secs: float = 0, timeout: int = 259200) -> None:
    """Stop the cluster; raise if any node failed.

    ``timeout`` arms a SIGALRM watchdog (3-day default) guarding against
    hung shutdowns (parity: TFCluster.py:117,136-144). ``grace_secs``: in
    InputMode.SPARK, how long each shutdown task waits after its node
    stopped.
    """
    in_main = threading.current_thread() is threading.main_thread()
    if timeout and in_main:
      def _watchdog(signum, frame):
        raise TimeoutError("cluster shutdown watchdog fired after %ds" % timeout)
      old = signal.signal(signal.SIGALRM, _watchdog)
      signal.alarm(int(timeout))
    try:
      with self.span("cluster.shutdown"):
        self._shutdown_inner(grace_secs)
    finally:
      if timeout and in_main:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
      # offline-log plane: the driver's own spans + metrics land in the
      # same per-process JSONL scheme the executors use, so one run
      # merges from one directory
      self._dump_driver_obs_log()

  def _dump_driver_obs_log(self) -> None:
    if not obs_metrics.enabled():
      return
    rec = obs_spans.active()
    reg = obs_metrics.active()
    # reuse the detector's log when one exists: same file, ONE meta header
    log = self.detector.jsonl if self.detector is not None \
        and self.detector.jsonl is not None else _driver_obs_log(rec)
    if rec is not None:
      log.append_spans(rec.drain(None))
    log.close(metrics_snapshot=reg.snapshot() if reg is not None else None)

  def _shutdown_inner(self, grace_secs: float) -> None:
    workers = [n for n in self.cluster_info
               if n["job_name"] in node_mod.GROUP_ROLES]
    background = [n for n in self.cluster_info
                  if n["job_name"] in node_mod.BACKGROUND_ROLES]

    if self.input_mode == InputMode.ENGINE:
      # push end-of-feed markers through a shutdown job on free (worker)
      # executors (parity: TFCluster.py:174-176); it also reaps the
      # chief's TensorBoard and raises a node's late error
      fn = node_mod.ShutdownTask(
          self.cluster_info, self.cluster_meta, grace_secs=grace_secs,
          queues=[q for q in self.queues if q not in ("error", "output",
                                                      "control")])
      self.engine.foreach_partition([[n["executor_id"]] for n in workers],
                                    fn).wait()
    elif any(n.get("tb_url") for n in self.cluster_info):
      # InputMode.TENSORFLOW has no shutdown job: reap the TensorBoard the
      # chief spawned. One PINNED task per executor slot (shared-queue
      # tasks could all land on one free executor and miss the chief's),
      # each best-effort so a dead node can't abort the rest of shutdown.
      fn = node_mod.make_tb_kill_fn(self.cluster_info, self.cluster_meta)
      try:
        self.engine.run_on_executors(
            fn, num_tasks=self.engine.num_executors).wait(
                raise_on_error=False)
      except Exception as e:  # noqa: BLE001 - reap is best-effort
        logger.warning("tensorboard reap job failed: %s", e)

    # stop ps/evaluator nodes by reaching their remote hubs directly
    # (parity: TFCluster.py:186-194)
    for n in background:
      try:
        hub = feedhub.connect(tuple(n["hub_addr"]),
                              self.cluster_meta["authkey"])
        hub.get_queue("control").put(None, block=True, timeout=30)
      except Exception as e:  # noqa: BLE001 - best-effort stop of sidecars
        logger.warning("failed to stop %s:%d: %s", n["job_name"],
                       n["task_index"], e)

    # driver-hosted ps processes exit once their control queue gets None
    for p in self.driver_ps_procs:
      p.join(timeout=60)
      if p.is_alive():
        logger.warning("driver ps process %s did not exit; terminating",
                       p.name)
        p.terminate()

    # wait for the node bring-up job itself (foreground workers return when
    # the user fn finishes); propagate node errors. The supervisor stays
    # live until the job settles: a node death racing shutdown un-completes
    # the job while its recovery runs, so drain recoveries (budget-bounded)
    # and re-wait until the job is stably done, THEN stand the supervisor
    # down before errors are read.
    self.node_job.wait(raise_on_error=False)
    if self.supervisor is not None:
      while True:
        if not self.supervisor.wait_idle(timeout=120):
          if self.tf_status.get("error") is None:
            self.tf_status["error"] = (
                "shutdown proceeded while a node recovery was still in "
                "flight (supervisor busy past the drain budget)")
          break
        if self.node_job.done():
          break
        self.node_job.wait(raise_on_error=False)
      self.supervisor.stop()
    if self.detector is not None:
      # stand the loop down FIRST (stop joins the thread), then one last
      # pass so late-arriving deltas (executors final-flush on exit) are
      # evaluated — the other order races the thread's own poll
      self.detector.stop()
      self.detector.poll()
    self.server.stop()
    err = self._node_error() or self.tf_status.get("error")
    if err:
      raise RuntimeError("cluster shutdown with node error:\n%s" % err)
    logger.info("cluster shutdown complete")

  def _node_error(self) -> Optional[str]:
    """The first node task's error, past the lost task of an executor
    whose group's shrink the supervisor committed: that loss is an
    elastic resize, not a failure of the job."""
    skip = set()
    if self.supervisor is not None:
      skip = {self.supervisor._eid_task[e] for e in self.supervisor.shrunk}
    for task_id, e in enumerate(self.node_job.errors):
      if e is not None and not (task_id in skip and is_executor_lost(e)):
        return e
    return None

  def tensorboard_url(self) -> Optional[str]:
    """URL of the TensorBoard server, if one was launched (parity:
    TFCluster.tensorboard_url, TFCluster.py:207-212)."""
    for n in self.cluster_info:
      if n.get("tb_url"):
        return n["tb_url"]
    return None


def _refuse_unported(feed_segment) -> None:
  """Raise, naming the ROADMAP item, for what the port cannot run yet."""
  if feed_segment is not None:
    raise NotImplementedError(
        "feed_segment: feeder pushdown segments (data.datapipe) are not "
        "ported to PyTorch yet (ROADMAP Queue 1 item 11)")


def run(engine: Engine, main_fn, tf_args=None,
        num_executors: Optional[int] = None, num_ps: int = 0,
        tensorboard: bool = False, input_mode: int = InputMode.FILES,
        log_dir: Optional[str] = None, driver_ps_nodes: bool = False,
        master_node: Optional[str] = None,
        reservation_timeout: float = 600,
        queues: Sequence[str] = ("input", "output", "error", "control"),
        eval_node: bool = False, release_port: bool = True,
        chips_per_node: int = 0, qmax: int = 1024,
        feed_transport: str = "auto", feed_chunk_size: int = 256,
        shm_capacity: int = 64 * 1024 * 1024,
        heartbeat_interval: Optional[float] = 5.0,
        supervise: bool = True, max_restarts: int = 2,
        restart_backoff: float = 0.5,
        restart_backoff_cap: float = 5.0,
        train_unroll: Optional[int] = None,
        group_map: Optional[Dict[int, int]] = None,
        elastic: bool = False,
        feed_segment=None,
        feed_target_bytes: Optional[int] = None) -> Cluster:
  """Start a cluster and run ``main_fn(tf_args, ctx)`` on every node.

  Signature parity with TensorFlowOnSpark's ``TFCluster.run``
  (TFCluster.py:215-245), with the engine abstraction in place of a
  SparkContext. ``chips_per_node=k`` gives each node ``k`` CUDA cards of
  its host (``CUDA_VISIBLE_DEVICES``, counted by ``nvidia-smi``); a host
  with too few cards fails bring-up with the count in the message.
  ``driver_ps_nodes`` hosts the ps nodes on the driver machine (parity
  :229,298-316).

  InputMode.SPARK: each node runs ``main_fn`` in a background process and
  reads what :meth:`Cluster.train` / :meth:`Cluster.inference` feed
  through ``ctx.get_data_feed()``. ``feed_transport``: ``"shm"`` carries a
  node's input on a shared-memory ring (:mod:`.control.shmring`; feeder
  and node on one host), ``"queue"`` on the hub's manager queues, and
  ``"auto"`` picks ``"shm"`` on engines whose executors share the
  driver's host (LocalEngine). A ring that cannot be built fails bring-up
  with the compiler's message; there is no fallback to the queue. Rows
  travel in chunks of ``feed_chunk_size`` (or sized to
  ``feed_target_bytes`` a chunk), at most ``qmax`` rows waiting in a hub
  queue, ``shm_capacity`` bytes in a ring (8 MiB at least).

  ``main_fn`` travels to the executors by the standard ``pickle``, so it
  must be a module-level function of an importable module or of the
  driver's ``__main__`` script; a lambda or a closure raises ``TypeError``
  here. A ``tf_args`` list replaces ``sys.argv`` in each node.

  Fault tolerance: every node heartbeats the rendezvous server every
  ``heartbeat_interval`` seconds (None disables); a node silent for 2
  intervals is declared dead. With ``supervise=True`` a driver-side
  :class:`ClusterSupervisor` relaunches dead nodes (executor killed or
  crashed — NOT application exceptions, which propagate as always) up to
  ``max_restarts`` times per executor; ``max_restarts=0`` fails the
  cluster on the first death. ``train_unroll=K`` exports
  ``TOS_TRAIN_UNROLL=K`` into every node (``parallel.sharding``).

  ``group_map={executor_id: group_id}`` declares elastic multi-group
  training (``parallel.groups``): the rendezvous server carries a
  :class:`~parallel.groups.SyncPlane` (the SYNC/SYNCQ/GROUP verbs, and
  ``groups`` in HEALTH replies) and the supervisor's events carry the
  group. With ``elastic=True`` a grouped executor that exhausts its
  restart budget commits a shrink (the surviving groups keep stepping
  with the sync denominator reduced) instead of failing the job; only
  losing every group is fatal. ``ClusterSupervisor.readmit`` re-opens
  the budget when the capacity returns.
  """
  _refuse_unported(feed_segment)
  num_executors = num_executors or engine.num_executors
  if train_unroll is not None and int(train_unroll) < 1:
    raise ValueError("train_unroll must be >= 1, got %r" % (train_unroll,))
  if feed_target_bytes is not None and int(feed_target_bytes) < 0:
    raise ValueError("feed_target_bytes must be >= 0, got %r"
                     % (feed_target_bytes,))
  if feed_transport == "auto":
    # a shared-memory ring needs the feeder task and the node on one host,
    # which only engines with colocated executors guarantee
    feed_transport = "shm" if getattr(engine, "colocated_executors", False) \
        else "queue"
  if feed_transport not in ("shm", "queue"):
    raise ValueError("feed_transport must be 'auto', 'shm' or 'queue', got "
                     "%r" % (feed_transport,))
  if driver_ps_nodes and input_mode != InputMode.FILES:
    raise ValueError("driver_ps_nodes requires InputMode.FILES/TENSORFLOW "
                     "(parity with TensorFlowOnSpark)")
  engine_nodes = num_executors - (num_ps if driver_ps_nodes else 0)
  if engine_nodes > engine.num_executors:
    raise ValueError("cluster of %d nodes needs %d executors but engine has %d"
                     % (num_executors, engine_nodes, engine.num_executors))

  # role template (parity: TFCluster.py:256-271): ps nodes first, then
  # master/chief, evaluator, workers
  num_master = 1 if master_node else 0
  num_eval = 1 if eval_node else 0
  num_workers = max(num_executors - num_ps - num_eval - num_master, 0)
  if num_ps + num_master + num_eval + num_workers != num_executors:
    raise ValueError("cluster requires %d nodes but %d executors reserved"
                     % (num_ps + num_master + num_eval + num_workers,
                        num_executors))
  if num_master + num_workers == 0:
    raise ValueError("cluster requires at least one worker or master/chief "
                     "node")
  if num_ps > 0:
    logger.warning("num_ps=%d: parameter servers are API-compatible; ps "
                   "nodes run as background sidecars", num_ps)

  executors = list(range(num_executors))
  cluster_template: Dict[str, List[int]] = {}
  idx = 0
  if num_ps:
    cluster_template["ps"] = executors[idx:idx + num_ps]
    idx += num_ps
  if num_master:
    cluster_template[master_node] = executors[idx:idx + 1]
    idx += 1
  if num_eval:
    cluster_template["evaluator"] = executors[idx:idx + 1]
    idx += 1
  if num_workers:
    cluster_template["worker"] = executors[idx:]
  logger.info("cluster template: %s", cluster_template)

  cluster_meta = {
      "id": random.getrandbits(64),
      "cluster_template": cluster_template,
      "num_executors": num_executors,
      "authkey": os.urandom(16),
      "queues": list(queues),
      "input_mode": input_mode,
      "default_fs": engine.default_fs(),
      "reservation_timeout": reservation_timeout,
      "tensorboard": tensorboard,
      "log_dir": log_dir,
      "release_port": release_port,
      "chips_per_node": chips_per_node,
      "qmax": qmax,
      # "queue" (manager-proxy, works everywhere) or "shm" (shared-memory
      # ring for the input stream, one per node); "auto" resolved above
      "feed_transport": feed_transport,
      # rows per feed chunk: one codec envelope / ring payload per chunk,
      # the transport unit AND the columnar assembly granularity
      "feed_chunk_size": feed_chunk_size,
      "shm_capacity": max(shm_capacity, 8 * 1024 * 1024),
      "heartbeat_interval": heartbeat_interval,
      # fused train loop default: every node exports this as
      # TOS_TRAIN_UNROLL (node._apply_node_env)
      "train_unroll": int(train_unroll) if train_unroll else None,
      # the feeders' adaptive per-envelope byte budget (None/0 = the fixed
      # feed_chunk_size row count)
      "feed_target_bytes": (int(feed_target_bytes)
                            if feed_target_bytes else None),
      # elastic multi-group training (parallel.groups): executor -> group
      # id, and whether a group past its restart budget shrinks the group
      # set instead of failing the job
      "group_map": ({int(k): int(v) for k, v in group_map.items()}
                    if group_map else None),
      "elastic": bool(elastic),
  }
  # the main fn must pickle by name: refuse a lambda or closure before the
  # server starts or any executor is touched
  main_bytes = node_mod._check_main_fn(main_fn)

  # startup grace = the reservation window: a node is allowed to sit
  # between REG and its first own beat for as long as cluster assembly may
  # legitimately take (executor deaths in that window are still caught by
  # the engine's ExecutorLost signal)
  server = rendezvous.Server(num_executors,
                             heartbeat_interval=heartbeat_interval,
                             startup_grace=reservation_timeout)
  if obs_metrics.enabled():
    # the driver end of the obs plane: executors ship metric/span deltas
    # through the rendezvous OBS verb into this bounded sink
    from tensorflowonspark_tpu_torch.obs import collector as obs_collector
    server.obs_sink = obs_collector.ObsSink()
  if group_map or elastic:
    # the driver end of the elastic-training plane: groups exchange
    # weights through the SYNC verbs, HEALTH replies carry the topology
    from tensorflowonspark_tpu_torch.parallel import groups as groups_mod
    groups_mod.attach_sync_plane(server)
  server_addr = server.start()
  cluster_meta["server_addr"] = list(server_addr)

  # launch node bring-up asynchronously so that reservation failures
  # surface through tf_status (parity :318-336)
  tf_status: Dict[str, Optional[str]] = {"error": None}
  node_fn = node_mod.NodeTask(main_bytes, tf_args, cluster_meta)

  driver_ps_procs = []
  if driver_ps_nodes and num_ps:
    # ps nodes run on the driver machine in their own processes/workdirs
    import multiprocessing as mp
    import tempfile
    mapfn_bytes = pickle.dumps(node_fn)
    ctx_mp = mp.get_context("spawn")
    for ps_id in cluster_template["ps"]:
      wd = tempfile.mkdtemp(prefix="tos_driver_ps_%d_" % ps_id)
      p = ctx_mp.Process(target=node_mod.driver_node_main,
                         args=(mapfn_bytes, ps_id, wd),
                         name="driver-ps-%d" % ps_id)
      p.start()
      driver_ps_procs.append(p)
    engine_ids = [i for i in executors if i not in cluster_template["ps"]]
  else:
    engine_ids = executors

  try:
    node_job = engine.run_on_executors(node_fn, num_tasks=len(engine_ids),
                                       task_payloads=engine_ids)
  except BaseException:
    server.stop()              # no node will ever reach it
    for p in driver_ps_procs:
      p.terminate()
    raise

  def _watch_job():
    # poll: a single failed bring-up task must surface its traceback
    # immediately (aborting await_reservations), not after the surviving
    # tasks run out their reservation timeout; driver-hosted ps processes
    # get the same treatment. Executor-death errors (the ExecutorLost
    # marker) belong to the supervisor when one is running.
    while not node_job.done():
      err = node_job.first_error()
      if supervise and is_executor_lost(err):
        err = None
      for p in driver_ps_procs:
        if p.exitcode not in (None, 0):
          err = err or ("driver ps process %s exited with code %s during "
                        "bring-up" % (p.name, p.exitcode))
      if err:
        tf_status["error"] = err
        return
      time.sleep(0.25)
    err = node_job.first_error()
    if err and not (supervise and is_executor_lost(err)):
      tf_status["error"] = err

  threading.Thread(target=_watch_job, daemon=True,
                   name="node-job-watcher").start()

  # the supervisor starts BEFORE the reservation wait so executors dying
  # during bring-up are already relaunched (cluster_info is patched in
  # place as nodes register); only engine-hosted nodes are supervised
  cluster_info: List[dict] = []
  supervisor = None
  if supervise:
    supervisor = ClusterSupervisor(
        engine, server, node_job, cluster_meta, cluster_info, engine_ids,
        tf_status, max_restarts=max_restarts, backoff=restart_backoff,
        backoff_cap=restart_backoff_cap).start()

  # the online consumer of the obs plane: a driver thread evaluating the
  # sink's rolling windows (stragglers, feed stalls, recompile storms,
  # serving saturation, memory slope, SLO burn). Alerts are counted +
  # mirrored into the supervisor event stream + JSONL'd + served over
  # HEALTH — never raised. Starts before the reservation wait so
  # bring-up is covered.
  detector = None
  if server.obs_sink is not None:
    from tensorflowonspark_tpu_torch.obs import anomaly as obs_anomaly
    if obs_anomaly.detect_enabled():
      # ONE driver ProcessLog, shared with the shutdown span/metrics dump
      detector = obs_anomaly.AnomalyDetector(
          server.obs_sink, supervisor=supervisor,
          jsonl=_driver_obs_log(obs_spans.active())).start()
      server.alert_source = detector

  def _abort_cleanup():
    if supervisor is not None:
      supervisor.stop()
    if detector is not None:
      detector.stop()
    server.stop()
    for p in driver_ps_procs:
      p.terminate()

  try:
    with Cluster.span("cluster.assemble", nodes=num_executors):
      cluster_info.extend(server.await_reservations(
          timeout=reservation_timeout, status=tf_status))
  except Exception:
    _abort_cleanup()
    raise

  # duplicate-node sanity check (parity: TFCluster.py:357-372)
  if server.reservations.duplicates:
    _abort_cleanup()
    raise RuntimeError(
        "duplicate node reservations detected (reused executors?): %r"
        % server.reservations.duplicates)

  logger.info("cluster of %d node(s) reserved: %s", len(cluster_info),
              [(n["executor_id"], n["job_name"], n["task_index"])
               for n in cluster_info])
  return Cluster(engine, cluster_info, cluster_meta, server, input_mode,
                 node_job, tf_status, driver_ps_procs=driver_ps_procs,
                 supervisor=supervisor, detector=detector)
