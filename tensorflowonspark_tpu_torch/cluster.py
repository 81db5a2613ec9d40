"""L3' cluster lifecycle API, FILES input mode: reserve → launch → shutdown.

The port's copy of ``tensorflowonspark_tpu/cluster.py`` (TensorFlowOnSpark's
``TFCluster.py``), generalized over the engine abstraction and targeted at
PyTorch on CUDA cards:

- ``run()`` builds the role template mapping job names → executor ids
  (TFCluster.py:256-271), starts the rendezvous server (:283-285), launches
  the node bring-up job asynchronously (:318-336), awaits and validates
  reservations with duplicate detection (:357-372);
- ``shutdown()`` reaps the chief's TensorBoard, remotely stops ps/evaluator
  nodes through their driver-reachable hubs (:186-194), enforces a watchdog
  timeout (default 3 days, :136-144) and raises if any node failed
  (:179-183).

::

    c = cluster.run(LocalEngine(num_executors=1), main_fn, tf_args,
                    input_mode=InputMode.TENSORFLOW, chips_per_node=1)
    c.shutdown()

Not ported yet, each refused by name before any executor is touched: the
engine feed plane (``InputMode.ENGINE`` and ``train``, ``inference``,
``train_stream``, ``train_dstream``, ``foreach_batch``: ROADMAP Queue 1
item 14), the observability plane (``TOS_OBS=1``: item 7), elastic groups
(``group_map``, ``elastic``: item 10) and feeder pushdown segments
(``feed_segment``: item 11).
"""

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

_FEED_PLANE = ("%s needs the engine feed plane (InputMode.ENGINE / SPARK), "
               "which is not ported to PyTorch yet (ROADMAP Queue 1 item 14); "
               "use InputMode.TENSORFLOW, where each node reads its own files")


class ClusterSupervisor(object):
  """Driver-side node babysitter: detect dead nodes, relaunch them.

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
  2. mark the dead node's hub ``dead`` so the relaunched node reclaims it;
  3. relaunch the node task via ``Engine.relaunch_task``, handing the
     restart count to the new node (→ ``ctx.restart_count``);
  4. await re-registration and patch ``cluster_info`` in place.

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
    self._event("detected-dead", executor_id=eid, attempt=attempt)
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
      self._event("skipped-background", executor_id=eid)
      if self.tf_status.get("error") is None:
        self.tf_status["error"] = msg
      return
    if attempt >= self.max_restarts:
      self._given_up.add(eid)
      msg = ("executor %d declared dead after %d restart attempt(s); "
             "restart budget (max_restarts=%d) exhausted"
             % (eid, attempt, self.max_restarts))
      logger.error(msg)
      self._event("gave-up", executor_id=eid, attempts=attempt)
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
    self._quarantine_dead_hub(old_meta)

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
    logger.warning("relaunching node on executor %d (attempt %d/%d)", eid,
                   attempt + 1, self.max_restarts)
    self.engine.relaunch_task(self.node_job, task_id,
                              payload={"executor_id": eid,
                                       "restart": attempt + 1})
    # re-arm the startup grace from the relaunch instant, so a stale beat
    # of the old incarnation cannot re-declare death mid-bring-up
    self.server.liveness.rearm(eid)
    self._event("relaunched", executor_id=eid, attempt=attempt + 1,
                backoff_s=round(delay, 3))

    if self._await_reregistration(eid, attempt + 1):
      self.restarts[eid] = attempt + 1
      self._event("recovered", executor_id=eid, attempt=attempt + 1)
    else:
      # liveness/ExecutorLost will re-fire and consume another attempt,
      # or the task error (a non-restartable bring-up failure) propagates
      logger.warning("executor %d did not re-register after relaunch", eid)

  def _quarantine_dead_hub(self, old_meta: Optional[dict]) -> None:
    """Mark the dead node's hub unusable, so the relaunched node's reclaim
    check (node.py) treats it as stale.

    The JAX package also drains the hub's undelivered feed rows here
    (``datafeed.drain_pending_rows``) and refeeds them. In FILES mode no
    rows are fed through the hub — each node reads its own files — so
    there is nothing to drain. Best-effort: an unreachable hub just died
    with its node.
    """
    if old_meta is None:
      return
    try:
      hub = feedhub.connect(tuple(old_meta["hub_addr"]),
                            self.cluster_meta["authkey"])
      hub.set("state", "dead")
    except Exception:  # noqa: BLE001 - hub died with the node
      return

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


class InputMode(object):
  """How the cluster gets training data (parity: TFCluster.py:43-46).

  ``FILES`` (alias ``TENSORFLOW``): each node reads its own data shard
  (TFRecord or other files from local disk); the engine only holds the
  executor slots.

  ``ENGINE`` (alias ``SPARK``): the engine pushes partitioned rows into each
  node's feed hub — not ported yet (ROADMAP Queue 1 item 14).
  """
  FILES = 0
  TENSORFLOW = 0
  ENGINE = 1
  SPARK = 1


class Cluster(object):
  """Handle for a started cluster (the JAX package's ``TPUCluster``;
  parity: TFCluster.py:49-212)."""

  def __init__(self, engine: Engine, cluster_info: List[dict],
               cluster_meta: dict, server: rendezvous.Server,
               input_mode: int, node_job, tf_status: dict,
               driver_ps_procs: Sequence = (), supervisor=None):
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

  @staticmethod
  def _span(name: str, **attrs):
    """Driver-side span, or a null context when no recorder is active."""
    rec = obs_spans.active()
    if rec is None:
      return contextlib.nullcontext()
    return rec.span(name, **attrs)

  # -- data plane: the engine feed plane is not ported yet -------------------

  def train(self, *args, **kwargs):
    raise NotImplementedError(_FEED_PLANE % "Cluster.train")

  def train_stream(self, *args, **kwargs):
    raise NotImplementedError(_FEED_PLANE % "Cluster.train_stream")

  def train_dstream(self, *args, **kwargs):
    raise NotImplementedError(_FEED_PLANE % "Cluster.train_dstream")

  def foreach_batch(self, *args, **kwargs):
    raise NotImplementedError(_FEED_PLANE % "Cluster.foreach_batch")

  def inference(self, *args, **kwargs):
    raise NotImplementedError(_FEED_PLANE % "Cluster.inference")

  @property
  def server_addr(self):
    """Rendezvous address (HEALTH queries and stop requests go here)."""
    return self.server.addr

  # -- lifecycle -------------------------------------------------------------

  def shutdown(self, grace_secs: float = 0, timeout: int = 259200) -> None:
    """Stop the cluster; raise if any node failed.

    ``timeout`` arms a SIGALRM watchdog (3-day default) guarding against
    hung shutdowns (parity: TFCluster.py:117,136-144). ``grace_secs`` is
    kept for signature parity; FILES mode has no feed to drain.
    """
    in_main = threading.current_thread() is threading.main_thread()
    if timeout and in_main:
      def _watchdog(signum, frame):
        raise TimeoutError("cluster shutdown watchdog fired after %ds" % timeout)
      old = signal.signal(signal.SIGALRM, _watchdog)
      signal.alarm(int(timeout))
    try:
      with self._span("cluster.shutdown"):
        self._shutdown_inner()
    finally:
      if timeout and in_main:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)

  def _shutdown_inner(self) -> None:
    background = [n for n in self.cluster_info
                  if n["job_name"] in node_mod.BACKGROUND_ROLES]

    if any(n.get("tb_url") for n in self.cluster_info):
      # reap the TensorBoard the chief spawned. One PINNED task per executor
      # slot (shared-queue tasks could all land on one free executor and
      # miss the chief's), each best-effort so a dead node can't abort the
      # rest of shutdown.
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
    self.server.stop()
    err = self.node_job.first_error() or self.tf_status.get("error")
    if err:
      raise RuntimeError("cluster shutdown with node error:\n%s" % err)
    logger.info("cluster shutdown complete")

  def tensorboard_url(self) -> Optional[str]:
    """URL of the TensorBoard server, if one was launched (parity:
    TFCluster.tensorboard_url, TFCluster.py:207-212)."""
    for n in self.cluster_info:
      if n.get("tb_url"):
        return n["tb_url"]
    return None


def _refuse_unported(input_mode, group_map, elastic, feed_segment) -> None:
  """Raise, naming the ROADMAP item, for what the port cannot run yet."""
  if input_mode != InputMode.FILES:
    raise NotImplementedError(_FEED_PLANE % "input_mode=InputMode.ENGINE")
  if obs_metrics.enabled():
    raise NotImplementedError(
        "TOS_OBS=1: the observability plane (the executor shippers, the "
        "driver sink and detector) is not ported to PyTorch yet (ROADMAP "
        "Queue 1 item 7); unset %s" % obs_metrics.ENV_OBS)
  if group_map or elastic:
    raise NotImplementedError(
        "group_map / elastic: elastic multi-group training is not ported "
        "to PyTorch yet (ROADMAP Queue 1 item 10)")
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
        chips_per_node: int = 0,
        heartbeat_interval: Optional[float] = 5.0,
        supervise: bool = True, max_restarts: int = 2,
        restart_backoff: float = 0.5,
        restart_backoff_cap: float = 5.0,
        train_unroll: Optional[int] = None,
        group_map: Optional[Dict[int, int]] = None,
        elastic: bool = False,
        feed_segment=None) -> Cluster:
  """Start a cluster and run ``main_fn(tf_args, ctx)`` on every node.

  Signature parity with TensorFlowOnSpark's ``TFCluster.run``
  (TFCluster.py:215-245), with the engine abstraction in place of a
  SparkContext. ``chips_per_node=k`` gives each node ``k`` CUDA cards of
  its host (``CUDA_VISIBLE_DEVICES``, counted by ``nvidia-smi``); a host
  with too few cards fails bring-up with the count in the message.
  ``driver_ps_nodes`` hosts the ps nodes on the driver machine (parity
  :229,298-316).

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
  """
  _refuse_unported(input_mode, group_map, elastic, feed_segment)
  num_executors = num_executors or engine.num_executors
  if train_unroll is not None and int(train_unroll) < 1:
    raise ValueError("train_unroll must be >= 1, got %r" % (train_unroll,))
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
      "heartbeat_interval": heartbeat_interval,
      # fused train loop default: every node exports this as
      # TOS_TRAIN_UNROLL (node._apply_node_env)
      "train_unroll": int(train_unroll) if train_unroll else None,
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

  node_job = engine.run_on_executors(node_fn, num_tasks=len(engine_ids),
                                     task_payloads=engine_ids)

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

  def _abort_cleanup():
    if supervisor is not None:
      supervisor.stop()
    server.stop()
    for p in driver_ps_procs:
      p.terminate()

  try:
    with Cluster._span("cluster.assemble", nodes=num_executors):
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
                 supervisor=supervisor)
