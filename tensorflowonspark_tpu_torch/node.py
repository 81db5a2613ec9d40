"""L2' per-executor node runtime, FILES input mode (InputMode.TENSORFLOW).

The port's copy of ``tensorflowonspark_tpu/node.py`` (lines 1-733 and its
TensorBoard reaper), itself the counterpart of TensorFlowOnSpark's
``TFSparkNode.py``:

- device allocation exports ``CUDA_VISIBLE_DEVICES`` for the node's card
  share (:mod:`.utils.gpu_info`, counting cards with ``nvidia-smi``), as
  TensorFlowOnSpark did (``TFSparkNode.py:179-239``) and where the JAX
  package exports TPU chip shares;
- the synthesized cluster spec feeds ``torch.distributed.init_process_group``
  (:meth:`NodeContext.initialize_distributed`), where the JAX package calls
  ``jax.distributed.initialize`` and TensorFlowOnSpark exported
  ``TF_CONFIG``;
- roles: workers run the user main fn in the foreground; ps/evaluator run
  it in a background process while the foreground blocks on a ``control``
  queue until the driver sends ``None`` (``TFSparkNode.py:441-458``);
- fault propagation: a dedicated ``error`` queue per executor, background
  exceptions captured as tracebacks (``TFSparkNode.py:423-429``);
- retried bring-up tasks re-register idempotently, while a live hub from a
  concurrent duplicate forces an error (``TFSparkNode.py:259-265``).

Task functions travel by the standard ``pickle``: the node task and the
TensorBoard reaper are instances of module-level classes, and the user's
``main_fn`` must be importable by name (a module-level function, or one in
the driver's ``__main__`` script, which spawned executors re-import). The
feed-plane half of the JAX module (``input_channel``, ``put_rows_chunk``,
``DualInput``, ``make_train_fn``, ``make_inference_fn``,
``make_shutdown_fn``) is ROADMAP Queue 1 item 14.
"""

import logging
import os
import pickle
import socket
import subprocess
import sys
import traceback
from typing import Dict, List, Optional

from tensorflowonspark_tpu_torch.control import feedhub, rendezvous
from tensorflowonspark_tpu_torch.utils import gpu_info, hostinfo, paths

logger = logging.getLogger(__name__)

#: roles that join the torch.distributed process group
GROUP_ROLES = ("chief", "master", "worker")
BACKGROUND_ROLES = ("ps", "evaluator")     # roles parked on a control queue

HUB_ADDR_FILE = "hub_addr"

#: pins the per-node coordinator/collectives port (env registry: TOS008)
ENV_NODE_PORT = "TOS_TPU_NODE_PORT"

# The JAX package's persistent compilation cache (TOS_COMPILE_CACHE, set up
# at node bring-up) has no counterpart yet: the port runs eagerly. Compiled
# dispatch, and a cache for it, is ROADMAP Queue 1 item 17.

_FEED_PLANE = ("the engine feed plane (DataFeed, InputMode.ENGINE) is not "
               "ported to PyTorch yet (ROADMAP Queue 1 item 14); in "
               "InputMode.TENSORFLOW each node reads its own files")
_CHECKPOINTS = ("checkpointing and model export under cluster.run are not "
                "ported to PyTorch yet (ROADMAP Queue 1 item 6)")


#: env values _apply_node_env exported in THIS (persistent) executor
#: process — so a later cluster that sets nothing can retract exactly
#: what a previous cluster exported, while a user's own env pin (a value
#: we never wrote) still passes through
_applied_node_env: Dict[str, str] = {}


def _apply_node_env(meta: dict) -> None:
  """Export cluster-level training knobs into this node process's env.

  ``cluster.run(train_unroll=K)`` rides the cluster meta so EVERY node —
  foreground or spawned background runner (which inherits this env at
  spawn) — sees the same ``TOS_TRAIN_UNROLL``, which
  ``parallel.sharding.resolve_unroll`` (and thus ``make_train_loop``)
  reads as its default. An explicit cluster value wins over a stale env;
  when the cluster sets nothing, an export left behind by a PREVIOUS
  cluster on this persistent executor is retracted, while a user-set env
  pin passes through.
  """
  unroll = meta.get("train_unroll")
  if not unroll and not _applied_node_env:
    return   # nothing to export or retract: skip the torch import below
  from tensorflowonspark_tpu_torch.parallel.sharding import ENV_TRAIN_UNROLL
  if unroll:
    _applied_node_env[ENV_TRAIN_UNROLL] = str(int(unroll))
    os.environ[ENV_TRAIN_UNROLL] = _applied_node_env[ENV_TRAIN_UNROLL]
  elif _applied_node_env.get(ENV_TRAIN_UNROLL) is not None \
      and os.environ.get(ENV_TRAIN_UNROLL) == \
      _applied_node_env[ENV_TRAIN_UNROLL]:
    os.environ.pop(ENV_TRAIN_UNROLL, None)
    _applied_node_env.pop(ENV_TRAIN_UNROLL)


class NodeContext(object):
  """Per-node metadata handed to the user main fn as ``ctx``.

  The port's ``TPUNodeContext``: field parity with TensorFlowOnSpark's
  TFNodeContext (``TFSparkNode.py:62-108``), plus the process-group
  coordinates (``coordinator_address``, ``process_id``,
  ``num_processes``) that :meth:`initialize_distributed` hands to
  ``torch.distributed``.
  """

  def __init__(self, executor_id=0, job_name="worker", task_index=0,
               cluster_spec=None, default_fs="file://", working_dir=".",
               hub=None, tmp_socket=None, coordinator_address=None,
               process_id=0, num_processes=1, cluster_info=None,
               restart_count=0, heartbeat=None):
    self.executor_id = executor_id
    self.worker_num = executor_id          # backwards-compat alias
    self.job_name = job_name
    self.task_index = task_index
    self.cluster_spec = cluster_spec or {}
    self.num_workers = sum(
        len(v) for k, v in self.cluster_spec.items() if k in GROUP_ROLES)
    self.default_fs = default_fs
    self.defaultFS = default_fs            # backwards-compat alias
    self.working_dir = working_dir
    self.mgr = hub                         # backwards-compat alias
    self.hub = hub
    self.tmp_socket = tmp_socket
    self.coordinator_address = coordinator_address
    self.process_id = process_id
    self.num_processes = num_processes
    self.cluster_info = cluster_info or []
    #: how many times the supervisor relaunched this node (0 = first
    #: launch)
    self.restart_count = restart_count
    self._heartbeat = heartbeat

  # -- convenience mirrors (parity: TFSparkNode.py:92-108) -------------------

  def absolute_path(self, path: str) -> str:
    return paths.absolute_path(path, self.default_fs, self.working_dir)

  def get_data_feed(self, train_mode=True, qname_in="input",
                    qname_out="output", input_mapping=None,
                    liveness_timeout=600.0):
    raise NotImplementedError("ctx.get_data_feed: " + _FEED_PLANE)

  def release_port(self) -> None:
    """Release the reserved coordinator port prior to starting the process
    group (parity: TFNode.release_port, TFNode.py:214-221)."""
    if self.tmp_socket is not None:
      self.tmp_socket.close()
      self.tmp_socket = None

  def export_model(self, state, export_dir: str) -> str:
    raise NotImplementedError("ctx.export_model: " + _CHECKPOINTS)

  @property
  def is_chief(self) -> bool:
    return is_chief(self.job_name, self.task_index, self.cluster_spec)

  @property
  def is_restart(self) -> bool:
    """True when this node is a supervised relaunch of a dead predecessor."""
    return self.restart_count > 0

  def checkpoint_manager(self, directory: str, **kwargs):
    raise NotImplementedError("ctx.checkpoint_manager: " + _CHECKPOINTS)

  def report_progress(self, value) -> None:
    """Attach an application progress value (e.g. the training step) to
    this node's heartbeats — visible driver-side via the HEALTH verb."""
    if self._heartbeat is not None:
      self._heartbeat.set_progress(value)

  def initialize_distributed(self, backend: str = "nccl") -> None:
    """Join the torch.distributed process group (the analog of TF reading
    TF_CONFIG, and of the JAX package's ``jax.distributed.initialize``).

    ``backend`` is NCCL by default, for the card; a caller on the CPU
    passes ``"gloo"``. Process 0's reserved port is the coordinator: each
    node releases its own reserved socket first, so process 0's TCP store
    can bind it. Skipped for single-process clusters; ps/evaluator nodes
    never call this — they are outside the group.
    """
    if self.num_processes <= 1:
      logger.info("single-process cluster; skipping torch.distributed")
      return
    self.release_port()
    import torch.distributed as dist
    logger.info("joining the %s process group: coordinator=%s rank=%d/%d",
                backend, self.coordinator_address, self.process_id,
                self.num_processes)
    dist.init_process_group(
        backend, init_method="tcp://%s" % self.coordinator_address,
        rank=self.process_id, world_size=self.num_processes)


def is_chief(job_name: str, task_index: int, roles) -> bool:
  """Chief = the chief/master node, or worker:0 when no chief exists.

  ``roles`` is any container of job names (cluster spec or template).
  """
  return (job_name in ("chief", "master")
          or (job_name == "worker" and task_index == 0
              and not any(r in roles for r in ("chief", "master"))))


def _role_of(executor_id: int, cluster_template: Dict[str, List[int]]):
  for job_name, ids in cluster_template.items():
    if executor_id in ids:
      return job_name, ids.index(executor_id)
  raise ValueError("executor %d not present in cluster template %r"
                   % (executor_id, cluster_template))


def _process_table(cluster_info: List[dict]):
  """Rank the group-joining nodes: chief/master first, then workers by
  index (the JAX package's ``_jax_process_table``).

  Returns (ordered list of node metas, coordinator host:port).
  """
  chiefs = [n for n in cluster_info if n["job_name"] in ("chief", "master")]
  workers = sorted((n for n in cluster_info if n["job_name"] == "worker"),
                   key=lambda n: n["task_index"])
  table = chiefs + workers
  coord = "%s:%d" % (table[0]["host"], table[0]["port"]) if table else None
  return table, coord


def _build_cluster_spec(cluster_info: List[dict]) -> Dict[str, List[str]]:
  """{job_name: ["host:port", ...]} sorted by task index.

  Rejects duplicate executor ids (parity: TFSparkNode.py:50-53).
  """
  seen = set()
  for n in cluster_info:
    if n["executor_id"] in seen:
      raise RuntimeError("duplicate executor_id %d in cluster info"
                         % n["executor_id"])
    seen.add(n["executor_id"])
  spec: Dict[str, List[str]] = {}
  by_job: Dict[str, List[dict]] = {}
  for n in cluster_info:
    by_job.setdefault(n["job_name"], []).append(n)
  for job, nodes in by_job.items():
    spec[job] = ["%s:%d" % (n["host"], n["port"])
                 for n in sorted(nodes, key=lambda n: n["task_index"])]
  return spec


def _find_tensorboard(search_path: Optional[str] = None):
  """Locate a TensorBoard entry point, or False.

  Searches PATH, the python bin dir, sys.path and PYTHONPATH for the
  ``tensorboard`` executable, then for the module form ``tensorboard/main.py``
  (parity: TensorFlowOnSpark's three-step search, TFSparkNode.py:310-322 —
  reordered so an explicit PATH entry OVERRIDES the interpreter's bin dir,
  the conventional Unix precedence).
  """
  if search_path is None:
    search_path = os.pathsep.join([
        os.environ.get("PATH", ""),
        os.path.dirname(sys.executable),
        os.pathsep.join(p for p in sys.path if p),
        os.environ.get("PYTHONPATH", ""),
    ])
  return hostinfo.find_in_path(search_path, "tensorboard") or \
      hostinfo.find_in_path(search_path,
                            os.path.join("tensorboard", "main.py"))


def _spawn_tensorboard(log_dir: str) -> Optional[dict]:
  """Launch a TensorBoard server subprocess (parity: TFSparkNode.py:292-329).

  Port selection: env ``TENSORBOARD_PORT`` or an ephemeral bind. Returns
  {'pid','url'} or None when no tensorboard entry point is found on the
  python bin dir / PATH / sys.path / PYTHONPATH.
  """
  tb_port = os.environ.get("TENSORBOARD_PORT")
  port = int(tb_port) if tb_port else hostinfo.get_free_port()
  tb_bin = _find_tensorboard()
  if not tb_bin:
    logger.warning("tensorboard not found on PATH/PYTHONPATH; skipping "
                   "launch")
    return None
  proc = subprocess.Popen(
      [sys.executable, tb_bin, "--logdir", log_dir, "--port", str(port),
       "--host", "0.0.0.0"],
      stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
  url = "http://%s:%d" % (hostinfo.get_ip_address(), port)
  logger.info("started TensorBoard pid=%d at %s", proc.pid, url)
  return {"pid": proc.pid, "url": url}


def _background_runner(fn_bytes: bytes, tf_args, ctx_kwargs: dict,
                       hub_addr, authkey: bytes, server_addr=None,
                       heartbeat_interval=None):
  """Entry point of the background process running a ps/evaluator main fn.

  Reconnects to this executor's feed hub by address (the hub lives in a
  separate manager process), captures any exception into the ``error``
  queue as a traceback (parity: TFSparkNode.py:423-429) and drives the hub
  state machine to ``'stopped'``. Heartbeats run HERE — in the process
  executing the user fn — so a SIGKILL/OOM of this process stops the
  beats.
  """
  hub = feedhub.connect(tuple(hub_addr), authkey)
  sender = None
  if server_addr and heartbeat_interval:
    sender = rendezvous.HeartbeatSender(
        tuple(server_addr), ctx_kwargs["executor_id"],
        interval=heartbeat_interval).start()
  ctx = NodeContext(hub=hub, heartbeat=sender, **ctx_kwargs)
  try:
    pickle.loads(fn_bytes)(tf_args, ctx)
  except BaseException:  # noqa: BLE001 - traceback must reach the driver
    tb = traceback.format_exc()
    logger.error("background main fn failed:\n%s", tb)
    try:
      hub.get_queue("error").put(tb)
    except Exception:  # noqa: BLE001 - error queue unreachable: fall back
      # so the failure still reaches the driver instead of vanishing with
      # this process
      try:
        hub.set("last_error", tb)   # the kv store may outlive queue breakage
      except Exception:  # noqa: BLE001 - hub manager fully gone; the
        # executor's inherited stderr is the last channel that still works
        os.write(2, ("background main fn failed:\n%s" % tb).encode())
  finally:
    if sender is not None:
      sender.stop()
    try:
      hub.set("state", "stopped")
    except Exception:  # noqa: BLE001
      pass


def _reclaim_stale_hub(working_dir: str, authkey: bytes,
                       executor_id: int) -> bool:
  """Duplicate/stale hub detection (parity: TFSparkNode.py:259-265).

  A hub in ``working_dir`` that answers with ``authkey`` and reports
  itself live means another concurrent node task (same cluster) owns this
  executor: raise, so the engine retries elsewhere. Anything else (a dead
  socket, a stale 'stopped' hub, or an AuthenticationError from a
  *previous* cluster's hub with another key) is reclaimed and the old
  manager released. Returns True when a predecessor's hub was found.
  """
  hub_file = os.path.join(working_dir, HUB_ADDR_FILE)
  if not os.path.exists(hub_file):
    return False
  try:
    with open(hub_file) as f:
      host, port = f.read().strip().split(":")
    old = feedhub.connect((host, int(port)), authkey)
    state = old.get("state")
    if state in ("running", "terminating"):
      raise RuntimeError(
          "executor already runs a live node (hub state=%r); failing this "
          "task so the engine can retry it elsewhere" % state)
    logger.info("found stale hub (state=%r); reclaiming executor", state)
    # a SIGKILLed predecessor leaves its hub manager as a live orphan (the
    # supervisor marks it 'dead'); reap it so managers don't pile up
    try:
      old.force_exit()
    except Exception:  # noqa: BLE001 - manager already gone
      pass
  except RuntimeError:
    raise
  except Exception as e:  # noqa: BLE001 - dead/foreign hub -> reclaim
    logger.info("found unreachable/foreign hub (%s); reclaiming executor",
                type(e).__name__)
  feedhub.release(executor_id)
  return True


def _check_main_fn(main_fn) -> bytes:
  """``main_fn`` pickled by name, or a ``TypeError`` saying why it cannot
  travel to the executors."""
  try:
    return pickle.dumps(main_fn)
  except (pickle.PicklingError, AttributeError, TypeError) as e:
    raise TypeError(
        "main_fn %r cannot be sent to the executors: the port sends it with "
        "the standard pickle, by name, so it must be a module-level "
        "function of an importable module or of the driver's __main__ "
        "script; a lambda or a closure cannot be pickled (%s)"
        % (main_fn, e)) from e


class NodeTask(object):
  """The engine task that brings up one cluster node (parity:
  TFSparkNode.run → _mapfn, TFSparkNode.py:158-465; the JAX package's
  ``make_node_fn._mapfn``). A module-level class, so it pickles by name."""

  def __init__(self, fn_bytes: bytes, tf_args, cluster_meta: dict):
    self.fn_bytes = fn_bytes
    self.tf_args = tf_args
    self.cluster_meta = cluster_meta

  def __call__(self, iterator):
    # 1. learn this task's executor id from its partition (parity :176-177).
    # A supervised relaunch hands a dict payload carrying the restart count
    # (cluster.ClusterSupervisor → Engine.relaunch_task).
    payload = next(iter(iterator))
    if isinstance(payload, dict):
      executor_id = payload["executor_id"]
      restart_count = int(payload.get("restart", 0))
    else:
      executor_id = payload
      restart_count = 0
    meta = self.cluster_meta
    working_dir = os.getcwd()
    job_name, task_index = _role_of(executor_id, meta["cluster_template"])
    authkey = bytes(meta["authkey"])

    # 2. a card-count check before anything is started or registered: a
    # node alone must fit on its host, so an over-asked chips_per_node
    # fails bring-up here, before the user fn could run anywhere
    num_chips = meta.get("chips_per_node", 0)
    gpus = None
    if num_chips and not os.environ.get(gpu_info.ENV_TEST_MODE):
      gpus = gpu_info.query_gpus()
      gpu_info.chip_env_for_worker(num_chips, 0, 1, len(gpus))

    reclaimed = _reclaim_stale_hub(working_dir, authkey, executor_id)

    # 3. start the feed hub; remote mode for driver-reachable roles
    hub_mode = "remote" if job_name in BACKGROUND_ROLES else "local"
    hub = feedhub.start(authkey, meta["queues"], mode=hub_mode)
    feedhub.hold(executor_id, hub)
    hostinfo.write_executor_id(executor_id, working_dir)
    with open(os.path.join(working_dir, HUB_ADDR_FILE), "w") as f:
      f.write("%s:%d" % hub.addr)

    # 4. reserve a port for the process-group coordinator (parity with TF
    # GRPC port reservation, :344-352); env pin supported
    tmp_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    tmp_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    # Steps 4-7 run with the reserved port open in a PERSISTENT executor
    # process: a bring-up failure (a bad port pin, TB spawn error,
    # reservation timeout, card-allocation error) must release the socket
    # or every supervised retry leaks one fd into the executor.
    try:
      tmp_sock.bind(("", int(os.environ.get(ENV_NODE_PORT, "0"))))
      port = tmp_sock.getsockname()[1]

      # 5. TensorBoard on chief / worker:0 (parity :292-329)
      tb_info = None
      if meta.get("tensorboard") and is_chief(job_name, task_index,
                                              meta["cluster_template"]):
        log_dir = meta.get("log_dir") or os.path.join(working_dir,
                                                      "tensorboard")
        os.makedirs(paths.strip_scheme(log_dir), exist_ok=True)
        tb_info = _spawn_tensorboard(paths.strip_scheme(log_dir))
        if tb_info:
          hub.set("tb_pid", tb_info["pid"])
          hub.set("tb_url", tb_info["url"])

      # 6. register and wait for the whole cluster (parity :332-370)
      host = hostinfo.get_ip_address()
      client = rendezvous.Client(tuple(meta["server_addr"]))
      reservation = {
          "executor_id": executor_id,
          "host": host,
          "job_name": job_name,
          "task_index": task_index,
          "port": port,
          "hub_addr": list(hub.addr),
          "pid": os.getpid(),
          "tb_url": tb_info["url"] if tb_info else None,
          # a reclaimed stale hub proves this is a retry of a dead
          # predecessor, not a concurrent task — the rendezvous replaces
          # instead of flagging a duplicate (Reservations.add)
          "reclaimed": reclaimed,
          # restart generation: lets the supervisor recognize THIS
          # relaunch's registration
          "restart": restart_count,
      }
      try:
        client.register(reservation)
        cluster_info = client.await_reservations(
            timeout=meta.get("reservation_timeout", 600))
      finally:
        client.close()

      # 6.5 card allocation (TensorFlowOnSpark's nvidia-smi GPU allocation,
      # :179-239). Runs AFTER reservation so the host-local worker index
      # comes from the actual host population in cluster_info — executor
      # ids are NOT contiguous per host.
      if gpus is not None:
        cohosted = sorted(n["executor_id"] for n in cluster_info
                          if n["host"] == host)
        gpu_info.allocate(num_chips, cohosted.index(executor_id),
                          len(cohosted), gpus)

      # 7. synthesize the cluster spec + process-group coordinates (the
      # analog of exporting TF_CONFIG, parity :373-384)
      cluster_spec = _build_cluster_spec(cluster_info)
      table, coordinator = _process_table(cluster_info)
      process_id = next((i for i, n in enumerate(table)
                         if n["executor_id"] == executor_id), -1)
    except BaseException:
      tmp_sock.close()
      raise

    ctx_kwargs = dict(
        executor_id=executor_id, job_name=job_name, task_index=task_index,
        cluster_spec=cluster_spec, default_fs=meta.get("default_fs", "file://"),
        working_dir=working_dir, coordinator_address=coordinator,
        process_id=process_id, num_processes=len(table),
        cluster_info=cluster_info, restart_count=restart_count)
    hb_interval = meta.get("heartbeat_interval")

    # 8. run the user main fn per role (parity :417-463)
    if isinstance(self.tf_args, list):
      sys.argv = [sys.argv[0] if sys.argv else "main"] + list(self.tf_args)
    # cluster-level training knobs (train_unroll → TOS_TRAIN_UNROLL) export
    # here so BOTH the foreground fn and the spawned background runner
    # (which inherits this env) resolve the same defaults
    _apply_node_env(meta)

    if job_name in BACKGROUND_ROLES:
      return self._run_background(executor_id, job_name, task_index, hub,
                                  authkey, tmp_sock, ctx_kwargs, hb_interval)
    return self._run_foreground(executor_id, hub, tmp_sock, ctx_kwargs,
                                hb_interval)

  def _run_background(self, executor_id, job_name, task_index, hub, authkey,
                      tmp_sock, ctx_kwargs, hb_interval):
    """ps/evaluator: the fn runs in a background process while this task
    parks on the control queue until the driver sends None (parity
    :431-458)."""
    tmp_sock.close()
    import multiprocessing as mp
    meta = self.cluster_meta
    proc = mp.get_context("spawn").Process(
        target=_background_runner,
        args=(self.fn_bytes, self.tf_args, ctx_kwargs, list(hub.addr),
              authkey, list(meta["server_addr"]), hb_interval),
        daemon=True, name="tos-node-%d" % executor_id)
    proc.start()
    hub.set("node_pid", proc.pid)
    control = hub.get_queue("control")
    while True:
      items = control.get_many(1, timeout=1.0)
      if items and items[0] is None:
        break
    # flip the state off "running" FIRST — sidecar fns poll it as their
    # stop signal — then join the background process (bounded) so its work
    # is durably done before 'stopped' is reported
    hub.set("state", "terminating")
    proc.join(timeout=60)
    if proc.is_alive():
      logger.warning("%s:%d background process still running at stop; "
                     "terminating", job_name, task_index)
      proc.terminate()
    hub.set("state", "stopped")
    return [executor_id]

  def _run_foreground(self, executor_id, hub, tmp_sock, ctx_kwargs,
                      hb_interval):
    """Workers: the fn runs in THIS process; beats come from here too, so
    a kill or hang of the worker is what stops them (parity :459-463)."""
    meta = self.cluster_meta
    # release-port semantics (parity :400-405): by default the reserved
    # port is released before the user fn; with release_port=False user
    # code calls ctx.release_port() itself, right before
    # ctx.initialize_distributed
    if meta.get("release_port", True):
      tmp_sock.close()
      tmp_sock = None
    sender = None
    if hb_interval:
      sender = rendezvous.HeartbeatSender(
          tuple(meta["server_addr"]), executor_id,
          interval=hb_interval).start()
    # the executor-side obs shipper of the JAX package (TOS_OBS=1) is
    # ROADMAP Queue 1 item 7; cluster.run refuses TOS_OBS=1 until then
    ctx = NodeContext(hub=hub, tmp_socket=tmp_sock, heartbeat=sender,
                      **ctx_kwargs)
    try:
      pickle.loads(self.fn_bytes)(self.tf_args, ctx)
      hub.set("state", "stopped")
    except BaseException:
      tb = traceback.format_exc()
      try:
        hub.get_queue("error").put(tb)
        hub.set("state", "stopped")
      except Exception:  # noqa: BLE001 - the engine reports the traceback
        pass
      raise
    finally:
      ctx.release_port()
      if sender is not None:
        sender.stop()
    return [executor_id]


def make_node_fn(main_fn, tf_args, cluster_meta: dict) -> NodeTask:
  """Build the engine task that brings up one cluster node. Raises
  ``TypeError`` when ``main_fn`` cannot be pickled by name."""
  return NodeTask(_check_main_fn(main_fn), tf_args, cluster_meta)


def driver_node_main(mapfn_bytes: bytes, executor_id: int,
                     workdir: str) -> None:
  """Entry point for a node hosted on the DRIVER machine (driver_ps_nodes,
  parity: TFCluster.py:298-316): runs the same bring-up task a regular
  executor would, in its own working directory."""
  os.makedirs(workdir, exist_ok=True)
  os.chdir(workdir)
  pickle.loads(mapfn_bytes)(iter([executor_id]))


def _get_hub(cluster_info: List[dict], executor_id: int, authkey: bytes):
  """Locate the feed hub of the node that owns this executor working dir
  (parity: TFSparkNode._get_manager, TFSparkNode.py:128-155).

  The working dir's ``hub_addr`` file is authoritative: a supervised
  relaunch starts a FRESH hub and rewrites the file, while ``cluster_info``
  pickled into an already-submitted task still names the dead one.
  Falls back to cluster_info when the file is missing/unreadable.
  """
  hub_file = os.path.join(os.getcwd(), HUB_ADDR_FILE)
  try:
    with open(hub_file) as f:
      host, port = f.read().strip().split(":")
    return feedhub.connect((host, int(port)), authkey)
  except Exception:  # noqa: BLE001 - fall back to the reservation table
    pass
  for n in cluster_info:
    if n["executor_id"] == executor_id:
      return feedhub.connect(tuple(n["hub_addr"]), authkey)
  raise RuntimeError("no cluster node found for executor %d" % executor_id)


def _kill_tensorboard(hub) -> None:
  """SIGTERM this node's TensorBoard if it started one (parity :619-625)."""
  tb_pid = hub.get("tb_pid")
  if tb_pid:
    try:
      os.kill(int(tb_pid), 15)
    except OSError:
      pass


class TensorBoardKill(object):
  """Engine task killing a node's TensorBoard at FILES-mode shutdown.

  Best-effort by design: a dead node/hub must not abort the rest of
  shutdown (server stop, sidecar stops, error propagation)."""

  def __init__(self, cluster_info, authkey: bytes):
    self.cluster_info = cluster_info
    self.authkey = authkey

  def __call__(self, iterator):
    for _ in iterator:
      pass
    try:
      executor_id = hostinfo.read_executor_id(os.getcwd())
      _kill_tensorboard(_get_hub(self.cluster_info, executor_id,
                                 self.authkey))
    except Exception as e:  # noqa: BLE001 - reap is best-effort
      logger.warning("tensorboard reap skipped on this executor: %s", e)


def make_tb_kill_fn(cluster_info, cluster_meta) -> TensorBoardKill:
  return TensorBoardKill(cluster_info, bytes(cluster_meta["authkey"]))

