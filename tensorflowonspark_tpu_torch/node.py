"""L2' per-executor node runtime and the feeder tasks of the engine feed plane.

The port's copy of ``tensorflowonspark_tpu/node.py``, itself the
counterpart of TensorFlowOnSpark's ``TFSparkNode.py``:

- device allocation exports ``CUDA_VISIBLE_DEVICES`` for the node's card
  share (:mod:`.utils.gpu_info`, counting cards with ``nvidia-smi``), as
  TensorFlowOnSpark did (``TFSparkNode.py:179-239``) and where the JAX
  package exports TPU chip shares;
- the synthesized cluster spec feeds ``torch.distributed.init_process_group``
  (:meth:`NodeContext.initialize_distributed`), where the JAX package calls
  ``jax.distributed.initialize`` and TensorFlowOnSpark exported
  ``TF_CONFIG``;
- roles: workers run the user main fn in the foreground (InputMode.
  TENSORFLOW) or in a spawned background process (InputMode.SPARK, so the
  executor is free for feeder tasks, ``TFSparkNode.py:431-439``);
  ps/evaluator run it in a background process while the foreground blocks
  on a ``control`` queue until the driver sends ``None`` (``:441-458``);
- with ``feed_transport="shm"`` the node creates a shared-memory ring
  (:mod:`.control.shmring`) for its input stream and advertises its name
  on the hub; a ring that cannot be built fails the bring-up (no fallback
  to the queue);
- the feeder tasks (:class:`TrainFeeder`, :class:`InferenceFeeder`,
  :class:`ShutdownTask`) push partitions into a node's input channel as
  codec-encoded chunks (:func:`put_rows_chunk`), collect inference
  results and send the end of feed (``TFSparkNode.py:468-656``);
- fault propagation: a dedicated ``error`` queue per executor, background
  exceptions captured as tracebacks (``TFSparkNode.py:423-429``);
- retried bring-up tasks re-register idempotently, while a live hub from a
  concurrent duplicate forces an error (``TFSparkNode.py:259-265``).

Task functions travel by the standard ``pickle``: the node task, the
feeder tasks and the TensorBoard reaper are instances of module-level
classes, and the user's ``main_fn`` must be importable by name (a
module-level function, or one in the driver's ``__main__`` script, which
spawned executors re-import).
"""

import itertools
import logging
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

from tensorflowonspark_tpu_torch.control import chunkcodec, feedhub, rendezvous
from tensorflowonspark_tpu_torch.control.marker import EndPartition
from tensorflowonspark_tpu_torch.obs import metrics as obs_metrics
from tensorflowonspark_tpu_torch.utils import chaos, gpu_info, hostinfo, paths

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

#: feeder byte budget per wire envelope: when set (> 0), feeders size
#: chunks adaptively from observed encoded bytes/row instead of the fixed
#: ``feed_chunk_size`` row count. ``cluster.run(feed_target_bytes=...)``
#: takes precedence over the env. 0/unset = fixed row count. (env
#: registry: TOS008)
ENV_FEED_TARGET_BYTES = "TOS_FEED_TARGET_BYTES"

#: adaptive-sizing row-count clamp, both directions: an envelope never
#: carries fewer rows than the floor (per-envelope overhead would
#: dominate) nor more than the cap (consumer-side latency and memory)
_ADAPT_MIN_ROWS = 16
_ADAPT_MAX_ROWS = 8192

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
               restart_count=0, heartbeat=None, server_addr=None):
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
    #: the driver's rendezvous server, (host, port): where a node's
    #: ``parallel.groups.GroupSyncClient`` reaches the sync plane
    self.server_addr = tuple(server_addr) if server_addr else None
    self._heartbeat = heartbeat

  # -- convenience mirrors (parity: TFSparkNode.py:92-108) -------------------

  def absolute_path(self, path: str) -> str:
    return paths.absolute_path(path, self.default_fs, self.working_dir)

  def get_data_feed(self, train_mode=True, qname_in="input",
                    qname_out="output", input_mapping=None,
                    liveness_timeout=600.0):
    """The :class:`~tensorflowonspark_tpu_torch.datafeed.DataFeed` over
    this node's hub (and its shm ring, when it has one): the rows the
    driver's ``Cluster.train`` / ``inference`` feed (InputMode.SPARK)."""
    from tensorflowonspark_tpu_torch.datafeed import DataFeed
    return DataFeed(self.hub, train_mode, qname_in, qname_out, input_mapping,
                    liveness_timeout=liveness_timeout)

  def release_port(self) -> None:
    """Release the reserved coordinator port prior to starting the process
    group (parity: TFNode.release_port, TFNode.py:214-221)."""
    if self.tmp_socket is not None:
      self.tmp_socket.close()
      self.tmp_socket = None

  def export_model(self, state, export_dir: str) -> str:
    """Chief-only export of ``state`` to ``<export_dir>/model`` (parity:
    TFNode.export_saved_model); other nodes write a throwaway dir.
    Returns the directory written. A train state cut over a mesh is
    gathered whole first, so every node of the mesh calls this."""
    from tensorflowonspark_tpu_torch.utils import compat
    return compat.export_model(state, export_dir, self.is_chief)

  @property
  def is_chief(self) -> bool:
    return is_chief(self.job_name, self.task_index, self.cluster_spec)

  @property
  def is_restart(self) -> bool:
    """True when this node is a supervised relaunch of a dead predecessor."""
    return self.restart_count > 0

  def checkpoint_manager(self, directory: str, **kwargs):
    """A :class:`~tensorflowonspark_tpu_torch.utils.checkpoint.
    CheckpointManager` for this node: the preemption-safe resume hook,
    ``state, start_step = mgr.restore_or(state)`` continues a relaunched
    node from its latest checkpoint (``start_step`` is 0 on a fresh
    launch). In a process group every node makes the manager and calls
    ``save``; a state cut over a mesh is saved whole and restores into a
    state cut over any mesh."""
    from tensorflowonspark_tpu_torch.utils.checkpoint import CheckpointManager
    return CheckpointManager(directory, **kwargs)

  def report_progress(self, value) -> None:
    """Attach an application progress value (e.g. the training step) to
    this node's heartbeats — visible driver-side via the HEALTH verb."""
    if self._heartbeat is not None:
      self._heartbeat.set_progress(value)

  def initialize_distributed(self, backend: str = "nccl") -> None:
    """Join the torch.distributed process group (the analog of TF reading
    TF_CONFIG, and of the JAX package's ``jax.distributed.initialize``).

    ``backend`` is NCCL by default, for the card; a caller on the CPU
    passes ``"gloo"``, and so must two ranks that share one card: NCCL
    refuses a group whose ranks sit on the same card. The group carries
    the data axis of ``parallel.mesh.build_mesh`` (the gradient
    all-reduce of data-parallel training). Process 0's reserved port is
    the coordinator: each node releases its own reserved socket first, so
    process 0's TCP store can bind it. Skipped for single-process clusters; ps/evaluator nodes
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


def _start_heartbeats(server_addr, executor_id: int, interval: float):
  """Start this process's heartbeats, once torch is imported.

  Importing torch loads its native library with the GIL held, for a few
  hundred ms on a loaded host. A user fn's first ``import torch`` after the
  first beat silences the beats for that long, and with 0.25 s beats (0.5
  s of silence reads as death) the supervisor kills a healthy node.
  Before the first beat the node is still under the startup grace.
  """
  import torch  # noqa: F401
  return rendezvous.HeartbeatSender(tuple(server_addr), executor_id,
                                    interval=interval).start()


def _start_obs_shipper(server_addr, executor_id: int, sender):
  """Executor-side obs plane bring-up (None when ``TOS_OBS`` is off).

  The shipper shares the HeartbeatSender's clock estimator — the BEAT
  round-trip is the TIME exchange — so span timestamps anchor to the
  driver's monotonic clock without extra control-plane traffic; the
  process recorder adopts the same estimator for its JSONL exports. The
  device tier (card-memory sampler) rides this shipper's cadence.
  """
  if not (obs_metrics.enabled() and server_addr):
    return None
  from tensorflowonspark_tpu_torch.obs import collector as obs_collector
  from tensorflowonspark_tpu_torch.obs import device as obs_device
  from tensorflowonspark_tpu_torch.obs import spans as obs_spans
  clock = sender.clock if sender is not None else None
  rec = obs_spans.active()
  if rec is not None and clock is not None:
    rec.clock = clock
  shipper = obs_collector.ObsShipper(tuple(server_addr), executor_id,
                                     clock=clock, label="exec")
  obs_device.install(shipper)
  return shipper.start()


# feeder-task obs shipper: one per executor PROCESS, shared across feed
# tasks (they are too short-lived to each own a thread + socket)
_feeder_shipper = None
_feeder_shipper_addr = None
_feeder_shipper_lock = threading.Lock()


def _ensure_feeder_shipper(server_addr, executor_id: int):
  """Obs shipper for feeder tasks (None when ``TOS_OBS`` is off).

  Feeder tasks run in the engine's executor process, which hosts no node
  runtime in InputMode.SPARK (the node's shipper lives in the background
  runner). Without a shipper HERE the feeder-side wire counters
  (``feed.wire_bytes``/``feed.wire_rows``/``feed.wire_enc.*``) never
  reach the driver's sink. Cached across feed tasks; re-pointed when a
  new cluster (fresh rendezvous server) reuses the executor process. The
  sink merges metric deltas additively per executor id, so this coexists
  with the node's shipper (the feeder owns a disjoint metric set). It
  installs no device tier: a feeder must never create a CUDA context.
  """
  global _feeder_shipper, _feeder_shipper_addr
  if not (obs_metrics.enabled() and server_addr):
    return None
  addr = (server_addr[0], int(server_addr[1]))
  with _feeder_shipper_lock:
    if _feeder_shipper is not None and _feeder_shipper_addr == addr:
      return _feeder_shipper
    if _feeder_shipper is not None:
      _feeder_shipper.stop(timeout=1.0)
    from tensorflowonspark_tpu_torch.obs import collector as obs_collector
    shipper = obs_collector.ObsShipper(addr, executor_id,
                                       label="feeder").start()
    _feeder_shipper = shipper
    _feeder_shipper_addr = addr
    return shipper


def _background_runner(fn_bytes: bytes, tf_args, ctx_kwargs: dict,
                       hub_addr, authkey: bytes, server_addr=None,
                       heartbeat_interval=None):
  """Entry point of the background process running the user main fn:
  every role in InputMode.SPARK, ps/evaluator in InputMode.TENSORFLOW.

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
    sender = _start_heartbeats(server_addr, ctx_kwargs["executor_id"],
                               heartbeat_interval)
  shipper = _start_obs_shipper(server_addr, ctx_kwargs["executor_id"],
                               sender)
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
    if shipper is not None:
      shipper.stop()           # final delta flush + JSONL close first,
    if sender is not None:     # so the driver hears it before the bye
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


def _create_ring(hub, meta: dict, executor_id: int, restart_count: int):
  """Create this node's shared-memory input ring and advertise its name on
  the hub (``ring_name``); control, error and output queues stay on the
  hub. Raises (the build's message included) when the ring cannot be
  made: the port does not fall back to the queue transport."""
  from tensorflowonspark_tpu_torch.control import shmring
  ring_name = "/tos_feed_%x_%d" % (meta["id"] & 0xFFFFFFFF, executor_id)
  if restart_count:
    # generation-suffix a relaunched node's ring: co-host feeder processes
    # cache opened rings by name (shmring.open_cached), so reusing the dead
    # predecessor's name would hand them a stale mapping of an unlinked
    # segment. Reap the old generations' segments while here.
    shmring.unlink_stale(ring_name)
    for gen in range(1, restart_count):
      shmring.unlink_stale("%s_r%d" % (ring_name, gen))
    ring_name = "%s_r%d" % (ring_name, restart_count)
  ring = shmring.ShmRing.create(ring_name,
                                meta.get("shm_capacity", 64 * 1024 * 1024))
  shmring.hold(executor_id, ring)
  hub.set("ring_name", ring_name)


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
    hub = feedhub.start(authkey, meta["queues"], mode=hub_mode,
                        qmax=meta.get("qmax", 1024))
    feedhub.hold(executor_id, hub)
    # only an InputMode.SPARK node is fed: in InputMode.TENSORFLOW nothing
    # would use the ring, and its /dev/shm segment (freed by the shutdown
    # job of InputMode.SPARK) would outlive the cluster
    if meta.get("feed_transport") == "shm" and meta["input_mode"] == 1:
      try:
        _create_ring(hub, meta, executor_id, restart_count)
      except BaseException:
        feedhub.release(executor_id)
        raise
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
        cluster_info=cluster_info, restart_count=restart_count,
        server_addr=meta.get("server_addr"))
    hb_interval = meta.get("heartbeat_interval")

    # 8. run the user main fn per role (parity :417-463)
    if isinstance(self.tf_args, list):
      sys.argv = [sys.argv[0] if sys.argv else "main"] + list(self.tf_args)
    # cluster-level training knobs (train_unroll → TOS_TRAIN_UNROLL) export
    # here so BOTH the foreground fn and the spawned background runner
    # (which inherits this env) resolve the same defaults
    _apply_node_env(meta)

    if job_name in BACKGROUND_ROLES or meta["input_mode"] == 1:
      return self._run_background(executor_id, job_name, task_index, hub,
                                  authkey, tmp_sock, ctx_kwargs, hb_interval)
    return self._run_foreground(executor_id, hub, tmp_sock, ctx_kwargs,
                                hb_interval)

  def _run_background(self, executor_id, job_name, task_index, hub, authkey,
                      tmp_sock, ctx_kwargs, hb_interval):
    """The fn runs in a spawned background process (parity :431-458).
    InputMode.SPARK workers return at once, so feeder tasks can run on
    this executor; ps/evaluator park on the control queue until the
    driver sends None."""
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
    if job_name not in BACKGROUND_ROLES:
      return [executor_id]
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
      sender = _start_heartbeats(meta["server_addr"], executor_id,
                                 hb_interval)
    shipper = _start_obs_shipper(meta["server_addr"], executor_id, sender)
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
      if shipper is not None:
        shipper.stop()
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


# --- the engine feed plane: channels and feeder tasks (TFSparkNode.py:468-656)


def _open_advertised_ring(hub, qname: str):
  """The node's shm ring adapter, or None (not advertised, or not
  reachable from this process: a feeder on another host).

  One resolution for the producer and consumer paths, so their choice of
  channel cannot drift."""
  if qname != "input":
    return None
  ring_name = hub.get("ring_name")
  if not ring_name:
    return None
  from tensorflowonspark_tpu_torch.control import shmring
  try:
    return shmring.RingQueueAdapter(shmring.open_cached(ring_name))
  except OSError as e:
    logger.warning("advertised shm ring %r unreachable from this process "
                   "(%s); using the hub queue", ring_name, e)
    return None


def input_channel(hub, qname: str = "input"):
  """PRODUCER-side input stream: the shared-memory ring when the node
  advertises one (feed_transport='shm') and it is reachable from this
  process, else the hub queue. Both expose the same put/get/join surface
  (:class:`~.control.shmring.RingQueueAdapter`).

  A feeder task on a DIFFERENT host cannot open the node's ring: it falls
  back to the hub queue, and the node's consumer drains both
  (:class:`DualInput`)."""
  ring = _open_advertised_ring(hub, qname)
  return ring if ring is not None else hub.get_queue(qname)


def _slice_chunk(chunk, a: int, b: int):
  """Row-range slice of a pending chunk (row list or ColumnChunk)."""
  if isinstance(chunk, chunkcodec.ColumnChunk):
    return chunkcodec.ColumnChunk([c[a:b] for c in chunk.cols],
                                  chunk.scalar, chunk.tuples, b - a)
  return chunk[a:b]


def put_rows_chunk(channel, rows, timeout=None, stats=None) -> int:
  """Ship one feed chunk as one or more chunk-boundary envelopes.

  The chunk is encoded ONCE in the feeder process (columnar for
  homogeneous rows, with per-column wire encodings, :mod:`.control.
  chunkcodec`) and travels as one unit on either transport: a ring
  payload, or a hub-queue ``ChunkEnvelope`` whose manager pickle is a
  bytes copy instead of a per-row object walk. Chunk boundaries survive
  to the consumer, which is what lets ``DataFeed`` assemble batches from
  column views instead of row tuples.

  Splitting works on the ENCODED payload size: oversized chunks halve at
  the row level until every envelope fits ``chunkcodec.MAX_PAYLOAD``, in
  row order. A single row whose payload still exceeds the bound raises
  :class:`~.control.chunkcodec.OversizedRowError`.

  ``rows`` may be a row list or a ``ColumnChunk``. Returns the encoded
  bytes shipped; ``stats`` (optional dict) accumulates per-column encoding
  counts for the chunks that shipped.
  """
  if not isinstance(rows, chunkcodec.ColumnChunk):
    rows = list(rows)
  enc_counts: Dict[str, int] = {}
  total_bytes = 0
  total_rows = 0
  # LIFO work stack: push the back half first so rows ship in order
  stack = [rows]
  while stack:
    chunk = stack.pop()
    n = chunk.n if isinstance(chunk, chunkcodec.ColumnChunk) else len(chunk)
    tally: Dict[str, int] = {}
    payload = chunkcodec.encode(chunk, tally)
    if len(payload) > chunkcodec.MAX_PAYLOAD:
      if n <= 1:
        raise chunkcodec.OversizedRowError(
            "a single row encodes to %d bytes, above the transport bound "
            "(chunkcodec.MAX_PAYLOAD = %d); it cannot be split further at "
            "the row level" % (len(payload), chunkcodec.MAX_PAYLOAD))
      half = n // 2
      stack.append(_slice_chunk(chunk, half, n))
      stack.append(_slice_chunk(chunk, 0, half))
      continue
    channel.put_chunk(n, payload, block=True, timeout=timeout)
    total_bytes += len(payload)
    total_rows += n
    # merge the tally only for envelopes that shipped (an oversized encode
    # attempt is encoded again after the split)
    for name, cnt in tally.items():
      enc_counts[name] = enc_counts.get(name, 0) + cnt
  if stats is not None:
    for name, cnt in enc_counts.items():
      stats[name] = stats.get(name, 0) + cnt
  reg = obs_metrics.active()
  if reg is not None and total_rows:
    reg.counter("feed.wire_bytes").inc(total_bytes)
    reg.counter("feed.wire_rows").inc(total_rows)
    for name, cnt in enc_counts.items():
      reg.counter("feed.wire_enc." + name).inc(cnt)
  return total_bytes


class _ChunkSizer(object):
  """Adaptive rows-per-envelope targeting ``target`` encoded bytes.

  Tracks an EWMA of observed encoded bytes per row (compression folds into
  the ratio: a 4x codec makes rows cheap on the wire, so the next envelope
  carries more of them). The row target stays clamped to
  ``[_ADAPT_MIN_ROWS, _ADAPT_MAX_ROWS]`` both ways."""

  __slots__ = ("target", "rows", "_bpr")

  def __init__(self, base_rows: int, target_bytes: int):
    self.target = int(target_bytes)
    self.rows = max(_ADAPT_MIN_ROWS, min(int(base_rows), _ADAPT_MAX_ROWS))
    self._bpr = 0.0

  def observe(self, n_rows: int, n_bytes: int) -> None:
    if n_rows <= 0:
      return
    bpr = n_bytes / float(n_rows)
    self._bpr = bpr if not self._bpr else 0.5 * self._bpr + 0.5 * bpr
    if self._bpr > 0:
      self.rows = max(_ADAPT_MIN_ROWS,
                      min(int(self.target / self._bpr), _ADAPT_MAX_ROWS))


def _feed_plan(cluster_meta: Dict, chunk_size: Optional[int]):
  """One feeder task's shipping plan from the cluster meta:
  ``(chunk_size, sizer)``. The sizer exists only when a byte budget is set
  (``feed_target_bytes`` cluster param, else ``TOS_FEED_TARGET_BYTES``).
  (The JAX package also compiles a ``feed_segment`` here, a pushdown of
  the consumer's map/filter prefix into the feeder: ROADMAP Queue 1 item
  11, refused by ``cluster.run``.)"""
  chunk_size = chunk_size or cluster_meta.get("feed_chunk_size", 256)
  # a new stream's columns owe nothing to the last one: drop any probe
  # backoff left by a previous feeder task in this process, or a fresh
  # compressible stream would ship its leading chunks raw
  chunkcodec._probe_backoff.clear()
  target = cluster_meta.get("feed_target_bytes")
  if not target:
    try:
      target = int(os.environ.get(ENV_FEED_TARGET_BYTES, "0") or 0)
    except ValueError:
      target = 0
  sizer = _ChunkSizer(chunk_size, target) if target and target > 0 else None
  return chunk_size, sizer


def _flush_chunk(queue, chunk, sizer, timeout, stats=None) -> int:
  """Ship one accumulated chunk; returns the rows delivered."""
  nbytes = put_rows_chunk(queue, chunk, timeout=timeout, stats=stats) \
      if chunk else 0
  if sizer is not None and chunk:
    sizer.observe(len(chunk), nbytes)
  return len(chunk)


class DualInput(object):
  """CONSUMER-side input draining the shm ring AND the hub queue.

  Co-host feeders (and the end-of-feed markers of co-hosted shutdown
  tasks) arrive on the ring; feeders on other hosts, and shutdown tasks
  placed off-host, fall back to the hub queue. Per-partition row order is
  preserved because any single feeder uses exactly one channel.
  ``task_done`` routes to whichever channel produced the last unit, so
  queue join backpressure still works for remote feeders.

  An end-of-feed ``None`` arriving on the ring (a shutdown marker, or the
  adapter's synthesized marker when the ring closes) is HELD BACK while
  the hub queue still has rows: a marker must never overtake remote
  feeders' in-flight data. ``delivered`` counts the units taken from each
  channel.
  """

  def __init__(self, ring, queue):
    self._ring = ring
    self._queue = queue
    self._last = None
    self._stash = None    # ring tail (from the marker on) awaiting drain
    self._stash_chunk = None  # held-back end-of-feed chunk (get_chunk path)
    self.delivered = {"ring": 0, "queue": 0}

  def _from(self, ch, got):
    self._last = ch
    self.delivered["ring" if ch is self._ring else "queue"] += 1
    return got

  def _deliver_ring(self, got, max_items: int):
    # identity scan, not `None in got`: rows may be numpy arrays, whose
    # __eq__ is elementwise and makes `in`/.index raise on truth-testing
    idx = next((i for i, r in enumerate(got) if r is None), -1)
    if idx >= 0 and not self._queue.empty():
      self._stash = got[idx:]
      prefix = got[:idx]
      if prefix:
        return self._from(self._ring, prefix)
      queued = self._queue.get_many(max_items, block=False)
      if queued:
        return self._from(self._queue, queued)
      # the queue drained between the check and the read: release now
      out, self._stash = self._stash, None
      return self._from(self._ring, out)
    return self._from(self._ring, got)

  def get_many(self, max_items: int, block: bool = True, timeout=None):
    if self._stash is not None:
      queued = self._queue.get_many(max_items, block=False)
      if queued:
        return self._from(self._queue, queued)
      out, self._stash = self._stash, None
      return self._from(self._ring, out)
    # the blocking contract of the single-channel queues: timeout=None
    # blocks until data arrives (alternating short polls of both channels)
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
      got = self._ring.get_many(max_items, block=False)
      if got:
        return self._deliver_ring(got, max_items)
      got = self._queue.get_many(max_items, block=False)
      if got:
        return self._from(self._queue, got)
      if not block:
        return []
      remaining = None if deadline is None else deadline - time.monotonic()
      if remaining is not None and remaining <= 0:
        return []
      wait = 0.25 if remaining is None else min(remaining, 0.25)
      got = self._ring.get_many(max_items, block=True, timeout=wait)
      if got:
        return self._deliver_ring(got, max_items)

  def _ring_chunk(self, got, max_rows: int):
    """Deliver a ring chunk, holding back an end-of-feed marker while the
    hub queue still has remote feeders' data (the ``get_chunk`` analog of
    ``_deliver_ring``)."""
    if got[0] == "marker" and got[1] is None and not self._queue.empty():
      queued = self._queue.get_chunk(max_rows, block=False)
      if queued:
        self._stash_chunk = got
        return self._from(self._queue, queued)
      # the queue drained between the check and the read: release now
    return self._from(self._ring, got)

  def get_chunk(self, max_rows: int = 1024, block: bool = True,
                timeout=None):
    """Chunk-granular dequeue over both channels (``None`` on timeout):
    one chunk-boundary unit per call, and an end-of-feed ``None`` from the
    ring waits for the hub queue to drain."""
    if self._stash_chunk is not None:
      queued = self._queue.get_chunk(max_rows, block=False)
      if queued:
        return self._from(self._queue, queued)
      out, self._stash_chunk = self._stash_chunk, None
      return self._from(self._ring, out)
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
      got = self._ring.get_chunk(max_rows, block=False)
      if got:
        return self._ring_chunk(got, max_rows)
      got = self._queue.get_chunk(max_rows, block=False)
      if got:
        return self._from(self._queue, got)
      if not block:
        return None
      remaining = None if deadline is None else deadline - time.monotonic()
      if remaining is not None and remaining <= 0:
        return None
      wait = 0.25 if remaining is None else min(remaining, 0.25)
      got = self._ring.get_chunk(max_rows, block=True, timeout=wait)
      if got:
        return self._ring_chunk(got, max_rows)

  def task_done(self, n: int = 1) -> None:
    if self._last is not None:
      self._last.task_done(n)

  def qsize(self) -> int:
    return self._ring.qsize() + self._queue.qsize()

  def empty(self) -> bool:
    return self.qsize() == 0


def consumer_channel(hub, qname: str = "input"):
  """The node-side input stream: ring+queue (:class:`DualInput`) when a
  ring is advertised and reachable, else the hub queue."""
  ring = _open_advertised_ring(hub, qname)
  if ring is not None:
    return DualInput(ring, hub.get_queue(qname))
  return hub.get_queue(qname)


def _check_errors(hub, where: str) -> None:
  """Poll the error queue; re-raise worker tracebacks on the feeder or
  driver side (parity: TFSparkNode.py:508-515)."""
  eq = hub.get_queue("error")
  errs = eq.get_many(16, block=False)
  if errs:
    # put back so shutdown's check still sees it (parity :644-650)
    eq.put_many(errs)
    raise RuntimeError("worker error detected during %s:\n%s"
                       % (where, "\n".join(str(e) for e in errs)))


_NO_ITEM = object()


def _materialize_partition(iterator):
  """Resolve a lazy partition handle on the executor.

  A partition of exactly ONE zero-arg callable is a handle: it is called
  HERE, so rows are produced executor-side and never ship through the
  driver. Anything else passes through untouched.
  """
  first = next(iterator, _NO_ITEM)
  if first is _NO_ITEM:
    return iter(())
  if callable(first):
    second = next(iterator, _NO_ITEM)
    if second is _NO_ITEM:
      return iter(first())
    return itertools.chain([first, second], iterator)
  return itertools.chain([first], iterator)


class TrainFeeder(object):
  """Feeder task: push one data partition into the local node's input
  channel (parity: TFSparkNode.train, TFSparkNode.py:468-535; the JAX
  package's ``make_train_fn._train``).

  Rows move as chunk-boundary envelopes (:func:`put_rows_chunk`), encoded
  once (columnar for homogeneous rows) and shipped whole, with blocking
  backpressure; the task then waits until the node consumed everything,
  surfacing the node's errors. A node in the ``terminating`` state (the
  user called ``DataFeed.terminate``) gets nothing: the partition is
  drained and dropped so the engine job completes. ``chunk_size`` defaults
  to the cluster's ``feed_chunk_size``; a ``feed_target_bytes`` budget
  sizes chunks adaptively. Returns ``[rows fed]``.
  """

  def __init__(self, cluster_info, cluster_meta, feed_timeout=600,
               qname="input", chunk_size=None):
    self.cluster_info = cluster_info
    self.cluster_meta = cluster_meta
    self.feed_timeout = feed_timeout
    self.qname = qname
    self.chunk_size = chunk_size

  def __call__(self, iterator):
    executor_id = hostinfo.read_executor_id(os.getcwd())
    # deterministic fault site (TOS_CHAOS_STALL "feeder[@executor]:s"): a
    # slow feed task, once per process
    chaos.stall_point("feeder", index=executor_id)
    hub = _get_hub(self.cluster_info, executor_id,
                   bytes(self.cluster_meta["authkey"]))
    state = hub.get("state")
    queue = input_channel(hub, self.qname)
    if state == "terminating":
      # parity :492-496; the RAW iterator is drained, so a lazy handle is
      # discarded uncalled
      logger.info("node terminating; skipping partition feed")
      for _ in iterator:
        pass
      return [0]
    shipper = _ensure_feeder_shipper(self.cluster_meta.get("server_addr"),
                                     executor_id)
    size, sizer = _feed_plan(self.cluster_meta, self.chunk_size)
    rows = 0
    flushes = 0
    chunk = []
    for item in _materialize_partition(iterator):
      chunk.append(item)
      if len(chunk) >= (sizer.rows if sizer is not None else size):
        rows += _flush_chunk(queue, chunk, sizer, self.feed_timeout)
        chunk = []
        flushes += 1
        # poll the error queue every 8th chunk, at the flush point only
        if flushes % 8 == 0:
          _check_errors(hub, "feeding")
    rows += _flush_chunk(queue, chunk, sizer, self.feed_timeout)
    # wait until the consumer processed everything, surfacing errors
    # (parity :504-517)
    deadline = time.monotonic() + self.feed_timeout
    while not queue.join(timeout=1.0):
      _check_errors(hub, "feeding")
      if time.monotonic() > deadline:
        raise TimeoutError(
            "feed timeout (%ds) waiting for node to consume %d rows"
            % (self.feed_timeout, rows))
    _check_errors(hub, "feeding")
    if shipper is not None:
      # final flush: this may be the run's last feed task, and engine
      # teardown won't wait for the cadence thread's next round; the
      # stamp gives the feeder its log (and trace track) now
      shipper.ship(timeout=5.0)
      shipper.stamp_log()
    logger.info("fed %d rows to executor %d", rows, executor_id)
    return [rows]


class InferenceFeeder(object):
  """Inference task: feed one partition, then collect exactly its results
  from the node's output queue (parity: TFSparkNode.inference,
  TFSparkNode.py:538-599; the JAX package's ``make_inference_fn``). An
  ``EndPartition`` marker follows the rows, so the node's batches end at
  the partition boundary."""

  def __init__(self, cluster_info, cluster_meta, feed_timeout=600,
               qname="input", chunk_size=None):
    self.cluster_info = cluster_info
    self.cluster_meta = cluster_meta
    self.feed_timeout = feed_timeout
    self.qname = qname
    self.chunk_size = chunk_size

  def __call__(self, iterator):
    iterator = _materialize_partition(iterator)
    executor_id = hostinfo.read_executor_id(os.getcwd())
    hub = _get_hub(self.cluster_info, executor_id,
                   bytes(self.cluster_meta["authkey"]))
    queue = input_channel(hub, self.qname)
    size, sizer = _feed_plan(self.cluster_meta, self.chunk_size)
    count = 0
    chunk = []
    for item in iterator:
      chunk.append(item)
      if len(chunk) >= (sizer.rows if sizer is not None else size):
        count += _flush_chunk(queue, chunk, sizer, self.feed_timeout)
        chunk = []
    count += _flush_chunk(queue, chunk, sizer, self.feed_timeout)
    if count == 0:
      return []  # an empty partition short-circuits (parity :569-570)
    queue.put(EndPartition(), block=True, timeout=self.feed_timeout)

    deadline = time.monotonic() + self.feed_timeout
    while not queue.join(timeout=1.0):
      _check_errors(hub, "inference feeding")
      if time.monotonic() > deadline:
        raise TimeoutError("feed timeout (%ds) during inference"
                           % self.feed_timeout)

    # collect exactly `count` results (parity :588-595)
    out_q = hub.get_queue("output")
    results = []
    while len(results) < count:
      got = out_q.get_many(count - len(results), timeout=self.feed_timeout)
      if not got:
        _check_errors(hub, "inference collection")
        if time.monotonic() > deadline:
          raise TimeoutError("timed out collecting inference results")
        continue
      results.extend(got)
      out_q.task_done(len(got))
    return results



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


class ShutdownTask(object):
  """Shutdown task: send end-of-feed, await the node's exit, surface late
  errors (parity: TFSparkNode.shutdown, TFSparkNode.py:602-656; the JAX
  package's ``make_shutdown_fn``).

  The partition payload names the executor whose node this task stops.
  Shutdown tasks ride the engine's SHARED queue, so a task can land on any
  free executor; acting on the slot it occupies could give one node two
  end-of-feed markers and another none. Host-local side effects
  (TensorBoard SIGTERM, /dev/shm reap) run only when the target node
  shares this task's host."""

  def __init__(self, cluster_info, cluster_meta, grace_secs=0,
               queues=("input",)):
    self.cluster_info = cluster_info
    self.authkey = bytes(cluster_meta["authkey"])
    self.grace_secs = grace_secs
    self.queues = tuple(queues)

  def _host_of(self, eid):
    for n in self.cluster_info:
      if n["executor_id"] == eid:
        return n["hub_addr"][0]
    return None

  def __call__(self, iterator):
    target = None
    for item in iterator:
      target = item
    here = hostinfo.read_executor_id(os.getcwd())
    executor_id = here if target is None else int(target)
    if executor_id == here:
      # local: the cwd hub_addr file is authoritative (relaunched nodes
      # rewrite it; cluster_info may still name the dead hub)
      hub = _get_hub(self.cluster_info, executor_id, self.authkey)
    else:
      entry = next((n for n in self.cluster_info
                    if n["executor_id"] == executor_id), None)
      if entry is None:
        raise RuntimeError("no cluster node found for executor %d"
                           % executor_id)
      hub = feedhub.connect(tuple(entry["hub_addr"]), self.authkey)
    co_hosted = executor_id == here or \
        self._host_of(executor_id) == self._host_of(here)

    if co_hosted:
      _kill_tensorboard(hub)  # a pid signal: valid on the node's host only

    for qname in self.queues:
      input_channel(hub, qname).put(None, block=True, timeout=60)

    # wait for the node process to finish (state -> stopped)
    deadline = time.monotonic() + max(self.grace_secs, 0) + 600
    while hub.get("state") not in ("stopped",):
      if time.monotonic() > deadline:
        raise TimeoutError("node on executor %d did not stop" % executor_id)
      time.sleep(0.5)
    if self.grace_secs:
      time.sleep(self.grace_secs)

    # the input ring has served its purpose; unlink the shm segment so
    # repeated runs don't accumulate /dev/shm usage
    ring_name = hub.get("ring_name")
    if ring_name:
      from tensorflowonspark_tpu_torch.control import shmring
      if executor_id == here:
        shmring.release(executor_id)
      elif co_hosted:
        # the ring is held by the target's executor process, not this one;
        # reap the segment by name (open mappings stay valid)
        shmring.unlink_stale(ring_name)

    # late-error propagation with peek-and-put-back (parity :644-650)
    eq = hub.get_queue("error")
    errs = eq.get_many(16, block=False)
    if errs:
      eq.put_many(errs)
      raise RuntimeError("worker error:\n%s" % "\n".join(str(e) for e in errs))
    # the background runner's fallback channel: a traceback it could not
    # enqueue (error queue unreachable at crash time) lands in the kv store
    last_error = hub.get("last_error")
    if last_error:
      raise RuntimeError("worker error (recovered from the hub kv store: "
                         "the error queue was unreachable when the node "
                         "crashed):\n%s" % last_error)
    return [executor_id]
