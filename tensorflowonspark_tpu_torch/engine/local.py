"""LocalEngine: a built-in multi-process executor engine with Spark semantics.

The port's copy of ``tensorflowonspark_tpu/engine/local.py``. It plays the
role Spark Standalone played in TensorFlowOnSpark's tests (a 2-worker
single-core standalone cluster on one host, because Spark *local* mode
shares one process and TFoS assumes separate executor processes).

Semantics implemented (see engine.base for why they matter):
- N persistent executor processes, spawned (not forked — safe to initialize
  CUDA inside tasks), each with its own working directory and
  ``TOS_EXECUTOR_SLOT`` env var;
- one task at a time per executor; a blocked task keeps its executor busy;
- pinned tasks (node bring-up, barrier gangs) target a specific executor,
  queued tasks go to whichever executor frees up first;
- task functions and results serialized with the standard ``pickle``
  (the JAX package uses cloudpickle; the port needs nothing beyond the
  standard library, numpy and torch): a task function is a module-level function or an instance of a
  module-level class, importable by name in the executor.
"""

import logging
import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import threading
import traceback
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence

from tensorflowonspark_tpu_torch.control import chunkcodec
from tensorflowonspark_tpu_torch.engine.base import (
    EXECUTOR_LOST, BarrierContext, Engine, EngineJob)

logger = logging.getLogger(__name__)

_STOP = "__stop_executor__"

#: exported into every executor process; consumed by pipeline transforms
#: for host-local chip placement (env registry: tools.analyze TOS008)
ENV_EXECUTOR_SLOT = "TOS_EXECUTOR_SLOT"


class _BarrierTask(object):
  """One member of a barrier gang: registers with the gang's rendezvous,
  waits for the whole gang, then runs ``fn(iter([task_id]), ctx)`` with a
  :class:`BarrierContext` whose ``barrier()`` is a rendezvous round. A
  module-level class, so the task pickles by name."""

  def __init__(self, fn, addr, addresses: List[str]):
    self.fn = fn
    self.addr = (addr[0], int(addr[1]))
    self.addresses = list(addresses)

  def __call__(self, it):
    from tensorflowonspark_tpu_torch.control.rendezvous import Client
    task_id = next(iter(it))
    client = Client(self.addr)
    n = len(self.addresses)
    rounds = [0]

    def sync():
      rounds[0] += 1
      client.barrier_wait(rounds[0], required=n, timeout=600,
                          task_id=task_id)

    try:
      client.register({"executor_id": task_id,
                       "host": self.addresses[task_id]})
      client.await_reservations(timeout=60)  # gang start line
      return self.fn(iter([task_id]), BarrierContext(
          task_id, self.addresses, sync_fn=sync))
    finally:
      client.close()


def _executor_main(slot: int, workdir: str, task_q, result_q, env: Dict[str, str]):
  """Executor process entry point: run one task at a time, forever."""
  os.chdir(workdir)
  os.environ.update(env)
  os.environ[ENV_EXECUTOR_SLOT] = str(slot)
  while True:
    item = task_q.get()
    if item == _STOP:
      break
    job_id, task_id, attempt, fn_bytes, data_bytes = item
    try:
      fn = pickle.loads(fn_bytes)
      data = chunkcodec.decode(data_bytes)
      result = fn(iter(data))
      # mapPartitions-style fns may return generators; materialize here,
      # inside the executor, like Spark does on collect
      if result is not None and hasattr(result, "__iter__") \
          and not isinstance(result, (list, tuple, str, bytes, dict)):
        result = list(result)
      result_q.put((slot, job_id, task_id, attempt, "ok",
                    pickle.dumps(result)))
    except BaseException:  # noqa: BLE001 - full traceback must reach driver
      result_q.put((slot, job_id, task_id, attempt, "err",
                    traceback.format_exc()))


class LocalEngine(Engine):
  """Multi-process engine; see module docstring."""

  colocated_executors = True

  def __init__(self, num_executors: int = 2, workdir: Optional[str] = None,
               env: Optional[Dict[str, str]] = None):
    self._num_executors = num_executors
    self._root = workdir or tempfile.mkdtemp(prefix="tos_tpu_engine_")
    self._owns_root = workdir is None
    self._ctx = mp.get_context("spawn")
    self._result_q = self._ctx.Queue()
    self._procs = []
    self._task_qs = []
    self._env = dict(env or {})
    for slot in range(num_executors):
      wd = os.path.join(self._root, "executor_%d" % slot)
      os.makedirs(wd, exist_ok=True)
      tq = self._ctx.Queue()
      # non-daemonic: executors must be able to spawn children (feed hub
      # manager processes, background node processes); cleanup is handled by
      # stop() + the atexit hook below
      p = self._ctx.Process(target=_executor_main,
                            args=(slot, wd, tq, self._result_q, self._env),
                            daemon=False, name="local-executor-%d" % slot)
      p.start()
      self._procs.append(p)
      self._task_qs.append(tq)

    # scheduler state
    self._lock = threading.Lock()
    self._idle = set(range(num_executors))
    self._pinned: List[deque] = [deque() for _ in range(num_executors)]
    self._shared: deque = deque()
    self._running: Dict[int, tuple] = {}   # slot -> (job_id, task_id)
    self._jobs: Dict[int, EngineJob] = {}
    self._next_job_id = 0
    self._stopped = threading.Event()
    self._collector = threading.Thread(target=self._collect, daemon=True,
                                       name="local-engine-collector")
    self._collector.start()
    # dead-executor supervision: a SIGKILLed/preempted executor process is
    # detected (its in-flight task failed with the ExecutorLost marker) and
    # the slot is respawned so pinned relaunches have somewhere to run
    self._monitor = threading.Thread(target=self._monitor_procs, daemon=True,
                                     name="local-engine-monitor")
    self._monitor.start()
    import atexit
    atexit.register(self.stop)

  # -- Engine interface ------------------------------------------------------

  @property
  def num_executors(self) -> int:
    return self._num_executors

  def executor_workdir(self, slot: int) -> str:
    return os.path.join(self._root, "executor_%d" % slot)

  def run_on_executors(self, fn, num_tasks: Optional[int] = None,
                       task_payloads=None) -> EngineJob:
    n = num_tasks if num_tasks is not None else self._num_executors
    if n > self._num_executors:
      raise ValueError("requested %d tasks but engine has %d executors"
                       % (n, self._num_executors))
    payloads = list(task_payloads) if task_payloads is not None \
        else list(range(n))
    if len(payloads) != n:
      raise ValueError("task_payloads has %d entries for %d tasks"
                       % (len(payloads), n))
    job = self._new_job(n)
    fn_bytes = pickle.dumps(fn)
    with self._lock:
      for i in range(n):
        data_bytes = chunkcodec.encode([payloads[i]])
        job._task_specs[i] = (fn_bytes, data_bytes, i)   # pinned to slot i
        self._pinned[i].append((job.job_id, i, 0, fn_bytes, data_bytes))
      self._schedule_locked()
    return job

  def foreach_partition(self, partitions: Sequence[Iterable], fn) -> EngineJob:
    job = self._new_job(len(partitions))
    fn_bytes = pickle.dumps(fn)
    with self._lock:
      for i, part in enumerate(partitions):
        # feeder side of the feed plane: homogeneous row partitions cross
        # the driver→executor task queue COLUMNAR (one buffer per column,
        # control/chunkcodec.py) instead of as a per-row pickle walk;
        # anything else falls back to pickle inside the codec
        data_bytes = chunkcodec.encode(part)
        job._task_specs[i] = (fn_bytes, data_bytes, None)  # any free slot
        self._shared.append((job.job_id, i, 0, fn_bytes, data_bytes))
      self._schedule_locked()
    return job

  def preempt_task(self, job: EngineJob, task_id: int) -> bool:
    """SIGKILL the executor running one of ``job``'s tasks (see Engine
    contract): the monitor then fails the attempt with ExecutorLost and
    respawns the slot, so a queued relaunch can actually schedule."""
    with self._lock:
      for slot, running in self._running.items():
        if running[0] == getattr(job, "job_id", None) and \
            running[1] == task_id:
          pid = self._procs[slot].pid
          break
      else:
        return False
    logger.warning("preempting task %d of job %s (killing executor pid %s)",
                   task_id, job.job_id, pid)
    try:
      os.kill(pid, 9)
    except OSError:
      pass
    return True

  def relaunch_task(self, job: EngineJob, task_id: int, payload=None):
    """Re-queue one task of ``job`` (fault recovery; see Engine contract).

    Pinned tasks return to their original executor slot — which the
    monitor has respawned if its process died — so a relaunched node keeps
    its working directory (and therefore its hub-reclaim and executor-id
    state). ``payload`` (when given) replaces the task's original payload.
    """
    spec = job._task_specs.get(task_id)
    if spec is None:
      raise ValueError("job %s task %d has no stored spec to relaunch"
                       % (getattr(job, "job_id", "?"), task_id))
    fn_bytes, data_bytes, slot = spec
    if payload is not None:
      data_bytes = chunkcodec.encode([payload])
      job._task_specs[task_id] = (fn_bytes, data_bytes, slot)
    attempt = job._task_restarted(task_id)
    with self._lock:
      self._jobs[job.job_id] = job     # re-track (evicted when it finished)
      task = (job.job_id, task_id, attempt, fn_bytes, data_bytes)
      if slot is not None:
        self._pinned[slot].append(task)
      else:
        self._shared.append(task)
      self._schedule_locked()

  def map_partitions(self, partitions, fn, timeout=None) -> List:
    job = self.foreach_partition(partitions, fn)
    results = job.wait(timeout=timeout)
    out = []
    for r in results:
      if r is None:
        continue
      out.extend(r if isinstance(r, (list, tuple)) else [r])
    return out

  def map_partitions_lazy(self, partitions, fn, timeout: Optional[float] = None,
                          window: Optional[int] = None):
    """Generator of per-partition results, at most ``window`` partitions
    in flight (default: one per executor). The driver holds one window of
    results instead of the whole output — the LocalEngine analog of
    returning an uncollected RDD. ``timeout`` bounds each partition's
    completion like the eager path's deadline."""
    window = window or self._num_executors

    def _gen():
      pending: deque = deque()
      parts = iter(partitions)

      def _submit():
        try:
          part = next(parts)
        except StopIteration:
          return False
        pending.append(self.foreach_partition([part], fn))
        return True

      for _ in range(window):
        if not _submit():
          break
      while pending:
        results = pending.popleft().wait(timeout=timeout)
        _submit()
        for r in results:
          if r is None:
            continue
          for row in (r if isinstance(r, (list, tuple)) else [r]):
            yield row

    return _gen()

  def barrier_run(self, fn, num_tasks: Optional[int] = None,
                  timeout: Optional[float] = None) -> List:
    """Gang-schedule with placement info and a reusable barrier.

    Oversubscription fails fast (parity: Spark barrier mode raising when the
    gang cannot be scheduled at once — reference tests/test_TFParallel.py).
    """
    n = num_tasks if num_tasks is not None else self._num_executors
    if n > self._num_executors:
      raise ValueError(
          "barrier gang of %d cannot be scheduled on %d executors"
          % (n, self._num_executors))
    from tensorflowonspark_tpu_torch.control.rendezvous import Server
    from tensorflowonspark_tpu_torch.utils.hostinfo import get_ip_address
    server = Server(n)
    addr = server.start()
    ip = get_ip_address()
    addresses = ["%s:%d" % (ip, slot) for slot in range(n)]
    try:
      job = self.run_on_executors(_BarrierTask(fn, addr, addresses),
                                  num_tasks=n)
      return job.wait(timeout=timeout)
    finally:
      server.stop()

  def stop(self) -> None:
    if self._stopped.is_set():
      return
    self._stopped.set()
    with self._lock:
      pass   # fence: a monitor-thread respawn in flight completes first
    for tq in self._task_qs:
      try:
        # bounded: a wedged/full task queue must not hang driver shutdown
        # — the executor process is terminated below regardless
        tq.put(_STOP, timeout=5)
      except Exception:  # noqa: BLE001
        pass
    for p in self._procs:
      p.join(timeout=5)
      if p.is_alive():
        p.terminate()
        p.join(timeout=5)
    if self._owns_root:
      shutil.rmtree(self._root, ignore_errors=True)

  # -- internals -------------------------------------------------------------

  def _new_job(self, num_tasks: int) -> EngineJob:
    job = EngineJob(num_tasks)
    job._task_specs = {}   # task_id -> (fn_bytes, data_bytes, pinned_slot)
    with self._lock:
      job.job_id = self._next_job_id
      self._next_job_id += 1
      self._jobs[job.job_id] = job
    return job

  def _schedule_locked(self) -> None:
    """Assign queued tasks to idle executors (caller holds self._lock)."""
    for slot in list(self._idle):
      task = None
      if self._pinned[slot]:
        task = self._pinned[slot].popleft()
      elif self._shared:
        task = self._shared.popleft()
      if task is not None:
        self._idle.discard(slot)
        self._running[slot] = (task[0], task[1], task[2])
        self._task_qs[slot].put(task)

  def _collect(self) -> None:
    while not self._stopped.is_set():
      try:
        slot, job_id, task_id, attempt, status, payload = \
            self._result_q.get(timeout=0.25)
      except Exception:  # noqa: BLE001 - queue.Empty or closed queue
        continue
      with self._lock:
        self._running.pop(slot, None)
        self._idle.add(slot)
        self._schedule_locked()
        job = self._jobs.get(job_id)
      if job is None:
        continue
      if status == "ok":
        job._task_finished(task_id, result=pickle.loads(payload),
                           attempt=attempt)
      else:
        job._task_finished(task_id, error=payload, attempt=attempt)
      if job.done():
        # evict finished jobs so the engine doesn't pin every job's results
        # forever (the lazy map path depends on this for bounded memory)
        with self._lock:
          self._jobs.pop(job_id, None)

  def _monitor_procs(self) -> None:
    """Detect executor processes that died (SIGKILL, OOM, crash): fail the
    in-flight task with the ExecutorLost marker and respawn the slot."""
    while not self._stopped.wait(0.2):
      for slot in range(self._num_executors):
        if self._stopped.is_set():
          return
        if self._procs[slot].is_alive():
          continue
        dead_job = None
        with self._lock:
          if self._stopped.is_set():
            return
          proc = self._procs[slot]
          if proc.is_alive():
            continue
          pid = proc.pid
          running = self._running.pop(slot, None)
          if running is not None:
            dead_job = self._jobs.get(running[0])
          wd = os.path.join(self._root, "executor_%d" % slot)
          # FRESH task queue: a process SIGKILLed while blocked in
          # task_q.get() dies holding the queue's reader lock, poisoning
          # it for any successor. Nothing pending is lost — the scheduler
          # dispatches at most one task per slot, and that task (if any)
          # was just failed above. (Known gap: the SHARED result_q has a
          # microsecond analogue — a kill landing mid-result-put holds its
          # write lock; fixing that needs per-slot result queues.)
          self._task_qs[slot] = self._ctx.Queue()
          new = self._ctx.Process(
              target=_executor_main,
              args=(slot, wd, self._task_qs[slot], self._result_q, self._env),
              daemon=False, name="local-executor-%d" % slot)
          new.start()
          self._procs[slot] = new
          self._idle.add(slot)
          self._schedule_locked()
        logger.warning("executor slot %d (pid %s) died; respawned as pid %d",
                       slot, pid, new.pid)
        if dead_job is not None:
          dead_job._task_finished(
              running[1],
              error="%s: executor process (slot %d, pid %s) died while "
                    "running task %d of job %d — killed or crashed without "
                    "a traceback" % (EXECUTOR_LOST, slot, pid, running[1],
                                     running[0]),
              attempt=running[2])

  def __del__(self):
    try:
      self.stop()
    except Exception:  # noqa: BLE001
      pass
