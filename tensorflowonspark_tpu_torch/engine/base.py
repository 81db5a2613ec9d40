"""Engine interface: what the cluster layer needs from an executor engine.

The port's copy of ``tensorflowonspark_tpu/engine/base.py``, unchanged.
Derived from how TensorFlowOnSpark drives Spark (TFCluster.py / TFSparkNode.py /
TFParallel.py):

- enumerate N persistent executors and run a function once on each
  (``nodeRDD.foreachPartition`` — node bring-up, shutdown jobs),
- stream partitioned data through whichever executors are free
  (``dataRDD.foreachPartition`` — feeding; ``dataRDD.mapPartitions`` —
  inference with collected results),
- gang-schedule with placement info (``rdd.barrier().mapPartitions``),
- replicate a dataset for epochs (``sc.union([rdd]*n)``).

Scheduling semantics the cluster layer RELIES on (Spark parity):

1. An executor runs one task at a time; a task that blocks keeps its executor
   busy (this is how ps/evaluator slots are kept out of feed scheduling —
   reference TFCluster.py:12-13).
2. ``run_on_executors`` places exactly one task on each distinct executor.
3. Queued tasks go to any executor that becomes free.
"""

import abc
import threading
import time
from typing import Callable, Iterable, List, Optional, Sequence

#: Error-string prefix engines use when a task died WITH its executor
#: (process killed / crashed without a traceback) — an infrastructure
#: failure, as opposed to an application exception. The cluster-layer
#: supervisor restarts the former and propagates the latter untouched.
EXECUTOR_LOST = "ExecutorLost"


def is_executor_lost(error: Optional[str]) -> bool:
  """True when a task error marks an executor-death (restartable) failure."""
  return bool(error) and error.startswith(EXECUTOR_LOST)


class EngineJob(object):
  """Handle for an asynchronously running set of tasks."""

  def __init__(self, num_tasks: int):
    self.num_tasks = num_tasks
    self.results: List[object] = [None] * num_tasks
    self.errors: List[Optional[str]] = [None] * num_tasks
    self._completed = [False] * num_tasks
    #: per-task attempt counter, bumped by _task_restarted: completions
    #: carry the attempt they belong to, so a stale report from a
    #: superseded attempt (e.g. the executor-death monitor observing the
    #: OLD process after a supervised relaunch was queued) cannot poison
    #: the replacement attempt's bookkeeping
    self._attempt = [0] * num_tasks
    self._done = 0
    self._cond = threading.Condition()

  def _task_finished(self, task_id: int, result=None,
                     error: Optional[str] = None,
                     attempt: Optional[int] = None):
    with self._cond:
      if attempt is not None and attempt != self._attempt[task_id]:
        return   # a superseded attempt reporting late: ignore
      if self._completed[task_id]:
        # late duplicate (e.g. a speculative attempt): first wins
        return
      self._completed[task_id] = True
      self.results[task_id] = result
      self.errors[task_id] = error
      self._done += 1
      self._cond.notify_all()

  def _task_restarted(self, task_id: int) -> int:
    """Reset one task's bookkeeping for a supervised relaunch: waiters go
    back to blocking until the replacement attempt finishes. Returns the
    new attempt number the replacement must report completions under."""
    with self._cond:
      self._attempt[task_id] += 1
      if self._completed[task_id]:
        self._completed[task_id] = False
        self._done -= 1
      self.results[task_id] = None
      self.errors[task_id] = None
      self._cond.notify_all()
      return self._attempt[task_id]

  def done(self) -> bool:
    with self._cond:
      return self._done >= self.num_tasks

  def first_error(self) -> Optional[str]:
    with self._cond:
      for e in self.errors:
        if e is not None:
          return e
      return None

  def wait(self, timeout: Optional[float] = None, raise_on_error: bool = True):
    """Block until all tasks finish; raise the first task error by default.

    Event-driven: waiters sleep on the condition variable and are woken by
    task completions (no polling cadence; a ``timeout`` bounds the wait).
    """
    with self._cond:
      deadline = None if timeout is None else time.monotonic() + timeout
      while self._done < self.num_tasks:
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
          raise TimeoutError(
              "engine job timed out with %d/%d tasks finished"
              % (self._done, self.num_tasks))
        self._cond.wait(remaining)
    if raise_on_error:
      err = self.first_error()
      if err:
        raise RuntimeError("engine task failed:\n%s" % err)
    return self.results


class Engine(abc.ABC):
  """Abstract executor engine (see module docstring for the contract)."""

  @property
  @abc.abstractmethod
  def num_executors(self) -> int:
    ...

  @abc.abstractmethod
  def run_on_executors(self, fn: Callable[[Iterable], object],
                       num_tasks: Optional[int] = None,
                       task_payloads: Optional[Sequence] = None) -> EngineJob:
    """Run ``fn(iter([payload]))`` once on each of ``num_tasks`` distinct
    executors (async); payloads default to the task indices. Parity:
    nodeRDD.foreachPartition."""

  @abc.abstractmethod
  def foreach_partition(self, partitions: Sequence[Iterable],
                        fn: Callable[[Iterable], object]) -> EngineJob:
    """Run ``fn(iter(partition))`` for each partition on free executors
    (async). Parity: dataRDD.foreachPartition."""

  @abc.abstractmethod
  def map_partitions(self, partitions: Sequence[Iterable],
                     fn: Callable[[Iterable], Iterable],
                     timeout: Optional[float] = None) -> List:
    """Run ``fn`` per partition, collect and concatenate results (blocking).
    Parity: dataRDD.mapPartitions(...).collect()."""

  @abc.abstractmethod
  def map_partitions_lazy(self, partitions: Sequence[Iterable],
                          fn: Callable[[Iterable], Iterable],
                          timeout: Optional[float] = None):
    """Non-collecting ``map_partitions``: return an engine-native lazy
    handle — Spark: the mapped RDD (parity: reference TFCluster.inference
    returning an uncollected RDD, TFCluster.py:96-115); Local: a generator
    streaming per-partition results — so cluster-scale inference output
    never materializes on the driver. ``timeout`` bounds per-partition
    completion where the engine executes eagerly-on-consume (Local); on
    Spark the deadline belongs to the caller's eventual RDD action."""

  @abc.abstractmethod
  def barrier_run(self, fn: Callable[[Iterable, "BarrierContext"], object],
                  num_tasks: Optional[int] = None,
                  timeout: Optional[float] = None) -> List:
    """Gang-schedule ``fn(iter([task_id]), barrier_ctx)`` on distinct
    executors; all tasks start together and get placement info. Parity:
    rdd.barrier().mapPartitions with BarrierTaskContext (TFParallel.py:43-56).
    Raises if num_tasks exceeds available executors."""

  def preempt_task(self, job: EngineJob, task_id: int) -> bool:
    """Forcibly stop a task that is still IN FLIGHT (fault recovery).

    Used by the cluster supervisor before relaunching a node whose task
    never completed — a hung user fn keeps its executor busy forever, and
    a pinned relaunch could never schedule behind it. Returns True when
    the task's executor was killed (the engine will fail the attempt and
    recycle the slot); False when unsupported or the task is not running.
    """
    return False

  def relaunch_task(self, job: EngineJob, task_id: int, payload=None):
    """Re-run ONE task of a previously submitted job (fault recovery).

    The cluster supervisor calls this to replace a node whose executor
    died: the task's bookkeeping in ``job`` is reset (waiters block again
    until the replacement finishes) and the stored fn re-runs with the
    original payload — or ``payload`` when given (e.g. to hand the
    relaunched node its restart count). Engines that cannot resubmit
    individual tasks raise NotImplementedError.
    """
    raise NotImplementedError(
        "%s does not support supervised task relaunch" % type(self).__name__)

  #: True when every executor runs on THIS host (LocalEngine) — enables
  #: same-host-only transports like the shared-memory feed ring
  colocated_executors = False

  def default_fs(self) -> str:
    """Default filesystem URI for path normalization."""
    return "file://"

  def stop(self) -> None:
    """Release engine resources (no-op by default)."""


class BarrierContext(object):
  """Placement info + synchronization for barrier tasks.

  Parity: pyspark BarrierTaskContext — ``get_task_infos()`` lists the
  addresses of all gang members; ``barrier()`` is a global sync point.
  """

  def __init__(self, task_id: int, addresses: List[str],
               sync_fn: Optional[Callable[[], None]] = None):
    self.task_id = task_id
    self.addresses = addresses
    self._sync_fn = sync_fn

  def get_task_infos(self) -> List[str]:
    return list(self.addresses)

  def barrier(self) -> None:
    if self._sync_fn is not None:
      self._sync_fn()
