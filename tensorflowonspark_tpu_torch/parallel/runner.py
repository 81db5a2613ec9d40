"""Independent-parallel runner: N single-node instances, no cluster.

The port's copy of ``tensorflowonspark_tpu/parallel/runner.py``
(TensorFlowOnSpark's ``TFParallel.run``): run a user fn once per
executor, optionally gang-scheduled under barrier execution with
placement info, with each task's CUDA cards claimed before CUDA starts —
used for embarrassingly parallel batch inference.

The tasks travel by the standard ``pickle``: ``map_fn`` must be a
module-level function (or an instance of a module-level class), and the
task bodies are instances of the module-level classes below.
"""

import logging
import os
from typing import List, Optional

from tensorflowonspark_tpu_torch.engine.base import Engine
from tensorflowonspark_tpu_torch.node import NodeContext
from tensorflowonspark_tpu_torch.utils import gpu_info

logger = logging.getLogger(__name__)


def _task_body(map_fn, tf_args, chips_per_node: int, task_id: int,
               addresses: List[str]):
  """Claim the task's card share, then run ``map_fn(tf_args, ctx)``."""
  if chips_per_node and not os.environ.get(gpu_info.ENV_TEST_MODE):
    cards = len(gpu_info.query_gpus())
    workers_per_host = max(1, cards // chips_per_node)
    gpu_info.apply_chip_env(gpu_info.chip_env_for_worker(
        chips_per_node, task_id, workers_per_host, cards))
  ctx = NodeContext(
      executor_id=task_id, job_name="worker", task_index=task_id,
      cluster_spec={"worker": addresses}, working_dir=os.getcwd())
  return map_fn(tf_args, ctx)


class _BarrierTask(object):
  """A gang member: its ctx carries every member's address."""

  def __init__(self, map_fn, tf_args, chips_per_node: int):
    self.map_fn = map_fn
    self.tf_args = tf_args
    self.chips_per_node = chips_per_node

  def __call__(self, it, barrier_ctx):
    task_id = next(iter(it))
    return _task_body(self.map_fn, self.tf_args, self.chips_per_node,
                      task_id, barrier_ctx.get_task_infos())


class _PlainTask(_BarrierTask):
  """A task of the non-barrier path: no placement info."""

  def __call__(self, it):
    task_id = next(iter(it))
    return _task_body(self.map_fn, self.tf_args, self.chips_per_node,
                      task_id, [])


def run(engine: Engine, map_fn, tf_args=None,
        num_tasks: Optional[int] = None, use_barrier: bool = True,
        chips_per_node: int = 0, timeout: Optional[float] = None) -> List:
  """Run ``map_fn(tf_args, ctx)`` on ``num_tasks`` independent executors.

  With ``use_barrier`` the tasks are gang-scheduled and each ctx carries the
  addresses of all gang members (``BarrierTaskContext.getTaskInfos``).
  ``chips_per_node=k`` gives task *i* cards ``[i*k, (i+1)*k)`` of its
  host's ``nvidia-smi`` count (tasks past the count wrap around and share).
  Returns the per-task results.
  """
  n = num_tasks if num_tasks is not None else engine.num_executors
  if use_barrier:
    return engine.barrier_run(_BarrierTask(map_fn, tf_args, chips_per_node),
                              num_tasks=n, timeout=timeout)
  return engine.run_on_executors(
      _PlainTask(map_fn, tf_args, chips_per_node), num_tasks=n).wait(
          timeout=timeout)
