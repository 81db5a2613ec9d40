"""Role compatibility shims for user main functions.

The port's counterpart of ``tensorflowonspark_tpu/utils/compat.py``. The
load-bearing behaviour is *chief-only export* (TensorFlowOnSpark's
``compat.py:10-31``): every worker calls :func:`export_model`, but only
the chief writes to the real destination; the others write to a throwaway
local directory, so export code that every node runs still runs on all of
them. The exported artifact is the checkpoint format of
:mod:`~tensorflowonspark_tpu_torch.utils.checkpoint` (``state.pt`` +
``state.json``) in ``<export_dir>/model``.

The reference's ``jax_shard_map`` and ``jax_axis_size`` paper over JAX
versions inside ``shard_map`` bodies; PyTorch has no counterpart to shim,
so the port has neither.
"""

import logging
import os
import shutil
import tempfile

from tensorflowonspark_tpu_torch.data import fs
from tensorflowonspark_tpu_torch.utils import checkpoint

logger = logging.getLogger(__name__)


def export_model(state, export_dir: str, is_chief: bool) -> str:
  """Export ``state`` (a tree of tensors, e.g. a TrainState's params);
  the chief writes to ``export_dir``, the others to a temporary dir.

  ``<dir>/model`` is written under a temporary name and renamed into
  place, replacing an earlier export. A remote ``export_dir`` (fsspec)
  has no rename: an earlier export is removed and the new one written in
  place, its tree last (a cut-short export does not load). Returns the
  directory written to. A train state cut over a mesh is gathered whole
  first (``checkpoint.whole_state``), so EVERY rank of its mesh calls
  this, chief or not, and the export holds the whole weights and
  optimizer state, as one process's would. Pass the train state (or
  ``parallel.sharding.gather_state(state).params``): a bare
  ``state.params`` dict of a cut state is this rank's blocks.
  """
  state = checkpoint.whole_state(state)
  target = checkpoint.storage_dir(export_dir) if is_chief else \
      tempfile.mkdtemp(prefix="nonchief_export_")
  if fs.is_remote(target):
    final = fs.join(target, "model")
    if fs.exists(final):
      fs.remove_tree(final)
    checkpoint.save_tree(final, state)
    logger.info("exported model to %s (chief=%s)", target, is_chief)
    return target
  os.makedirs(target, exist_ok=True)
  tmp = os.path.join(target, ".model.tmp-%d" % os.getpid())
  shutil.rmtree(tmp, ignore_errors=True)
  checkpoint.save_tree(tmp, state)
  checkpoint.commit_dir(tmp, os.path.join(target, "model"))
  logger.info("exported model to %s (chief=%s)", target, is_chief)
  return target


def import_model(export_dir: str, template=None):
  """Load a state written by :func:`export_model`: into ``template`` in
  place (a train state cut over a mesh keeps this rank's blocks, on any
  mesh: ``parallel.sharding.cut_state``), or (no template) as plain
  containers of CPU tensors."""
  path = fs.join(checkpoint.storage_dir(export_dir), "model")
  return checkpoint.load_tree(path, template)


def is_gpu_available() -> bool:
  """True when ``nvidia-smi`` lists a card on this host (the port's
  counterpart of the reference's ``is_tpu_available``)."""
  import subprocess
  from tensorflowonspark_tpu_torch.utils import gpu_info
  try:
    return bool(gpu_info.query_gpus())
  except (OSError, RuntimeError, subprocess.SubprocessError):
    return False


def disable_auto_shard(options) -> None:
  """No-op (parity stub: TensorFlowOnSpark's ``compat.py:20-24`` disabled
  tf.data auto-sharding; the port's feed plane shards by executor)."""
  logger.debug("disable_auto_shard: no-op on the PyTorch path")
