"""ML pipeline: the Estimator/Model API over the cluster layer.

The port's copy of ``tensorflowonspark_tpu/pipeline.py`` (TensorFlowOnSpark's
``pipeline.py``), without Spark ML:

- ``Namespace`` + ``TFParams.merge_args_params`` give the layered config
  merge;
- the ``Has*`` param mixins exist with the same names and setter/getter
  surface, generated over a lightweight Params base;
- ``TFEstimator.fit`` launches a cluster in ENGINE (SPARK) input mode,
  feeds the dataset, shuts down with a grace period and returns a
  ``TFModel``;
- ``TFModel.transform`` runs independent single-node inference per
  executor with a per-process bundle cache;
- ``yield_batch`` batches rows for the predict fn.

The model artifact is a *bundle* directory:
  ``<export_dir>/model/``          ``compat.export_model``'s checkpoint of
                                   the params (``state.pt`` + ``state.json``)
  ``<export_dir>/predict.pkl``     the pickled ``predict_fn(params, batch)``
  ``<export_dir>/signature.json``  the outputs' names, dtypes and shapes
                                   (when recorded)
where ``batch`` is a dict of stacked numpy arrays keyed by input tensor
names, and the fn returns a dict keyed by output tensor names.

What differs from the reference: the predict fn is pickled with the
standard ``pickle`` (the reference uses cloudpickle), so it must be a
module-level function or an instance of a module-level class —
:func:`export_bundle` refuses a lambda or a closure with a ``ValueError``
at export, not later inside an executor; the params checkpoint is the
port's ``torch.save`` format, not orbax, so bundles do not cross between
the packages (only ``signature.json`` reads the same); and a task claims
its CUDA cards through ``utils.gpu_info`` (``nvidia-smi``), where the
reference claims TPU chips.
"""

import argparse
import json
import logging
import os
import pickle
import time
from typing import Dict, Iterable, List, Optional, Sequence

from tensorflowonspark_tpu_torch import cluster as cluster_lib
from tensorflowonspark_tpu_torch.cluster import InputMode

logger = logging.getLogger(__name__)


class Namespace(dict):
  """argparse-compatible bag of arguments.

  Accepts a dict, an ``argparse.Namespace``, a list of argv strings, or
  another Namespace; attribute and item access are interchangeable.
  """

  def __init__(self, d=None):
    super().__init__()
    if d is None:
      return
    if isinstance(d, (list, tuple)):
      self["argv"] = list(d)
    elif isinstance(d, argparse.Namespace):
      self.update(vars(d))
    elif isinstance(d, dict):
      self.update(d)
    else:
      raise TypeError("unsupported Namespace source: %r" % type(d))

  def __getattr__(self, name):
    try:
      return self[name]
    except KeyError:
      raise AttributeError(name)

  def __setattr__(self, name, value):
    self[name] = value


# --- lightweight Spark-ML-style Params --------------------------------------


class Params(object):
  """Minimal Params base: declared params become get/set pairs."""

  _params: Dict[str, object]

  def __init__(self):
    self._params = {}

  def _declare(self, name: str, default=None):
    self._params.setdefault(name, default)

  def _set(self, **kwargs):
    for k, v in kwargs.items():
      self._params[k] = v
    return self

  def _get(self, name: str):
    return self._params.get(name)


def _mixin(name: str, param: str, default=None, cap: Optional[str] = None):
  """Build a Has<X> mixin exposing set<X>/get<X>."""
  cap = cap or "".join(p.capitalize() for p in param.split("_"))

  def setter(self, value):
    self._declare(param, default)
    return self._set(**{param: value})

  def getter(self):
    self._declare(param, default)
    return self._get(param)

  return type(name, (object,), {"set" + cap: setter, "get" + cap: getter,
                                "_param_name": param,
                                "_param_default": default})


HasBatchSize = _mixin("HasBatchSize", "batch_size", 100)
HasClusterSize = _mixin("HasClusterSize", "cluster_size", 1)
HasNumPS = _mixin("HasNumPS", "num_ps", 0, cap="NumPS")
HasInputMapping = _mixin("HasInputMapping", "input_mapping")
HasOutputMapping = _mixin("HasOutputMapping", "output_mapping")
HasInputMode = _mixin("HasInputMode", "input_mode", InputMode.ENGINE)
HasMasterNode = _mixin("HasMasterNode", "master_node", "chief")
HasModelDir = _mixin("HasModelDir", "model_dir")
HasExportDir = _mixin("HasExportDir", "export_dir")
HasEpochs = _mixin("HasEpochs", "epochs", 1)
HasGraceSecs = _mixin("HasGraceSecs", "grace_secs", 30)
HasReservationTimeout = _mixin("HasReservationTimeout",
                               "reservation_timeout", 600)
HasFeedTimeout = _mixin("HasFeedTimeout", "feed_timeout", 600)
HasTensorboard = _mixin("HasTensorboard", "tensorboard", False)
HasSignatureDefKey = _mixin("HasSignatureDefKey", "signature_def_key",
                            "serving_default")
HasChipsPerNode = _mixin("HasChipsPerNode", "chips_per_node", 0)
HasProtocol = _mixin("HasProtocol", "protocol", "grpc")


class TFParams(Params, HasBatchSize, HasClusterSize, HasNumPS,
               HasInputMapping, HasOutputMapping, HasInputMode,
               HasMasterNode, HasModelDir, HasExportDir, HasEpochs,
               HasGraceSecs, HasReservationTimeout, HasFeedTimeout,
               HasTensorboard, HasSignatureDefKey, HasChipsPerNode,
               HasProtocol):
  """All pipeline params."""

  def merge_args_params(self, args) -> Namespace:
    """Overlay set params onto a Namespace of args."""
    merged = Namespace(args)
    merged.update(self._params)
    return merged


# --- model bundle -----------------------------------------------------------


def _check_picklable(predict_fn) -> bytes:
  """``predict_fn`` pickled by name, or a ``ValueError`` saying what it
  must be: the executors load it with the standard ``pickle``."""
  fn = predict_fn if callable(predict_fn) and hasattr(
      predict_fn, "__qualname__") else type(predict_fn)
  qualname = getattr(fn, "__qualname__", "")
  why = None
  if "<lambda>" in qualname or "<locals>" in qualname:
    why = "%s is a lambda or a closure" % qualname
  else:
    try:
      return pickle.dumps(predict_fn)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
      why = "%s does not pickle: %s" % (qualname or type(predict_fn), e)
  raise ValueError(
      "export_bundle: the predict fn must be a module-level function or "
      "an instance of a module-level class, importable by name where the "
      "bundle is loaded (the port pickles with the standard pickle); %s"
      % why)


def export_bundle(params, predict_fn, export_dir: str,
                  is_chief: bool = True, example_batch=None,
                  output_signature: Optional[Dict] = None) -> str:
  """Write the model bundle (the params' checkpoint + the pickled predict
  fn) and return the directory written (a temporary one off the chief).

  When ``example_batch`` (a dict of input arrays) is given, the predict fn
  runs once at export time and the bundle records an output SIGNATURE —
  output names, dtypes and trailing shapes — so serving derives its output
  schema from the model without the caller re-declaring it.
  ``output_signature`` may instead declare it explicitly:
  ``{name: {"dtype": ..., "shape": [...]}}``.
  """
  from tensorflowonspark_tpu_torch.utils import compat

  blob = _check_picklable(predict_fn)
  target = compat.export_model(params, export_dir, is_chief)
  with open(os.path.join(target, "predict.pkl"), "wb") as f:
    f.write(blob)

  signature = dict(output_signature) if output_signature else None
  inputs = None
  if example_batch is not None:
    import numpy as np
    inputs = sorted(example_batch)
    out = predict_fn(params, example_batch)
    if not isinstance(out, dict):
      out = {"output": out}
    signature = {
        name: {"dtype": str(np.asarray(a).dtype),
               # leading batch dim is caller-determined; record the rest
               "shape": [None] + list(np.asarray(a).shape[1:])}
        for name, a in out.items()}
  if signature is not None:
    with open(os.path.join(target, "signature.json"), "w") as f:
      json.dump({"inputs": inputs, "outputs": signature}, f, indent=2)
  return target


def load_signature(export_dir: str) -> Optional[Dict]:
  """The bundle's recorded IO signature, or None for pre-signature
  bundles: ``{"inputs": [names] | None, "outputs": {name: {dtype, shape}}}``.
  """
  path = os.path.join(export_dir, "signature.json")
  if not os.path.exists(path):
    return None
  with open(path) as f:
    return json.load(f)


def signature_output_names(export_dir: str) -> Optional[List[str]]:
  """The bundle signature's output columns in serving order (sorted), or
  None for pre-signature bundles. The ONE derivation both TFModel.transform
  and the inference CLI use, so column names and value order can never
  drift apart."""
  sig = load_signature(export_dir)
  if sig and sig.get("outputs"):
    return sorted(sig["outputs"])
  return None


def _host_local_slot(workers_per_host: int):
  """Claim a free host-local worker slot from a flock'd slot file.

  Spark offers no guarantee that tasks co-located on one host carry
  non-congruent partition ids. A per-host slot file (``fcntl.flock`` over
  a tmp path, keyed by uid) hands each claiming process a distinct free
  slot instead. Returns None when the slot file is unusable or exhausted;
  callers fall back to the partition-id heuristic.

  The file holds a ``{slot: claiming pid}`` map — the same JSON the JAX
  package writes, so tasks of either package on one host share it:
  claims by dead processes are reclaimed; when every slot is held by a
  live process (oversubscription) the claim returns None. The open
  refuses symlinks and the lock wait is bounded.
  """
  import fcntl
  import tempfile
  import time
  path = os.path.join(tempfile.gettempdir(),
                      "tos_transform_slots.%d" % os.getuid())
  try:
    fd = os.open(path,
                 os.O_RDWR | os.O_CREAT | getattr(os, "O_NOFOLLOW", 0),
                 0o600)
  except OSError:
    return None
  try:
    for _ in range(50):
      try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        break
      except OSError:
        time.sleep(0.1)
    else:
      return None
    try:
      raw = os.read(fd, 1 << 16).strip()
      try:
        claims = {int(s): int(p) for s, p in json.loads(raw).items()} \
            if raw else {}
      except (ValueError, AttributeError):
        claims = {}

      def _alive(pid):
        try:
          os.kill(pid, 0)
          return True
        except OSError:
          return False

      claims = {s: p for s, p in claims.items()
                if 0 <= s < workers_per_host and _alive(p)}
      me = os.getpid()
      for s, p in claims.items():
        if p == me:  # idempotent under worker reuse: keep the held slot
          return s
      free = [s for s in range(workers_per_host) if s not in claims]
      if not free:
        return None
      claims[free[0]] = os.getpid()
      os.lseek(fd, 0, os.SEEK_SET)
      os.ftruncate(fd, 0)
      os.write(fd, json.dumps({str(s): p
                               for s, p in claims.items()}).encode())
      return free[0]
    finally:
      fcntl.flock(fd, fcntl.LOCK_UN)
  except OSError:
    return None
  finally:
    os.close(fd)


def _transform_worker_slot(workers_per_host: int = 0) -> int:
  """This task's host-local worker index for card placement.

  LocalEngine executors export ``TOS_EXECUTOR_SLOT``. Spark tasks claim
  a slot from the host-local slot file when ``workers_per_host`` is known
  (see ``_host_local_slot``), falling back to their partition id (a
  heuristic: congruent partition ids co-located on one host would
  double-claim). Anything else gets slot 0.
  """
  slot = os.environ.get("TOS_EXECUTOR_SLOT")
  if slot is not None:
    return int(slot)
  try:
    from pyspark import TaskContext
    ctx = TaskContext.get()
    if ctx is not None:
      if workers_per_host > 0:
        claimed = _host_local_slot(workers_per_host)
        if claimed is not None:
          return claimed
      return ctx.partitionId()
  except ImportError:
    pass
  return 0


def _allocate_transform_chips(chips_per_node: int) -> None:
  """Claim this task's card share before CUDA initializes.

  No-op without ``chips_per_node``, in test mode (``TOS_TPU_TEST_MODE``),
  or when this executor process claimed already. The host's cards are
  counted by ``nvidia-smi``; ``workers_per_host = max(1, cards //
  chips_per_node)``, so tasks past the card count share cards (a
  one-card host gives every task card 0).
  """
  from tensorflowonspark_tpu_torch.utils import gpu_info
  if not chips_per_node or os.environ.get(gpu_info.ENV_TEST_MODE):
    return
  if os.environ.get(gpu_info.ENV_CHIP_ENV_APPLIED):
    return  # a prior task on this executor process already claimed cards
  gpus = gpu_info.query_gpus()
  workers_per_host = max(1, len(gpus) // chips_per_node)
  slot = _transform_worker_slot(workers_per_host) % workers_per_host
  gpu_info.apply_chip_env(gpu_info.chip_env_for_worker(
      chips_per_node, slot, workers_per_host, len(gpus)))


# per-executor-process bundle cache
_bundle_cache: Dict[str, tuple] = {}

#: per-process record of the pipeline's serving: the seconds spent loading
#: bundles, and the seconds from this process's first transform task's
#: start to its first batch's outputs (card claim, bundle load and first
#: predict included)
TRANSFORM_STATS = {"load_s": 0.0, "first_batch_s": None}


def load_bundle(export_dir: str):
  """Load (params, predict_fn), cached per process. The params come back
  as ``compat.import_model`` gives them: the exported tree of CPU
  tensors and numpy arrays."""
  from tensorflowonspark_tpu_torch.utils import compat

  key = os.path.abspath(export_dir)
  if key not in _bundle_cache:
    t0 = time.monotonic()
    params = compat.import_model(export_dir)
    with open(os.path.join(export_dir, "predict.pkl"), "rb") as f:
      predict_fn = pickle.load(f)
    _bundle_cache[key] = (params, predict_fn)
    TRANSFORM_STATS["load_s"] += time.monotonic() - t0
    logger.info("loaded model bundle from %s", export_dir)
  return _bundle_cache[key]


def yield_batch(iterable: Iterable, batch_size: int,
                num_tensors: int = 1):
  """Group rows into lists-of-columns batches.

  Yields lists of ``num_tensors`` column lists.
  """
  cols: List[List] = [[] for _ in range(num_tensors)]
  count = 0
  for row in iterable:
    if num_tensors == 1 and not isinstance(row, (tuple, list)):
      row = (row,)
    for i in range(num_tensors):
      cols[i].append(row[i])
    count += 1
    if count >= batch_size:
      yield cols
      cols = [[] for _ in range(num_tensors)]
      count = 0
  if count > 0:
    yield cols


# --- Estimator / Model ------------------------------------------------------


class TFEstimator(TFParams):
  """Trains a model on a cluster and produces a TFModel.

  ``train_fn(args, ctx)`` is the user main function (module-level: it is
  pickled by name); it should consume the DataFeed and, on the chief,
  call ``pipeline.export_bundle`` with ``args.export_dir``.
  """

  def __init__(self, train_fn, tf_args=None, export_fn=None):
    super().__init__()
    self.train_fn = train_fn
    self.tf_args = tf_args if tf_args is not None else {}
    self.export_fn = export_fn

  def fit(self, engine, partitions: Sequence) -> "TFModel":
    """Launch a cluster, feed the dataset, return the trained TFModel."""
    args = self.merge_args_params(self.tf_args)
    cluster_size = args.get("cluster_size") or engine.num_executors
    logger.info("fitting TFEstimator on %d executor(s)", cluster_size)

    input_mode = args.get("input_mode", InputMode.ENGINE)
    cluster = cluster_lib.run(
        engine, self.train_fn, tf_args=args,
        num_executors=cluster_size,
        num_ps=args.get("num_ps", 0),
        tensorboard=bool(args.get("tensorboard")),
        input_mode=input_mode,
        log_dir=args.get("model_dir"),
        master_node=args.get("master_node", "chief"),
        reservation_timeout=args.get("reservation_timeout", 600),
        chips_per_node=args.get("chips_per_node", 0))
    if input_mode == InputMode.ENGINE:
      cluster.train(partitions, num_epochs=args.get("epochs", 1),
                    feed_timeout=args.get("feed_timeout", 600))
    # FILES mode: the main fn reads its own data; nothing to feed
    cluster.shutdown(grace_secs=args.get("grace_secs", 30))

    model = TFModel(self.tf_args)
    model._params.update(self._params)
    return model


def _stack_column(col):
  """A batch column as one array; variable-length rows (mixed-length
  generation prompts) cannot stack rectangularly, so they become an
  object column — serving predict fns route those through the
  continuous-batching engine (``models.transformer.
  make_serving_predict_fn``)."""
  import numpy as np
  try:
    return np.asarray(col)
  except ValueError:
    arr = np.empty(len(col), object)
    arr[:] = col
    return arr


class _TransformPartition(object):
  """The engine task of :meth:`TFModel.transform`: claims the task's card
  share, loads the bundle (cached per process) and runs its predict fn
  over the partition's rows, ``batch_size`` at a time. A module-level
  class, so the task pickles by name."""

  def __init__(self, export_dir: str, input_tensors, output_tensors,
               batch_size: int, chips_per_node: int):
    self.export_dir = export_dir
    self.input_tensors = input_tensors
    self.output_tensors = output_tensors
    self.batch_size = batch_size
    self.chips_per_node = chips_per_node

  def __call__(self, iterator):
    import numpy as np
    t0 = time.monotonic()
    # N parallel inference tasks on one host claim DISJOINT cards (the
    # allocation parallel/runner.py does) — before the bundle load
    # initializes CUDA
    _allocate_transform_chips(self.chips_per_node)
    params, predict_fn = load_bundle(self.export_dir)
    results = []
    n_cols = len(self.input_tensors) if self.input_tensors else 1
    for cols in yield_batch(iterator, self.batch_size, n_cols):
      if self.input_tensors:
        batch = {name: _stack_column(col)
                 for name, col in zip(self.input_tensors, cols)}
      else:
        batch = {"input": _stack_column(cols[0])}
      out = predict_fn(params, batch)
      if not isinstance(out, dict):
        out = {"output": out}
      names = self.output_tensors or sorted(out)
      arrays = [np.asarray(out[n]) for n in names]
      for i in range(len(arrays[0])):
        row = tuple(a[i].tolist() for a in arrays)
        results.append(row[0] if len(row) == 1 else row)
      if TRANSFORM_STATS["first_batch_s"] is None:
        TRANSFORM_STATS["first_batch_s"] = time.monotonic() - t0
    return results


class TFModel(TFParams):
  """Batch inference with independent per-executor model instances."""

  def __init__(self, tf_args=None):
    super().__init__()
    self.tf_args = tf_args if tf_args is not None else {}

  def transform(self, engine, partitions: Sequence, collect: bool = True):
    """Run the exported bundle over partitioned rows.

    Rows are tuples ordered by ``sorted(input_mapping)`` columns; outputs
    are tuples ordered by ``sorted(output_mapping)`` tensor names (or, with
    no mapping, by the bundle's signature).

    ``collect=False`` returns the engine's lazy handle instead of a
    driver-side list (LocalEngine: a generator streaming one window of
    partitions at a time), for cluster-scale inference.
    """
    args = self.merge_args_params(self.tf_args)
    export_dir = args.get("export_dir") or args.get("model_dir")
    if not export_dir:
      raise ValueError("TFModel requires export_dir (or model_dir)")
    input_mapping = args.get("input_mapping") or {}
    output_mapping = args.get("output_mapping") or {}
    input_tensors = [input_mapping[c] for c in sorted(input_mapping)] \
        if input_mapping else None
    output_tensors = sorted(output_mapping) if output_mapping else None
    if output_tensors is None:
      # the bundle's recorded signature declares the output columns
      # ahead of execution
      output_tensors = signature_output_names(export_dir)
    fn = _TransformPartition(export_dir, input_tensors, output_tensors,
                             args.get("batch_size", 100),
                             args.get("chips_per_node", 0) or 0)
    if collect:
      return engine.map_partitions(partitions, fn,
                                   timeout=args.get("feed_timeout", 600))
    return engine.map_partitions_lazy(partitions, fn,
                                      timeout=args.get("feed_timeout", 600))
