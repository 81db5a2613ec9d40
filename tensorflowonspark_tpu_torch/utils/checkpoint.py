"""Checkpoint/resume: a manager of step directories with commit markers.

The port's counterpart of ``tensorflowonspark_tpu/utils/checkpoint.py``.
It keeps the reference's surface and semantics: periodic saves keyed by
step with an interval-CROSSING rule, retention, chief-only writes, the
``.commit-<step>.json`` marker written last (byte for byte the reference's
format), and ``restore_or``'s fallback past a step that never committed.

Storage replaces orbax with ``torch.save``. Each step is a directory::

    <directory>/<step>/state.pt     {key: tensor}, written by torch.save
    <directory>/<step>/state.json   the tree those tensors belong to
    <directory>/<step>/data.json    the input pipeline's state (optional)
    <directory>/.commit-<step>.json {"step": <step>, "manifest": {...}}

The step is written under a temporary name, made durable and renamed into
place; the marker comes last. Loading uses ``torch.load(...,
weights_only=True)``: the tensors travel as a flat dict and the tree as
JSON, so nothing is unpickled.

What a state can be: a tree of ``dict`` / ``list`` / ``tuple`` /
``NamedTuple`` whose leaves are tensors, numpy arrays or Python scalars,
the optimizer states of :mod:`~tensorflowonspark_tpu_torch.optim`, or a
:class:`~tensorflowonspark_tpu_torch.train_state.TrainState` (its
``params`` by name, ``opt_state`` and ``step``; never the module or the
transformation). A restore writes IN PLACE into the template: each saved
tensor is ``copy_``'d into the template's tensor, on its device and in its
dtype, so the model's parameters that a train step holds stay the same
objects.

Neither the orbax layout nor the ``torch.save`` layout is read by the
other package; only the commit markers are shared. The port has no
counterpart of orbax's save-on-preemption signal (``reached_preemption``).
"""

import glob
import json
import logging
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: commit-marker file written next to each step after its save is durable
_MARKER_FMT = ".commit-%d.json"
_MARKER_PREFIX = ".commit-"
_MARKER_SUFFIX = ".json"

_TENSORS = "state.pt"
_TREE = "state.json"
_DATA = "data.json"
_FORMAT = 1


def atomic_write_json(path: str, payload: dict) -> None:
  """Commit ``payload`` to ``path`` via write-to-temp + fsync + atomic
  rename: a kill at any point leaves either no file or a complete one.
  Raises ``OSError`` on failure."""
  tmp = path + ".tmp"
  with open(tmp, "w") as f:
    json.dump(payload, f)
    f.flush()
    os.fsync(f.fileno())
  os.replace(tmp, path)


def local_dir(path: str) -> str:
  """``path`` as an absolute local directory. A remote URI is refused by
  name: the port reads and writes local paths and ``file://`` URIs only."""
  from tensorflowonspark_tpu_torch.data import fs
  if fs.is_remote(path):
    raise NotImplementedError(
        "remote storage (%r) for checkpoints and exports is not ported to "
        "PyTorch yet (ROADMAP Queue 1 item 15): local paths and file:// "
        "URIs only" % path.split("://", 1)[0])
  return os.path.abspath(fs.strip_scheme(path))


# -- the tree format -----------------------------------------------------------


def _object_types():
  from tensorflowonspark_tpu_torch import optim
  return {"_Count": optim._Count, "MultiStepsState": optim.MultiStepsState}


def _is_namedtuple(x) -> bool:
  return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_train_state(x) -> bool:
  from tensorflowonspark_tpu_torch.train_state import TrainState
  return isinstance(x, TrainState)


def _host(t: torch.Tensor) -> torch.Tensor:
  """``t`` on the host, owning exactly its own bytes (torch.save writes a
  view's whole storage)."""
  t = t.detach().cpu()
  if t.untyped_storage().nbytes() != t.numel() * t.element_size() \
      or not t.is_contiguous():
    t = t.clone(memory_format=torch.contiguous_format)
  return t


def _encode(x, path: str, tensors: Dict[str, torch.Tensor]) -> dict:
  """The JSON node of ``x``; its tensors go into ``tensors`` on the host.
  A container's node holds ``[key, node]`` pairs in order."""
  if torch.is_tensor(x):
    key = str(len(tensors))
    tensors[key] = _host(x)
    return {"t": "tensor", "key": key, "path": path}
  if isinstance(x, (np.ndarray, np.generic)):
    key = str(len(tensors))
    tensors[key] = _host(torch.from_numpy(np.array(x, ndmin=1)
                                          if isinstance(x, np.generic)
                                          else np.array(x)))
    return {"t": "scalar" if isinstance(x, np.generic) else "ndarray",
            "key": key, "path": path}
  if x is None or isinstance(x, (bool, int, float, str)):
    return {"t": "py", "v": x, "path": path}
  if _is_train_state(x):
    fields = (("params", x.params), ("opt_state", x.opt_state),
              ("step", int(x.step)))
    return {"t": "train_state", "items": [
        [k, _encode(v, "%s/%s" % (path, k), tensors)] for k, v in fields]}
  if isinstance(x, dict):
    for k in x:
      if not isinstance(k, str):
        raise TypeError("checkpoint dict keys must be str, got %r at %s"
                        % (k, path or "/"))
    pairs, t = x.items(), "dict"
  elif _is_namedtuple(x):
    pairs, t = zip(x._fields, x), "namedtuple"
  elif isinstance(x, (list, tuple)):
    pairs, t = ((str(i), v) for i, v in enumerate(x)), type(x).__name__
  elif _object_types().get(type(x).__name__) is type(x):
    pairs, t = vars(x).items(), "object"
  else:
    raise TypeError("cannot checkpoint a %s at %s" % (type(x).__name__,
                                                      path or "/"))
  node = {"t": t, "items": [[k, _encode(v, "%s/%s" % (path, k), tensors)]
                            for k, v in pairs]}
  if t in ("namedtuple", "object"):
    node["name"] = type(x).__name__
  return node


def _leaves(node: dict):
  """The leaf nodes of a tree, in order."""
  if "items" not in node:
    yield node
    return
  for _, child in node["items"]:
    yield from _leaves(child)


def _leaf(node: dict, tensors) -> Any:
  t = tensors[node["key"]]
  if node["t"] == "tensor":
    return t
  arr = t.numpy()
  return arr[0] if node["t"] == "scalar" else arr


def _decode(node: dict, tensors) -> Any:
  """The saved tree without a template: NamedTuples, optimizer state
  objects and a TrainState come back as dicts of their fields."""
  t = node["t"]
  if t in ("tensor", "ndarray", "scalar"):
    return _leaf(node, tensors)
  if t == "py":
    return node["v"]
  if t in ("list", "tuple"):
    items = [_decode(v, tensors) for _, v in node["items"]]
    return tuple(items) if t == "tuple" else items
  return {k: _decode(v, tensors) for k, v in node["items"]}


def _mismatch(path: str, what: str):
  return ValueError("checkpoint does not fit the template at %s: %s"
                    % (path or "/", what))


def _fields(node: dict, tmpl, path: str):
  """``tmpl``'s children by the keys of container ``node``; raises where
  the two differ in kind or keys."""
  t, keys = node["t"], [k for k, _ in node["items"]]
  if t == "dict":
    ok = isinstance(tmpl, dict)
  elif t == "namedtuple":
    ok = _is_namedtuple(tmpl) and type(tmpl).__name__ == node["name"]
  elif t == "object":
    ok = type(tmpl).__name__ == node["name"] and hasattr(tmpl, "__dict__")
  elif t == "train_state":
    ok = _is_train_state(tmpl)
  else:
    ok = (isinstance(tmpl, (list, tuple)) and not _is_namedtuple(tmpl)
          and type(tmpl).__name__ == t)
  if not ok:
    raise _mismatch(path, "a %s where a %s was saved"
                    % (type(tmpl).__name__, node.get("name", t)))
  if t == "dict":
    have = dict(tmpl)
  elif t == "namedtuple":
    have = dict(zip(tmpl._fields, tmpl))
  elif t == "object":
    have = dict(vars(tmpl))
  elif t == "train_state":
    have = {"params": tmpl.params, "opt_state": tmpl.opt_state,
            "step": tmpl.step}
  else:
    have = {str(i): v for i, v in enumerate(tmpl)}
  if sorted(have) != sorted(keys):
    raise _mismatch(path, "keys %s, saved %s" % (sorted(have), sorted(keys)))
  return have


@torch.no_grad()
def _restore(node: dict, tmpl, tensors, apply: bool, path: str = "") -> Any:
  """``node`` written into ``tmpl``: tensors ``copy_``'d in place (cast to
  the template's dtype, on its device), mutable containers and objects
  updated in place, tuples rebuilt. Raises ``ValueError`` where the two
  differ; with ``apply=False`` it only checks and changes nothing."""
  t = node["t"]
  if t in ("tensor", "ndarray", "scalar"):
    src = tensors[node["key"]]
    want = tuple(src.shape) if t != "scalar" else ()
    have = tuple(tmpl.shape) if torch.is_tensor(tmpl) else (
        np.shape(tmpl) if isinstance(tmpl, (np.ndarray, np.generic))
        else None)
    if have is None:
      raise _mismatch(path, "a %s where an array was saved"
                      % type(tmpl).__name__)
    if have != want and not (torch.is_tensor(tmpl) and t == "scalar"
                             and have in ((), (1,))):
      raise _mismatch(path, "shape %s, saved %s" % (have, want))
    if not apply:
      return tmpl
    if torch.is_tensor(tmpl):
      tmpl.copy_(src.reshape(tmpl.shape))
      return tmpl
    arr = np.asarray(_leaf(node, tensors), dtype=tmpl.dtype)
    return arr[()] if isinstance(tmpl, np.generic) else arr
  if t == "py":
    v = node["v"]
    if (v is None) != (tmpl is None) or \
        isinstance(v, str) != isinstance(tmpl, str):
      raise _mismatch(path, "%r, saved %r" % (tmpl, v))
    return v
  have = _fields(node, tmpl, path)
  out = {k: _restore(v, have[k], tensors, apply, "%s/%s" % (path, k))
         for k, v in node["items"]}
  if not apply:
    return tmpl
  if t == "namedtuple":
    return type(tmpl)(**out)
  if t == "tuple":
    return tuple(out[str(i)] for i in range(len(out)))
  if t == "list":
    tmpl[:] = [out[str(i)] for i in range(len(out))]
  elif t == "dict":
    tmpl.update(out)
  elif t == "object":
    for k, v in out.items():
      setattr(tmpl, k, v)
  else:   # train_state: the params were written in place
    tmpl.opt_state, tmpl.step = out["opt_state"], int(out["step"])
  return tmpl


def _fsync_dir(path: str) -> None:
  fd = os.open(path, os.O_RDONLY)
  try:
    os.fsync(fd)
  finally:
    os.close(fd)


def commit_dir(tmp: str, final: str) -> None:
  """Move the finished directory ``tmp`` to ``final`` durably: ``tmp``'s
  entries are fsynced, an earlier ``final`` is removed, the rename is
  fsynced in the parent."""
  _fsync_dir(tmp)
  if os.path.exists(final):
    shutil.rmtree(final)
  os.rename(tmp, final)
  _fsync_dir(os.path.dirname(final))


def save_tree(directory: str, tree: Any) -> Dict[str, float]:
  """Write ``tree`` into ``directory`` (created) as ``state.pt`` +
  ``state.json``, each fsynced. Returns the bytes written and the
  seconds of the copy to the host (``host_s``) and of the write
  (``write_s``)."""
  t0 = time.monotonic()
  tensors: Dict[str, torch.Tensor] = {}
  node = _encode(tree, "", tensors)
  t1 = time.monotonic()
  os.makedirs(directory, exist_ok=True)
  with open(os.path.join(directory, _TENSORS), "wb") as f:
    torch.save(tensors, f)
    f.flush()
    os.fsync(f.fileno())
  with open(os.path.join(directory, _TREE), "w") as f:
    json.dump({"format": _FORMAT, "tree": node}, f)
    f.flush()
    os.fsync(f.fileno())
  return {"bytes": sum(os.path.getsize(os.path.join(directory, n))
                       for n in (_TENSORS, _TREE)),
          "host_s": t1 - t0, "write_s": time.monotonic() - t1}


def load_tree(directory: str, template: Any = None) -> Any:
  """The tree :func:`save_tree` wrote: restored in place into
  ``template``, or (no template) as plain containers of CPU tensors and
  numpy arrays."""
  with open(os.path.join(directory, _TREE)) as f:
    meta = json.load(f)
  if meta.get("format") != _FORMAT:
    raise ValueError("unknown checkpoint format %r in %s"
                     % (meta.get("format"), directory))
  tensors = torch.load(os.path.join(directory, _TENSORS),
                       map_location="cpu", weights_only=True)
  if template is None:
    return _decode(meta["tree"], tensors)
  _restore(meta["tree"], template, tensors, apply=False)
  return _restore(meta["tree"], template, tensors, apply=True)


def params_fingerprint(tree: Any) -> str:
  """Cheap content fingerprint of a params tree: crc32 over every leaf's
  bytes folded with its path, shape and dtype (not cryptographic).

  The port's own print: the reference folds in a JAX treedef, so the two
  packages never give equal prints for the same weights. Where the leaves
  live (card or host) and whether they are ``Parameter``s does not enter.
  """
  import zlib
  tensors: Dict[str, torch.Tensor] = {}
  acc = 0
  for leaf in _leaves(_encode(tree, "", tensors)):
    if leaf["t"] == "py":
      acc = zlib.crc32(repr((leaf["path"], leaf["v"])).encode(), acc)
      continue
    t = tensors[leaf["key"]]
    acc = zlib.crc32(str((leaf["path"], tuple(t.shape),
                          str(t.dtype))).encode(), acc)
    acc = zlib.crc32(t.reshape(-1).view(torch.uint8).numpy().tobytes(), acc)
  return "%08x" % (acc & 0xFFFFFFFF)


# -- the manager ---------------------------------------------------------------


def _process_group():
  """``torch.distributed`` when a process group of more than one rank is
  up, else None."""
  import torch.distributed as dist
  if dist.is_available() and dist.is_initialized() \
      and dist.get_world_size() > 1:
    return dist
  return None


def _collective(group, value: int, least: bool = False) -> int:
  """Rank 0's ``value`` on every rank, or with ``least`` the least
  ``value`` of all ranks (then no rank returns before every rank has
  called it). Every rank calls it."""
  device = torch.device("cuda", torch.cuda.current_device()) \
      if group.get_backend() == "nccl" else torch.device("cpu")
  t = torch.tensor([value], dtype=torch.int64, device=device)
  if least:
    group.all_reduce(t, op=group.ReduceOp.MIN)
  else:
    group.broadcast(t, src=0)
  return int(t.item())


class CheckpointManager(object):
  """Periodic save / latest restore of a train state.

  Usage::

      mgr = CheckpointManager(model_dir, save_interval_steps=100)
      state, start_step = mgr.restore_or(state)     # resume if possible
      for step in range(start_step, num_steps):
          state, loss = train_step(state, batch)
          mgr.save(step, state, is_chief=ctx.is_chief)
      mgr.wait()

  With a checkpointable input pipeline (exact mid-epoch resume)::

      it = data.checkpointable_input(pattern, batch_size, seed=0)
      state, start_step = mgr.restore_or(state, data_iterator=it)
      for step, batch in enumerate(it, start=start_step):
          state, loss = train_step(state, batch)
          mgr.save(step, state, data_state=it.get_state())

  A save is synchronous: it returns after the step and its marker are
  durable, as the reference's does for a local directory. :meth:`wait`
  and :meth:`close` are kept for the reference's surface.
  """

  def __init__(self, directory: str, save_interval_steps: int = 100,
               max_to_keep: Optional[int] = 3,
               publish_hook: Optional[Any] = None):
    self.directory = local_dir(directory)
    os.makedirs(self.directory, exist_ok=True)
    self.save_interval_steps = save_interval_steps
    self.max_to_keep = max_to_keep
    #: ``publish_hook(step, state, manifest)`` fires after a save commits;
    #: best effort: a failure is logged, never fails the save
    self.publish_hook = publish_hook
    #: newest step this manager saved, and the newest on disk when it was
    #: made: in a process group every rank decides from these alone, since
    #: rank 0 may be renaming a later step into place meanwhile; there
    #: every rank makes its manager, and takes rank 0's newest step
    self._last_saved: Optional[int] = None
    self._latest_at_start = self.latest_step()
    group = _process_group()
    if group is not None:
      latest = _collective(group, -1 if self._latest_at_start is None
                           else self._latest_at_start)
      self._latest_at_start = None if latest < 0 else latest
    #: the newest step this process wrote: its bytes, and the seconds of
    #: the copy to the host, the write and the commit (rename, marker,
    #: retention)
    self.last_save: Dict[str, float] = {}

  # -- steps on disk -----------------------------------------------------------

  def _step_dir(self, step: int) -> str:
    return os.path.join(self.directory, str(int(step)))

  def all_steps(self):
    """Every step with a checkpoint in this directory (ascending)."""
    try:
      names = os.listdir(self.directory)
    except OSError:
      return []
    return sorted(int(n) for n in names if n.isdigit()
                  and os.path.isdir(os.path.join(self.directory, n)))

  def latest_step(self, refresh: bool = False) -> Optional[int]:
    """Newest checkpointed step, or None. The directory is scanned on
    every call, so ``refresh`` changes nothing here."""
    steps = self.all_steps()
    return steps[-1] if steps else None

  # -- save --------------------------------------------------------------------

  def save(self, step: int, state: Any, is_chief: bool = True,
           force: bool = False, data_state: Optional[dict] = None,
           manifest: Optional[dict] = None) -> bool:
    """Save if the step reached or crossed an interval boundary.

    ``data_state`` (a small JSON-safe dict, e.g.
    ``CheckpointableInput.get_state()``) rides in the same step, so model
    and input-pipeline state stay consistent; ``manifest`` rides in the
    commit marker.

    Roles: in a ``torch.distributed`` process group of more than one rank
    every rank calls ``save``, rank 0 writes, and all ranks then agree on
    its outcome before any returns: a failed write raises on every rank
    (``is_chief`` is ignored there, as the reference ignores it in a JAX
    process group). Without a process group only the chief writes.

    The decision is interval-CROSSING, not modulo: a fused train loop
    calls this once per slab with ``step`` jumping ``unroll`` at a time,
    and the save fires at the first call whose step reached or passed a
    boundary since the last saved step.
    """
    group = _process_group()
    if group is None and not is_chief:
      return False
    if not force and not self._due(step):
      return False
    if group is None:
      self._write(step, state, data_state, manifest)
      self._last_saved = int(step)
      return True
    error = None
    if group.get_rank() == 0:
      try:
        self._write(step, state, data_state, manifest)
      except Exception as e:  # noqa: BLE001 - raised below, on every rank
        error = e
    if not _collective(group, int(error is None), least=True):
      if error is not None:
        raise error
      raise RuntimeError("checkpoint save of step %d failed on rank 0"
                         % step)
    self._last_saved = int(step)
    return True

  def _write(self, step: int, state: Any, data_state: Optional[dict],
             manifest: Optional[dict]) -> None:
    final = self._step_dir(step)
    # a save of this step that died mid-write left its temporary dir
    for stale in glob.glob(os.path.join(self.directory, ".%d.tmp-*" % step)):
      shutil.rmtree(stale, ignore_errors=True)
    tmp = os.path.join(self.directory, ".%d.tmp-%d" % (step, os.getpid()))
    rec = save_tree(tmp, state)
    t0 = time.monotonic()
    if data_state is not None:
      path = os.path.join(tmp, _DATA)
      with open(path, "w") as f:
        json.dump(data_state, f)
        f.flush()
        os.fsync(f.fileno())
      rec["bytes"] += os.path.getsize(path)
    # an overwrite: the old step stops committing before it goes
    self._remove_marker(step)
    commit_dir(tmp, final)
    self._write_marker(step, manifest)
    rec["commit_s"] = time.monotonic() - t0
    self.last_save = rec
    logger.info("checkpoint saved at step %d (%d bytes)", step, rec["bytes"])
    if self.publish_hook is not None:
      try:
        self.publish_hook(step, state, manifest)
      except Exception as e:  # noqa: BLE001 - best-effort publish
        logger.warning("publish hook at step %d failed: %s: %s",
                       step, type(e).__name__, e)

  # -- commit markers ----------------------------------------------------------

  def _marker_path(self, step: int) -> str:
    return os.path.join(self.directory, _MARKER_FMT % step)

  def _remove_marker(self, step: int) -> None:
    try:
      os.remove(self._marker_path(step))
    except FileNotFoundError:
      pass

  def _write_marker(self, step: int, manifest: Optional[dict]) -> None:
    """Commit the save (the step is durable), then apply retention: the
    oldest steps past ``max_to_keep`` lose their marker, then their data,
    and markers whose step is gone are pruned."""
    try:
      atomic_write_json(self._marker_path(step),
                        {"step": int(step), "manifest": manifest or {}})
    except OSError as e:
      # the data is durable; the step merely never commits (a torn save)
      logger.warning("commit marker for step %d failed: %s", step, e)
      return
    steps = self.all_steps()
    if self.max_to_keep is not None and len(steps) > self.max_to_keep:
      for old in steps[:len(steps) - self.max_to_keep]:
        self._remove_marker(old)
        shutil.rmtree(self._step_dir(old), ignore_errors=True)
    live = set(self.all_steps())
    for name in os.listdir(self.directory):
      s = self._marker_step(name)
      if s is not None and s not in live:
        self._remove_marker(s)

  @staticmethod
  def _marker_step(name: str) -> Optional[int]:
    if not (name.startswith(_MARKER_PREFIX) and name.endswith(_MARKER_SUFFIX)):
      return None
    try:
      return int(name[len(_MARKER_PREFIX):-len(_MARKER_SUFFIX)])
    except ValueError:
      return None

  def _has_markers(self) -> bool:
    """True when this directory uses commit markers at all; marker-free
    directories keep the load-failure fallback."""
    try:
      return any(self._marker_step(n) is not None
                 for n in os.listdir(self.directory))
    except OSError:
      return False

  def _read_marker(self, step: int) -> Optional[dict]:
    """The step's commit record, or None (missing or unparseable: both
    mean the save never committed)."""
    try:
      with open(self._marker_path(step)) as f:
        return json.load(f)
    except (OSError, ValueError):
      return None

  def manifest(self, step: Optional[int] = None) -> Optional[dict]:
    """The manifest committed with ``step`` (default: latest), or None."""
    step = step if step is not None else self.latest_step()
    if step is None:
      return None
    rec = self._read_marker(step)
    return rec.get("manifest") if rec else None

  def _due(self, step: int) -> bool:
    """True when ``step`` reached or crossed an interval boundary since
    the last saved step (always for the first save; never for a step
    that does not advance)."""
    known = [s for s in (self._last_saved, self._latest_at_start)
             if s is not None]
    if _process_group() is None:
      known += self.all_steps()[-1:]
    last = max(known) if known else None
    if last is not None and step <= last:
      return False
    if last is None:
      return True
    interval = max(1, int(self.save_interval_steps))
    return (step // interval) > (last // interval)

  # -- restore -----------------------------------------------------------------

  def restore(self, state_template: Any, step: Optional[int] = None,
              with_data: bool = False) -> Any:
    """Restore the given (or latest) step into the template, in place.

    ``with_data=True`` returns ``(state, data_state_or_None)``.
    """
    step = step if step is not None else self.latest_step()
    if step is None:
      raise FileNotFoundError("no checkpoints in %s" % self.directory)
    path = self._step_dir(step)
    state = load_tree(path, state_template)
    if not with_data:
      return state
    data = None
    if os.path.exists(os.path.join(path, _DATA)):
      with open(os.path.join(path, _DATA)) as f:
        data = json.load(f)
    return state, data

  def restore_or(self, state: Any, data_iterator: Any = None,
                 with_manifest: bool = False):
    """(state, next_step): the latest step restored into ``state`` if there
    is one, else ``state`` unchanged and 0.

    With ``data_iterator`` (anything exposing ``set_state``) a saved
    input-pipeline state is pushed into it. With ``with_manifest=True``
    the return is ``(state, next_step, manifest)``.

    In a directory that carries commit markers a step with no marker never
    committed: it is rejected without a restore attempt. A marker-free
    directory keeps the fallback past a step that fails to load. When
    every step fails, the last error is raised: retraining from step 0
    would discard real progress.
    """
    step = self.latest_step()
    last_error = None
    markers = self._has_markers()
    while step is not None:
      if markers and self._read_marker(step) is None:
        logger.warning("checkpoint step %d has no commit marker (torn "
                       "save); rejecting it without a restore attempt", step)
        last_error = RuntimeError(
            "checkpoint step %d in %s has no commit marker"
            % (step, self.directory))
        step = self._older(step)
        continue
      logger.info("resuming from checkpoint step %d", step)
      try:
        if data_iterator is None:
          restored = self.restore(state, step=step)
        else:
          restored, data = self.restore(state, step=step, with_data=True)
          if data is not None:
            data_iterator.set_state(data)
          else:
            logger.warning("checkpoint step %d has no input-pipeline state; "
                           "the data iterator starts from its current "
                           "position", step)
        if with_manifest:
          return restored, step + 1, self.manifest(step)
        return restored, step + 1
      except Exception as e:  # noqa: BLE001 - torn/corrupt checkpoint
        logger.warning("checkpoint step %d unreadable (%s: %s); trying the "
                       "previous step", step, type(e).__name__, e)
        last_error = e
        step = self._older(step)
    if last_error is not None:
      raise last_error
    return (state, 0, None) if with_manifest else (state, 0)

  def _older(self, step: int) -> Optional[int]:
    older = [s for s in self.all_steps() if s < step]
    return max(older) if older else None

  def wait(self) -> None:
    """Saves are synchronous: nothing is in flight when ``save`` returns."""

  def close(self) -> None:
    """Nothing to release: the manager holds no handle between calls."""
