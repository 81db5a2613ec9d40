"""Sharding rules, the train step and the fused K-step train loop: one
card, or a mesh of processes.

Counterpart of ``tensorflowonspark_tpu/parallel/sharding.py``:
:data:`LOGICAL_RULES`, :func:`batch_sharding` / :func:`slab_sharding`,
:func:`state_shardings`, :func:`init_sharded_state`,
:func:`resolve_unroll`, :func:`make_train_step`, :class:`TrainLoop` /
:func:`make_train_loop` and :func:`shard_batch`. ``mesh=None`` trains on
one card. Over a mesh from
:func:`~tensorflowonspark_tpu_torch.parallel.mesh.build_mesh` each rank
holds its block of the state and of every batch, where the reference's
GSPMD holds global arrays laid out over devices:

* parameters follow their logical axes through :data:`LOGICAL_RULES`
  (``embed`` over ``fsdp``; ``heads``, ``mlp`` and ``vocab`` over
  ``tensor``; ``expert``, the MoE layers' stacked experts, over
  ``expert``; a dimension its axis cannot divide stays whole), and each
  rank stores its block; optimizer state mirrors its parameter
  (:class:`StateSharding`). The model gathers what it computes with
  (``models.transformer``); a state whose every parameter is whole is
  the data-parallel case: every rank holds all of it;
* a batch is cut over ``data`` x ``fsdp`` on dim 0 and, with
  ``extra_axes=("sequence",)``, over ``sequence`` on dim 1
  (:func:`shard_batch`); the step takes this rank's block;
* the step's gradient of each parameter is this rank's share of the
  global batch's; the shares are summed over the batch axes the
  parameter is whole on (``data``, ``fsdp``, ``sequence``: one bucketed
  all-reduce, :func:`~tensorflowonspark_tpu_torch.parallel.collectives.
  sync_gradients`, per set of axes) and divided by the batch-axes degree,
  so every rank applies the global batch's gradient to its block before
  the optimizer sees it (the clip, the weight decay and ``MultiSteps``
  see it, as in the reference, where XLA inserts the collectives). An
  FSDP-cut parameter's shares arrive already summed over ``fsdp`` by the
  reduce-scatter of its gather. A batch is whole over ``expert`` and
  ``pipeline``, so no gradient is summed over them here: an expert
  block's gradient is the rank's own, and a weight every expert rank
  holds alike (the dense weights, the MoE router) gets the same gradient
  on each, since the MoE layers sum their partial gradients over the
  axis themselves (``parallel.expert_parallel``). The optimizer's own
  global reductions (the clip's norm, Adafactor's factored statistics)
  run over the parameter's axes (``optim.param_layout``).
* the returned loss is averaged over the batch axes: every rank returns
  the global batch's loss, as the reference's replicated loss.

A cut state is checkpointed and exported whole, as orbax writes a
sharded leaf as its global array: :func:`gather_state` gives every
tensor of it (parameters and optimizer state) whole, in the layout of one
process, and :func:`cut_state` copies a rank's blocks of a whole state
into a template laid out on any mesh; :func:`state_layout` says how each
tensor lies (an optimizer tensor as its parameter, a factored statistic
as its parameter less the dimension it reduced) and raises by name where
it cannot tell.

A batch handed to a step is this rank's block (the counterpart of
``jax.make_array_from_process_local_data``); :func:`shard_batch` and
:func:`shard_slab` cut it out of a global host batch (what the
reference's ``device_put`` of the global batch gives each device).
Nothing is cut over ``pipeline`` here, as in the reference's GSPMD: every
stage rank runs the whole step alike. The 1F1B pipeline trains through
``parallel.pipeline_parallel`` (``models.transformer.
make_pipeline_train_step``) instead.

``loss_fn(model, batch)`` returns a scalar loss tensor; it stands for the
reference's pure ``loss_fn(params, batch)``, the model carrying the
weights (``state.apply_fn``). Over a mesh it is this rank's share: a
loss over the global token count (``causal_lm_loss(..., mesh=...)``), or
a mean over equal local batches. A step computes the gradients with
``torch.autograd.grad`` and applies them with
``TrainState.apply_gradients``, which updates weights and optimizer state
IN PLACE: the port's stand-in for JAX's donated state. With
``donate_state=False`` the step first deep-copies the state, so the one
passed in stays as it was.

There is no ``jit``: the fused loop runs the same step body K times over
a slab moved to the card in one copy, and keeps the K losses on the card
until the caller reads them — one transfer and one host read per slab,
and over a mesh one all-reduce of the ``[K]`` losses. Same batches in the
same order give bit-identical losses and weights on both paths, because
they run the same code.

Obs seams (``TOS_OBS=1``; one cached None check per call when off): the
step and the fused loop call ``obs.device.note_trace("train.step")`` /
``("train.loop")`` with the batch (or slab), so ``xla.compiles.<label>``
counts each new batch shape once, where the reference's jit retraces,
and set their ``xla.cost.<label>.flops`` / ``.bytes`` gauges once per
shape from :func:`step_cost`. :class:`TrainLoop` owns the step
accounting the detectors read: ``train.steps`` (by K per fused slab),
``train.unroll`` and one ``train.slab`` span per call.
"""

import copy
import os
import time
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tensorflowonspark_tpu_torch.obs import device as obs_device
from tensorflowonspark_tpu_torch.obs import metrics as obs_metrics
from tensorflowonspark_tpu_torch.obs import spans as obs_spans
from tensorflowonspark_tpu_torch.parallel import collectives
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib

#: default unroll for :func:`make_train_loop` — optimizer steps per slab;
#: 1 = the per-step path
ENV_TRAIN_UNROLL = "TOS_TRAIN_UNROLL"


def resolve_unroll(unroll: Optional[int] = None) -> int:
  """The effective train-loop unroll: an explicit argument beats the
  ``TOS_TRAIN_UNROLL`` env; default 1. An env value that names no usable
  K (malformed, empty, ``0``) resolves to 1; an explicit ``unroll`` < 1
  raises."""
  if unroll is None:
    try:
      unroll = int(os.environ.get(ENV_TRAIN_UNROLL, "1"))
    except ValueError:
      unroll = 1
    return max(1, unroll)
  if unroll < 1:
    raise ValueError("train unroll must be >= 1, got %d" % unroll)
  return int(unroll)


# logical axis name -> mesh axis (None = replicated), the reference's
LOGICAL_RULES = (
    ("batch", (mesh_lib.AXIS_DATA, mesh_lib.AXIS_FSDP)),
    ("sequence", mesh_lib.AXIS_SEQUENCE),
    ("vocab", mesh_lib.AXIS_TENSOR),
    ("embed", mesh_lib.AXIS_FSDP),
    ("heads", mesh_lib.AXIS_TENSOR),
    ("kv", None),
    ("mlp", mesh_lib.AXIS_TENSOR),
    ("stage", mesh_lib.AXIS_PIPELINE),
    ("expert", mesh_lib.AXIS_EXPERT),
    ("conv_in", None),
    ("conv_out", mesh_lib.AXIS_TENSOR),
)

#: the axes a batch is cut over, each rank's loss a share of the global
#: batch's: gradients and losses are averaged over them
BATCH_AXES = (mesh_lib.AXIS_DATA, mesh_lib.AXIS_FSDP, mesh_lib.AXIS_SEQUENCE)


def logical_to_mesh(logical, shape, mesh) -> tuple:
  """The mesh spec of one parameter: for each dimension the mesh axis its
  logical name maps to under :data:`LOGICAL_RULES`, or None where there
  is none, where the axis has degree 1 (or there is no mesh), or where
  the degree does not divide the dimension (it stays whole, as
  ``_heads_logical`` keeps an indivisible head count replicated)."""
  rules = dict(LOGICAL_RULES)
  out = []
  for name, size in zip(logical, shape):
    axis = rules.get(name) if name is not None else None
    if axis is not None and not isinstance(axis, str):
      axis = None                      # batch axes: never a weight's
    if mesh is None or axis is None or axis not in mesh.shape \
        or mesh.shape[axis] == 1 or size % mesh.shape[axis]:
      axis = None
    out.append(axis)
  return tuple(out)


def local_shape(shape, spec, mesh) -> tuple:
  """The shape of this rank's block of a ``shape`` array under ``spec``."""
  return tuple(n // (mesh.shape[a] if a else 1) for n, a in zip(shape, spec))


def shard_array(x, spec, mesh):
  """This rank's block of a whole array (numpy or tensor) under
  ``spec``: each cut dimension narrowed to the rank's coordinate."""
  for dim, axis in enumerate(spec):
    if axis is None:
      continue
    per = x.shape[dim] // mesh.shape[axis]
    index = [slice(None)] * x.ndim
    index[dim] = slice(mesh.coord(axis) * per, (mesh.coord(axis) + 1) * per)
    x = x[tuple(index)]
  return x


def gather_array(x: torch.Tensor, spec, mesh) -> torch.Tensor:
  """The whole array from this rank's block ``x`` under ``spec``: an
  all-gather over each cut dimension's axis (every rank gets it)."""
  for dim, axis in enumerate(spec):
    if axis is not None:
      x = collectives.all_gather(x, mesh, axis, axis=dim)
  return x


class StateSharding(object):
  """How a train state lies on a mesh: each parameter's global shape and
  mesh spec (an axis or None per dimension). ``sharded`` is True when
  some parameter is cut, False for a data-parallel state. The port's
  ``state_sharding`` (the reference's is a tree of ``NamedSharding``)."""

  def __init__(self, mesh, specs, shapes):
    self.mesh = mesh
    self.specs = dict(specs)
    self.shapes = {k: tuple(v) for k, v in shapes.items()}
    self.sharded = any(a is not None for sp in self.specs.values()
                       for a in sp)

  def spec(self, name: str) -> tuple:
    return self.specs[name]

  def global_shape(self, name: str) -> tuple:
    return self.shapes[name]

  def __eq__(self, other):
    return isinstance(other, StateSharding) and self.mesh is other.mesh \
        and self.specs == other.specs and self.shapes == other.shapes

  def __repr__(self):
    return "StateSharding(%s, %d params, sharded=%s)" % (
        dict(self.mesh.shape), len(self.specs), self.sharded)


def _check_mesh(mesh, state_sharding=None, batch_extra_axes=()) -> None:
  """Refuse what the port does not run: a mesh of another type, extra
  batch axes other than ``sequence`` (or without a mesh), and a state
  sharding of another type."""
  if state_sharding is not None and \
      not isinstance(state_sharding, StateSharding):
    raise TypeError("state_sharding must be a StateSharding "
                    "(create_sharded_state / init_sharded_state), got %s"
                    % type(state_sharding).__name__)
  extra = tuple(batch_extra_axes or ())
  if any(a != mesh_lib.AXIS_SEQUENCE for a in extra):
    raise ValueError("batch_extra_axes may name only %r, got %r"
                     % (mesh_lib.AXIS_SEQUENCE, extra))
  if mesh is None:
    if extra:
      raise ValueError("batch_extra_axes %r cut a batch over a mesh; "
                       "without one there is nothing to cut" % (extra,))
    return
  if not isinstance(mesh, mesh_lib.Mesh):
    raise NotImplementedError(
        "a mesh of type %s: the port trains over parallel.mesh.build_mesh's "
        "Mesh; device meshes of other kinds are ROADMAP Queue 1 item 10c, "
        "part 3" % type(mesh).__name__)


def _state_device(state) -> torch.device:
  return next(state.model.parameters()).device


def _map_batch(fn, batch):
  """``fn`` on each array of a batch (an array, a tensor, or a dict /
  tuple / list of them)."""
  if isinstance(batch, dict):
    return {k: _map_batch(fn, v) for k, v in batch.items()}
  if isinstance(batch, (tuple, list)):
    return type(batch)(_map_batch(fn, v) for v in batch)
  return fn(batch)


def _on_device(x, device: torch.device):
  if isinstance(x, np.ndarray):
    x = torch.from_numpy(np.ascontiguousarray(x))
  return torch.as_tensor(x).to(device)


def _to_device(batch, device: torch.device):
  """A host batch (numpy array, tensor, or a dict / tuple of them) on
  ``device``."""
  return _map_batch(lambda x: _on_device(x, device), batch)


def _take(slab, i: int):
  return _map_batch(lambda x: x[i], slab)


def _slab_len(slab) -> int:
  if isinstance(slab, dict):
    return _slab_len(next(iter(slab.values()))) if slab else 0
  if isinstance(slab, (tuple, list)):
    return _slab_len(slab[0]) if slab else 0
  return int(slab.shape[0])


def sync_state_gradients(grads, names, sharding, mesh) -> list:
  """The global batch's gradient of each parameter's block from this
  rank's shares ``grads`` (in ``names`` order): each is summed over the
  batch axes (:data:`BATCH_AXES`) its parameter is whole on, one bucketed
  ``sync_gradients`` per set of such axes, and divided by the batch axes'
  degree. ``sharding`` None: every parameter whole (data parallelism, one
  all-reduce set)."""
  n_b = mesh_lib.axis_size(mesh, *BATCH_AXES)
  sets = {}
  for i, name in enumerate(names):
    spec = sharding.spec(name) if sharding is not None else ()
    axes = tuple(a for a in BATCH_AXES if a in mesh.shape and a not in spec)
    sets.setdefault(axes, []).append(i)
  out = list(grads)
  for axes, idx in sets.items():
    synced = collectives.sync_gradients([grads[i] for i in idx], mesh,
                                        axis_name=axes)
    rest = n_b // mesh_lib.axis_size(mesh, *axes)
    for i, g in zip(idx, synced):
      # an FSDP-cut block's shares were summed over fsdp by its gather's
      # reduce-scatter: the mean over the other axes still owes 1 / fsdp
      out[i] = g if rest == 1 else g.div_(rest)
  return out


def _check_layout(state, state_sharding) -> None:
  """Refuse a state whose blocks lie otherwise than ``state_sharding``
  says (the step was built for another layout)."""
  if state_sharding is not None and state_sharding != state.sharding:
    raise ValueError("the train step was built for %r, but the state lies "
                     "as %r" % (state_sharding, state.sharding))


def _step_body(loss_fn: Callable, state, batch, mesh=None) -> torch.Tensor:
  """One optimizer step on the local batch; the local loss. Over a mesh
  the gradients are the global batch's (:func:`sync_state_gradients`,
  over the state's own ``sharding``) before the update."""
  params = state.params
  loss = loss_fn(state.model, batch)
  grads = torch.autograd.grad(loss, list(params.values()))
  if mesh is not None:
    grads = sync_state_gradients(grads, list(params), state.sharding, mesh)
  state.apply_gradients(dict(zip(params, grads)))
  return loss.detach()


def _global_loss(losses: torch.Tensor, mesh) -> torch.Tensor:
  """The local losses averaged over the mesh's batch axes: the global
  batch's loss on every rank (one collective however many steps)."""
  return losses if mesh is None else \
      collectives.psum_mean(losses, mesh, BATCH_AXES)


def _tree_bytes(tree) -> int:
  """Bytes of every tensor and array in a nested dict / list / tuple /
  object (an optimizer state)."""
  if isinstance(tree, torch.Tensor):
    return tree.numel() * tree.element_size()
  if isinstance(tree, np.ndarray):
    return tree.nbytes
  if isinstance(tree, dict):
    return sum(_tree_bytes(v) for v in tree.values())
  if isinstance(tree, (list, tuple)):
    return sum(_tree_bytes(v) for v in tree)
  if hasattr(tree, "__dict__"):
    return _tree_bytes(vars(tree))
  return 0


def _first_leaf(batch):
  if isinstance(batch, dict):
    return _first_leaf(next(iter(batch.values())))
  if isinstance(batch, (tuple, list)):
    return _first_leaf(batch[0])
  return batch


def step_cost(state, batch, steps: int = 1) -> dict:
  """The analytic count behind the ``xla.cost.train.step`` /
  ``train.loop`` gauges, for ``steps`` optimizer steps on ``batch`` (one
  step's batch; the reference reads XLA's cost analysis instead).

  ``flops``: a model with a ``TransformerConfig`` (``model.cfg``) takes
  ``transformer_flops_per_token(N, L, d_model, S)`` per token of a
  ``[B, S]`` batch (6N for the matmuls forward and backward, plus the
  attention term); any other model ``6·N`` per example (the leading dim).
  ``bytes``: the weights read by the forward and by the backward and read
  and written by the update (4P), the gradients written and read once
  (2P), each optimizer-state tensor read and written once (2O), the batch
  read once — ``6P + 2O + batch``, P the weight bytes, O the optimizer
  state's. A lower bound: activations are not counted.
  """
  from tensorflowonspark_tpu_torch.obs import profiler as obs_profiler
  params = state.params
  n = sum(int(p.numel()) for p in params.values())
  lead = _first_leaf(batch)
  shape = tuple(getattr(lead, "shape", ()))
  cfg = getattr(state.model, "cfg", None)
  if cfg is not None and hasattr(cfg, "num_layers") and len(shape) >= 2:
    flops = obs_profiler.transformer_flops_per_token(
        n, cfg.num_layers, cfg.d_model, shape[1]) * shape[0] * shape[1]
  else:
    flops = 6.0 * n * (shape[0] if shape else 1)
  pbytes = _tree_bytes(params)
  nbytes = 6 * pbytes + 2 * _tree_bytes(state.opt_state) + \
      _tree_bytes(batch)
  return {"flops": float(flops * steps), "bytes": float(nbytes * steps)}


def make_train_step(loss_fn: Callable, mesh=None, state_sharding=None,
                    donate_state: bool = True,
                    batch_extra_axes: Tuple[str, ...] = ()):
  """``step(state, batch) -> (state, loss)``: one optimizer step on the
  card (or wherever the state's model lives). The batch is moved to the
  model's device; ``loss`` stays there (read it with ``float``). Over a
  ``mesh`` the batch is this rank's block (``batch_extra_axes=
  ("sequence",)``: cut on dim 1 too) and ``loss`` the global batch's.
  The state's blocks lie as its own ``sharding`` says, which
  ``create_sharded_state`` sets; a ``state_sharding`` given here must be
  that one, and a state laid out otherwise raises (see the module
  docstring)."""
  _check_mesh(mesh, state_sharding, batch_extra_axes)
  # obs seam, cached at build: off = one None check per step
  obs_on = obs_metrics.active() is not None
  seen: set = set()              # this step's "jit cache" of batch shapes

  def step(state, batch):
    _check_layout(state, state_sharding)
    if obs_on:
      obs_device.note_trace("train.step", batch, cache=seen)
      obs_device.capture_cost("train.step", step_cost, state, batch)
    if not donate_state:
      state = copy.deepcopy(state)
    batch = _to_device(batch, _state_device(state))
    return state, _global_loss(_step_body(loss_fn, state, batch, mesh),
                              mesh)

  return step


class TrainLoop(object):
  """Built by :func:`make_train_loop`: per-step and fused paths behind
  one call.

  ``loop(state, item) -> (state, losses)`` where ``item`` is a plain
  batch (one step; ``losses`` is ``[1]``) or a
  :class:`~tensorflowonspark_tpu_torch.data.readers.Slab` of ``unroll``
  stacked batches (the fused path; ``losses`` is ``[unroll]``). A slab of
  another length takes the per-step path, batch by batch. ``loop.steps``
  counts optimizer steps taken.
  """

  def __init__(self, loss_fn: Callable, unroll: int, donate_state: bool,
               mesh=None, obs_handles=None, state_sharding=None,
               batch_extra_axes=()):
    self._loss_fn = loss_fn
    self._mesh = mesh
    self._layout = state_sharding
    self._step = make_train_step(loss_fn, mesh, state_sharding,
                                 donate_state=donate_state,
                                 batch_extra_axes=batch_extra_axes)
    self._donate = donate_state
    self.unroll = unroll
    #: optimizer steps dispatched through this loop (host-side count)
    self.steps = 0
    self._obs = obs_handles      # None, or (counter, recorder-or-None)
    self._seen: set = set()      # the fused loop's "jit cache" of shapes

  def _record(self, n: int, t0: float) -> None:
    self.steps += n
    if self._obs is None:
      return
    counter, rec = self._obs
    counter.inc(n)
    if rec is not None:
      rec.record_span("train.slab", t0, time.monotonic() - t0, steps=n)

  def _per_step(self, state, batches: List, t0: float):
    losses = []
    for batch in batches:
      state, loss = self._step(state, batch)
      losses.append(loss)
    self._record(len(losses), t0)
    return state, (torch.stack(losses) if losses else torch.zeros((0,)))

  def _fused(self, state, slab, t0: float):
    if self._obs is not None:
      obs_device.note_trace("train.loop", slab, cache=self._seen)
      obs_device.capture_cost("train.loop", step_cost, state,
                              _take(slab, 0), self.unroll)
    if not self._donate:
      state = copy.deepcopy(state)
    _check_layout(state, self._layout)
    slab = _to_device(slab, _state_device(state))      # one copy per slab
    losses = [_step_body(self._loss_fn, state, _take(slab, i), self._mesh)
              for i in range(self.unroll)]
    self._record(self.unroll, t0)
    return state, _global_loss(torch.stack(losses), self._mesh)

  def __call__(self, state, item):
    from tensorflowonspark_tpu_torch.data.readers import Slab
    t0 = time.monotonic()
    if isinstance(item, Slab):
      k = _slab_len(item.data)
      if self.unroll > 1 and k == self.unroll:
        return self._fused(state, item.data, t0)
      return self._per_step(state, [_take(item.data, i) for i in range(k)],
                            t0)
    return self._per_step(state, [item], t0)


def make_train_loop(loss_fn: Callable, mesh=None, state_sharding=None,
                    donate_state: bool = True,
                    batch_extra_axes: Tuple[str, ...] = (),
                    unroll: Optional[int] = None) -> TrainLoop:
  """A train loop taking ``unroll`` optimizer steps per slab (``None``
  reads ``TOS_TRAIN_UNROLL``); see :class:`TrainLoop`. Feed it with
  :func:`~tensorflowonspark_tpu_torch.data.readers.slab_batches`. Over a
  ``mesh`` a slab holds this rank's rows (:func:`shard_slab`) and the
  ``[unroll]`` losses are the global batches'."""
  _check_mesh(mesh, state_sharding, batch_extra_axes)
  unroll = resolve_unroll(unroll)
  obs_handles = None
  reg = obs_metrics.active()
  if reg is not None:
    # the loop owns the step accounting the detectors read: train.steps
    # bumps by K per fused dispatch (obs/anomaly.py discounts one-slab
    # quantization via this gauge), train.slab spans each call. Don't
    # ALSO wrap loop calls in a StepTimer, or steps double-count.
    reg.gauge("train.unroll").set(unroll)
    obs_handles = (reg.counter("train.steps"), obs_spans.active())
  return TrainLoop(loss_fn, unroll, donate_state, mesh, obs_handles,
                   state_sharding, batch_extra_axes)


def batch_sharding(mesh, extra_axes: Tuple[str, ...] = ()):
  """The spec of a batch: dim 0 over the data axes and, with
  ``extra_axes``, dim 1 over those (``sequence``)."""
  return collectives.P(mesh_lib.data_axes(mesh) or None, *extra_axes)


def slab_sharding(mesh, extra_axes: Tuple[str, ...] = ()):
  """The spec of a ``[K, B, ...]`` slab: :func:`batch_sharding` one
  dimension in."""
  return collectives.P(None, mesh_lib.data_axes(mesh) or None, *extra_axes)


def _cut(x, dim: int, mesh, axes, what: str):
  """This rank's block of ``x`` along ``dim`` over ``axes``."""
  index, count = collectives.block_index(mesh, axes)
  size = int(x.shape[dim])
  if size % count:
    raise ValueError("a global batch of %d %s does not divide over the %d "
                     "ranks of the %s ax%s" % (
                         size, what, count, "/".join(axes),
                         "is" if len(axes) == 1 else "es"))
  per = size // count
  at = [slice(None)] * (dim + 1)
  at[dim] = slice(index * per, (index + 1) * per)
  return x[tuple(at)]


def _block_of(x, lead: int, mesh, extra_axes):
  """The rows (dim ``lead``) over the data axes and, with
  ``extra_axes``, the positions (dim ``lead + 1``) over them."""
  x = _cut(x, lead, mesh, mesh_lib.data_axes(mesh), "rows")
  if extra_axes:
    x = _cut(x, lead + 1, mesh, tuple(extra_axes), "positions")
  return x


def shard_batch(batch, mesh, extra_axes: Tuple[str, ...] = ()):
  """This rank's block of a GLOBAL host batch (an array, a tensor, or a
  dict / tuple / list of them) that every rank holds alike: its rows
  over the data axes (``data`` x ``fsdp``) and, with
  ``extra_axes=("sequence",)``, its positions over ``sequence`` (rank
  ``i`` of the axis keeps ``[i * S / n, (i + 1) * S / n)``; the label of
  its last position, the next block's first token, reaches the loss
  through ``causal_lm_loss(..., mesh=...)``); what the reference's
  ``device_put`` over ``batch_sharding`` gives each device. A batch that
  does not divide raises."""
  _check_mesh(mesh, None, extra_axes)
  return _map_batch(lambda x: _block_of(x, 0, mesh, extra_axes), batch)


def shard_slab(slab, mesh, extra_axes: Tuple[str, ...] = ()):
  """:func:`shard_batch` for a ``[K, B, ...]`` slab (or a
  :class:`~tensorflowonspark_tpu_torch.data.readers.Slab`): dims 1 (and
  2), the reference's ``slab_sharding``."""
  from tensorflowonspark_tpu_torch.data.readers import Slab
  _check_mesh(mesh, None, extra_axes)
  if isinstance(slab, Slab):
    return Slab(shard_slab(slab.data, mesh, extra_axes))
  return _map_batch(lambda x: _block_of(x, 1, mesh, extra_axes), slab)


class Slot(NamedTuple):
  """How one tensor of a train state lies on the mesh: ``spec`` (a mesh
  axis or None per dimension), the WHOLE tensor's ``shape``, and
  ``perm``: ``(dim, order)`` where the whole tensor's dimension ``dim``
  is reordered by ``order`` before it is cut (a cut fused QKV weight's
  heads and the optimizer tensors that keep them), else None."""
  spec: tuple
  shape: tuple
  perm: Optional[tuple] = None


def _underivable(path, what: str) -> ValueError:
  return ValueError(
      "cannot derive how the optimizer tensor at %s lies on the mesh: %s. "
      "A checkpoint, an export or a restore of a cut state needs every "
      "optimizer tensor to be a parameter's mirror (its block's shape, one "
      "per parameter in a list, a NamedTuple field or a dict by name) or an "
      "optim.FactoredState statistic" % ("/".join(str(k) for k in path),
                                         what))


def _less(t: tuple, dim: int) -> tuple:
  return t[:dim] + t[dim + 1:]


def _perm_less(perm, dim: int):
  """A parameter's ``perm`` in a statistic that reduced ``dim``."""
  if perm is None or perm[0] == dim:
    return None
  return (perm[0] - (dim < perm[0]), perm[1])


class _Params(object):
  """Each parameter's name, block shape and :class:`Slot`, in the
  state's parameter order (the order of a per-parameter list)."""

  def __init__(self, state, param_sharding):
    self.names = list(state.params)
    self.block = {n: tuple(p.shape) for n, p in state.params.items()}
    model = getattr(state, "model", None)
    permutation = getattr(model, "param_permutation", None)
    self.slots = {}
    for n in self.names:
      if param_sharding is None:
        spec, shape = (None,) * len(self.block[n]), self.block[n]
      else:
        spec, shape = param_sharding.spec(n), param_sharding.global_shape(n)
      perm = permutation(n) if permutation is not None else None
      self.slots[n] = Slot(tuple(spec), tuple(shape), perm)

  def mirror(self, name, t, path) -> Slot:
    if tuple(t.shape) != self.block[name]:
      raise _underivable(path, "shape %s where parameter %s's block is %s"
                         % (tuple(t.shape), name, self.block[name]))
    return self.slots[name]


def _factored(tree, path, params: _Params, out: dict) -> None:
  """The slots of an ``optim.FactoredState``: a factored parameter's row
  statistic is its spec less ``d0`` (whole over the axis that cuts
  ``d0``: each rank holds the mean over the whole dimension), its column
  statistic less ``d1``; the slots a parameter does not use hold one
  zero on every rank."""
  from tensorflowonspark_tpu_torch import optim
  n = len(params.names)
  for field in ("v_row", "v_col", "v"):
    if len(getattr(tree, field)) != n:
      raise _underivable(path + (field,), "%d entries for %d parameters"
                         % (len(getattr(tree, field)), n))
  one = Slot((None,), (1,))
  for i, name in enumerate(params.names):
    slot = params.slots[name]
    shapes = [tuple(getattr(tree, f)[i].shape) for f in ("v_row", "v_col",
                                                         "v")]
    try:
      dims = optim.factored_slots(slot.shape, params.block[name], *shapes)
    except ValueError as e:
      raise _underivable(path + ("v", i),
                         "%s (parameter %s)" % (e, name)) from e
    if dims is None:
      got = {"v_row": one, "v_col": one, "v": slot}
    else:
      got = {"v": one}
      for field, dim in (("v_row", dims[1]), ("v_col", dims[0])):
        got[field] = Slot(_less(slot.spec, dim), _less(slot.shape, dim),
                          _perm_less(slot.perm, dim))
    for field, s in got.items():
      out[path + (field, i)] = s


def _opt_slots(tree, path, params: _Params, out: dict) -> None:
  """The slot of every tensor in an optimizer state (see
  :func:`state_layout`); raises where one cannot be derived."""
  from tensorflowonspark_tpu_torch import optim
  names = params.names
  if torch.is_tensor(tree):
    raise _underivable(path, "a tensor of shape %s outside any per-parameter "
                       "slot" % (tuple(tree.shape),))
  if isinstance(tree, optim.FactoredState):
    _factored(tree, path, params, out)
    _opt_slots(tree.count, path + ("count",), params, out)
    return
  if isinstance(tree, dict):
    if tree and sorted(tree) == sorted(names) and \
        all(torch.is_tensor(v) for v in tree.values()):
      for k, v in tree.items():
        out[path + (k,)] = params.mirror(k, v, path + (k,))
      return
    items = tree.items()
  elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
    items = zip(tree._fields, tree)
  elif isinstance(tree, (list, tuple)):
    if tree and len(tree) == len(names) and \
        all(torch.is_tensor(v) for v in tree):
      for i, v in enumerate(tree):
        out[path + (i,)] = params.mirror(names[i], v, path + (i,))
      return
    items = enumerate(tree)
  elif hasattr(tree, "__dict__"):
    items = vars(tree).items()
  else:
    return
  for k, v in items:
    _opt_slots(v, path + (k,), params, out)


def state_layout(state, param_sharding=None) -> dict:
  """The :class:`Slot` of every tensor of a train state, by path (the
  paths of :func:`_state_tensors`): a parameter's from its
  ``StateSharding`` (``param_sharding``, default ``state.sharding``; None
  or a state held whole: every tensor whole) and the model's
  ``param_permutation``; an optimizer tensor's from its parameter: a
  moment (AdamW's ``mu``/``nu``, Lion's, SGD's trace, ``MultiSteps``'
  running mean, Adafactor's unfactored ``v``) mirrors it, and Adafactor's
  factored row and column statistics are its spec less the dimension
  each reduced (``optim.factored_slots``). An optimizer tensor that is
  none of these raises ``ValueError`` naming its path: a layout is never
  guessed. Counts and scalars are Python numbers, not tensors."""
  if param_sharding is None:
    param_sharding = getattr(state, "sharding", None)
  params = _Params(state, param_sharding)
  out = {("params", n): params.slots[n] for n in params.names}
  _opt_slots(state.opt_state, ("opt_state",), params, out)
  return out


def state_shardings(state, param_sharding: StateSharding) -> dict:
  """The spec of every tensor of a train state, by path (the reference's
  ``state_shardings``): :func:`state_layout`'s, whose every optimizer
  tensor's spec follows its parameter (a factored statistic's less the
  dimension it reduced)."""
  return {path: collectives.P(*slot.spec)
          for path, slot in state_layout(state, param_sharding).items()}


def init_sharded_state(params_init_fn: Callable, make_state_fn: Callable,
                       mesh):
  """A train state laid out over ``mesh``, and its
  :class:`StateSharding`: the reference's ``init_sharded_state``.

  ``params_init_fn()`` returns ``(params, logical)``: the whole weights
  (``{name: array}``) and each one's logical axis names (the port's
  ``nn.with_logical_partitioning``); ``make_state_fn(blocks,
  sharding)`` wraps this rank's blocks in a train state, running the
  optimizer's init under :func:`optim.param_layout`. Each rank keeps only
  its blocks of the whole weights it was given; a block that every rank
  of some axes holds alike is then broadcast from coordinate 0 of those
  axes, and the optimizer state is made again from the agreed blocks (an
  optimizer's init is a function of its parameters), so ranks handed
  different weights still agree where they must, and no moment crosses
  the group.
  """
  from tensorflowonspark_tpu_torch import optim
  params, logical = params_init_fn()
  shapes = {n: tuple(np.shape(p)) for n, p in params.items()}
  specs = {n: logical_to_mesh(logical[n], shapes[n], mesh) for n in params}
  sharding = StateSharding(mesh, specs, shapes)
  blocks = {n: shard_array(p, specs[n], mesh) for n, p in params.items()}
  layout = sharding if sharding.sharded else None
  with optim.param_layout(layout):
    state = make_state_fn(blocks, sharding)
  with torch.no_grad():
    for name, t in state.params.items():
      axes = tuple(a for a in mesh.wide() if a not in specs[name])
      if axes or (not mesh.wide()
                  and mesh.group(mesh_lib.AXIS_DATA) is not None):
        t.copy_(collectives.broadcast_from(t, mesh, axes or
                                           mesh_lib.AXIS_DATA))
  with optim.param_layout(layout):
    state.opt_state = state.tx.init(state.params)
  state.sharding = sharding
  return state, sharding


def _state_tensors(state):
  """``(path, tensor)`` of every parameter and optimizer-state tensor: a
  NamedTuple's fields by name, a list's entries by index."""
  out = [(("params", n), p) for n, p in state.params.items()]

  def walk(tree, path):
    if isinstance(tree, torch.Tensor):
      out.append((path, tree))
    elif isinstance(tree, dict):
      for k, v in tree.items():
        walk(v, path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
      for k, v in zip(tree._fields, tree):
        walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
      for i, v in enumerate(tree):
        walk(v, path + (i,))
    elif hasattr(tree, "__dict__"):
      for k, v in vars(tree).items():
        walk(v, path + (k,))

  walk(state.opt_state, ("opt_state",))
  return out


def _map_state(tree, path, fn):
  """``tree`` rebuilt with ``fn(path, tensor)`` in place of each tensor
  (the walk and the paths of :func:`_state_tensors`); objects are
  shallow copies, so the counts they hold are the caller's values."""
  if torch.is_tensor(tree):
    return fn(path, tree)
  if isinstance(tree, dict):
    return {k: _map_state(v, path + (k,), fn) for k, v in tree.items()}
  if isinstance(tree, tuple) and hasattr(tree, "_fields"):
    return type(tree)(*[_map_state(v, path + (k,), fn)
                        for k, v in zip(tree._fields, tree)])
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map_state(v, path + (i,), fn)
                      for i, v in enumerate(tree))
  if hasattr(tree, "__dict__"):
    out = copy.copy(tree)
    for k, v in vars(tree).items():
      setattr(out, k, _map_state(v, path + (k,), fn))
    return out
  return tree


class WholeState(object):
  """A train state's every tensor as its whole global array, in the
  layout of one process (:func:`gather_state`): ``params`` by name,
  ``opt_state`` with the optimizer's own containers, and ``step``. What a
  checkpoint and an export of a cut state write, and what a checkpoint's
  ``publish_hook`` is handed; ``utils.checkpoint`` writes it as it writes
  a ``TrainState``, so a checkpoint written by ranks has the tree and the
  tensor shapes of one written by one process."""

  def __init__(self, params: dict, opt_state: Any, step: int):
    self.params = params
    self.opt_state = opt_state
    self.step = int(step)
    self.sharding = None


def _order(perm, back: bool) -> torch.Tensor:
  return torch.as_tensor(np.argsort(perm[1]) if back else perm[1])


def _gather(t: torch.Tensor, slot: Slot, mesh) -> torch.Tensor:
  """The whole tensor of block ``t``, in the order of one process."""
  whole = gather_array(t.detach(), slot.spec, mesh) if mesh is not None \
      else t.detach()
  if slot.perm is not None:
    whole = whole.index_select(
        slot.perm[0], _order(slot.perm, back=True).to(whole.device))
  return whole


def cut_state_mesh(state):
  """The mesh a train state is cut over, or None where every rank holds
  it whole (one card, or only the data axis above 1)."""
  sh = getattr(state, "sharding", None)
  return sh.mesh if sh is not None and sh.sharded else None


def gather_state(state) -> WholeState:
  """Every tensor of a train state, its parameters and its optimizer
  state, as its whole global array in the layout of one process (a
  :class:`WholeState`, on the tensors' device): each block all-gathered
  over the axes that cut it (:func:`state_layout`), a cut fused QKV
  weight and the optimizer tensors that keep its heads put back in the
  order of one process. Over a cut mesh EVERY rank calls it (the
  gathers are collectives), and every rank gets the whole state; a layout
  that cannot be derived raises on every rank before the first gather. A
  tensor that every rank holds whole is the state's own, uncopied (read
  it before the next step)."""
  mesh = cut_state_mesh(state)
  layout = state_layout(state)

  def whole(path, t):
    return _gather(t, layout[path], mesh)

  params = {n: whole(("params", n), p) for n, p in state.params.items()}
  return WholeState(params, _map_state(state.opt_state, ("opt_state",),
                                       whole), state.step)


def whole_like(state) -> WholeState:
  """A :class:`WholeState` of ``state``'s containers whose tensors are
  empty ``meta`` tensors of the whole shapes and dtypes: what a restore
  checks a checkpoint's tree against before it cuts it."""
  layout = state_layout(state)

  def meta(path, t):
    return torch.empty(layout[path].shape, dtype=t.dtype, device="meta")

  params = {n: meta(("params", n), p) for n, p in state.params.items()}
  return WholeState(params, _map_state(state.opt_state, ("opt_state",),
                                       meta), state.step)


def _at(tree, key):
  """``tree``'s child ``key``: a dict's item, a list's or tuple's entry,
  or an attribute (a NamedTuple's field, an object's, a state's)."""
  if isinstance(tree, dict):
    return tree[key]
  if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
    return tree[key]
  return getattr(tree, key)


def _scalars(tmpl, whole, path) -> list:
  """``(object or container, key, value)`` for every Python number the
  optimizer state ``tmpl`` holds (a step count, ``MultiSteps``' mini
  step), ``value`` read from ``whole`` at the same path."""
  out = []
  if torch.is_tensor(tmpl):
    return out
  if isinstance(tmpl, dict):
    items, mutable = tmpl.items(), True
  elif isinstance(tmpl, (list, tuple)):
    items = zip(tmpl._fields, tmpl) if hasattr(tmpl, "_fields") \
        else enumerate(tmpl)
    mutable = isinstance(tmpl, list)
  elif hasattr(tmpl, "__dict__"):
    items, mutable = vars(tmpl).items(), True
  else:
    return out
  for k, v in list(items):
    child = _at(whole, k)
    if isinstance(v, (bool, int, float)):
      if not mutable:
        raise TypeError("a number in a tuple at %s cannot be restored in "
                        "place" % "/".join(str(p) for p in path + (k,)))
      out.append((tmpl, k, child))
    else:
      out += _scalars(v, child, path + (k,))
  return out


@torch.no_grad()
def cut_state(whole, template):
  """Copy this rank's blocks of the whole state ``whole`` into the train
  state ``template``, in place (the model's parameters stay the objects
  a train step holds), and its step and optimizer counts; returns the
  template. ``whole``: a :class:`WholeState` (:func:`gather_state` on any
  mesh, or a one-process state), or the plain tree
  ``utils.checkpoint.load_tree`` reads without a template. Each tensor
  is cut as ``template.sharding`` lays it out (:func:`state_layout`),
  which may be another mesh than the one it was gathered from: a cut
  fused QKV weight and the optimizer tensors that keep its heads are
  reordered first. Every block is taken before the first copy, so a
  whole state that does not fit (a shape, a missing entry) raises
  ``ValueError`` and changes nothing. No collective: each rank cuts its
  own blocks."""
  mesh = cut_state_mesh(template)
  layout = state_layout(template)
  blocks = []
  for path, t in _state_tensors(template):
    at = "/".join(str(k) for k in path)
    try:
      src = whole
      for key in path:
        src = _at(src, key)
    except (KeyError, IndexError, AttributeError, TypeError) as e:
      raise ValueError("the whole state has no tensor at %s" % at) from e
    src = torch.as_tensor(src)
    slot = layout[path]
    if tuple(src.shape) != slot.shape:
      raise ValueError("the whole state's tensor at %s has shape %s where "
                       "the template's whole shape is %s"
                       % (at, tuple(src.shape), slot.shape))
    if slot.perm is not None:
      src = src.index_select(slot.perm[0], _order(slot.perm, back=False).to(
          src.device))
    if mesh is not None:
      src = shard_array(src, slot.spec, mesh)
    blocks.append((t, src))
  numbers = _scalars(template.opt_state, _at(whole, "opt_state"),
                     ("opt_state",))
  step = int(_at(whole, "step"))
  for t, src in blocks:
    t.copy_(src)
  for obj, key, value in numbers:
    if isinstance(obj, (dict, list)):
      obj[key] = value
    else:
      setattr(obj, key, value)
  template.step = step
  return template


def gather_state_params(state) -> dict:
  """The whole weights of a train state laid out over a mesh, as f32
  numpy arrays on every rank (each block all-gathered over its axes, in
  the order of one process); a state without a sharding gives its own
  weights. The weights-only view of :func:`gather_state`."""
  mesh = cut_state_mesh(state)
  slots = _Params(state, getattr(state, "sharding", None)).slots
  out = {}
  for name, p in state.params.items():
    whole = _gather(p, slots[name], mesh).float().cpu()
    # a copy, never a view of the live weight the next step updates
    out[name] = (whole.clone() if whole.data_ptr() == p.data_ptr()
                 else whole).numpy()
  return out
