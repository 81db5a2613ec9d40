"""The train step and the fused K-step train loop: one card, or data
parallelism across processes.

Counterpart of ``tensorflowonspark_tpu/parallel/sharding.py``:
:func:`resolve_unroll`, :func:`make_train_step`, :class:`TrainLoop` /
:func:`make_train_loop` and :func:`shard_batch`. ``mesh=None`` trains on
one card. A mesh from
:func:`~tensorflowonspark_tpu_torch.parallel.mesh.build_mesh` whose only
axis above 1 is ``data`` trains data-parallel over its process group:
every rank holds the whole state (replicated, as
``models.transformer.create_sharded_state`` makes it) and its own rows of
the global batch, and the step averages the local gradients over the
group (:func:`~tensorflowonspark_tpu_torch.parallel.collectives.
sync_gradients`, a bucketed all-reduce) before the optimizer sees them,
so the clip, the weight decay and ``MultiSteps`` accumulation see the
averaged gradient, as in the reference, where XLA inserts the all-reduce.
The returned loss is averaged over the group too: every rank returns the
global batch's loss, as the reference's replicated loss. FSDP, tensor or
sequence sharding, a state sharding and extra batch axes raise
``NotImplementedError``: ROADMAP Queue 1 item 10.

A batch handed to a step is this rank's local shard (the counterpart of
``jax.make_array_from_process_local_data``); :func:`shard_batch` and
:func:`shard_slab` cut a rank's rows out of a global host batch (what
the reference's ``device_put`` of the global batch gives each device).
The mean of the local gradients equals the global batch's gradient when
the loss is a mean over equal local batches, as ``causal_lm_loss`` is.

``loss_fn(model, batch)`` returns a scalar loss tensor; it stands for the
reference's pure ``loss_fn(params, batch)``, the model carrying the
weights (``state.apply_fn``). A step computes the gradients with
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
from typing import Callable, List, Optional, Tuple

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


def _refuse_mesh(mesh, state_sharding, batch_extra_axes) -> None:
  """Refuse what only item 10 would run: a state sharding, extra batch
  axes, or a mesh with an axis other than ``data`` above 1."""
  if state_sharding is not None or batch_extra_axes:
    raise NotImplementedError(
        "a state sharding or extra batch axes %r (FSDP, tensor or sequence "
        "sharding) are not ported to PyTorch yet (ROADMAP Queue 1 item 10); "
        "data parallelism needs neither" % (tuple(batch_extra_axes),))
  if mesh is None:
    return
  if not isinstance(mesh, mesh_lib.Mesh):
    raise NotImplementedError(
        "a mesh of type %s: the port trains over parallel.mesh.build_mesh's "
        "Mesh (its data axis); device meshes are ROADMAP Queue 1 item 10"
        % type(mesh).__name__)
  wide = ["%s=%d" % (a, d) for a, d in mesh.shape.items()
          if a != mesh_lib.AXIS_DATA and d > 1]
  if wide:
    raise NotImplementedError(
        "mesh axes %s are not ported to PyTorch yet (ROADMAP Queue 1 item "
        "10); only the data axis trains across processes" % ", ".join(wide))


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


def _step_body(loss_fn: Callable, state, batch, mesh=None) -> torch.Tensor:
  """One optimizer step on the local batch; the local loss. Over a mesh
  the gradients are averaged over its data axis before the update."""
  params = state.params
  loss = loss_fn(state.model, batch)
  grads = torch.autograd.grad(loss, list(params.values()))
  if mesh is not None:
    grads = collectives.sync_gradients(grads, mesh)
  state.apply_gradients(dict(zip(params, grads)))
  return loss.detach()


def _global_loss(losses: torch.Tensor, mesh) -> torch.Tensor:
  """The local losses averaged over the mesh's data axis: the global
  batch's loss on every rank (one collective however many steps)."""
  return losses if mesh is None else collectives.psum_mean(losses, mesh)


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
  ``mesh`` the batch is this rank's shard and ``loss`` the global
  batch's (see the module docstring)."""
  _refuse_mesh(mesh, state_sharding, batch_extra_axes)
  # obs seam, cached at build: off = one None check per step
  obs_on = obs_metrics.active() is not None
  seen: set = set()              # this step's "jit cache" of batch shapes

  def step(state, batch):
    if obs_on:
      obs_device.note_trace("train.step", batch, cache=seen)
      obs_device.capture_cost("train.step", step_cost, state, batch)
    if not donate_state:
      state = copy.deepcopy(state)
    batch = _to_device(batch, _state_device(state))
    return state, _global_loss(_step_body(loss_fn, state, batch, mesh), mesh)

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
               mesh=None, obs_handles=None):
    self._loss_fn = loss_fn
    self._mesh = mesh
    self._step = make_train_step(loss_fn, mesh, donate_state=donate_state)
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
  _refuse_mesh(mesh, state_sharding, batch_extra_axes)
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
  return TrainLoop(loss_fn, unroll, donate_state, mesh, obs_handles)


def _rows(x, dim: int, mesh):
  """This rank's rows ``[rank * B / N, (rank + 1) * B / N)`` of ``x``
  along ``dim``."""
  n = mesh_lib.axis_size(mesh, *mesh_lib.data_axes(mesh))
  b = int(x.shape[dim])
  if b % n:
    raise ValueError("a global batch of %d rows does not divide over the "
                     "%d ranks of the data axis" % (b, n))
  per = b // n
  index = [slice(None)] * (dim + 1)
  index[dim] = slice(mesh.rank * per, (mesh.rank + 1) * per)
  return x[tuple(index)]


def shard_batch(batch, mesh, extra_axes: Tuple[str, ...] = ()):
  """This rank's rows (dim 0) of a GLOBAL host batch (an array, a tensor,
  or a dict / tuple / list of them) that every rank holds alike; what
  the reference's ``device_put`` over the data axes gives each device. A
  batch that does not divide by the data axis raises; ``extra_axes``
  (sequence sharding) is item 10."""
  _refuse_mesh(mesh, None, extra_axes)
  return _map_batch(lambda x: _rows(x, 0, mesh), batch)


def shard_slab(slab, mesh, extra_axes: Tuple[str, ...] = ()):
  """:func:`shard_batch` for a ``[K, B, ...]`` slab (or a
  :class:`~tensorflowonspark_tpu_torch.data.readers.Slab`): this rank's
  rows of dim 1, the reference's ``slab_sharding``."""
  from tensorflowonspark_tpu_torch.data.readers import Slab
  _refuse_mesh(mesh, None, extra_axes)
  if isinstance(slab, Slab):
    return Slab(shard_slab(slab.data, mesh))
  return _map_batch(lambda x: _rows(x, 1, mesh), slab)
