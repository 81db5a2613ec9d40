"""The train step and the fused K-step train loop, on one card.

Counterpart of the single-device part of
``tensorflowonspark_tpu/parallel/sharding.py``: :func:`resolve_unroll`,
:func:`make_train_step` and :class:`TrainLoop` / :func:`make_train_loop`.
A mesh (data, FSDP, tensor or sequence sharding) raises
``NotImplementedError``: multi-GPU parallelism is ROADMAP Queue 1 item 10.

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
until the caller reads them — one transfer and one host read per slab.
Same batches in the same order give bit-identical losses and weights on
both paths, because they run the same code.
"""

import copy
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

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
  if mesh is not None or state_sharding is not None or batch_extra_axes:
    raise NotImplementedError(
        "sharded training (a mesh, a state sharding or batch axes) is not "
        "ported to PyTorch yet (ROADMAP Queue 1 item 10); pass mesh=None")


def _state_device(state) -> torch.device:
  return next(state.model.parameters()).device


def _to_device(batch, device: torch.device):
  """A host batch (numpy array, tensor, or a dict / tuple of them) on
  ``device``."""
  if isinstance(batch, dict):
    return {k: _to_device(v, device) for k, v in batch.items()}
  if isinstance(batch, (tuple, list)):
    return type(batch)(_to_device(v, device) for v in batch)
  if isinstance(batch, np.ndarray):
    batch = torch.from_numpy(np.ascontiguousarray(batch))
  return torch.as_tensor(batch).to(device)


def _take(slab, i: int):
  if isinstance(slab, dict):
    return {k: _take(v, i) for k, v in slab.items()}
  if isinstance(slab, (tuple, list)):
    return type(slab)(_take(v, i) for v in slab)
  return slab[i]


def _slab_len(slab) -> int:
  if isinstance(slab, dict):
    return _slab_len(next(iter(slab.values()))) if slab else 0
  if isinstance(slab, (tuple, list)):
    return _slab_len(slab[0]) if slab else 0
  return int(slab.shape[0])


def _step_body(loss_fn: Callable, state, batch) -> torch.Tensor:
  params = state.params
  loss = loss_fn(state.model, batch)
  grads = torch.autograd.grad(loss, list(params.values()))
  state.apply_gradients(dict(zip(params, grads)))
  return loss.detach()


def make_train_step(loss_fn: Callable, mesh=None, state_sharding=None,
                    donate_state: bool = True,
                    batch_extra_axes: Tuple[str, ...] = ()):
  """``step(state, batch) -> (state, loss)``: one optimizer step on the
  card (or wherever the state's model lives). The batch is moved to the
  model's device; ``loss`` stays there (read it with ``float``)."""
  _refuse_mesh(mesh, state_sharding, batch_extra_axes)

  def step(state, batch):
    if not donate_state:
      state = copy.deepcopy(state)
    batch = _to_device(batch, _state_device(state))
    return state, _step_body(loss_fn, state, batch)

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

  def __init__(self, loss_fn: Callable, unroll: int, donate_state: bool):
    self._loss_fn = loss_fn
    self._step = make_train_step(loss_fn, donate_state=donate_state)
    self._donate = donate_state
    self.unroll = unroll
    #: optimizer steps dispatched through this loop (host-side count)
    self.steps = 0

  def _per_step(self, state, batches: List):
    losses = []
    for batch in batches:
      state, loss = self._step(state, batch)
      losses.append(loss)
    self.steps += len(losses)
    return state, (torch.stack(losses) if losses else torch.zeros((0,)))

  def _fused(self, state, slab):
    if not self._donate:
      state = copy.deepcopy(state)
    slab = _to_device(slab, _state_device(state))      # one copy per slab
    losses = [_step_body(self._loss_fn, state, _take(slab, i))
              for i in range(self.unroll)]
    self.steps += self.unroll
    return state, torch.stack(losses)

  def __call__(self, state, item):
    from tensorflowonspark_tpu_torch.data.readers import Slab
    if isinstance(item, Slab):
      k = _slab_len(item.data)
      if self.unroll > 1 and k == self.unroll:
        return self._fused(state, item.data)
      return self._per_step(state, [_take(item.data, i) for i in range(k)])
    return self._per_step(state, [item])


def make_train_loop(loss_fn: Callable, mesh=None, state_sharding=None,
                    donate_state: bool = True,
                    batch_extra_axes: Tuple[str, ...] = (),
                    unroll: Optional[int] = None) -> TrainLoop:
  """A train loop taking ``unroll`` optimizer steps per slab (``None``
  reads ``TOS_TRAIN_UNROLL``); see :class:`TrainLoop`. Feed it with
  :func:`~tensorflowonspark_tpu_torch.data.readers.slab_batches`."""
  _refuse_mesh(mesh, state_sharding, batch_extra_axes)
  return TrainLoop(loss_fn, resolve_unroll(unroll), donate_state)
