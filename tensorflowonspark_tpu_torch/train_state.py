"""The train state: a model with its weights, an optimizer and its state.

Counterpart of ``flax.training.train_state.TrainState`` as the JAX
package uses it (``create_state``, ``state.apply_gradients``; the model
stands for ``state.apply_fn`` with its params). The weights live in the
model (a ``trainable``
:class:`~tensorflowonspark_tpu_torch.models.transformer.Transformer`, or
any ``nn.Module``); the optimizer is an
:mod:`~tensorflowonspark_tpu_torch.optim` transformation over the
``{name: parameter}`` dict. :meth:`TrainState.apply_gradients` updates
weights and optimizer state IN PLACE and returns the same object: the
port's stand-in for JAX's donated state buffers.
"""

from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch import nn

from tensorflowonspark_tpu_torch import optim


@dataclass
class TrainState:
  model: nn.Module
  tx: Any
  opt_state: Any
  #: optimizer steps taken (``apply_gradients`` calls)
  step: int = 0

  @classmethod
  def create(cls, model: nn.Module, tx) -> "TrainState":
    return cls(model=model, tx=tx, opt_state=tx.init(cls._params_of(model)))

  @staticmethod
  def _params_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}

  @property
  def params(self) -> Dict[str, torch.Tensor]:
    """The trainable weights by name (the model's own parameters)."""
    return self._params_of(self.model)

  @torch.no_grad()
  def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> "TrainState":
    """One optimizer step from ``grads`` (consumed: the optimizer may
    reuse their memory), in place and outside autograd: a gradient that
    autograd handed out as a view cannot take an in-place update that
    autograd would record (SGD's decoupled decay adds the weights into
    it)."""
    params = self.params
    updates, self.opt_state = self.tx.update(grads, self.opt_state, params)
    optim.apply_updates(params, updates)
    self.step += 1
    return self
