"""MNIST model family on PyTorch: the MLP and the small CNN.

The port's copy of ``tensorflowonspark_tpu/models/mnist.py``: the same
topologies (a 512-unit ReLU MLP; two 3x3 convolutions with 2x2 average
pools and two dense layers), bf16 compute over f32 parameters, a
``train_step`` of Adam (optax's ``adam``: ``scale_by_adam`` then the
learning rate), ``eval_step`` and the reference's ``synthetic_dataset``
(the same numpy draws, so both packages see the same images).

Images arrive as the reference takes them, NHWC ``[B, 28, 28, 1]``
float32. Parameter names follow the flax modules' (``Dense_0.kernel``,
``Conv_1.bias``, ...), and dense kernels keep flax's ``[in, out]``
layout; a convolution kernel is torch's OIHW where flax's is HWIO
(:func:`params_from_flax` transposes). The CNN computes in NCHW and
flattens its last feature map in flax's NHWC order, so the first dense
kernel is the reference's as it is. The convolutions and dense layers
are ``F.conv2d`` / ``torch.matmul``: the reference computes them with
XLA, outside any Pallas kernel.
"""

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.utils.device import resolve_device
from tensorflowonspark_tpu_torch.utils.params import copy_into, lecun_normal

IMAGE_SHAPE = (28, 28, 1)
NUM_CLASSES = 10

def _param(shape, device) -> nn.Parameter:
  return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))


class Dense(nn.Module):
  """flax ``nn.Dense(dtype=dtype)``: ``kernel`` [in, out] and ``bias``,
  both cast to ``dtype`` at use."""

  def __init__(self, features_in: int, features: int, dtype, device):
    super().__init__()
    self.dtype = dtype
    self.kernel = _param((features_in, features), device)
    self.bias = _param((features,), device)

  def forward(self, x):
    return x.to(self.dtype) @ self.kernel.to(self.dtype) + \
        self.bias.to(self.dtype)


class Conv(nn.Module):
  """flax ``nn.Conv(features, (3, 3), dtype=dtype)`` (SAME padding):
  ``kernel`` [out, in, 3, 3] and ``bias``, on NCHW activations."""

  def __init__(self, features_in: int, features: int, dtype, device):
    super().__init__()
    self.dtype = dtype
    self.kernel = _param((features, features_in, 3, 3), device)
    self.bias = _param((features,), device)

  def forward(self, x):
    return F.conv2d(x.to(self.dtype), self.kernel.to(self.dtype),
                    self.bias.to(self.dtype), padding=1)


class _Model(nn.Module):

  def load_params(self, params: Mapping[str, Any]) -> None:
    """Copy a flat weight dict in (numpy arrays or tensors)."""
    copy_into(dict(self.named_parameters()), params)

  @property
  def device(self) -> torch.device:
    return next(self.parameters()).device


class MLP(_Model):
  """512-unit ReLU MLP (the reference example's topology)."""

  def __init__(self, hidden: int = 512, num_classes: int = NUM_CLASSES,
               dtype=torch.bfloat16, device=None):
    super().__init__()
    dev = resolve_device(device)
    self.Dense_0 = Dense(int(np.prod(IMAGE_SHAPE)), hidden, dtype, dev)
    self.Dense_1 = Dense(hidden, num_classes, dtype, dev)

  def forward(self, x):
    x = torch.as_tensor(x, device=self.device)
    x = self.Dense_0(x.reshape(x.shape[0], -1))
    return self.Dense_1(F.relu(x)).float()


class CNN(_Model):
  """Small convnet: conv 32 -> pool -> conv 64 -> pool -> dense 256 ->
  dense 10."""

  def __init__(self, num_classes: int = NUM_CLASSES, dtype=torch.bfloat16,
               device=None):
    super().__init__()
    dev = resolve_device(device)
    self.Conv_0 = Conv(IMAGE_SHAPE[2], 32, dtype, dev)
    self.Conv_1 = Conv(32, 64, dtype, dev)
    flat = (IMAGE_SHAPE[0] // 4) * (IMAGE_SHAPE[1] // 4) * 64
    self.Dense_0 = Dense(flat, 256, dtype, dev)
    self.Dense_1 = Dense(256, num_classes, dtype, dev)

  def forward(self, x):
    x = torch.as_tensor(x, device=self.device).permute(0, 3, 1, 2)  # NCHW
    x = F.avg_pool2d(F.relu(self.Conv_0(x)), 2, 2)
    x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flax's NHWC order
    x = F.relu(self.Dense_0(x))
    return self.Dense_1(x).float()


def init_params(model: _Model, seed: int) -> Dict[str, np.ndarray]:
  """Random f32 weights for ``model`` with flax's init laws (lecun normal
  kernels, zero biases), from ``seed``. The numbers differ from flax's
  own init: numpy and JAX draw differently."""
  rng = np.random.default_rng(seed)
  out = {}
  for name, p in model.named_parameters():
    shape = tuple(p.shape)
    if name.endswith(".bias"):
      out[name] = np.zeros(shape, np.float32)
    else:
      fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
      out[name] = lecun_normal(rng, shape, fan_in)
  return out


def params_from_flax(tree: Mapping) -> Dict[str, np.ndarray]:
  """A flax MLP or CNN param tree (nested dicts of numpy arrays) as the
  port's flat names; HWIO conv kernels become OIHW."""
  out = {}
  for module, leaves in tree.items():
    for leaf, value in leaves.items():
      arr = np.asarray(value, np.float32)
      if module.startswith("Conv_") and leaf == "kernel":
        arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
      out["%s.%s" % (module, leaf)] = arr
  return out


def create_state(params: Union[int, Mapping[str, Any]] = 0,
                 model: Optional[_Model] = None,
                 learning_rate: float = 1e-3, device=None):
  """A :class:`~tensorflowonspark_tpu_torch.train_state.TrainState` of
  ``model`` (default: an :class:`MLP` on ``device``, ``None`` being the
  card) under Adam (optax's ``adam(learning_rate)``). ``params``: a seed
  or a flat weight dict (e.g. :func:`params_from_flax`)."""
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.train_state import TrainState
  model = model if model is not None else MLP(device=device)
  if isinstance(params, (int, np.integer)):
    params = init_params(model, int(params))
  model.load_params(params)
  tx = optim.chain(optim.scale_by_adam(),
                   optim.scale_by_learning_rate(learning_rate))
  return TrainState.create(model, tx)


def _labels(labels, device) -> torch.Tensor:
  if not torch.is_tensor(labels):
    labels = torch.as_tensor(np.asarray(labels))
  return labels.to(device).long()


def loss_fn(logits: torch.Tensor, labels) -> torch.Tensor:
  return F.cross_entropy(logits.float(), _labels(labels, logits.device))


def train_step(state, images, labels) -> Tuple[Any, torch.Tensor]:
  """One optimization step; returns ``(state, loss)`` (the state is
  updated in place and returned)."""
  params = state.params
  loss = loss_fn(state.model(images), labels)
  grads = torch.autograd.grad(loss, list(params.values()))
  state.apply_gradients(dict(zip(params, grads)))
  return state, loss.detach()


@torch.no_grad()
def eval_step(state, images, labels) -> Tuple[torch.Tensor, torch.Tensor]:
  """``(loss, accuracy)`` of the state's model on a batch."""
  logits = state.model(images)
  labels = _labels(labels, logits.device)
  accuracy = (logits.argmax(-1) == labels).float().mean()
  return loss_fn(logits, labels), accuracy


def synthetic_dataset(num: int, seed: int = 0,
                      noise: float = 0.05) -> Tuple[Any, Any]:
  """Deterministic synthetic MNIST-like data, the reference's draws: each
  class has a distinct template plus noise, so models learn."""
  rng = np.random.RandomState(seed)
  templates = rng.rand(NUM_CLASSES, *IMAGE_SHAPE).astype("float32")
  labels = rng.randint(0, NUM_CLASSES, size=num)
  images = templates[labels] + noise * rng.randn(num, *IMAGE_SHAPE) \
      .astype("float32")
  return images.astype("float32"), labels.astype("int32")
