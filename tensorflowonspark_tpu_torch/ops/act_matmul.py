"""tanh-GELU fused into the matrix product that consumes it: the port of
the Pallas ``gelu_matmul`` kernel.

Counterpart of ``tensorflowonspark_tpu/ops/act_matmul.py``: the forward
``_act_matmul_fwd`` with its kernel ``_act_matmul_kernel``, and the
custom VJP ``_bwd_rule``. :func:`gelu_matmul` computes ``gelu(x) @ W``
(the MLP down-projection over its pre-activation) with the activated
tensor never in device memory. On CUDA tensors the forward launches the
hand-written kernel in ``csrc/act_matmul.cu``; on CPU tensors it runs
:func:`gelu_matmul_reference`.

The backward (:func:`gelu_matmul_bwd`) is plain PyTorch on both devices,
as the reference's is plain XLA: GELU and its derivative recomputed in
f32 from the saved pre-activation, then two matrix products. GELU and
``gelu' * ga`` are PyTorch's fused tanh-GELU forward and backward (one
pass each over the ``[rows, F]`` tensor, where eager term-by-term
arithmetic would take a dozen).

GELU is the tanh approximation of ``jax.nn.gelu(approximate=True)``
(flax's default), with its constants copied here.
"""

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.ops import _build
from tensorflowonspark_tpu_torch.ops.ln_matmul import (body_name,
                                                       check_kernel_inputs,
                                                       matmul_f32)

# jax.nn.gelu(approximate=True): sqrt(2 / pi) in the input's dtype (f32)
_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))
_CUBIC = 0.044715


def gelu_tanh(xf: torch.Tensor) -> torch.Tensor:
  """``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))``, in the
  order ``jax.nn.gelu(approximate=True)`` writes it."""
  cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (xf + _CUBIC * xf ** 3)))
  return xf * cdf


def _check_shapes(x: torch.Tensor, W: torch.Tensor) -> Tuple[int, int]:
  f = x.shape[-1]
  if W.dim() != 2 or W.shape[0] != f:
    raise ValueError("gelu_matmul needs x [..., F] and W [F, N]; got %s, %s"
                     % (tuple(x.shape), tuple(W.shape)))
  return f, W.shape[1]


def gelu_matmul_reference(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
  """The plain version, as ``_act_matmul_kernel`` computes it: GELU in f32
  rounded to W's dtype, the product summed in f32, the result in x's
  dtype."""
  f, n = _check_shapes(x, W)
  a = gelu_tanh(x.reshape(-1, f).float()).to(W.dtype)
  return matmul_f32(a, W).to(x.dtype).reshape(x.shape[:-1] + (n,))


def gelu_matmul_bwd(x: torch.Tensor, W: torch.Tensor, g: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """``(dx, dW)`` for the output cotangent ``g``: the reference's
  ``_bwd_rule`` term for term. ``a = gelu(x)`` in f32 then x's dtype,
  ``dW = a^T g`` and ``ga = g W^T`` summed in f32, ``dx = gelu'(x) * ga``
  in f32; each returned in its input's dtype."""
  f, n = _check_shapes(x, W)
  x2 = x.reshape(-1, f)
  gx = g.reshape(-1, n).to(x.dtype)
  a = F.gelu(x2, approximate="tanh")         # f32 arithmetic, x's dtype
  dW = matmul_f32(a.t(), gx)
  ga = matmul_f32(gx, W.t())
  dx = torch.ops.aten.gelu_backward(ga, x2.float(), approximate="tanh")
  return dx.reshape(x.shape).to(x.dtype), dW.to(W.dtype)


def _lib() -> ctypes.CDLL:
  lib = _build.load("act_matmul")
  if lib.tos_gelu_matmul.argtypes is None:
    lib.tos_gelu_matmul.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tos_gelu_matmul.restype = ctypes.c_int
    lib.tos_gelu_matmul_body.argtypes = [ctypes.c_int] * 3
    lib.tos_gelu_matmul_body.restype = ctypes.c_int
  return lib


def kernel_body(f: int, n: int, dtype: torch.dtype) -> str:
  """Which body the card's kernel runs for x ``[.., f]`` and W ``[f, n]``
  in ``dtype``, as its dispatcher (``csrc/act_matmul.cu``) decides:
  ``"wgmma"`` (bf16, f and n multiples of 8), ``"wmma"`` (other bf16
  widths) or ``"f32"``. Builds the kernel's library on first use."""
  return body_name(_lib().tos_gelu_matmul_body(f, n, _build.DTYPE_CODES[dtype]),
                   "gelu_matmul", dtype)


def _forward(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
  if not ops.on_card(x, W):
    return gelu_matmul_reference(x, W)
  f, n = _check_shapes(x, W)
  check_kernel_inputs("gelu_matmul", x, W)
  x2, W = _build.aligned(x.reshape(-1, f)), _build.aligned(W)
  rows = x2.shape[0]
  out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
  if rows and n:
    lib = _lib()
    rc = lib.tos_gelu_matmul(_build.ptr(x2), _build.ptr(W), _build.ptr(out),
                             rows, f, n, _build.DTYPE_CODES[x.dtype],
                             x.device.index, _build.stream_handle(x))
    _build.check(lib, rc, "gelu_matmul kernel")
    ops.count_launch("gelu_matmul")
  return out.reshape(x.shape[:-1] + (n,))


class _GeluMatmulFn(torch.autograd.Function):
  """The fused forward with the reference's custom VJP: residuals are
  ``(x, W)`` only; the backward recomputes the activation."""

  @staticmethod
  def forward(ctx, x, W):
    ctx.save_for_backward(x, W)
    return _forward(x, W)

  @staticmethod
  def backward(ctx, g):
    x, W = ctx.saved_tensors
    dx, dW = gelu_matmul_bwd(x, W, g)
    return (dx if ctx.needs_input_grad[0] else None,
            dW if ctx.needs_input_grad[1] else None)


def gelu_matmul(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
  """``gelu(x) @ W`` (tanh-GELU) with the activated tensor never in device
  memory. x: ``[..., F]`` pre-activation; W: ``[F, N]``. Returns ``[...,
  N]`` in x's dtype. CUDA tensors run the kernel (x and W both bf16 or
  both f32, F and N of any width; launched on the current stream, no
  synchronisation); CPU tensors run :func:`gelu_matmul_reference`.
  Differentiable in both: the backward is :func:`gelu_matmul_bwd`."""
  _check_shapes(x, W)
  if torch.is_grad_enabled() and (x.requires_grad or W.requires_grad):
    return _GeluMatmulFn.apply(x, W)
  return _forward(x, W)


def gelu_matmul_sharded(x: torch.Tensor, W: torch.Tensor,
                        mesh) -> torch.Tensor:
  """The per-shard GELU->matmul of the JAX package's
  ``gelu_matmul_sharded``: the kernel on this rank's rows of the
  pre-activation ``x [.., F / tensor]`` and its row block of ``W [F /
  tensor, N]``. The contracted ``F`` is cut over ``tensor``, so the local
  products are partial sums, added over the axis by one all-reduce
  (``collectives.reduce_from``: the gradient passes through as it is; the
  identity at tensor degree 1), the collective the unfused
  down-projection needs too."""
  from tensorflowonspark_tpu_torch.parallel import collectives
  from tensorflowonspark_tpu_torch.parallel.mesh import AXIS_TENSOR
  return collectives.reduce_from(gelu_matmul(x, W), mesh, AXIS_TENSOR)
