"""LayerNorm (no bias): the port of the fused Pallas LayerNorm, forward and
backward.

Counterpart of ``tensorflowonspark_tpu/ops/layer_norm.py``: ``_ln_fwd``
with its kernel ``_ln_fwd_kernel``, and the custom VJP ``_ln_bwd_rule``
with ``_ln_bwd_kernel``. On CUDA tensors both directions launch the
hand-written kernels in ``csrc/layer_norm.cu``; on CPU tensors they run
:func:`layer_norm_reference` / :func:`layer_norm_bwd_reference`.
:func:`layer_norm` is differentiable in ``x`` and ``weight`` through a
``torch.autograd.Function`` whose backward is the kernel; like the TPU
kernel, the backward recomputes the row statistics from ``x`` (nothing
but ``x`` and ``weight`` is saved).

Layout: ``[..., hidden]``; the leading dims flatten to rows, of any width
(the forward takes a warp per row up to 8192 and a block per row past it;
the backward holds each row in the registers of 1 to 8 warps, and takes a
block per row where that cannot hold it).
"""

import ctypes
from typing import Tuple

import torch

from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.ops import _build


def _stats(xf: torch.Tensor, eps: float):
  mu = xf.mean(dim=-1, keepdim=True)
  xc = xf - mu
  var = (xc * xc).mean(dim=-1, keepdim=True)
  return xc, torch.rsqrt(var + eps)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
  """The plain version: f32 statistics with the centered variance
  ``mean((x - mean)^2)``, output in ``x``'s dtype."""
  xc, rstd = _stats(x.float(), eps)
  return (xc * rstd * weight.float()).to(x.dtype)


def layer_norm_bwd_reference(x: torch.Tensor, weight: torch.Tensor,
                             g: torch.Tensor, eps: float = 1e-6
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The plain backward, as ``_ln_bwd_kernel`` computes it: statistics
  recomputed from ``x``, ``dx = rstd * (dy - mean(dy) - xhat *
  mean(dy * xhat))`` with ``dy = g * weight`` (in x's dtype), and
  ``dw = sum over rows of g * xhat`` (f32, in weight's dtype)."""
  xc, rstd = _stats(x.float(), eps)
  xhat = xc * rstd
  gf = g.float()
  dy = gf * weight.float()
  m1 = dy.mean(dim=-1, keepdim=True)
  m2 = (dy * xhat).mean(dim=-1, keepdim=True)
  dx = rstd * (dy - m1 - xhat * m2)
  dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
  return dx.to(x.dtype), dw.to(weight.dtype)


def _lib() -> ctypes.CDLL:
  lib = _build.load("layer_norm")
  if lib.tos_layer_norm_fwd.argtypes is None:
    lib.tos_layer_norm_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.tos_layer_norm_fwd.restype = ctypes.c_int
    lib.tos_layer_norm_bwd.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.tos_layer_norm_bwd.restype = ctypes.c_int
    lib.tos_layer_norm_bwd_partials.argtypes = [ctypes.c_int] * 4
    lib.tos_layer_norm_bwd_partials.restype = ctypes.c_int
  return lib


def _check_kernel_inputs(x: torch.Tensor, weight: torch.Tensor) -> None:
  if x.dtype not in _build.DTYPE_CODES:
    raise TypeError("layer_norm kernel takes bf16 or f32, got %s" % x.dtype)
  if weight.dtype != torch.float32:
    raise TypeError("layer_norm weight must be f32, got %s" % weight.dtype)
  if x.shape[-1] <= 0:
    raise ValueError("layer_norm kernel takes H > 0, got %d" % x.shape[-1])


def _forward(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
  if not ops.on_card(x, weight):
    return layer_norm_reference(x, weight, eps)
  _check_kernel_inputs(x, weight)
  x = x.contiguous()
  weight = weight.contiguous()
  y = torch.empty_like(x)
  h = x.shape[-1]
  rows = x.numel() // h
  if rows == 0:
    return y
  lib = _lib()
  rc = lib.tos_layer_norm_fwd(_build.ptr(x), _build.ptr(weight),
                              _build.ptr(y), rows, h, float(eps),
                              _build.DTYPE_CODES[x.dtype], x.device.index,
                              _build.stream_handle(x))
  _build.check(lib, rc, "layer_norm kernel")
  ops.count_launch("layer_norm")
  return y


def layer_norm_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                   eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
  """``(dx, dw)`` of :func:`layer_norm` for the output cotangent ``g``:
  dx in x's dtype, dw ``[H]`` f32 summed over every row in a fixed order
  (bitwise reproducible). CUDA tensors run the kernel (two launches on the
  current stream: per-block partials, then their sum; the number of
  partial rows follows the card's SM count); CPU tensors run
  :func:`layer_norm_bwd_reference`."""
  h = x.shape[-1]
  if g.shape != x.shape or weight.shape != (h,):
    raise ValueError("layer_norm_bwd needs g shaped like x %s and weight "
                     "[%d], got %s and %s" % (tuple(x.shape), h,
                                              tuple(g.shape),
                                              tuple(weight.shape)))
  if not ops.on_card(x, weight, g):
    return layer_norm_bwd_reference(x, weight, g, eps)
  _check_kernel_inputs(x, weight)
  if g.dtype != x.dtype:
    raise TypeError("layer_norm_bwd takes g in x's dtype %s, got %s"
                    % (x.dtype, g.dtype))
  x, g = _build.aligned(x), _build.aligned(g)
  weight = weight.contiguous()
  dx = torch.empty_like(x)
  rows = x.numel() // h
  if rows == 0:
    return dx, torch.zeros(h, dtype=torch.float32, device=x.device)
  dw = torch.empty(h, dtype=torch.float32, device=x.device)
  lib = _lib()
  code = _build.DTYPE_CODES[x.dtype]
  n_partial = lib.tos_layer_norm_bwd_partials(rows, h, code, x.device.index)
  if n_partial <= 0:
    raise RuntimeError("layer_norm backward kernel: no plan for %d rows of "
                       "H %d" % (rows, h))
  partial = torch.empty((n_partial, h), dtype=torch.float32, device=x.device)
  rc = lib.tos_layer_norm_bwd(_build.ptr(x), _build.ptr(weight), _build.ptr(g),
                              _build.ptr(dx), _build.ptr(partial), n_partial,
                              _build.ptr(dw), rows, h, float(eps), code,
                              x.device.index, _build.stream_handle(x))
  _build.check(lib, rc, "layer_norm backward kernel")
  ops.count_launch("layer_norm_bwd")
  return dx, dw


class _LayerNormFn(torch.autograd.Function):
  """LayerNorm whose backward is :func:`layer_norm_bwd` (the custom VJP
  of the JAX package: residuals are ``x`` and ``weight`` only)."""

  @staticmethod
  def forward(ctx, x, weight, eps):
    ctx.save_for_backward(x, weight)
    ctx.eps = eps
    return _forward(x, weight, eps)

  @staticmethod
  def backward(ctx, g):
    x, weight = ctx.saved_tensors
    dx, dw = layer_norm_bwd(x, weight, g, ctx.eps)
    return (dx if ctx.needs_input_grad[0] else None,
            dw if ctx.needs_input_grad[1] else None, None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
  """``(x - mean) * rsqrt(var + eps) * weight`` over the last axis.

  x: ``[..., H]`` in bf16 or f32; weight: ``[H]`` f32. Returns ``x``'s
  dtype. CUDA tensors run the kernel (launched on the current stream, no
  synchronisation); CPU tensors run :func:`layer_norm_reference`.
  Differentiable in ``x`` and ``weight``: the backward is
  :func:`layer_norm_bwd`.
  """
  h = x.shape[-1]
  if weight.shape != (h,):
    raise ValueError("weight must be [%d], got %s" % (h, tuple(weight.shape)))
  if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
    return _LayerNormFn.apply(x, weight, eps)
  return _forward(x, weight, eps)


