"""LayerNorm fused into the matrix product that consumes it: the port of
the Pallas ``ln_matmul`` kernel.

Counterpart of ``tensorflowonspark_tpu/ops/ln_matmul.py``: the forward
``_ln_matmul_fwd`` with its kernel ``_ln_matmul_kernel``, and the custom
VJP ``_bwd_rule``. :func:`ln_matmul` computes ``LN(x) * w_ln @ W`` with
the normalized activation never in device memory. On CUDA tensors the
forward launches the hand-written kernel in ``csrc/ln_matmul.cu`` (a row
statistics pass, then the product with the LayerNorm applied on the way
into the tensor cores; :func:`kernel_body` says which body a shape takes);
on CPU tensors it runs :func:`ln_matmul_reference`.

The backward (:func:`ln_matmul_bwd`) is plain PyTorch on both devices, as
the reference's is plain XLA outside any Pallas kernel: it recomputes
``xhat`` from the saved ``x``, then two matrix products and the
two-mean LayerNorm backward, term for term. XLA fuses the elementwise
terms; eager PyTorch would run each as a kernel of its own over the
``[rows, H]`` f32 tensors, so the normalisation and the LayerNorm
backward go through PyTorch's fused LayerNorm ops, which compute the
same terms.

Layout: x ``[..., H]`` (leading dims flatten to rows), w_ln ``[H]`` f32,
W ``[H, N]``; the output is ``[..., N]`` in x's dtype.
"""

import ctypes
from typing import Tuple

import torch

from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.ops import _build
from tensorflowonspark_tpu_torch.ops.layer_norm import _stats


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """``a @ b`` (2-D) with an f32 result, as JAX's ``dot_general(...,
  preferred_element_type=float32)``: the operands' products are exact in
  f32 and sum in f32, where ``torch.matmul`` of two bf16 tensors would
  round its result to bf16. On the card cuBLAS takes the bf16 operands
  with an f32 output directly; elsewhere the operands are widened first,
  which forms the same products."""
  if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
    return torch.mm(a, b, out_dtype=torch.float32)
  return a.float() @ b.float()


def _check_shapes(x: torch.Tensor, w_ln: torch.Tensor,
                  W: torch.Tensor) -> Tuple[int, int]:
  h = x.shape[-1]
  if w_ln.shape != (h,) or W.dim() != 2 or W.shape[0] != h:
    raise ValueError("ln_matmul needs x [..., H], w_ln [H] and W [H, N]; got "
                     "%s, %s, %s" % (tuple(x.shape), tuple(w_ln.shape),
                                     tuple(W.shape)))
  return h, W.shape[1]


def ln_matmul_reference(x: torch.Tensor, w_ln: torch.Tensor, W: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
  """The plain version, as ``_ln_matmul_kernel`` computes it: f32
  statistics with the centered variance, ``(x - mean) * rstd * w_ln`` in
  f32 rounded to W's dtype, the product summed in f32, the result in x's
  dtype."""
  h, n = _check_shapes(x, w_ln, W)
  xc, rstd = _stats(x.reshape(-1, h).float(), eps)
  xn = (xc * rstd * w_ln.float()).to(W.dtype)
  return matmul_f32(xn, W).to(x.dtype).reshape(x.shape[:-1] + (n,))


def ln_matmul_bwd(x: torch.Tensor, w_ln: torch.Tensor, W: torch.Tensor,
                  g: torch.Tensor, eps: float = 1e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """``(dx, dw_ln, dW)`` for the output cotangent ``g``: the reference's
  ``_bwd_rule`` term for term. ``xhat`` is recomputed in f32, ``y =
  (xhat * w_ln)`` in x's dtype, ``dW = y^T g`` and ``gy = g W^T`` summed
  in f32, ``dw_ln = sum(gy * xhat)`` and ``dx = rstd * (dy - mean(dy) -
  xhat * mean(dy * xhat))`` with ``dy = gy * w_ln``; each returned in its
  input's dtype. The row statistics, ``xhat * w_ln`` and the last two
  terms come from PyTorch's fused LayerNorm forward and backward in f32
  (one pass each where the terms one by one take a dozen)."""
  h, n = _check_shapes(x, w_ln, W)
  xf = x.reshape(-1, h).float()
  wf = w_ln.float()
  gx = g.reshape(-1, n).to(x.dtype)
  yf, mean, rstd = torch.native_layer_norm(xf, (h,), wf, None, eps)
  dW = matmul_f32(yf.to(x.dtype).t(), gx)
  gy = matmul_f32(gx, W.t())
  dx, dw_ln, _ = torch.ops.aten.native_layer_norm_backward(
      gy, xf, (h,), mean, rstd, wf, None, (True, True, False))
  return (dx.reshape(x.shape).to(x.dtype), dw_ln.to(w_ln.dtype),
          dW.to(W.dtype))


def check_kernel_inputs(name: str, x: torch.Tensor, W: torch.Tensor,
                        w_ln=None) -> None:
  """What the fused-product kernels take: x and W both bf16 or both f32,
  w_ln f32. K (= H or F) and N may be any width: bf16 widths that are not
  multiples of 8 take the WMMA body, which reads element by element."""
  if x.dtype not in _build.DTYPE_CODES or W.dtype != x.dtype:
    raise TypeError("%s kernel takes x and W both bf16 or both f32, got %s "
                    "and %s" % (name, x.dtype, W.dtype))
  if w_ln is not None and w_ln.dtype != torch.float32:
    raise TypeError("%s w_ln must be f32, got %s" % (name, w_ln.dtype))


def _lib() -> ctypes.CDLL:
  lib = _build.load("ln_matmul")
  if lib.tos_ln_matmul.argtypes is None:
    lib.tos_ln_matmul.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.tos_ln_matmul.restype = ctypes.c_int
    lib.tos_ln_matmul_body.argtypes = [ctypes.c_int] * 3
    lib.tos_ln_matmul_body.restype = ctypes.c_int
  return lib


#: the fused products' bodies, by the code their dispatchers give them
#: (``tos::pgemm_wg::body`` in ``csrc/prologue_gemm_wgmma.cuh``)
KERNEL_BODIES = {2: "wgmma", 1: "wmma", 0: "f32"}


def body_name(code: int, name: str, dtype: torch.dtype) -> str:
  """The name of the body a fused product's dispatcher gave ``code``."""
  if code not in KERNEL_BODIES:
    raise ValueError("%s has no kernel body for %s" % (name, dtype))
  return KERNEL_BODIES[code]


def kernel_body(h: int, n: int, dtype: torch.dtype) -> str:
  """Which body the card's kernel runs for x ``[.., h]`` and W ``[h, n]``
  in ``dtype``, as its dispatcher (``csrc/ln_matmul.cu``) decides:
  ``"wgmma"`` (bf16, h and n multiples of 8), ``"wmma"`` (other bf16
  widths) or ``"f32"``. Builds the kernel's library on first use."""
  return body_name(_lib().tos_ln_matmul_body(h, n, _build.DTYPE_CODES[dtype]),
                   "ln_matmul", dtype)


def _forward(x: torch.Tensor, w_ln: torch.Tensor, W: torch.Tensor,
             eps: float) -> torch.Tensor:
  if not ops.on_card(x, w_ln, W):
    return ln_matmul_reference(x, w_ln, W, eps)
  h, n = _check_shapes(x, w_ln, W)
  check_kernel_inputs("ln_matmul", x, W, w_ln)
  x2, W, w_ln = (_build.aligned(x.reshape(-1, h)), _build.aligned(W),
                 _build.aligned(w_ln))
  rows = x2.shape[0]
  out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
  if rows and n:
    lib = _lib()
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    rc = lib.tos_ln_matmul(_build.ptr(x2), _build.ptr(w_ln), _build.ptr(stats),
                           _build.ptr(W), _build.ptr(out), rows, h, n, float(eps),
                           _build.DTYPE_CODES[x.dtype], x.device.index,
                           _build.stream_handle(x))
    _build.check(lib, rc, "ln_matmul kernel")
    ops.count_launch("ln_matmul")
  return out.reshape(x.shape[:-1] + (n,))


class _LnMatmulFn(torch.autograd.Function):
  """The fused forward with the reference's custom VJP: residuals are
  ``(x, w_ln, W)`` only; the backward recomputes the norm."""

  @staticmethod
  def forward(ctx, x, w_ln, W, eps):
    ctx.save_for_backward(x, w_ln, W)
    ctx.eps = eps
    return _forward(x, w_ln, W, eps)

  @staticmethod
  def backward(ctx, g):
    x, w_ln, W = ctx.saved_tensors
    grads = ln_matmul_bwd(x, w_ln, W, g, ctx.eps)
    return tuple(d if need else None
                 for d, need in zip(grads, ctx.needs_input_grad)) + (None,)


def ln_matmul(x: torch.Tensor, w_ln: torch.Tensor, W: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
  """``layer_norm(x, w_ln) @ W`` with the normalized activation never in
  device memory. x: ``[..., H]``; w_ln: ``[H]`` f32; W: ``[H, N]``.
  Returns ``[..., N]`` in x's dtype. CUDA tensors run the kernel (x and W
  both bf16 or both f32, H and N of any width; launched on the current
  stream, no synchronisation); CPU tensors run
  :func:`ln_matmul_reference`. Differentiable in all three: the backward
  is :func:`ln_matmul_bwd`."""
  _check_shapes(x, w_ln, W)
  if torch.is_grad_enabled() and (x.requires_grad or w_ln.requires_grad
                                  or W.requires_grad):
    return _LnMatmulFn.apply(x, w_ln, W, eps)
  return _forward(x, w_ln, W, eps)


def ln_matmul_sharded(x: torch.Tensor, w_ln: torch.Tensor, W: torch.Tensor,
                      mesh, eps: float = 1e-6) -> torch.Tensor:
  """The per-shard LN->matmul of the JAX package's ``ln_matmul_sharded``:
  the kernel on this rank's rows of ``x`` and its column block of ``W``
  (``[H, N / tensor]``: the QKV heads or the MLP up columns). ``H`` is
  whole, so the forward needs no collective. ``x`` and ``w_ln``, which
  every rank of the tensor axis holds alike, enter through
  ``collectives.copy_to``: their gradients, each rank's share from its
  columns, are summed over the axis in the backward (the identity at
  tensor degree 1)."""
  from tensorflowonspark_tpu_torch.parallel import collectives
  from tensorflowonspark_tpu_torch.parallel.mesh import AXIS_TENSOR
  x = collectives.copy_to(x, mesh, AXIS_TENSOR)
  w_ln = collectives.copy_to(w_ln, mesh, AXIS_TENSOR)
  return ln_matmul(x, w_ln, W, eps)
