"""Flash attention: the port of the Pallas flash-attention kernels,
forward and fused backward.

Counterpart of ``tensorflowonspark_tpu/ops/flash_attention.py``: the
forward ``_fwd_impl`` (kernel ``_attn_fwd_kernel``) and the single-pass
backward ``_bwd_impl`` (kernels ``_attn_bwd_fused_kernel`` and, for
grouped K/V, ``_attn_bwd_fused_gqa_kernel``), with the public
``flash_attention`` / ``flash_attention_block`` made differentiable by
autograd Functions whose backward is the kernel. On CUDA
tensors the wrappers launch the hand-written kernels in
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``; on CPU
tensors they run :func:`flash_attention_reference` and
:func:`flash_attention_bwd_reference`.

Layout ``[batch, seq, heads, head_dim]``. K/V may carry ``heads / g``
heads (grouped-query attention, consumed unexpanded: query head ``i``
reads KV head ``i // g``). ``q_base``/``kv_base`` are the absolute
positions of the first query and key, as in ``flash_attention_block``.

The backward plan is ``"fused"`` (the only one ported); ``"split"`` (the
reference's separate dQ and dK/dV kernels) raises ``NotImplementedError``
when a gradient is asked for.
"""

import ctypes
import math
import os
from typing import Optional, Tuple

import torch

from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.ops import _build

NEG_INF = -1e30
#: head dims the kernels are instantiated for
HEAD_DIMS = (64, 128)
#: backward plans of the reference (only "fused" is ported)
BWD_MODES = ("fused", "split")


def _check_window(window, causal):
  if window is None:
    return None
  window = int(window)
  if window < 1:
    raise ValueError("window must be >= 1, got %d" % window)
  if not causal:
    raise ValueError("sliding-window attention requires causal=True "
                     "(the window is 'the last W positions')")
  return window


def _check_shapes(q, k, v):
  if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
    raise ValueError("q must be [B, Sq, H, D] and k, v the same [B, Sk, Hk, D]"
                     ", got %s, %s, %s" % (tuple(q.shape), tuple(k.shape),
                                           tuple(v.shape)))
  b, _, h, d = q.shape
  if k.shape[0] != b or k.shape[3] != d:
    raise ValueError("q and k/v disagree on batch or head_dim: %s vs %s"
                     % (tuple(q.shape), tuple(k.shape)))
  if h % k.shape[2]:
    raise ValueError("kv heads (%d) must divide query heads (%d)"
                     % (k.shape[2], h))


def _keep_mask(sq, sk, q_base, kv_base, window, device):
  """``[Sq, Sk]`` visibility under the causal (+ window) mask."""
  q_pos = q_base + torch.arange(sq, device=device)[:, None]
  k_pos = kv_base + torch.arange(sk, device=device)[None, :]
  keep = k_pos <= q_pos
  if window is not None:
    keep = keep & (k_pos > q_pos - window)
  return keep


def flash_attention_reference(q, k, v, q_base: int = 0, kv_base: int = 0,
                              causal: bool = True,
                              window: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The plain version: dense f32 scores ``[B, H, Sq, Sk]`` with the
  kernel's masks and -1e30 fill. Returns ``(out, lse)``: ``out`` in q's
  dtype, ``lse`` f32 ``[B, H, Sq]``; an empty row gives out 0, lse -1e30.
  """
  window = _check_window(window, causal)
  _check_shapes(q, k, v)
  b, sq, h, d = q.shape
  sk, g = k.shape[1], h // k.shape[2]
  qf = q.float() * (1.0 / math.sqrt(d))
  kf = k.float().repeat_interleave(g, dim=2)
  vf = v.float().repeat_interleave(g, dim=2)
  s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
  if causal:
    keep = _keep_mask(sq, sk, int(q_base), int(kv_base), window, q.device)
  else:
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
  s = torch.where(keep, s, torch.full_like(s, NEG_INF))
  empty = ~keep.any(dim=-1)                                # [Sq]
  lse = torch.logsumexp(s, dim=-1)
  lse = torch.where(empty, torch.full_like(lse, NEG_INF), lse)
  lse_safe = torch.where(empty, torch.zeros_like(lse), lse)
  p = torch.where(keep, torch.exp(s - lse_safe[..., None]),
                  torch.zeros_like(s))
  out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
  return out.to(q.dtype), lse


def _group_sum(x: torch.Tensor, hk: int) -> torch.Tensor:
  """``[B, S, H, D]`` -> ``[B, S, Hk, D]``: sum each KV head's query group."""
  b, s, h, d = x.shape
  return x.reshape(b, s, hk, h // hk, d).sum(dim=3)


def flash_attention_bwd_reference(q, k, v, out, lse, g, g_lse=None,
                                  q_base: int = 0, kv_base: int = 0,
                                  causal: bool = True,
                                  window: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
  """The plain backward: dense f32 scores and the fused kernel's math
  (``_pair_p_ds``): P recomputed from ``lse`` with masked entries and
  empty rows forced to 0, ``dS = P * (dO V^T - Delta)`` with ``Delta =
  sum_d dO * O - g_lse``. Returns ``(dq, dk, dv)`` in q's / k's / v's
  dtypes; grouped dK/dV are summed over each KV head's query heads."""
  window = _check_window(window, causal)
  _check_shapes(q, k, v)
  b, sq, h, d = q.shape
  sk, hk = k.shape[1], k.shape[2]
  grp = h // hk
  scale = 1.0 / math.sqrt(d)
  qf = q.float() * scale
  kf = k.float().repeat_interleave(grp, dim=2)
  vf = v.float().repeat_interleave(grp, dim=2)
  gf = g.float()
  s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
  if causal:
    keep = _keep_mask(sq, sk, int(q_base), int(kv_base), window, q.device)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
  lse = lse.float()[..., None]                                 # [B, H, Sq, 1]
  lse_safe = torch.where(lse <= NEG_INF, torch.zeros_like(lse), lse)
  p = torch.exp(s - lse_safe)
  p = torch.where((s <= NEG_INF) | (lse <= NEG_INF), torch.zeros_like(p), p)
  delta = (gf * out.float()).sum(dim=-1).transpose(1, 2)       # [B, H, Sq]
  if g_lse is not None:
    delta = delta - g_lse.float()
  dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
  ds = p * (dp - delta[..., None])
  dv = _group_sum(torch.einsum("bhqk,bqhd->bkhd", p, gf), hk)
  dk = _group_sum(torch.einsum("bhqk,bqhd->bkhd", ds, qf), hk)
  dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
  return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def default_bwd_mode() -> str:
  """Backward plan from ``TFOS_TPU_FLASH_BWD`` (``fused``, the default, or
  ``split``), the JAX package's knob."""
  mode = os.environ.get("TFOS_TPU_FLASH_BWD", "fused")
  if mode not in BWD_MODES:
    raise ValueError("TFOS_TPU_FLASH_BWD must be 'fused' or 'split', got %r"
                     % (mode,))
  return mode


def _resolve_bwd(bwd: Optional[str]) -> str:
  bwd = bwd or default_bwd_mode()
  if bwd not in BWD_MODES:
    raise ValueError("bwd must be 'fused' or 'split', got %r" % (bwd,))
  return bwd


def _check_kernel_dtypes(what, *tensors):
  dtype = tensors[0].dtype
  if dtype not in _build.DTYPE_CODES or any(t.dtype != dtype
                                            for t in tensors):
    raise TypeError("%s takes its tensors all bf16 or all f32, got %s"
                    % (what, ", ".join(str(t.dtype) for t in tensors)))


def _lib(name: str, fn_name: str, argtypes) -> ctypes.CDLL:
  lib = _build.load(name)
  fn = getattr(lib, fn_name)
  if fn.argtypes is None:
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
  return lib


_FWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _forward(q, k, v, q_base, kv_base, causal, window):
  if not ops.on_card(q, k, v):
    return flash_attention_reference(q, k, v, q_base, kv_base, causal, window)
  b, sq, h, d = q.shape
  sk, hk = k.shape[1], k.shape[2]
  if d not in HEAD_DIMS:
    raise ValueError("flash_attention kernel takes head_dim in %s, got %d"
                     % (HEAD_DIMS, d))
  _check_kernel_dtypes("flash_attention kernel", q, k, v)
  q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
  out = torch.empty_like(q)
  lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
  if out.numel() == 0:
    return out, lse
  lib = _lib("flash_attention", "tos_flash_attention_fwd", _FWD_ARGS)
  rc = lib.tos_flash_attention_fwd(
      _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
      _build.ptr(lse), b, sq, sk, h, hk, d, int(q_base), int(kv_base),
      int(bool(causal)), window or 0, 1.0 / math.sqrt(d),
      _build.DTYPE_CODES[q.dtype], q.device.index, _build.stream_handle(q))
  _build.check(lib, rc, "flash_attention kernel")
  ops.count_launch("flash_attention_fwd")
  return out, lse


def flash_attention_bwd(q, k, v, out, lse, g, g_lse=None, q_base: int = 0,
                        kv_base: int = 0, causal: bool = True,
                        window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """``(dq, dk, dv)`` for the forward's ``(out, lse)`` and their
  cotangents ``g`` (and ``g_lse``, or None), exactly as the JAX package's
  fused ``_bwd_impl``. CUDA tensors run the kernel (a Delta pre-pass and
  the backward, on the current stream; bitwise reproducible); CPU tensors
  run :func:`flash_attention_bwd_reference`."""
  window = _check_window(window, causal)
  _check_shapes(q, k, v)
  if out.shape != q.shape or g.shape != q.shape:
    raise ValueError("out and g must be shaped like q %s, got %s and %s"
                     % (tuple(q.shape), tuple(out.shape), tuple(g.shape)))
  b, sq, h, d = q.shape
  sk, hk = k.shape[1], k.shape[2]
  if lse.shape != (b, h, sq) or (g_lse is not None
                                 and g_lse.shape != (b, h, sq)):
    raise ValueError("lse and g_lse must be [%d, %d, %d]" % (b, h, sq))
  extra = () if g_lse is None else (g_lse,)
  if not ops.on_card(q, k, v, out, lse, g, *extra):
    return flash_attention_bwd_reference(q, k, v, out, lse, g, g_lse, q_base,
                                         kv_base, causal, window)
  if d not in HEAD_DIMS:
    raise ValueError("flash_attention backward kernel takes head_dim in %s, "
                     "got %d" % (HEAD_DIMS, d))
  _check_kernel_dtypes("flash_attention backward kernel", q, k, v, out, g)
  if lse.dtype != torch.float32 or any(t.dtype != torch.float32
                                       for t in extra):
    raise TypeError("lse and g_lse must be f32")
  q, k, v, out, lse, g = (t.contiguous() for t in (q, k, v, out, lse, g))
  extra = tuple(t.contiguous() for t in extra)
  dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
  if dq.numel() == 0 or sk == 0:
    return dq.zero_(), dk.zero_(), dv.zero_()
  delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
  dq_acc = dq if q.dtype == torch.float32 else torch.empty(
      q.shape, dtype=torch.float32, device=q.device)
  # grouped KV: each query head's f32 dK/dV, summed in head order after
  part = None if h == hk else torch.empty(
      (2, b, hk, h // hk, sk, d), dtype=torch.float32, device=q.device)
  lib = _lib("flash_attention_bwd", "tos_flash_attention_bwd", _BWD_ARGS)
  rc = lib.tos_flash_attention_bwd(
      _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
      _build.ptr(g), _build.ptr(lse),
      _build.ptr(extra[0]) if extra else None, _build.ptr(delta),
      _build.ptr(dq_acc), _build.ptr(dq), _build.ptr(dk), _build.ptr(dv),
      None if part is None else _build.ptr(part), b, sq, sk, h, hk, d,
      int(q_base), int(kv_base), int(bool(causal)), window or 0,
      1.0 / math.sqrt(d), _build.DTYPE_CODES[q.dtype], q.device.index,
      _build.stream_handle(q))
  _build.check(lib, rc, "flash_attention backward kernel")
  ops.count_launch("flash_attention_bwd" if h == hk
                   else "flash_attention_bwd_gqa")
  return dq, dk, dv


class _FlashFn(torch.autograd.Function):
  """(out, lse) with the fused backward kernel as its VJP; an lse
  cotangent folds into Delta (``flash_attention_block``'s custom VJP),
  an absent one (``flash_attention``) is None."""

  @staticmethod
  def forward(ctx, q, k, v, q_base, kv_base, causal, window):
    out, lse = _forward(q, k, v, q_base, kv_base, causal, window)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.args = (q_base, kv_base, causal, window)
    ctx.set_materialize_grads(False)
    return out, lse

  @staticmethod
  def backward(ctx, g, g_lse):
    q, k, v, out, lse = ctx.saved_tensors
    if g is None:
      g = torch.zeros_like(out)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, g_lse, *ctx.args)
    return dq, dk, dv, None, None, None, None


def flash_attention_fwd(q, k, v, q_base: int = 0, kv_base: int = 0,
                        causal: bool = True, window: Optional[int] = None,
                        bwd: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Attention of ``q`` (at ``q_base + arange(Sq)``) against ``k``/``v``
  (at ``kv_base + arange(Sk)``) — the port of ``flash_attention_block``.
  Returns ``(out, lse)`` exactly as the JAX package's ``_fwd_impl``: out
  ``[B, Sq, H, D]`` in q's dtype, lse f32 ``[B, H, Sq]``. CUDA tensors run
  the kernel on the current stream (bf16 or f32, head_dim 64 or 128); CPU
  tensors run the plain version. Differentiable in q, k, v through both
  outputs (``bwd``: the backward plan, see :func:`default_bwd_mode`).
  """
  window = _check_window(window, causal)
  _check_shapes(q, k, v)
  bwd = _resolve_bwd(bwd)
  if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
    if bwd == "split":
      raise NotImplementedError(
          "the split flash-attention backward (separate dQ and dK/dV "
          "kernels) is not ported to PyTorch yet (ROADMAP Queue 2 rows "
          "5-7); use bwd='fused'")
    return _FlashFn.apply(q, k, v, int(q_base), int(kv_base), bool(causal),
                          window)
  return _forward(q, k, v, q_base, kv_base, causal, window)


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None,
                    bwd: Optional[str] = None) -> torch.Tensor:
  """Full self-attention (both bases 0); returns ``out`` only."""
  return flash_attention_fwd(q, k, v, 0, 0, causal, window, bwd)[0]
