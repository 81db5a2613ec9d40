"""Flash attention: the port of the Pallas flash-attention kernels,
forward and both backward plans.

Counterpart of ``tensorflowonspark_tpu/ops/flash_attention.py``: the
forward ``_fwd_impl`` (kernel ``_attn_fwd_kernel``) and the backward
``_bwd_impl`` in its two plans, with the public ``flash_attention`` /
``flash_attention_block`` made differentiable by an autograd Function
whose backward is the kernels:

* ``"fused"``: one single-pass kernel (``_attn_bwd_fused_kernel``, and
  ``_attn_bwd_fused_gqa_kernel`` for grouped K/V), ``csrc/
  flash_attention_bwd.cu``;
* ``"split"``: a dQ kernel (``_attn_bwd_dq_kernel``) and a dK/dV kernel
  (``_attn_bwd_dkv_kernel``, ``_attn_bwd_dkv_gqa_kernel``), ``csrc/
  flash_attention_bwd_split.cu``.

The plan is the caller's ``bwd`` or ``TFOS_TPU_FLASH_BWD`` (default
``"fused"``), and grouped K/V whose fused plan would not fit the
reference's VMEM budget takes the split plan, as the reference decides
(:func:`bwd_plan`). On CUDA tensors the wrappers launch the hand-written
kernels; on CPU tensors they run the plain versions beside them
(``*_reference``).

Layout ``[batch, seq, heads, head_dim]``. K/V may carry ``heads / g``
heads (grouped-query attention, consumed unexpanded: query head ``i``
reads KV head ``i // g``). ``q_base``/``kv_base`` are the absolute
positions of the first query and key, as in ``flash_attention_block``.
The kernels' tiles are their own (the bf16 forward 128 query rows by 64
keys, the bf16 dK/dV and fused backward 128 keys by 64 query rows, 64 by
32 past head_dim 64, the CUDA-core bodies 64 by 64): the reference's
``DEFAULT_BWD_BLOCKS`` (256, 512) are a VMEM tuning for the TPU and have
no counterpart here. The kernels take every head_dim ``d`` with ``8 <= d
<= 128`` and ``d % 8 == 0`` (:func:`check_head_dim`), in tiles padded to
64 or 128 columns inside the kernel. The bf16 forward, dK/dV and fused
backward run their products on the tensor cores (wgmma) from tiles copied
by TMA, which needs 16-byte aligned bases (the wrappers copy a view that
lacks one); f32 runs on the CUDA cores.
"""

import ctypes
import math
import os
from typing import Optional, Tuple

import torch

from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.ops import _build

NEG_INF = -1e30
#: the widest head_dim the kernels take; past it a warpgroup's dK and dV
#: alone would fill its registers (ROADMAP Queue 3)
MAX_HEAD_DIM = 128
#: backward plans of the reference
BWD_MODES = ("fused", "split")
#: the plain backward's query rows per chunk hold at most this many f32
#: scores (256 MB), so it also runs at long sequence lengths
_PLAIN_CHUNK_ELEMS = 1 << 26

# The reference's plan rule, kept verbatim so that both packages choose the
# same backward plan (tensorflowonspark_tpu/ops/flash_attention.py:393-401,
# applied at :588-590). VMEM budget for the grouped fused backward's
# resident blocks (dK+dV full f32 + dQ f32 + q/do); past this the split plan
# wins anyway because the residents crowd out double-buffering for the
# streamed blocks
GQA_FUSED_VMEM_BUDGET = 10 * 1024 * 1024


def _gqa_fused_fits(s_q: int, s_kv: int, d: int, itemsize: int) -> bool:
  resident = (2 * s_kv + s_q) * d * 4 + 2 * s_q * d * itemsize
  return resident <= GQA_FUSED_VMEM_BUDGET


def bwd_plan(bwd: str, grp: int, s_q: int, s_kv: int, d: int,
             itemsize: int) -> str:
  """The backward plan that runs for the requested ``bwd``: grouped K/V
  (``grp`` > 1) asked to run fused switches to ``"split"`` where
  :func:`_gqa_fused_fits` says no, exactly where the reference's
  ``_bwd_impl`` switches (whether ``bwd`` was asked for or came from the
  default)."""
  if bwd == "fused" and grp > 1 and not _gqa_fused_fits(s_q, s_kv, d,
                                                        itemsize):
    return "split"
  return bwd


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


def _plain_bwd(q, k, v, g, lse, delta, q_base, kv_base, causal, window,
               want_dq: bool, want_dkv: bool):
  """The backward's dense math (``_pair_p_ds``) in f32 over chunks of
  query rows: P recomputed from ``lse`` with masked entries and empty rows
  forced to 0, ``dS = P * (dO V^T - Delta)``. Returns ``(dq, dk, dv)`` in
  f32 (``None`` for what was not asked); dK/dV summed over each KV head's
  query heads."""
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
  lse, delta = lse.float(), delta.float()
  dq = torch.empty(q.shape, dtype=torch.float32, device=q.device) \
      if want_dq else None
  dk = dv = None
  rows = max(1, _PLAIN_CHUNK_ELEMS // max(1, b * h * sk))
  for r0 in range(0, sq, rows):
    r1 = min(sq, r0 + rows)
    qc, gc = qf[:, r0:r1], gf[:, r0:r1]
    s = torch.einsum("bqhd,bkhd->bhqk", qc, kf)
    if causal:
      keep = _keep_mask(r1 - r0, sk, int(q_base) + r0, int(kv_base), window,
                        q.device)
      s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    lc = lse[:, :, r0:r1, None]                               # [B, H, r, 1]
    lse_safe = torch.where(lc <= NEG_INF, torch.zeros_like(lc), lc)
    p = torch.exp(s - lse_safe)
    p = torch.where((s <= NEG_INF) | (lc <= NEG_INF), torch.zeros_like(p), p)
    dp = torch.einsum("bqhd,bkhd->bhqk", gc, vf)
    ds = p * (dp - delta[:, :, r0:r1, None])
    if want_dq:
      dq[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    if want_dkv:
      dv_c = torch.einsum("bhqk,bqhd->bkhd", p, gc)
      dk_c = torch.einsum("bhqk,bqhd->bkhd", ds, qc)
      dv = dv_c if dv is None else dv + dv_c
      dk = dk_c if dk is None else dk + dk_c
  if want_dkv:
    if dk is None:                                            # no query rows
      dk = torch.zeros((b, sk, h, d), dtype=torch.float32, device=q.device)
      dv = torch.zeros_like(dk)
    dk, dv = _group_sum(dk, hk), _group_sum(dv, hk)
  return dq, dk, dv


def _plain_delta(out, g, g_lse=None) -> torch.Tensor:
  """``Delta = sum_d dO * O - g_lse``, f32 ``[B, H, Sq]``."""
  delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2)
  return delta if g_lse is None else delta - g_lse.float()


def flash_attention_bwd_reference(q, k, v, out, lse, g, g_lse=None,
                                  q_base: int = 0, kv_base: int = 0,
                                  causal: bool = True,
                                  window: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
  """The plain backward of either plan: ``Delta = sum_d dO * O - g_lse``,
  then the dense math of :func:`_plain_bwd`. Returns ``(dq, dk, dv)`` in
  q's / k's / v's dtypes; grouped dK/dV are summed over each KV head's
  query heads."""
  dq, dk, dv = _plain_bwd(q, k, v, g, lse, _plain_delta(out, g, g_lse),
                          q_base, kv_base, causal, window, True, True)
  return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                     q_base: int = 0, kv_base: int = 0,
                                     causal: bool = True,
                                     window: Optional[int] = None
                                     ) -> torch.Tensor:
  """The plain version of the dQ kernel: ``dq = scale * sum_k dS K`` from
  the forward's ``lse`` and the pre-pass's ``delta`` (both f32 ``[B, H,
  Sq]``), in q's dtype."""
  return _plain_bwd(q, k, v, g, lse, delta, q_base, kv_base, causal, window,
                    True, False)[0].to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta,
                                      q_base: int = 0, kv_base: int = 0,
                                      causal: bool = True,
                                      window: Optional[int] = None
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The plain version of the dK/dV kernels: ``dv = sum_q P^T dO``, ``dk
  = sum_q dS^T (q * scale)``, grouped K/V summed over the query group in
  f32 and cast once to k's / v's dtype."""
  _, dk, dv = _plain_bwd(q, k, v, g, lse, delta, q_base, kv_base, causal,
                         window, False, True)
  return dk.to(k.dtype), dv.to(v.dtype)


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


def check_head_dim(what: str, d: int) -> None:
  """Raise unless the kernels take head_dim ``d``: ``8 <= d <= 128`` and
  ``d % 8 == 0`` (a bf16 row a multiple of 16 bytes, as TMA needs). Each
  kernel pads it to a 64- or 128-column tile of its own."""
  if not (8 <= d <= MAX_HEAD_DIM and d % 8 == 0):
    raise ValueError("%s takes head_dim d with 8 <= d <= %d and d %% 8 == 0,"
                     " got %d" % (what, MAX_HEAD_DIM, d))


def _check_kernel_dtypes(what, *tensors):
  dtype = tensors[0].dtype
  if dtype not in _build.DTYPE_CODES or any(t.dtype != dtype
                                            for t in tensors):
    raise TypeError("%s takes its tensors all bf16 or all f32, got %s"
                    % (what, ", ".join(str(t.dtype) for t in tensors)))


def _tma_operand(t):
  """``t`` contiguous, as the bf16 kernels read it by TMA: from a 16-byte
  aligned base (contiguous rows of a multiple of 8 bf16 already give strides
  that are multiples of 16 bytes), so a bf16 view at another offset is
  copied."""
  t = t.contiguous()
  return t.clone() if t.dtype == torch.bfloat16 and t.data_ptr() % 16 else t


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
_DELTA_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_DQ_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_DKV_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _forward(q, k, v, q_base, kv_base, causal, window):
  if not ops.on_card(q, k, v):
    return flash_attention_reference(q, k, v, q_base, kv_base, causal, window)
  b, sq, h, d = q.shape
  sk, hk = k.shape[1], k.shape[2]
  check_head_dim("flash_attention kernel", d)
  _check_kernel_dtypes("flash_attention kernel", q, k, v)
  q, k, v = (_tma_operand(t) for t in (q, k, v))
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


def _check_bwd_shapes(q, k, v, g, lse, *rows):
  """Shapes of the backward's inputs: ``g`` like q, ``lse`` and every
  per-row tensor in ``rows`` ``[B, H, Sq]``."""
  _check_shapes(q, k, v)
  if g.shape != q.shape:
    raise ValueError("g must be shaped like q %s, got %s"
                     % (tuple(q.shape), tuple(g.shape)))
  b, sq, h, _ = q.shape
  if any(t.shape != (b, h, sq) for t in (lse,) + rows):
    raise ValueError("lse, g_lse and delta must be [%d, %d, %d]" % (b, h, sq))


def _check_bwd_kernel(what, q, k, v, g, *rows):
  """What the backward kernels take: a head_dim :func:`check_head_dim`
  accepts, q/k/v/g all bf16 or all f32, per-row tensors f32."""
  check_head_dim(what, q.shape[-1])
  _check_kernel_dtypes(what, q, k, v, g)
  if any(t.dtype != torch.float32 for t in rows):
    raise TypeError("%s takes lse, g_lse and delta in f32" % what)


def _split_args(q, k, q_base, kv_base, causal, window):
  """The arguments the split kernels share, after the tensors' pointers."""
  b, sq, h, d = q.shape
  return (b, sq, k.shape[1], h, k.shape[2], d, int(q_base), int(kv_base),
          int(bool(causal)), window or 0, 1.0 / math.sqrt(d),
          _build.DTYPE_CODES[q.dtype], q.device.index, _build.stream_handle(q))


def _bwd_delta(out, g, g_lse):
  """The Delta pre-pass of the split plan: the kernel shared with the
  fused plan on the card (``csrc/flash_bwd_delta.cuh``), the plain sum on
  the CPU. Not a TPU kernel (the reference sums in XLA): counts nothing."""
  extra = () if g_lse is None else (g_lse,)
  if not ops.on_card(out, g, *extra):
    return _plain_delta(out, g, g_lse)
  _check_kernel_dtypes("flash_attention Delta pre-pass", out, g)
  if g_lse is not None and g_lse.dtype != torch.float32:
    raise TypeError("flash_attention Delta pre-pass takes g_lse in f32")
  out, g = out.contiguous(), g.contiguous()
  extra = tuple(t.contiguous() for t in extra)
  b, sq, h, d = out.shape
  delta = torch.empty((b, h, sq), dtype=torch.float32, device=out.device)
  lib = _lib("flash_attention_bwd_split", "tos_flash_attention_bwd_delta",
             _DELTA_ARGS)
  rc = lib.tos_flash_attention_bwd_delta(
      _build.ptr(out), _build.ptr(g),
      _build.ptr(extra[0]) if extra else None, _build.ptr(delta), b, sq, h, d,
      _build.DTYPE_CODES[out.dtype], out.device.index,
      _build.stream_handle(out))
  _build.check(lib, rc, "flash_attention backward Delta pre-pass")
  return delta


def flash_attention_bwd_dq(q, k, v, g, lse, delta, q_base: int = 0,
                           kv_base: int = 0, causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
  """dQ of the split plan (the JAX package's ``_attn_bwd_dq_kernel``) from
  the forward's ``lse`` and the pre-pass's ``delta`` (f32 ``[B, H, Sq]``):
  in q's dtype. CUDA tensors launch the kernel on the current stream
  (bitwise reproducible); CPU tensors run
  :func:`flash_attention_bwd_dq_reference`."""
  window = _check_window(window, causal)
  _check_bwd_shapes(q, k, v, g, lse, delta)
  if not ops.on_card(q, k, v, g, lse, delta):
    return flash_attention_bwd_dq_reference(q, k, v, g, lse, delta, q_base,
                                            kv_base, causal, window)
  _check_bwd_kernel("flash_attention dQ kernel", q, k, v, g, lse, delta)
  q, k, v, g = (_tma_operand(t) for t in (q, k, v, g))
  lse, delta = lse.contiguous(), delta.contiguous()
  dq = torch.empty_like(q)
  if dq.numel() == 0 or k.shape[1] == 0:
    return dq.zero_()
  lib = _lib("flash_attention_bwd_split", "tos_flash_attention_bwd_dq",
             _DQ_ARGS)
  rc = lib.tos_flash_attention_bwd_dq(
      *(_build.ptr(t) for t in (q, k, v, g, lse, delta, dq)),
      *_split_args(q, k, q_base, kv_base, causal, window))
  _build.check(lib, rc, "flash_attention dQ kernel")
  ops.count_launch("flash_attention_bwd_dq")
  return dq


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, q_base: int = 0,
                            kv_base: int = 0, causal: bool = True,
                            window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
  """``(dk, dv)`` of the split plan (the JAX package's
  ``_attn_bwd_dkv_kernel``, or ``_attn_bwd_dkv_gqa_kernel`` for grouped
  K/V: the query group summed in f32), in k's / v's dtype. CUDA tensors
  launch the kernel (counted as ``flash_attention_bwd_dkv`` or
  ``flash_attention_bwd_dkv_gqa``); CPU tensors run
  :func:`flash_attention_bwd_dkv_reference`."""
  window = _check_window(window, causal)
  _check_bwd_shapes(q, k, v, g, lse, delta)
  if not ops.on_card(q, k, v, g, lse, delta):
    return flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta, q_base,
                                             kv_base, causal, window)
  _check_bwd_kernel("flash_attention dK/dV kernel", q, k, v, g, lse, delta)
  q, k, v, g = (_tma_operand(t) for t in (q, k, v, g))
  lse, delta = lse.contiguous(), delta.contiguous()
  dk, dv = torch.empty_like(k), torch.empty_like(v)
  if dk.numel() == 0 or q.shape[1] == 0:
    return dk.zero_(), dv.zero_()
  lib = _lib("flash_attention_bwd_split", "tos_flash_attention_bwd_dkv",
             _DKV_ARGS)
  rc = lib.tos_flash_attention_bwd_dkv(
      *(_build.ptr(t) for t in (q, k, v, g, lse, delta, dk, dv)),
      *_split_args(q, k, q_base, kv_base, causal, window))
  _build.check(lib, rc, "flash_attention dK/dV kernel")
  ops.count_launch("flash_attention_bwd_dkv" if q.shape[2] == k.shape[2]
                   else "flash_attention_bwd_dkv_gqa")
  return dk, dv


def _fused_bwd(q, k, v, out, lse, g, g_lse, q_base, kv_base, causal, window):
  """The fused plan's kernel (a Delta pre-pass and the single-pass
  backward, plus the group sum for grouped K/V)."""
  _check_bwd_kernel("flash_attention backward kernel", q, k, v, g, lse,
                    *(() if g_lse is None else (g_lse,)))
  _check_kernel_dtypes("flash_attention backward kernel", q, out)
  b, sq, h, d = q.shape
  sk, hk = k.shape[1], k.shape[2]
  q, k, v, g = (_tma_operand(t) for t in (q, k, v, g))
  out, lse = out.contiguous(), lse.contiguous()
  g_lse = None if g_lse is None else g_lse.contiguous()
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
      None if g_lse is None else _build.ptr(g_lse), _build.ptr(delta),
      _build.ptr(dq_acc), _build.ptr(dq), _build.ptr(dk), _build.ptr(dv),
      None if part is None else _build.ptr(part), b, sq, sk, h, hk, d,
      int(q_base), int(kv_base), int(bool(causal)), window or 0,
      1.0 / math.sqrt(d), _build.DTYPE_CODES[q.dtype], q.device.index,
      _build.stream_handle(q))
  _build.check(lib, rc, "flash_attention backward kernel")
  ops.count_launch("flash_attention_bwd" if h == hk
                   else "flash_attention_bwd_gqa")
  return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, g, g_lse=None, q_base: int = 0,
                        kv_base: int = 0, causal: bool = True,
                        window: Optional[int] = None,
                        bwd: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """``(dq, dk, dv)`` for the forward's ``(out, lse)`` and their
  cotangents ``g`` (and ``g_lse``, or None), exactly as the JAX package's
  ``_bwd_impl``, in the plan :func:`bwd_plan` picks for ``bwd`` (None:
  ``TFOS_TPU_FLASH_BWD``). CUDA tensors run the plan's kernels on the
  current stream (bitwise reproducible); CPU tensors run their plain
  versions."""
  window = _check_window(window, causal)
  extra = () if g_lse is None else (g_lse,)
  _check_bwd_shapes(q, k, v, g, lse, *extra)
  if out.shape != q.shape:
    raise ValueError("out must be shaped like q %s, got %s"
                     % (tuple(q.shape), tuple(out.shape)))
  b, sq, h, d = q.shape
  plan = bwd_plan(_resolve_bwd(bwd), h // k.shape[2], sq, k.shape[1], d,
                  q.element_size())
  if plan == "split":
    delta = _bwd_delta(out, g, g_lse)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, q_base, kv_base,
                                causal, window)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, q_base, kv_base,
                                     causal, window)
    return dq, dk, dv
  if not ops.on_card(q, k, v, out, lse, g, *extra):
    return flash_attention_bwd_reference(q, k, v, out, lse, g, g_lse, q_base,
                                         kv_base, causal, window)
  return _fused_bwd(q, k, v, out, lse, g, g_lse, q_base, kv_base, causal,
                    window)


class _FlashFn(torch.autograd.Function):
  """(out, lse) with the backward kernels of plan ``bwd`` as its VJP; an
  lse cotangent folds into Delta (``flash_attention_block``'s custom VJP),
  an absent one (``flash_attention``) is None."""

  @staticmethod
  def forward(ctx, q, k, v, q_base, kv_base, causal, window, bwd):
    out, lse = _forward(q, k, v, q_base, kv_base, causal, window)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.args = (q_base, kv_base, causal, window, bwd)
    ctx.set_materialize_grads(False)
    return out, lse

  @staticmethod
  def backward(ctx, g, g_lse):
    q, k, v, out, lse = ctx.saved_tensors
    if g is None:
      g = torch.zeros_like(out)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, g_lse, *ctx.args)
    return dq, dk, dv, None, None, None, None, None


def flash_attention_fwd(q, k, v, q_base: int = 0, kv_base: int = 0,
                        causal: bool = True, window: Optional[int] = None,
                        bwd: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Attention of ``q`` (at ``q_base + arange(Sq)``) against ``k``/``v``
  (at ``kv_base + arange(Sk)``) — the port of ``flash_attention_block``.
  Returns ``(out, lse)`` exactly as the JAX package's ``_fwd_impl``: out
  ``[B, Sq, H, D]`` in q's dtype, lse f32 ``[B, H, Sq]``. CUDA tensors run
  the kernel on the current stream (bf16 or f32, head_dim as
  :func:`check_head_dim` takes it); CPU
  tensors run the plain version. Differentiable in q, k, v through both
  outputs (``bwd``: the backward plan, see :func:`default_bwd_mode` and
  :func:`bwd_plan`).
  """
  window = _check_window(window, causal)
  _check_shapes(q, k, v)
  bwd = _resolve_bwd(bwd)
  if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
    return _FlashFn.apply(q, k, v, int(q_base), int(kv_base), bool(causal),
                          window, bwd)
  return _forward(q, k, v, q_base, kv_base, causal, window)


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None,
                    bwd: Optional[str] = None) -> torch.Tensor:
  """Full self-attention (both bases 0); returns ``out`` only."""
  return flash_attention_fwd(q, k, v, 0, 0, causal, window, bwd)[0]


def flash_attention_block(q, k, v, q_base, kv_base, causal: bool = True,
                          bwd: Optional[str] = None,
                          window: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Partial attention of local queries against ONE KV block, the ring
  step (the JAX package's ``flash_attention_block``): :func:`
  flash_attention_fwd` under the reference's signature. Returns the
  normalized partial ``out`` and its ``lse``; merge partials across blocks
  with :func:`merge_partials`. Differentiable in q, k, v through both
  outputs: the lse cotangent folds into the backward's Delta
  (:func:`_bwd_delta`, or the fused kernel's own pre-pass). A block that
  lies wholly in the future of every query (``kv_base`` past the last
  query) gives out 0 and lse -1e30, and its kernels' loop bounds, taken
  from the bases, visit no tile. The Hopper kernels choose their own
  tiles, so the reference's Pallas tiling and interpret arguments have
  no counterpart here."""
  return flash_attention_fwd(q, k, v, int(q_base), int(kv_base), causal,
                             window, bwd)


def merge_partials(o_a, lse_a, o_b, lse_b):
  """Combine two normalized attention partials over disjoint KV sets
  (the ring's merge step, the JAX package's ``merge_partials``): the
  partial over their union and its lse. A partial with lse -1e30 (no
  visible key) contributes nothing. ``o`` is ``[B, S, H, D]``, ``lse``
  ``[B, H, S]``; the output takes ``o_a``'s dtype. Plain PyTorch
  elementwise math, as the reference's is XLA: no kernel."""
  lse_new = torch.logaddexp(lse_a, lse_b)
  lse_safe = torch.where(lse_new <= NEG_INF, torch.zeros_like(lse_new),
                         lse_new)
  w_a = torch.where(lse_a <= NEG_INF, torch.zeros_like(lse_a),
                    torch.exp(lse_a - lse_safe))
  w_b = torch.where(lse_b <= NEG_INF, torch.zeros_like(lse_b),
                    torch.exp(lse_b - lse_safe))
  # weights [B, H, S] -> [B, S, H, 1] against outputs [B, S, H, D]
  o = (o_a.float() * w_a.transpose(1, 2)[..., None]
       + o_b.float() * w_b.transpose(1, 2)[..., None])
  return o.to(o_a.dtype), lse_new
