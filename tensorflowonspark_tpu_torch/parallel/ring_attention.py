"""Ring attention: sequence parallelism over the mesh's ``sequence`` axis.

Counterpart of ``tensorflowonspark_tpu/parallel/ring_attention.py``. Each
rank of the axis holds one block of the sequence: its queries stay put
while the key/value blocks go round the ring (``collectives.
ring_permute``), and the partials merge by their logsumexps, so the
result is exact full attention over the global sequence.

Where the reference's ``shard_map`` body sees its local block of global
arrays, here each process passes its own blocks: ``q [B, S_local, H_local,
D]`` and ``k``/``v [B, S_local, Hk_local, D]``, rank ``i`` of the axis
holding positions ``[i * S_local, (i + 1) * S_local)``. Under grouped
K/V the ring moves the UNEXPANDED blocks (``H / Hk`` less traffic), the
key and value blocks stacked into one send. The flash path runs each
step's block through ``ops.flash_attention_block`` (the hand-written
kernels on the card, their plain versions on the CPU) and merges with
``ops.merge_partials``; the dense path is the reference's online-softmax
block math in plain PyTorch.

Gradients: ``torch.distributed`` has no autograd, so the permute is an
autograd Function whose backward rotates the gradient the other way. The
backward of the whole ring is then the reverse ring: each step's block
backward (the flash kernels with the lse cotangent the merge hands back)
and the key/value gradients carried back round the ring with their
blocks.
"""

import math
from typing import Optional

import torch

from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.parallel import collectives
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib

NEG_INF = -1e30


def expand_heads(kv: torch.Tensor, num_heads: int) -> torch.Tensor:
  """Grouped K/V heads broadcast to ``num_heads`` (KV head ``j`` serves
  query heads ``[j * g, (j + 1) * g)``: the blocked layout, the one rule
  the model and the kernels share)."""
  hk = kv.shape[2]
  if hk == num_heads:
    return kv
  if num_heads % hk:
    raise ValueError("kv heads (%d) must divide query heads (%d)"
                     % (hk, num_heads))
  return kv.repeat_interleave(num_heads // hk, dim=2)


def local_heads(kv: torch.Tensor, num_heads: int, mesh) -> torch.Tensor:
  """This rank's query heads' K/V from ``kv`` whose every head is on
  every rank of the ``tensor`` axis (a KV head count the axis cannot
  divide): expanded up front to the ``num_heads`` query heads of the
  whole axis, then cut to this rank's ``num_heads / tensor``. The
  expansion enters through ``collectives.copy_to``, so the ranks' partial
  gradients add up to ``kv``'s."""
  t = mesh_lib.axis_size(mesh, mesh_lib.AXIS_TENSOR)
  full = expand_heads(collectives.copy_to(kv, mesh, mesh_lib.AXIS_TENSOR),
                      num_heads)
  per = num_heads // t
  r = mesh_lib.axis_index(mesh, mesh_lib.AXIS_TENSOR)
  return full[:, :, r * per:(r + 1) * per]


def _block_attn(q, k, v, m, l, o, q_offset, kv_offset, causal, scale,
                window=None):
  """One online-softmax step against a KV block (the reference's
  ``_block_attn``): q ``[B, Sq, H, D]``; k/v ``[B, Sk, H, D]``; m/l ``[B,
  H, Sq]``; o ``[B, Sq, H, D]``, all f32 but q/k/v; positions are global
  offsets. Returns the new ``(m, l, o)``."""
  scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
  if causal:
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)[None, :]
    keep = k_pos <= q_pos
    if window is not None:
      keep = keep & (k_pos > q_pos - window)
    scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
  m_new = torch.maximum(m, scores.amax(dim=-1))
  # fully-masked rows (m_new at NEG_INF) must not turn into NaN
  m_safe = torch.where(m_new <= NEG_INF, torch.zeros_like(m_new), m_new)
  p = torch.exp(scores - m_safe[..., None])
  p = torch.where(scores <= NEG_INF, torch.zeros_like(p), p)
  correction = torch.where(m <= NEG_INF, torch.zeros_like(m),
                           torch.exp(m - m_safe))
  l_new = l * correction + p.sum(dim=-1)
  pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
  o_new = o * correction.transpose(1, 2)[..., None] + pv
  return m_new, l_new, o_new


def _rotate(k_blk, v_blk, mesh, axis_name):
  """The next ring step's key and value blocks: both in one send."""
  kv = collectives.ring_permute(torch.stack((k_blk, v_blk)), mesh,
                                axis_name, 1)
  return kv[0], kv[1]


def _ring_dense(q, k, v, mesh, axis_name, causal, window):
  n = mesh.shape[axis_name]
  my = mesh.coord(axis_name)
  b, s_local, h, d = q.shape
  scale = 1.0 / math.sqrt(d)
  m = torch.full((b, h, s_local), NEG_INF, dtype=torch.float32,
                 device=q.device)
  l = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
  o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
  k_blk, v_blk = k, v
  for step in range(n):
    src = (my - step) % n
    m, l, o = _block_attn(q, expand_heads(k_blk, h), expand_heads(v_blk, h),
                          m, l, o, my * s_local, src * s_local, causal,
                          scale, window)
    if step < n - 1:
      k_blk, v_blk = _rotate(k_blk, v_blk, mesh, axis_name)
  l = torch.where(l == 0.0, torch.ones_like(l), l)        # empty rows -> 0
  return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def _ring_flash(q, k, v, mesh, axis_name, causal, bwd, window):
  n = mesh.shape[axis_name]
  my = mesh.coord(axis_name)
  s_local = q.shape[1]
  # the running output stays f32 across the steps (a bf16 carry would
  # round n times) and is cast to q's dtype once
  o = lse = None
  k_blk, v_blk = k, v
  for step in range(n):
    src = (my - step) % n
    # grouped K/V go to the kernels unexpanded
    o_j, lse_j = ops.flash_attention_block(
        q, k_blk, v_blk, my * s_local, src * s_local, causal=causal,
        bwd=bwd, window=window)
    if o is None:
      o, lse = o_j.float(), lse_j
    else:
      o, lse = ops.merge_partials(o, lse, o_j.float(), lse_j)
    if step < n - 1:
      k_blk, v_blk = _rotate(k_blk, v_blk, mesh, axis_name)
  return o.to(q.dtype)


def ring_attention(q, k, v, mesh, causal: bool = True,
                   axis_name: str = mesh_lib.AXIS_SEQUENCE,
                   use_flash: bool = False, bwd: Optional[str] = None,
                   window: Optional[int] = None, kv_whole: bool = False):
  """Exact full attention over a sequence cut over ``axis_name``, from
  this rank's blocks (see the module docstring); returns this rank's
  output block ``[B, S_local, H_local, D]`` in q's dtype.

  K/V may carry fewer heads than q (grouped-query attention): the ring
  moves the grouped blocks and each step expands them locally (dense) or
  not at all (flash). ``kv_whole``: k/v hold every KV head on every rank
  of the ``tensor`` axis, which cannot divide them, while q holds this
  rank's query heads: they are expanded up front (:func:`local_heads`),
  the reference's rule for an indivisible tensor axis. ``use_flash``
  runs each step through ``ops.flash_attention_block`` with backward plan
  ``bwd`` (None: ``TFOS_TPU_FLASH_BWD``). Differentiable in q, k and v.
  """
  if window is not None and not causal:
    raise ValueError("sliding-window ring attention requires causal=True")
  if kv_whole:
    h = q.shape[2] * mesh_lib.axis_size(mesh, mesh_lib.AXIS_TENSOR)
    k, v = local_heads(k, h, mesh), local_heads(v, h, mesh)
  if use_flash:
    return _ring_flash(q, k, v, mesh, axis_name, causal, bwd, window)
  return _ring_dense(q, k, v, mesh, axis_name, causal, window)


def full_attention(q, k, v, causal: bool = True,
                   window: Optional[int] = None) -> torch.Tensor:
  """Single-device dense attention, the reference implementation (k/v
  at q's head count); ``window`` masks like the flash kernels' sliding
  window. O(S^2) memory."""
  if window is not None and not causal:
    raise ValueError("sliding-window attention requires causal=True "
                     "(same contract as ops.flash_attention)")
  b, s, h, d = q.shape
  scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
      * (1.0 / math.sqrt(d))
  if causal:
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    if window is not None:
      mask = mask & ~torch.tril(torch.ones((s, s), dtype=torch.bool,
                                           device=q.device), diagonal=-window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
  probs = torch.softmax(scores, dim=-1)
  return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
