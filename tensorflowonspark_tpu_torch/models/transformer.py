"""Decoder-only Transformer on PyTorch: the port of the flagship model.

Counterpart of ``tensorflowonspark_tpu/models/transformer.py`` for the
serving and training paths: the config (same fields, same validation),
rotary positions, the tied embedding, pre-LN blocks, the non-decode
forward (with ``remat`` and ``return_hidden``), the KV-cache decode
(``Attention._decode_attend``) with a scalar cursor (rows in lockstep) or
a vector of per-row cursors (the serving slab), greedy and sampled
decoding (:func:`greedy_generate_kv`, top-k temperature sampling from a
``torch.Generator``), the pipeline's serving predict fn
(:func:`make_serving_predict_fn`), the losses (:func:`causal_lm_loss`,
:func:`causal_lm_loss_blocked`) and :func:`create_state`. The decode-speed
layouts are the reference's too: the int8 cache (``kv_cache_dtype="int8"``,
per-token/head scales), the paged cache (a page pool addressed through a
per-row page table), multi-token writes at per-row cursors, the
shallow-exit forward (``exit_layer``) and greedy speculative decoding
(:func:`speculative_generate_kv`).

What differs from the flax model, by design of the port:

* weights are ``nn.Parameter``s of one ``Transformer`` module. Their
  storage is chosen at construction: ``trainable=False`` (serving, the
  default) stores them in ``cfg.dtype`` without gradients, which gives
  the values the flax model computes with, since flax casts its f32
  params to ``cfg.dtype`` at every use; ``trainable=True`` (training)
  keeps f32 master weights that require gradients and casts them to
  ``cfg.dtype`` at every use exactly as flax does (the embedding table at
  lookup and at the tied projection, each dense kernel as
  ``DenseGeneral(dtype=cfg.dtype)`` does). LayerNorm scales are f32 in
  both, because the kernel takes them so, and so are the MoE layers'
  router and expert weights, which the reference computes with in f32.
* ``cfg.remat`` wraps each block of a differentiated forward in
  ``torch.utils.checkpoint`` (non-reentrant), as ``nn.remat(Block)`` does.
  ``remat_policy="dots"`` keeps what the reference's
  ``dots_with_no_batch_dims_saveable`` keeps: the outputs of the block's
  products with no batch dims that the backward reads (q, k, v or qkv,
  out, up), saved by a selective-checkpoint policy; everything else
  recomputes in the backward, the hand-written kernels included (a Pallas
  call is no dot in the reference either).
* the decode cache is a :class:`KVCache` updated IN PLACE (the flax cache
  is a returned pytree); one cursor serves every layer.
* the hot ops go through ``tensorflowonspark_tpu_torch.ops``: on the card
  the hand-written LayerNorm and flash-attention kernels (forward and
  backward) and, with ``ln_matmul_impl`` / ``act_matmul_impl`` "fused",
  the LN->matmul and GELU->matmul kernels; on the CPU their plain
  versions. There is no ``jit``; PyTorch runs eagerly.

* over a mesh (``Transformer(..., mesh=...)``, ``create_sharded_state``)
  each rank holds its blocks of the weights, laid out by the reference's
  logical axes and ``parallel.sharding.LOGICAL_RULES``, and computes on
  its block of the batch: ``fsdp`` cuts every ``embed`` dimension (a
  block gathers its weights on entry, ``collectives.gather_from``, and
  their gradients are reduce-scattered back); ``tensor`` cuts heads, mlp
  and vocab Megatron-style (column-parallel QKV and up projections,
  row-parallel out and down with one all-reduce each, a vocab-parallel
  tied embedding and loss; a head count the axis cannot divide stays
  whole, ``_heads_logical``'s rule); ``sequence`` cuts positions, with
  ring attention (``parallel.ring_attention``) and rotary positions from
  the rank's offset. Where the reference's GSPMD places collectives by
  the shardings, the port calls them where the math needs them, each
  with its conjugate in the backward. The decode path runs over the
  mesh too (:func:`greedy_generate_kv`, :func:`speculative_generate_kv`):
  each rank decodes its rows (cut over ``data`` x ``fsdp``) at its heads
  (the KV cache cut over ``tensor`` where the axis divides the KV heads,
  whole where it does not), MoE layers over ``expert``; the
  vocab-parallel logits are gathered whole before a token is picked, so
  every rank picks the same one, and a ``sequence`` axis decodes the
  same rows on each of its ranks, as the reference's decode does.

Options outside this slice raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.obs import device as obs_device
from tensorflowonspark_tpu_torch.obs import metrics as obs_metrics
from tensorflowonspark_tpu_torch.parallel import collectives
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.parallel import ring_attention as ra
from tensorflowonspark_tpu_torch.parallel import sharding as sharding_lib
from tensorflowonspark_tpu_torch.utils.device import resolve_device
from tensorflowonspark_tpu_torch.utils.params import copy_into, is_moe_layer

NEG_INF = -1e30


@dataclass(frozen=True)
class TransformerConfig:
  """Same fields and validation as the JAX package's config; ``dtype``
  is a torch dtype. See the JAX config for what each field means."""
  vocab_size: int = 32000
  num_layers: int = 12
  num_heads: int = 12
  d_model: int = 768
  d_ff: int = 3072
  max_seq_len: int = 2048
  dtype: torch.dtype = torch.bfloat16
  # training-only (activation recompute): no effect on inference
  remat: bool = True
  remat_policy: str = "none"
  use_ring_attention: bool = False
  attention_impl: str = "auto"
  num_kv_heads: int = 0
  attention_window: int = 0
  fuse_qkv: bool = False
  layer_norm_impl: str = "auto"
  ln_matmul_impl: str = "off"
  act_matmul_impl: str = "off"
  moe_experts: int = 0
  moe_top_k: int = 1
  moe_every: int = 2
  moe_capacity_factor: float = 0.0
  kv_cache_dtype: str = "model"
  kv_page_size: int = 0
  kv_num_pages: int = 0
  kv_pages_per_slot: int = 0
  # an SPMD layout choice: on one device both lookups give the same rows
  embed_lookup: str = "gather"

  def __post_init__(self):
    if self.moe_experts > 0 and self.moe_every < 1:
      raise ValueError("moe_every must be >= 1 when moe_experts > 0")
    if self.attention_impl not in ("auto", "flash", "dense"):
      raise ValueError("attention_impl must be 'auto', 'flash' or 'dense', "
                       "got %r" % (self.attention_impl,))
    if self.layer_norm_impl not in ("auto", "fused", "flax"):
      raise ValueError("layer_norm_impl must be 'auto', 'fused' or 'flax', "
                       "got %r" % (self.layer_norm_impl,))
    if self.num_kv_heads < 0:
      raise ValueError("num_kv_heads must be >= 0, got %d"
                       % (self.num_kv_heads,))
    if self.attention_window < 0:
      raise ValueError("attention_window must be >= 0 (0 = full causal), "
                       "got %d" % (self.attention_window,))
    if self.num_kv_heads and self.num_heads % self.num_kv_heads != 0:
      raise ValueError("num_kv_heads (%d) must divide num_heads (%d)"
                       % (self.num_kv_heads, self.num_heads))
    if self.embed_lookup not in ("gather", "one_hot"):
      raise ValueError("embed_lookup must be 'gather' or 'one_hot', got %r"
                       % (self.embed_lookup,))
    if self.ln_matmul_impl not in ("off", "fused"):
      raise ValueError("ln_matmul_impl must be 'off' or 'fused', got %r"
                       % (self.ln_matmul_impl,))
    if self.act_matmul_impl not in ("off", "fused"):
      raise ValueError("act_matmul_impl must be 'off' or 'fused', got %r"
                       % (self.act_matmul_impl,))
    if self.remat_policy not in ("none", "dots"):
      raise ValueError("remat_policy must be 'none' or 'dots', got %r"
                       % (self.remat_policy,))
    if self.kv_cache_dtype not in ("model", "int8"):
      raise ValueError("kv_cache_dtype must be 'model' or 'int8', got %r"
                       % (self.kv_cache_dtype,))
    if self.kv_page_size < 0 or self.kv_num_pages < 0 \
        or self.kv_pages_per_slot < 0:
      raise ValueError("kv_page_size/kv_num_pages/kv_pages_per_slot must "
                       "be >= 0")
    if self.kv_page_size > 0:
      if self.kv_num_pages < 2:
        raise ValueError(
            "paged KV needs kv_num_pages >= 2 (page 0 is the reserved "
            "trash page), got %d" % (self.kv_num_pages,))
      if self.kv_pages_per_slot < 1:
        raise ValueError("paged KV needs kv_pages_per_slot >= 1, got %d"
                         % (self.kv_pages_per_slot,))
      if self.kv_cache_dtype == "int8":
        raise ValueError("paged KV does not compose with the int8 cache "
                         "yet — use kv_cache_dtype='model'")
    if self.d_model % self.num_heads:
      raise ValueError("num_heads (%d) must divide d_model (%d)"
                       % (self.num_heads, self.d_model))
    unported = [
        (self.attention_impl == "dense", "attention_impl='dense'",
         "Queue 1 item 11, the kernels' opt-outs"),
        (self.layer_norm_impl == "flax", "layer_norm_impl='flax'",
         "Queue 1 item 11, the kernels' opt-outs"),
    ]
    for hit, what, item in unported:
      if hit:
        raise NotImplementedError(
            "%s is not ported to PyTorch yet (ROADMAP %s)" % (what, item))

  @property
  def head_dim(self) -> int:
    return self.d_model // self.num_heads

  @property
  def kv_heads(self) -> int:
    return self.num_kv_heads or self.num_heads


@dataclass
class KVCache:
  """Per-layer decode cache, updated in place by :meth:`Transformer.forward`.

  ``k[i]``/``v[i]``: ``[batch, max_seq_len, kv_heads, head_dim]`` in
  ``cfg.dtype``. ``index`` is the write cursor: a host ``int`` when every
  row is at the same position (prefill and single-request decode — no
  device sync to branch on it), or a ``[batch]`` int64 tensor of per-row
  cursors (the serving slab).

  The int8 cache (``k_scale`` set) holds ``k[i]``/``v[i]`` as
  ``torch.int8`` and their per-token/head f32 scales in ``k_scale[i]``/
  ``v_scale[i]`` ``[batch, max_seq_len, kv_heads]``. The paged cache
  (``page_table`` set) holds ``k[i]``/``v[i]`` as page pools ``[num_pages,
  page_size, kv_heads, head_dim]``; row ``b``'s token at position ``p``
  lives in page ``page_table[b, p // page_size]`` at offset ``p %
  page_size``, and page 0 is the trash page. Its cursor is always a
  vector. Every layer shares the one table and the one cursor (the
  reference keeps a copy of each per layer, with equal values).
  """
  k: List[torch.Tensor]
  v: List[torch.Tensor]
  index: Union[int, torch.Tensor] = 0
  k_scale: Optional[List[torch.Tensor]] = None
  v_scale: Optional[List[torch.Tensor]] = None
  page_table: Optional[torch.Tensor] = None


def zero_cache(cfg: TransformerConfig, batch: int, device,
               kv_heads: Optional[int] = None) -> KVCache:
  """A zeroed decode cache for ``batch`` rows in the layout ``cfg`` names:
  paged (``kv_page_size > 0``; vector cursors, an all-trash table), int8
  (``kv_cache_dtype="int8"``) or the model dtype, with the scalar cursor 0
  unless paged. ``kv_heads``: the KV heads one rank holds over a mesh
  (default: every one, ``cfg.kv_heads``). (Zeros matter: unwritten
  entries are masked, but 0 * garbage could be NaN in the probs @ v
  product.)"""
  hk, d, n = kv_heads or cfg.kv_heads, cfg.head_dim, cfg.num_layers

  def zeros(shape, dtype):
    return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)]

  if cfg.kv_page_size > 0:
    pool = (cfg.kv_num_pages, cfg.kv_page_size, hk, d)
    return KVCache(zeros(pool, cfg.dtype), zeros(pool, cfg.dtype),
                   torch.zeros((batch,), dtype=torch.long, device=device),
                   page_table=torch.zeros((batch, cfg.kv_pages_per_slot),
                                          dtype=torch.long, device=device))
  shape = (batch, cfg.max_seq_len, hk, d)
  if cfg.kv_cache_dtype == "int8":
    return KVCache(zeros(shape, torch.int8), zeros(shape, torch.int8), 0,
                   zeros(shape[:3], torch.float32),
                   zeros(shape[:3], torch.float32))
  return KVCache(zeros(shape, cfg.dtype), zeros(shape, cfg.dtype), 0)


def _quantize(x: torch.Tensor):
  """Per-token/head symmetric int8 over the head dim: ``(int8 values, f32
  scales)`` with ``s = max(amax, 1e-8) / 127`` and ``round(x / s)``
  clipped to +-127 (round half to even, as ``jnp.round``)."""
  xf = x.float()
  s = xf.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
  q = torch.round(xf / s[..., None]).clamp(-127, 127)
  return q.to(torch.int8), s


def _write_plan(cache: KVCache, seg: int):
  """Where a forward's ``seg`` new tokens a row land in a vector-cursor
  cache, computed once per forward and shared by every layer's buffers.

  Paged: ``(pages, offsets)``, each ``[b * seg]``. A position inside the
  span but past the row's allocation resolves through an unused table
  entry to the trash page 0; a position PAST the span (a speculative
  verify window overshooting a full slot) is forced to page 0, since
  clipping its page slot would alias it into the row's last page over
  live entries.

  Contiguous: ``(rows, positions, keep, below)`` for :func:`_write_rows`.
  One token a row keeps the reference's update-slice, whose start clamps
  to the last position (``keep``, ``below`` None): only a speculative
  draft step past a full slot's end reaches the clamp, and the verify
  window then rewrites that position. A multi-token window DROPS
  positions at or past ``max_seq_len`` (``keep`` false) and never clamps
  them, which would overwrite live entries below the cursor: each such
  position is sent to ``below``, the one just below its row's cursor.
  Nothing syncs the host."""
  idx = cache.index
  dev = idx.device
  if cache.page_table is not None:
    table = cache.page_table
    ps, pp = cache.k[0].shape[1], table.shape[1]
    pos = idx[:, None] + torch.arange(seg, device=dev)[None, :]
    pages = table.gather(1, (pos // ps).clamp(0, pp - 1))
    pages = torch.where(pos < ps * pp, pages, torch.zeros_like(pages))
    return pages.reshape(-1), (pos % ps).reshape(-1)
  last = cache.k[0].shape[1] - 1
  rows = torch.arange(idx.shape[0], device=dev)
  if seg == 1:
    return rows, idx.clamp(max=last), None, None
  pos = idx[:, None] + torch.arange(seg, device=dev)[None, :]
  below = (idx - 1).clamp(min=0)
  return (rows, torch.where(pos <= last, pos, below[:, None]), pos <= last,
          below)


def _write_rows(buf: torch.Tensor, val: torch.Tensor, plan) -> None:
  """Write ``val [b, seg, ...]`` into ``buf [b, max_seq_len, ...]`` at the
  positions of the forward's :func:`_write_plan`. A dropped position
  carries the value its stand-in below the cursor already holds: no
  position of the window is below the cursor, so that write changes
  nothing, and every value it writes there is the same one."""
  rows, at, keep, below = plan
  val = val.to(buf.dtype)
  if keep is None:
    buf[rows, at] = val[:, 0]
    return
  held = buf[rows, below][:, None].expand_as(val)
  keep = keep.reshape(keep.shape + (1,) * (val.dim() - 2))
  buf[rows[:, None].expand_as(at), at] = torch.where(keep, val, held)


def _rope_tables(positions: torch.Tensor, head_dim: int):
  """(cos, sin) ``[B, S, 1, head_dim // 2]`` f32 for rotary positions
  ``[B, S]`` — computed once per forward and shared by every layer."""
  half = head_dim // 2
  # ln(1e4) / half rounded as f32 arithmetic rounds it (the JAX package
  # computes it in f32), held as an exact Python float
  step = float(np.float32(np.log(np.float32(10000.0))) / np.float32(half))
  freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                  device=positions.device) * step)
  angles = positions[..., None].to(torch.float32) * freqs     # [B, S, half]
  return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _apply_rotary(x: torch.Tensor, rope) -> torch.Tensor:
  """Rotate-half rotary embedding over the last (head_dim) axis with f32
  angles; result in ``x``'s dtype. x: [B, S, H, d]."""
  cos, sin = rope
  half = x.shape[-1] // 2
  x1, x2 = x[..., :half], x[..., half:]
  return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                   dim=-1).to(x.dtype)


def _rotary(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
  """Rotary embedding of ``x`` [B, S, H, d] at ``positions`` [B, S]."""
  return _apply_rotary(x, _rope_tables(positions, x.shape[-1]))


def _flash_eligible(cfg: TransformerConfig, seq_len: int) -> bool:
  """The reference's rule for a fresh-cache prefill of ``seq_len``
  tokens: the flash op where the sequence divides into kernel blocks,
  else dense attention against the cache. "flash" raises instead of
  degrading."""
  divisible = seq_len % min(128, max(1, seq_len)) == 0
  if cfg.attention_impl == "flash" and not divisible:
    raise ValueError(
        "attention_impl='flash' but the sequence length %d does not divide "
        "into kernel blocks — pad the sequence or use 'auto'" % seq_len)
  return divisible


def _heads_logical(n_heads: int, mesh) -> Optional[str]:
  """``"heads"`` (the tensor axis) when the tensor axis divides
  ``n_heads``, else None (whole): the reference's one rule for the
  projection kernels."""
  t = mesh_lib.axis_size(mesh, mesh_lib.AXIS_TENSOR) if mesh else 1
  return "heads" if n_heads % max(1, t) == 0 else None


def param_logical(cfg: TransformerConfig, mesh=None) -> dict:
  """The logical axes of each kind of weight (the reference's
  ``nn.with_logical_partitioning``); a kind is a parameter name without
  its ``layers.i.`` prefix, every LayerNorm scale ``ln.scale``. The fused
  QKV projection's heads are cut only where the tensor axis divides both
  the query and the KV heads: each rank keeps its query heads with their
  own KV group (``[q_r | k_r | v_r]``, see :meth:`Transformer.
  load_params`)."""
  heads = _heads_logical(cfg.num_heads, mesh)
  kv = _heads_logical(cfg.kv_heads, mesh) if heads else None
  return {"embed.embedding": ("vocab", "embed"), "ln.scale": (None,),
          "attn.q": ("embed", heads, "kv"), "attn.k": ("embed", kv, "kv"),
          "attn.v": ("embed", kv, "kv"), "attn.qkv": ("embed", kv, "kv"),
          "attn.out": (heads, "kv", "embed"), "mlp.up": ("embed", "mlp"),
          "mlp.down": ("mlp", "embed"), "moe.w_gate": (None, None),
          "moe.w_up": ("expert", "embed", "mlp"),
          "moe.w_down": ("expert", "mlp", "embed")}


def param_kind(name: str) -> str:
  """``layers.3.attn.q`` -> ``attn.q``; every LayerNorm scale ->
  ``ln.scale``."""
  if name.endswith(".scale"):
    return "ln.scale"
  parts = name.split(".")
  return ".".join(parts[2:]) if parts[0] == "layers" else name


class _Plan(object):
  """How one rank's model lies on the mesh: each kind of weight's mesh
  spec (``sharding.logical_to_mesh`` of :func:`param_logical`), and the
  collectives the forward needs. Without a mesh (or at degree 1) every
  spec is whole and every collective the identity."""

  def __init__(self, cfg: TransformerConfig, mesh=None):
    from tensorflowonspark_tpu_torch.utils.params import param_specs
    self.cfg, self.mesh = cfg, mesh
    shapes = {param_kind(n): shape
              for n, (shape, _, _) in param_specs(cfg).items()}
    shapes.setdefault("mlp.up", (cfg.d_model, cfg.d_ff))
    shapes.setdefault("mlp.down", (cfg.d_ff, cfg.d_model))
    if cfg.fuse_qkv:
      shapes["attn.q"] = (cfg.d_model, cfg.num_heads, cfg.head_dim)
      shapes["attn.k"] = shapes["attn.v"] = (cfg.d_model, cfg.kv_heads,
                                             cfg.head_dim)
    else:
      shapes["attn.qkv"] = (cfg.d_model, cfg.num_heads + 2 * cfg.kv_heads,
                            cfg.head_dim)
    self.shapes = shapes
    logical = param_logical(cfg, mesh)
    self.specs = {k: sharding_lib.logical_to_mesh(logical[k], shapes[k], mesh)
                  for k in shapes}
    self.t = mesh_lib.axis_size(mesh, mesh_lib.AXIS_TENSOR) if mesh else 1
    if cfg.vocab_size % self.t:
      raise ValueError("the tensor axis (%d) must divide the vocabulary (%d): "
                       "the logits and the loss are vocab-parallel"
                       % (self.t, cfg.vocab_size))
    # what the tensor axis cuts: query heads (and out), KV heads, the MLP's
    # hidden units, the vocabulary
    self.heads = self.specs["attn.out"][0] is not None
    self.kv = self.specs["attn.qkv" if cfg.fuse_qkv else "attn.k"][1] \
        is not None
    self.mlp = self.specs["mlp.up"][1] is not None
    self.vocab = self.specs["embed.embedding"][0] is not None
    self.seq = mesh_lib.axis_size(mesh, mesh_lib.AXIS_SEQUENCE) if mesh \
        else 1
    self.wide = bool(mesh is not None and mesh.wide(
        (mesh_lib.AXIS_FSDP, mesh_lib.AXIS_SEQUENCE, mesh_lib.AXIS_TENSOR)))
    self.expert = mesh_lib.axis_size(mesh, mesh_lib.AXIS_EXPERT) if mesh \
        else 1
    if cfg.moe_experts > 0 and self.wide:
      raise NotImplementedError(
          "MoE layers over a mesh cut on fsdp, sequence or tensor %s are not "
          "ported to PyTorch yet (ROADMAP Queue 1 item 10c, part 3c); the "
          "data and expert axes are" % (dict(mesh.shape),))
    if self.expert > 1 and cfg.moe_experts % self.expert:
      raise ValueError("the expert axis (%d) must divide moe_experts (%d)"
                       % (self.expert, cfg.moe_experts))

  def local(self, kind: str) -> tuple:
    return sharding_lib.local_shape(self.shapes[kind], self.specs[kind],
                                    self.mesh)

  def full(self, w: torch.Tensor, kind: str, dtype) -> torch.Tensor:
    """The weight ``w`` in ``dtype`` with its fsdp-cut dimension gathered
    (its tensor-cut one stays this rank's); the gradient goes back through
    the gather's reduce-scatter."""
    w = w.to(dtype)
    for dim, axis in enumerate(self.specs[kind]):
      if axis == mesh_lib.AXIS_FSDP:
        w = collectives.gather_from(w, self.mesh, axis, axis=dim)
    return w

  def copy_t(self, x: torch.Tensor) -> torch.Tensor:
    return collectives.copy_to(x, self.mesh, mesh_lib.AXIS_TENSOR)

  def reduce_t(self, x: torch.Tensor) -> torch.Tensor:
    return collectives.reduce_from(x, self.mesh, mesh_lib.AXIS_TENSOR)

  def t_index(self) -> int:
    return mesh_lib.axis_index(self.mesh, mesh_lib.AXIS_TENSOR)

  def local_kv_heads(self) -> int:
    """The KV heads one rank holds: cut over ``tensor`` where the axis
    divides them, else every one."""
    return self.cfg.kv_heads // self.t if self.kv else self.cfg.kv_heads

  def kv_index(self) -> Optional[torch.Tensor]:
    """Where the tensor axis cuts the query heads but not the KV heads:
    the KV head of each of this rank's query heads (KV head ``j`` serves
    query heads ``[j * g, (j + 1) * g)``), to take from K/V that hold
    every KV head; else None."""
    if not self.heads or self.kv:
      return None
    cfg = self.cfg
    per, g = cfg.num_heads // self.t, cfg.num_heads // cfg.kv_heads
    first = self.t_index() * per
    return torch.arange(first, first + per) // g

  def qkv_order(self) -> np.ndarray:
    """The heads order of a cut fused QKV weight: rank by rank, each
    rank's query heads, then its K heads, then its V heads."""
    cfg, t = self.cfg, self.t
    h, hk = cfg.num_heads, cfg.kv_heads
    order = []
    for r in range(t):
      order += list(range(r * h // t, (r + 1) * h // t))
      order += list(range(h + r * hk // t, h + (r + 1) * hk // t))
      order += list(range(h + hk + r * hk // t, h + hk + (r + 1) * hk // t))
    return np.asarray(order)


def _param(shape, cfg: TransformerConfig, device, trainable: bool,
           dtype: Optional[torch.dtype] = None) -> nn.Parameter:
  """A weight in ``dtype`` if given, else f32 master (``trainable``) or
  ``cfg.dtype`` (serving)."""
  if dtype is None:
    dtype = torch.float32 if trainable else cfg.dtype
  return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                      requires_grad=trainable)


# -- remat "dots": the block's products with no batch dims are saved ----------

#: ``.on`` while one of the block's weight products runs (in this thread)
_IN_PRODUCT = threading.local()
# what a product over [..., D] @ [D, N] lowers to: mm (folded), addmm, or
# bmm against the weight broadcast over the batch
_PRODUCT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                torch.ops.aten.bmm.default)


@contextlib.contextmanager
def _weight_product():
  """Marks the products with no batch dims that remat "dots" saves: q, k
  and v (or qkv), out and up. Not down: the backward never reads its
  output (the residual add passes the gradient on), so the reference
  keeps no residual for it and the recompute stops before it under
  either policy; saving it would only hold memory."""
  before = getattr(_IN_PRODUCT, "on", False)
  _IN_PRODUCT.on = True
  try:
    yield
  finally:
    _IN_PRODUCT.on = before


def _dots_policy(ctx, op, *args, **kwargs):
  """``dots_with_no_batch_dims_saveable``: save a marked product, recompute
  the rest. Attention's products (batch dims B and H) are never marked."""
  if op in _PRODUCT_OPS and getattr(_IN_PRODUCT, "on", False):
    return CheckpointPolicy.MUST_SAVE
  return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
  return create_selective_checkpoint_contexts(_dots_policy)


def _dense(x: torch.Tensor, w: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
  """flax ``DenseGeneral(dtype=dtype)`` over the last axis: x [..., D] @
  w [D, *feats], both cast to ``dtype``."""
  out = x.to(dtype) @ w.to(dtype).reshape(w.shape[0], -1)
  return out.reshape(x.shape[:-1] + w.shape[1:])


def _row_parallel(x: torch.Tensor, w: torch.Tensor, plan: "_Plan",
                  dtype: torch.dtype) -> torch.Tensor:
  """A row-parallel product in decode: this rank's ``x [..., K/t] @ w
  [K/t, N]`` in f32 (the operands are ``dtype`` values, exact in f32),
  the partial sums all-reduced over ``tensor`` in f32 and the sum rounded
  to ``dtype`` once. Summing rounded ``dtype`` partials instead would
  round twice, and a bf16 model's tokens would part from one card's."""
  return plan.reduce_t(x.to(dtype).float() @ w.to(dtype).float()).to(dtype)


class LayerNorm(nn.Module):
  """Bias-free LayerNorm, eps 1e-6, f32 scale; output in the input dtype
  (``ops.layer_norm``: the kernel on the card). Over a mesh the scale is
  whole on every rank and the norm runs on the rank's rows: it reduces
  over ``d_model``, which no axis cuts, so it needs no collective."""

  def __init__(self, cfg: TransformerConfig, device, trainable: bool):
    super().__init__()
    self.scale = _param((cfg.d_model,), cfg, device, trainable,
                        torch.float32)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return ops.layer_norm(x, self.scale)


class TiedEmbed(nn.Module):
  """Tied input/output embedding (``embed.embedding`` [V, D]), used in
  ``cfg.dtype``. Over a mesh the table's rows are cut over ``tensor``
  (a lookup masked to the rank's rows, then one all-reduce; the output
  projection gives the rank's vocabulary columns of the logits) and its
  columns over ``fsdp`` (gathered at use)."""

  def __init__(self, cfg: TransformerConfig, device, trainable: bool,
               plan: _Plan):
    super().__init__()
    self.dtype = cfg.dtype
    self.plan = plan
    self.embedding = _param(plan.local("embed.embedding"), cfg, device,
                            trainable)

  def table(self) -> torch.Tensor:
    """The rank's rows of the table in ``cfg.dtype``, whole columns."""
    return self.plan.full(self.embedding, "embed.embedding", self.dtype)

  def forward(self, tokens: torch.Tensor) -> torch.Tensor:
    table = self.table()
    if not self.plan.vocab:
      return F.embedding(tokens, table)
    per = table.shape[0]
    local = tokens - self.plan.t_index() * per
    inside = (local >= 0) & (local < per)
    rows = F.embedding(local.clamp(0, per - 1), table) * \
        inside[..., None].to(table.dtype)
    return self.plan.reduce_t(rows)

  def attend(self, x: torch.Tensor) -> torch.Tensor:
    table = self.table()
    if self.plan.vocab:
      x = self.plan.copy_t(x)
    return x.to(self.dtype) @ table.t()


class Attention(nn.Module):

  def __init__(self, cfg: TransformerConfig, device, trainable: bool,
               plan: _Plan):
    super().__init__()
    self.cfg = cfg
    self.plan = plan
    if cfg.fuse_qkv:
      self.qkv = _param(plan.local("attn.qkv"), cfg, device, trainable)
    else:
      self.q = _param(plan.local("attn.q"), cfg, device, trainable)
      self.k = _param(plan.local("attn.k"), cfg, device, trainable)
      self.v = _param(plan.local("attn.v"), cfg, device, trainable)
    self.out = _param(plan.local("attn.out"), cfg, device, trainable)

  def _local_q(self, q: torch.Tensor) -> torch.Tensor:
    """This rank's query heads of a whole ``q`` every rank computed."""
    per = self.cfg.num_heads // self.plan.t
    r = self.plan.t_index()
    return self.plan.copy_t(q)[:, :, r * per:(r + 1) * per]

  def _project(self, x, ln_scale=None):
    """``(q, k, v, kv_whole)``: q holds this rank's query heads; k/v its
    KV heads, or every KV head (``kv_whole``) where the tensor axis cuts
    the query heads but cannot cut the KV heads."""
    cfg, plan = self.cfg, self.plan
    dt = cfg.dtype
    if cfg.fuse_qkv:
      w = plan.full(self.qkv, "attn.qkv", dt)
      if plan.kv:
        # columns [q_r | k_r | v_r]: this rank's query heads and their group
        h, hk = cfg.num_heads // plan.t, cfg.kv_heads // plan.t
        if ln_scale is not None:
          qkv = ops.ln_matmul_sharded(
              x, ln_scale, w.reshape(cfg.d_model, -1), plan.mesh).reshape(
                  x.shape[:-1] + w.shape[1:])
        else:
          with _weight_product():
            qkv = _dense(plan.copy_t(x), w, dt)
        return (qkv[..., :h, :], qkv[..., h:h + hk, :],
                qkv[..., h + hk:, :], False)
      h, hk = cfg.num_heads, cfg.kv_heads
      if ln_scale is not None:
        qkv = ops.ln_matmul(x, ln_scale, w.reshape(cfg.d_model, -1)).reshape(
            x.shape[:-1] + (h + 2 * hk, cfg.head_dim))
      else:
        with _weight_product():
          qkv = _dense(x, w, dt)
      q, k, v = qkv[..., :h, :], qkv[..., h:h + hk, :], qkv[..., h + hk:, :]
      if plan.heads:
        return self._local_q(q), k, v, True
      return q, k, v, False
    if ln_scale is not None:
      raise ValueError("ln-fused attention requires fuse_qkv")
    wq = plan.full(self.q, "attn.q", dt)
    wk = plan.full(self.k, "attn.k", dt)
    wv = plan.full(self.v, "attn.v", dt)
    xq = plan.copy_t(x) if plan.heads else x
    xk = xq if plan.kv else x
    with _weight_product():
      return (_dense(xq, wq, dt), _dense(xk, wk, dt), _dense(xk, wv, dt),
              plan.heads and not plan.kv)

  def _out_proj(self, o: torch.Tensor, decode: bool = False) -> torch.Tensor:
    """The output projection; row-parallel (one all-reduce) over a tensor
    axis that cuts the heads. In ``decode`` each rank's partial product is
    kept in f32 and the sum rounded to ``cfg.dtype`` once, as one card's
    product rounds its f32 accumulation once (:func:`_row_parallel`)."""
    b, s = o.shape[:2]
    dt = self.cfg.dtype
    w = self.plan.full(self.out, "attn.out", dt)
    o = o.to(dt).reshape(b, s, -1)
    if decode and self.plan.heads:
      return _row_parallel(o, w.reshape(-1, w.shape[-1]), self.plan, dt)
    with _weight_product():
      y = o @ w.reshape(-1, w.shape[-1])
    return self.plan.reduce_t(y) if self.plan.heads else y

  def forward(self, x, rope, cache: Optional[KVCache] = None,
              layer: int = 0, ln_scale: Optional[torch.Tensor] = None,
              writes=None):
    """``x`` arrives normalized; ``rope`` holds the (cos, sin) tables of
    its positions. With ``cache`` this is the decode path (``writes``, a
    vector-cursor cache's :func:`_write_plan`). With
    ``ln_scale`` (requires ``fuse_qkv``), ``x`` is the RAW residual
    stream and ln1 + the QKV projection run as one kernel
    (``ops.ln_matmul``). Over a mesh cut on ``sequence`` the attention is
    the ring (``cfg.use_ring_attention``)."""
    cfg, plan = self.cfg, self.plan
    q, k, v, kv_whole = self._project(x, ln_scale)
    q = _apply_rotary(q, rope)
    k = _apply_rotary(k, rope)
    if cache is not None:
      return self._out_proj(self._decode_attend(q, k, v, cache, layer,
                                                writes), decode=True)
    # the kernel takes any length: the block rule only decides whether
    # "flash" refuses this one
    _flash_eligible(cfg, q.shape[1])
    window = cfg.attention_window or None
    if plan.seq > 1:
      if not cfg.use_ring_attention:
        raise ValueError("a sequence axis of %d needs use_ring_attention="
                         "True: each rank holds one block of the sequence"
                         % plan.seq)
      out = ra.ring_attention(q, k, v, plan.mesh, causal=True,
                              use_flash=True, window=window,
                              kv_whole=kv_whole)
    else:
      if kv_whole:
        k = ra.local_heads(k, cfg.num_heads, plan.mesh)
        v = ra.local_heads(v, cfg.num_heads, plan.mesh)
      out = ops.flash_attention(q, k, v, causal=True, window=window)
    return self._out_proj(out)

  def _decode_attend(self, q, k, v, cache: KVCache, layer: int, writes):
    """Incremental attention against the KV cache (q, k already rotated
    to their cursor positions): write the new keys and values at the
    cursor (through ``writes`` when it is a vector), attend everything
    cached so far. The cursor itself advances once per forward, in
    :meth:`Transformer.forward`."""
    cfg = self.cfg
    if cache.page_table is not None:
      return self._decode_attend_paged(q, k, v, cache, layer, writes)
    b, seg = q.shape[:2]
    idx = cache.index
    vec = torch.is_tensor(idx)
    quant = cache.k_scale is not None
    if quant:
      k_store, ks = _quantize(k)
      v_store, vs = _quantize(v)
      pairs = ((cache.k[layer], k_store), (cache.v[layer], v_store),
               (cache.k_scale[layer], ks), (cache.v_scale[layer], vs))
    else:
      pairs = ((cache.k[layer], k), (cache.v[layer], v))
    if not vec and idx + seg > cfg.max_seq_len:
      raise ValueError("decode write of %d tokens at position %d overruns "
                       "the max_seq_len=%d cache"
                       % (seg, idx, cfg.max_seq_len))
    for buf, val in pairs:
      if vec:
        _write_rows(buf, val, writes)
      else:
        buf[:, idx:idx + seg] = val.to(buf.dtype)

    # PREFILL fast path: a fresh-cache multi-token segment attends only
    # within itself, so the flash op runs it over the grouped K/V directly
    # instead of the seg x max_seq_len dense scores (the raw projections:
    # an int8 cache's quantization does not touch it). The cursor is a
    # host int here, so the branch costs no device sync. Over a tensor
    # axis the kernel runs at the rank's heads: its query heads over their
    # own KV group, or over the KV head of each where every KV head is
    # whole on the rank.
    if not vec and idx == 0 and seg > 1 and _flash_eligible(cfg, seg):
      sel = self.plan.kv_index()
      if sel is not None:
        sel = sel.to(k.device)
        k, v = k.index_select(2, sel), v.index_select(2, sel)
      out = ops.flash_attention(q, k, v, causal=True,
                                window=cfg.attention_window or None)
      return out.to(q.dtype)
    if quant:
      return self._dense_attend(q, cache.k[layer], cache.v[layer], idx, vec,
                                cache.k_scale[layer], cache.v_scale[layer])
    return self._dense_attend(q, cache.k[layer], cache.v[layer], idx, vec)

  def _decode_attend_paged(self, q, k, v, cache: KVCache, layer: int,
                           writes):
    """Incremental attention against a PAGED cache (the serving slab):
    the write goes through the page table (``writes``, the forward's
    :func:`_write_plan`), each row's pages are gathered into a ``[b,
    pages_per_slot * page_size, ...]`` view, and the view is attended as
    the vector-cursor branch attends its rows. Frozen lanes (an all-zero
    table) write into page 0: several writes may land on one trash entry,
    with an arbitrary winner, and nothing live attends it."""
    b, seg = q.shape[:2]
    pk, pv = cache.k[layer], cache.v[layer]
    pages, offs = writes
    pk[pages, offs] = k.reshape((b * seg,) + k.shape[2:]).to(pk.dtype)
    pv[pages, offs] = v.reshape((b * seg,) + v.shape[2:]).to(pv.dtype)
    table = cache.page_table
    view = (b, pk.shape[1] * table.shape[1]) + pk.shape[2:]
    return self._dense_attend(q, pk[table].reshape(view),
                              pv[table].reshape(view), cache.index, True)

  def _dense_attend(self, q, ck, cv, idx, vec, k_scale=None, v_scale=None):
    """q regrouped [b, seg, kv_head, group, d] against the whole cache
    ``ck``/``cv [b, L, kv_heads, d]`` with the causal + unwritten (+
    window) mask, in f32. An int8 cache's scales ``[b, L, kv_heads]``
    apply to the K-indexed tensors, the scores and the probs, as the
    reference applies them (no dequantized cache is formed). Over a
    tensor axis ``q`` holds the rank's query heads and the cache its KV
    heads; where the cache holds every KV head and the query heads are
    cut, each query head attends its own KV head's entries."""
    cfg = self.cfg
    b, seg, h, d = q.shape
    sel = self.plan.kv_index()
    if sel is not None:
      sel = sel.to(ck.device)
      ck, cv = ck.index_select(2, sel), cv.index_select(2, sel)
      if k_scale is not None:
        k_scale = k_scale.index_select(2, sel)
        v_scale = v_scale.index_select(2, sel)
    hk = ck.shape[2]
    kf, vf = ck.float(), cv.float()
    qg = q.reshape(b, seg, hk, h // hk, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * (1.0 / d ** 0.5)
    if k_scale is not None:
      scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    ar = torch.arange(seg, device=q.device)
    k_pos = torch.arange(ck.shape[1], device=q.device)
    if vec:
      q_pos = idx[:, None, None] + ar[None, :, None]     # [b, seg, 1]
      keep = k_pos[None, None, :] <= q_pos                # [b, seg, L]
      if cfg.attention_window:
        keep = keep & (k_pos[None, None, :] > q_pos - cfg.attention_window)
      mask = keep[:, None, None]
    else:
      q_pos = idx + ar[:, None]                           # [seg, 1]
      keep = k_pos[None, :] <= q_pos
      if cfg.attention_window:
        keep = keep & (k_pos[None, :] > q_pos - cfg.attention_window)
      mask = keep[None, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
      probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf)
    return o.reshape(b, seg, h, d).to(q.dtype)


class MLPBlock(nn.Module):

  def __init__(self, cfg: TransformerConfig, device, trainable: bool,
               plan: _Plan):
    super().__init__()
    self.dtype = cfg.dtype
    self.plan = plan
    self.up = _param(plan.local("mlp.up"), cfg, device, trainable)
    self.down = _param(plan.local("mlp.down"), cfg, device, trainable)

  def forward(self, x, ln_scale: Optional[torch.Tensor] = None,
              act_fused: bool = False, decode: bool = False):
    """With ``ln_scale`` (the preceding LayerNorm's weight), ``x`` is the
    RAW residual stream and the norm + up-projection run as one kernel
    (``ops.ln_matmul``); without it ``x`` arrives normalized. With
    ``act_fused``, GELU + the down-projection run as one kernel over the
    pre-activation (``ops.gelu_matmul``). Over a mesh cutting ``mlp``,
    up is column-parallel and down row-parallel (one all-reduce; in
    ``decode`` summed in f32, :func:`_row_parallel`)."""
    plan, dt = self.plan, self.dtype
    up = plan.full(self.up, "mlp.up", dt)
    down = plan.full(self.down, "mlp.down", dt)
    if ln_scale is not None:
      h = ops.ln_matmul_sharded(x, ln_scale, up, plan.mesh) if plan.mlp \
          else ops.ln_matmul(x, ln_scale, up)
    else:
      with _weight_product():
        h = _dense(plan.copy_t(x) if plan.mlp else x, up, dt)
    if act_fused:
      if plan.mlp:
        return ops.gelu_matmul_sharded(h, down, plan.mesh)
      return ops.gelu_matmul(h, down)
    if decode and plan.mlp:
      a = F.gelu(h, approximate="tanh")
      return _row_parallel(a.reshape(-1, a.shape[-1]), down, plan,
                           dt).reshape(a.shape[:-1] + (down.shape[-1],))
    out = _dense(F.gelu(h, approximate="tanh"), down, dt)
    return plan.reduce_t(out) if plan.mlp else out


class MoEBlock(nn.Module):
  """Expert-routed FFN (``parallel.expert_parallel``), the reference's
  ``MoEBlock``: f32 weights ``w_gate`` [D, E], ``w_up`` [E, D, F] and
  ``w_down`` [E, F, D] (over a mesh with an expert axis, the rank's block
  of the experts), top-k routing, and the load-balancing loss of each
  forward kept in :attr:`aux` (the reference sows it under
  ``intermediates/moe_aux``; the loss does not add it). Without an
  expert axis the layer runs ``moe_ffn_reference``; with one,
  ``moe_ffn`` (dense masked dispatch), or ``moe_ffn_a2a`` when
  ``moe_capacity_factor`` > 0, whose dropped assignments the forward
  keeps in :attr:`dropped` (a tensor; None on the other paths). Tokens
  are taken one by one, so the decode cache is untouched."""

  def __init__(self, cfg: TransformerConfig, device, trainable: bool,
               plan: _Plan):
    super().__init__()
    self.cfg = cfg
    self.plan = plan
    for name in ("w_gate", "w_up", "w_down"):
      setattr(self, name, _param(plan.local("moe." + name), cfg, device,
                                 trainable, torch.float32))
    self.aux: Optional[torch.Tensor] = None
    self.dropped: Optional[torch.Tensor] = None

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    from tensorflowonspark_tpu_torch.parallel import expert_parallel as ep
    cfg, mesh = self.cfg, self.plan.mesh
    params = {"w_gate": self.w_gate, "w_up": self.w_up,
              "w_down": self.w_down}
    flat = x.reshape(-1, x.shape[-1])
    # one router forward feeds the dispatch and the aux loss
    dispatch, combine, probs = ep.route(params, flat, cfg.moe_top_k)
    if self.plan.expert > 1 and cfg.moe_capacity_factor > 0:
      drops: list = []
      y = ep.moe_ffn_a2a(params, flat, mesh, cfg.moe_capacity_factor,
                         cfg.moe_top_k, drops=drops)
      self.dropped = drops[0]
    elif self.plan.expert > 1:
      y = ep.moe_ffn(params, flat, mesh, cfg.moe_top_k,
                     routing=(dispatch, combine))
    else:
      y = ep.moe_ffn_reference(params, flat, cfg.moe_top_k,
                               routing=(dispatch, combine))
    self.aux = ep.aux_loss_from(probs, dispatch, cfg.moe_top_k)
    return y.reshape(x.shape).to(x.dtype)


class Block(nn.Module):
  """Pre-LN block: x + attn(ln1(x)), then + mlp(ln2(x)), or + moe(ln2(x))
  on a MoE layer (``use_moe``).

  Off the decode path (no cache), ``ln_matmul_impl="fused"`` runs ln2 +
  the up-projection as one kernel, and ln1 + the QKV projection too when
  ``fuse_qkv``; ``act_matmul_impl="fused"`` runs GELU + the
  down-projection as one. A MoE layer's ln2 is the plain LayerNorm kernel
  on every path, as in the reference. The LayerNorm modules keep their
  ``scale`` either way (the parameter names do not change); only their
  forward is skipped. The decode path never fuses, as in the
  reference."""

  def __init__(self, cfg: TransformerConfig, device, trainable: bool,
               plan: _Plan, use_moe: bool = False):
    super().__init__()
    self.cfg = cfg
    self.ln1 = LayerNorm(cfg, device, trainable)
    self.attn = Attention(cfg, device, trainable, plan)
    self.ln2 = LayerNorm(cfg, device, trainable)
    if use_moe:
      self.moe = MoEBlock(cfg, device, trainable, plan)
    else:
      self.mlp = MLPBlock(cfg, device, trainable, plan)
    self.use_moe = use_moe

  def forward(self, x, rope, cache=None, layer=0, writes=None):
    cfg = self.cfg
    fuse_ln = cfg.ln_matmul_impl == "fused" and cache is None
    if fuse_ln and cfg.fuse_qkv:
      x = x + self.attn(x, rope, ln_scale=self.ln1.scale)
    else:
      x = x + self.attn(self.ln1(x), rope, cache, layer, writes=writes)
    if self.use_moe:
      return x + self.moe(self.ln2(x))
    act_fused = cfg.act_matmul_impl == "fused" and cache is None
    if fuse_ln:
      return x + self.mlp(x, ln_scale=self.ln2.scale, act_fused=act_fused)
    return x + self.mlp(self.ln2(x), act_fused=act_fused,
                        decode=cache is not None)


class Transformer(nn.Module):
  """Causal LM: int token ids [batch, seq] -> f32 logits [batch, seq, V].

  ``params``: the flat float32 weight dict of
  :func:`~tensorflowonspark_tpu_torch.utils.params.init_params` or
  :func:`~tensorflowonspark_tpu_torch.utils.params.params_from_flax`.
  ``device``: ``None`` is the card (raises when there is none); the tests
  pass ``"cpu"``. ``trainable``: keep f32 master weights that require
  gradients (training) instead of ``cfg.dtype`` weights (serving); see
  the module docstring. ``mesh``: this rank's place on a mesh
  (``parallel.mesh.build_mesh``); each parameter then holds the rank's
  block (:func:`param_logical`), the forward takes the rank's block of
  the batch and returns the rank's vocabulary columns of its logits
  (whole when the tensor axis is 1). ``blocks``: ``params`` already
  holds the rank's blocks (``parallel.sharding.init_sharded_state``)
  instead of the whole weights.
  """

  def __init__(self, cfg: TransformerConfig,
               params: Mapping[str, np.ndarray], device=None,
               trainable: bool = False, mesh=None, blocks: bool = False):
    super().__init__()
    self.cfg = cfg
    self.device = resolve_device(device)
    self.trainable = trainable
    self.mesh = mesh
    self.plan = _Plan(cfg, mesh)
    self.embed = TiedEmbed(cfg, self.device, trainable, self.plan)
    self.layers = nn.ModuleList(
        [Block(cfg, self.device, trainable, self.plan,
               is_moe_layer(cfg, i)) for i in range(cfg.num_layers)])
    self.ln_f = LayerNorm(cfg, self.device, trainable)
    self.load_params(params, blocks=blocks)

  def _qkv_cut(self) -> bool:
    return self.cfg.fuse_qkv and self.plan.kv

  def param_permutation(self, name: str) -> Optional[tuple]:
    """``(dim, order)`` where parameter ``name``'s whole weight has its
    dimension ``dim`` reordered by ``order`` before it is cut into
    blocks, else None: a cut fused QKV weight's heads, rank by rank
    (``[q_r | k_r | v_r]``, :meth:`_Plan.qkv_order`). A checkpoint holds
    the weight and every optimizer tensor that keeps that dimension in
    the order of one process (``parallel.sharding.gather_state``)."""
    if not self._qkv_cut() or param_kind(name) != "attn.qkv":
      return None
    return 1, self.plan.qkv_order()

  def _reorder(self, params: Mapping[str, Any], back: bool) -> dict:
    out = dict(params)
    for n, p in params.items():
      perm = self.param_permutation(n)
      if perm is None:
        continue
      order = np.argsort(perm[1]) if back else perm[1]
      out[n] = p[:, torch.as_tensor(order)] if torch.is_tensor(p) \
          else np.asarray(p)[:, order]
    return out

  def permute_params(self, params: Mapping[str, Any]) -> dict:
    """Whole weights in the layout the blocks are cut from
    (:meth:`param_permutation`); every other weight as it is."""
    return self._reorder(params, back=False)

  def unpermute_params(self, params: Mapping[str, Any]) -> dict:
    """The inverse of :meth:`permute_params`."""
    return self._reorder(params, back=True)

  def param_specs(self) -> dict:
    """Each parameter's mesh spec (an axis or None per dimension)."""
    return {n: self.plan.specs[param_kind(n)]
            for n, _ in self.named_parameters()}

  def load_params(self, params: Mapping[str, Any],
                  blocks: bool = False) -> None:
    """Copy a flat weight dict in (numpy arrays or tensors, each cast to
    its parameter's dtype): the whole weights, of which each rank keeps
    its blocks, or with ``blocks`` the rank's blocks themselves."""
    if self.mesh is not None and not blocks:
      specs = self.param_specs()
      params = {n: sharding_lib.shard_array(p, specs[n], self.mesh)
                for n, p in self.permute_params(params).items()}
    copy_into(dict(self.named_parameters()), params)


  def init_cache(self, batch: int) -> KVCache:
    """A fresh zeroed cache for ``batch`` rows in the config's layout
    (:func:`zero_cache`), at the KV heads this rank holds."""
    return zero_cache(self.cfg, batch, self.device,
                      self.plan.local_kv_heads())

  def serving_params(self) -> dict:
    """The weights as a serving model stores them: a flat dict of CPU
    tensors, each LayerNorm scale and MoE weight in f32 and every other
    weight in
    ``cfg.dtype`` (what ``pipeline.export_bundle`` writes for
    :func:`make_serving_predict_fn`: a bf16 model's bundle is half the
    bytes of its f32 master weights). Of a model cut over fsdp, tensor or
    expert, the WHOLE weights: each block all-gathered over the axes that
    cut it (:meth:`param_specs`) and a cut fused QKV weight put back in
    the order of one process, bitwise the uncut model's. That is a
    collective: over a cut mesh every rank calls it together, and every
    rank gets the whole weights."""
    specs = self.param_specs()
    out = {}
    for name, p in self.named_parameters():
      w = p.detach().to(torch.float32 if param_kind(name).startswith(
          ("ln.", "moe.")) else self.cfg.dtype)
      if self.mesh is not None and any(specs[name]):
        w = sharding_lib.gather_array(w, specs[name], self.mesh)
      out[name] = w
    return {n: w.cpu() for n, w in self.unpermute_params(out).items()}

  def whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
    """Logits of the whole vocabulary from this rank's forward: its
    vocabulary columns all-gathered over ``tensor`` where the table is cut
    there (every rank gets the same row), else ``logits`` as they are."""
    if not self.plan.vocab:
      return logits
    return collectives.all_gather(logits.contiguous(), self.mesh,
                                  mesh_lib.AXIS_TENSOR, axis=-1)

  def moe_aux(self) -> List[torch.Tensor]:
    """The load-balancing loss of each MoE layer's last forward, in layer
    order (the reference's ``intermediates/moe_aux``); empty without
    MoE layers."""
    return [b.moe.aux for b in self.layers if b.use_moe]

  def numpy_params(self) -> dict:
    """The weights as the flat f32 numpy dict ``load_params`` takes (see
    :func:`~tensorflowonspark_tpu_torch.utils.params.params_to_flax` for
    the flax tree); over a mesh, this rank's blocks
    (``parallel.sharding.gather_state_params`` gives the whole weights)."""
    return {name: p.detach().float().cpu().numpy()
            for name, p in self.named_parameters()}

  def forward(self, tokens: torch.Tensor,
              cache: Optional[KVCache] = None,
              return_hidden: bool = False,
              exit_layer: Optional[int] = None) -> torch.Tensor:
    """Logits for ``tokens``. With ``cache``, the decode path: tokens sit
    at the cache cursor, their keys/values are written into the cache and
    the cursor advances by ``tokens.shape[1]``. ``return_hidden`` returns
    the final-norm output in ``cfg.dtype`` instead of the logits (for
    :func:`causal_lm_loss_blocked`). A differentiated forward without a
    cache recomputes each block in the backward when ``cfg.remat``, all
    of it (``remat_policy="none"``) or all but its weight products
    (``"dots"``). ``exit_layer`` runs only the first N blocks before the
    final norm and the tied projection: the shallow-exit draft of
    self-speculative decoding, which shares the weights and the cache.
    Its cursor advances as any forward's does; the caller that drafts
    rolls it back. Over a mesh the decode path takes this rank's rows
    and returns its vocabulary columns, as the forward without a cache
    does (:meth:`whole_logits` gathers them); its cache holds the rank's
    KV heads (:meth:`init_cache`)."""
    cfg = self.cfg
    if exit_layer is not None and not 1 <= exit_layer <= cfg.num_layers:
      raise ValueError("exit_layer must be in [1, num_layers=%d], got %r"
                       % (cfg.num_layers, exit_layer))
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    remat_kw = {"context_fn": _dots_contexts} \
        if cfg.remat_policy == "dots" else {}
    tokens = tokens.to(self.device)
    b, s = tokens.shape
    ar = torch.arange(s, device=self.device)
    writes = None
    if cache is None:
      # a block of a sequence cut over the mesh starts at its offset
      offset = mesh_lib.axis_index(self.mesh, mesh_lib.AXIS_SEQUENCE) * s
      positions = (ar + offset if offset else ar).expand(b, s)
    elif torch.is_tensor(cache.index):
      positions = cache.index[:, None] + ar[None, :]
      writes = _write_plan(cache, s)
    else:
      positions = (cache.index + ar).expand(b, s)
    rope = _rope_tables(positions, self.cfg.head_dim)
    x = self.embed(tokens)
    layers = self.layers if exit_layer is None else self.layers[:exit_layer]
    for i, block in enumerate(layers):
      if remat:
        x = checkpoint(block, x, rope, use_reentrant=False, **remat_kw)
      else:
        x = block(x, rope, cache, i, writes)
    if cache is not None:
      cache.index = cache.index + s
    x = self.ln_f(x)
    if return_hidden:
      return x.to(cfg.dtype)
    return self.embed.attend(x).float()


def _as_prompt(prompt, device) -> torch.Tensor:
  t = prompt if torch.is_tensor(prompt) else torch.as_tensor(np.asarray(prompt))
  if t.dim() != 2:
    raise ValueError("prompt must be [batch, prompt_len], got %s"
                     % (tuple(t.shape),))
  return t.to(device=device, dtype=torch.long)


def _row_axes(mesh) -> tuple:
  """The axes a decode's rows are cut over: ``data`` and ``fsdp``, those
  of them above 1."""
  return mesh.wide(mesh_lib.data_axes(mesh)) if mesh is not None else ()


def _my_rows(prompt: torch.Tensor, mesh) -> torch.Tensor:
  """This rank's block of the global ``prompt``'s rows over the data
  axes, the batch first padded with zero rows to a multiple of their
  extent (the reference pads a ragged last serving batch so, and slices
  it back: decode rows are independent)."""
  if not _row_axes(mesh):
    return prompt
  pad = (-prompt.shape[0]) % mesh_lib.axis_size(mesh, *_row_axes(mesh))
  if pad:
    prompt = torch.cat([prompt, prompt.new_zeros((pad, prompt.shape[1]))])
  return sharding_lib.shard_batch(prompt, mesh)


def _all_rows(out: torch.Tensor, mesh, b: int) -> torch.Tensor:
  """Every rank's decoded rows (:func:`_my_rows`' blocks all-gathered over
  the data axes), the padding sliced off: the whole ``[b, ...]``."""
  if not _row_axes(mesh):
    return out
  return collectives.all_gather(out, mesh, _row_axes(mesh), axis=0)[:b]


def _select_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float, top_k: int) -> torch.Tensor:
  """Greedy (``temperature == 0``) or top-k temperature sampling, as the
  reference's ``_select_token``: the logits are divided by
  ``temperature``; with ``0 < top_k < vocab`` every logit below the k-th
  largest is masked (ties at the k-th are kept, as ``lax.top_k`` + ``>=``
  keeps them); the token is drawn from the categorical of what is left,
  with ``generator``."""
  if temperature == 0.0:
    return logits.argmax(dim=-1)
  scaled = logits.float() / temperature
  if 0 < top_k < logits.shape[-1]:
    kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
    scaled = torch.where(scaled < kth, torch.full_like(scaled, NEG_INF),
                         scaled)
  probs = torch.softmax(scaled, dim=-1)
  return torch.multinomial(probs, 1, generator=generator)[:, 0]


def greedy_generate_kv(model: Transformer, prompt, num_steps: int,
                       eos_id: Optional[int] = None, pad_id: int = 0,
                       temperature: float = 0.0, top_k: int = 0,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
  """Decoding with a per-layer KV cache (the serving path).

  prompt: ``[batch, prompt_len]`` ints. Returns ``[batch, prompt_len +
  num_steps]`` int64 on the model's device. Greedy by default;
  ``temperature > 0`` samples (optionally top-k filtered, see
  :func:`_select_token`) with ``generator``, a ``torch.Generator`` on the
  model's device. Where the reference demands an explicit ``rng`` key,
  the port demands the generator: a silent fixed seed would make every
  "sampled" call identical. The draws are not JAX's stream, so a sampled
  decode differs from the reference's. With ``eos_id``, a row that emits
  it keeps the EOS and every later position is ``pad_id``. The whole
  prompt is one fresh-cache prefill (flash where its length divides into
  kernel blocks), then one token per step.

  Over a mesh (``model.mesh``) the decode is SPMD: every rank calls it
  with the same prompt (and, sampling, a generator seeded alike). The
  rows are cut over ``data`` x ``fsdp``, padded to a multiple of their
  extent; each rank decodes its rows at its heads, every token picked
  from the logits gathered whole over ``tensor`` (so the ranks of a row
  pick the same one: the lowest id on a tie, as ``argmax`` does).
  Sampling gathers the logits over the data axes as well and every rank
  draws for the whole batch, so the mesh samples one process's tokens.
  The tokens are all-gathered over the data axes and every rank returns
  the whole ``[batch, prompt_len + num_steps]``, as the reference's
  decode on a mesh returns it replicated.
  """
  cfg = model.cfg
  if temperature < 0:
    raise ValueError("temperature must be >= 0, got %r" % temperature)
  if temperature > 0:
    if generator is None:
      raise ValueError("temperature > 0 requires an explicit "
                       "torch.Generator (generator=)")
    if torch.device(generator.device).type != model.device.type:
      raise ValueError("the generator lives on %s, the model on %s"
                       % (generator.device, model.device))
  prompt = _as_prompt(prompt, model.device)
  b, plen = prompt.shape
  if plen + num_steps > cfg.max_seq_len:
    raise ValueError(
        "generation of %d tokens from a %d-token prompt exceeds the "
        "cfg.max_seq_len=%d cache" % (num_steps, plen, cfg.max_seq_len))
  if eos_id is not None and int(eos_id) == int(pad_id):
    raise ValueError("eos_id and pad_id must differ (both %d): a padded "
                     "position would read as a fresh stop" % int(pad_id))
  if num_steps < 1:
    return prompt

  if obs_metrics.active() is not None:
    # recompile sentinel seam: the reference compiles one decode loop per
    # (batch, prompt length, steps, sampling, eos, pad)
    obs_device.note_trace("transformer.kv_generate", b, plen, num_steps,
                          temperature, top_k, eos_id, pad_id)

  mesh, whole = model.mesh, prompt
  rows = _row_axes(mesh)

  def select(logits):
    logits = model.whole_logits(logits[:, -1])
    if temperature == 0.0 or not rows:
      return _select_token(logits, generator, temperature, top_k)
    # sampling: every rank draws for the whole batch from its generator
    # (seeded alike), as one process does, and keeps its rows
    every = collectives.all_gather(logits, mesh, rows, axis=0)[:b]
    drawn = _select_token(every, generator, temperature, top_k)
    return _my_rows(drawn[:, None], mesh)[:, 0]

  prompt = _my_rows(prompt, mesh)
  with torch.inference_mode():
    cache = model.init_cache(prompt.shape[0])
    nxt = select(model(prompt, cache))
    done = nxt == eos_id if eos_id is not None \
        else torch.zeros_like(nxt, dtype=torch.bool)
    out, tok = [nxt], nxt
    for _ in range(num_steps - 1):
      new = select(model(tok[:, None], cache))
      if eos_id is not None:
        new = torch.where(done, torch.full_like(new, pad_id), new)
        done = done | (new == eos_id)
      out.append(new)
      tok = new
    return torch.cat([whole, _all_rows(torch.stack(out, dim=1), mesh, b)],
                     dim=1)


def speculative_generate_kv(draft: Transformer, model: Transformer, prompt,
                            num_steps: int, draft_k: int = 4
                            ) -> torch.Tensor:
  """Greedy speculative decoding: the ``draft`` model proposes
  ``draft_k`` tokens a round and ``model`` (the target) verifies them in
  ONE multi-token decode pass. The output is exactly the target's own
  greedy decode (greedy acceptance is lossless).

  Rollback is a cursor assignment: rejected draft entries sit past the
  rewound cursor, masked from attention and overwritten by the next
  round. Batched rows accept the row-wise MINIMUM prefix each round
  (lockstep cursors); rows that agreed further receive those same tokens
  through the bonus token. The round's accepted count is read on the
  host (one sync a round).

  Both models must share a vocabulary, and ``prompt_len + num_steps +
  draft_k`` must fit both ``max_seq_len`` (a round's draft writes may
  overshoot the kept output); both live on one device. Returns
  ``[batch, prompt_len + num_steps]`` int64 on it.

  Over a mesh both models lie on the same one and the decode is SPMD, as
  :func:`greedy_generate_kv`'s: each rank runs its rows, each round's
  accepted count is the minimum over every rank's rows (so the ranks
  that share weights over ``fsdp`` run the same forwards), and every
  rank returns the whole batch.
  """
  cfg, dcfg = model.cfg, draft.cfg
  if dcfg.vocab_size != cfg.vocab_size:
    raise ValueError("draft and target must share a vocabulary (%d vs %d)"
                     % (dcfg.vocab_size, cfg.vocab_size))
  mesh = model.mesh
  if (mesh is None) != (draft.mesh is None) or (
      mesh is not None and (dict(mesh.shape) != dict(draft.mesh.shape)
                            or mesh.rank != draft.mesh.rank)):
    raise ValueError("draft and target must lie on one mesh (%r vs %r)"
                     % (draft.mesh, mesh))
  if draft_k < 1:
    raise ValueError("draft_k must be >= 1, got %d" % draft_k)
  prompt = _as_prompt(prompt, model.device)
  b, plen = prompt.shape
  need = plen + num_steps + draft_k
  for name, c in (("draft", dcfg), ("target", cfg)):
    if need > c.max_seq_len:
      raise ValueError(
          "speculative decode needs %d cache slots (prompt %d + steps %d "
          "+ draft_k %d) but the %s max_seq_len is %d"
          % (need, plen, num_steps, draft_k, name, c.max_seq_len))
  k = int(draft_k)
  whole = prompt
  prompt = _my_rows(prompt, mesh)
  with torch.inference_mode():
    rows = prompt.shape[0]
    cache_t, cache_d = model.init_cache(rows), draft.init_cache(rows)
    # prefill both; the TARGET's argmax after the prompt is token 1
    last = model.whole_logits(model(prompt, cache_t)[:, -1]).argmax(dim=-1)
    draft(prompt, cache_d)
    out, n_gen = [last[:, None]], 1
    while n_gen < num_steps:
      # both cursors sit at plen + n_gen - 1 (the tokens consumed so far)
      cursor, tok, proposals = plen + n_gen - 1, last, []
      for _ in range(k):
        tok = draft.whole_logits(draft(tok[:, None], cache_d)[:, -1]).argmax(
            dim=-1)
        proposals.append(tok)
      p = torch.stack(proposals, dim=1)                     # [b, k]
      # logits[:, j] is the target's prediction AFTER input j
      t = model.whole_logits(model(torch.cat([last[:, None], p[:, :k - 1]],
                                             dim=1), cache_t)).argmax(dim=-1)
      m = torch.cumprod((p == t).long(), dim=1).sum(dim=1).min()
      if _row_axes(mesh):
        m = -collectives.all_reduce(-m.reshape(1), mesh, _row_axes(mesh),
                                    op="max")[0]
      m = int(m)
      bonus = t[:, min(m, k - 1)]
      if m < k:
        out.append(torch.cat([p[:, :m], bonus[:, None]], dim=1))
        adv, last = m + 1, bonus
      else:
        out.append(p)
        adv, last = k, p[:, k - 1]
      n_gen += adv
      cache_t.index = cache_d.index = cursor + adv
    gen = _all_rows(torch.cat(out, dim=1)[:, :num_steps], mesh, b)
    return torch.cat([whole, gen], dim=1)


# -- serving through a pipeline bundle -----------------------------------------

# Per-process caches of the serving predict fn, reached at call time and
# never pickled with it (a live model or engine holds card memory and a
# thread): the model per (config, device), and the continuous-batching
# engine per serving config and weights' content.
_SERVING_MODEL_CACHE: dict = {}
_SERVING_ENGINE_CACHE: dict = {}
# the last params tree fingerprinted, with its print: the identity fast
# path of both caches
_SERVING_PRINT: list = [None, None]

# how long a cached-engine rebuild waits for the old engine to finish its
# accepted requests before stopping it (ServingEngine.drain)
_SERVING_ENGINE_DRAIN_TIMEOUT = 60.0

#: per-process counters of :class:`ServingPredictFn` batches by path and
#: of its engine cache's outcomes (built or rebuilt; reused)
SERVING_STATS = {"rect_calls": 0, "ragged_calls": 0, "engine_builds": 0,
                 "engine_hits": 0}


def reset_serving_stats() -> None:
  for k in SERVING_STATS:
    SERVING_STATS[k] = 0


def _prompt_rows(prompts):
  """Normalize a predict-fn prompt column to (rows, ragged?).

  ``rows`` is a list of 1-D int32 arrays; ``ragged`` is True when rows
  disagree on length — list/tuple columns of per-row sequences and
  object-dtype arrays (``pipeline``'s ragged-column fallback) both land
  here. Rectangular ndarrays return (None, False): the batched
  fixed-shape path handles them without row materialization.
  """
  if isinstance(prompts, np.ndarray) and prompts.dtype != object:
    return None, False
  rows = [np.atleast_1d(np.asarray(r, np.int32).ravel()) for r in prompts]
  lengths = {len(r) for r in rows}
  return rows, len(lengths) > 1


def _params_print(params) -> str:
  """``params_fingerprint`` of ``params``, computed once per tree object."""
  if _SERVING_PRINT[0] is not params:
    from tensorflowonspark_tpu_torch.utils.checkpoint import (
        params_fingerprint)
    _SERVING_PRINT[:] = [params, params_fingerprint(params)]
  return _SERVING_PRINT[1]


class ServingPredictFn(object):
  """The ``predict_fn(params, batch)`` of :func:`make_serving_predict_fn`.

  A module-level class, so a bundle's ``predict.pkl`` pickles it by name
  with the standard ``pickle``: it holds only its settings (and a call
  count). The model and the engine it serves with live in this module's
  caches, reached at call time, so pickling it after a serve still works.
  ``params``: the flat weight dict (``Transformer.serving_params``,
  ``init_params``, ``params_from_flax`` or a bundle's, loaded by
  ``compat.import_model``). ``mesh``: a live mesh every rank of whose
  group calls the predict fn with the same batch (not picklable, as the
  reference's live mesh is not); ``mesh_spec``: a ``MeshSpec`` the
  process serves over through its serving group
  (``parallel.serving_group``), started on the first serve.
  """

  def __init__(self, cfg: "TransformerConfig", num_steps: int,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               eos_id: Optional[int] = None, pad_id: int = 0,
               num_slots: Optional[int] = None, device=None, mesh=None,
               mesh_spec=None):
    self.cfg = cfg
    self.mesh = mesh
    self.mesh_spec = mesh_spec
    self.num_steps = int(num_steps)
    self.temperature = float(temperature)
    self.top_k = int(top_k)
    self.seed = int(seed)
    self.eos_id = None if eos_id is None else int(eos_id)
    self.pad_id = int(pad_id)
    self.num_slots = num_slots
    self.device = device
    self._calls = 0

  def _model(self, params, dev: torch.device) -> Transformer:
    """The serving model of ``params`` on ``dev`` (over ``self.mesh``):
    built once per (config, device, mesh), reloaded in place when the
    weights' content changes, reused as it is for the same tree object or
    content."""
    key = (self.cfg, str(dev), None if self.mesh is None else id(self.mesh))
    hit = _SERVING_MODEL_CACHE.get(key)
    if hit is not None and (hit[0] is params
                            or hit[1] == _params_print(params)):
      hit[0] = params
      return hit[2]
    if hit is not None:
      hit[2].load_params(params)
      model = hit[2]
    else:
      model = Transformer(self.cfg, params, device=dev, mesh=self.mesh)
    _SERVING_MODEL_CACHE[key] = [params, _params_print(params), model]
    return model

  def _engine(self, params, dev: torch.device):
    """The continuous-batching engine for ragged batches: one per serving
    config AND weights' content; a stale or dead engine is drained and
    rebuilt. Admission bounds are off (``max_queue=0``,
    ``max_queued_tokens=0``): the transform feed is already bounded by its
    batch size and has no retry story."""
    from tensorflowonspark_tpu_torch.serving import ServingEngine
    cfg_key = (self.cfg, self.num_steps, self.eos_id, self.pad_id,
               self.num_slots, str(dev))
    for k, (p, eng) in list(_SERVING_ENGINE_CACHE.items()):
      if k[:len(cfg_key)] == cfg_key and p is params and eng.alive:
        SERVING_STATS["engine_hits"] += 1
        return eng
    key = cfg_key + (_params_print(params),)
    cached = _SERVING_ENGINE_CACHE.get(key)
    if cached is not None and cached[1].alive:
      SERVING_STATS["engine_hits"] += 1
      return cached[1]
    # retire every engine under this serving config (the stale version
    # and any dead same-version entry): drain finishes what the old engine
    # accepted (bounded), then stops it
    for k in [k for k in _SERVING_ENGINE_CACHE
              if k == key or k[:len(cfg_key)] == cfg_key]:
      _SERVING_ENGINE_CACHE.pop(k)[1].drain(
          timeout=_SERVING_ENGINE_DRAIN_TIMEOUT)
    SERVING_STATS["engine_builds"] += 1
    eng = ServingEngine(params, self.cfg, num_slots=self.num_slots,
                        eos_id=self.eos_id, pad_id=self.pad_id,
                        max_new_tokens=self.num_steps, max_queue=0,
                        max_queued_tokens=0, device=dev).start()
    _SERVING_ENGINE_CACHE[key] = (params, eng)
    return eng

  def _generator(self, prompts: np.ndarray, dev: torch.device):
    """The sampling generator of one batch: seeded from ``(seed,
    crc32(prompts.tobytes()), call count)`` through a numpy
    ``SeedSequence`` (the reference folds its key with the same three), so
    different batches and repeated serves of one batch draw different
    streams, and a fresh process repeats them."""
    import zlib
    self._calls += 1
    state = np.random.SeedSequence(
        [self.seed, zlib.crc32(prompts.tobytes()), self._calls]
    ).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(state))
    return gen

  def _group(self):
    """This process's serving group for ``mesh_spec`` (None: one
    process serves)."""
    if self.mesh_spec is None:
      return None
    from tensorflowonspark_tpu_torch.parallel import serving_group
    return serving_group.group_for(self.mesh_spec, self.device)

  def _wide(self) -> bool:
    if self.mesh is not None:
      return self.mesh.size > 1
    if self.mesh_spec is None:
      return False
    from tensorflowonspark_tpu_torch.parallel import serving_group
    return math.prod(serving_group.resolve_degrees(
        self.mesh_spec, self.device).values()) > 1

  def __call__(self, params, batch):
    dev = resolve_device(self.device)
    raw = next(iter(batch.values()))
    rows, ragged = _prompt_rows(raw)
    if ragged and self._wide():
      raise NotImplementedError(
          "a ragged serving batch over a mesh decodes through the "
          "continuous-batching engine over the mesh, which is not ported to "
          "PyTorch yet (ROADMAP Queue 1 item 10c, part 3b-ii); serve "
          "equal-length prompts")
    if ragged:
      # mixed-length generation: the continuous-batching engine decodes
      # each row to ITS own length/stop instead of a padded lockstep loop
      if self.temperature > 0:
        raise ValueError(
            "variable-length serving batches decode through the "
            "continuous-batching engine, which is greedy-only — "
            "temperature > 0 needs equal-length prompts")
      SERVING_STATS["ragged_calls"] += 1
      outs = self._engine(params, dev).generate(
          rows, max_new_tokens=self.num_steps)
      width = max(len(o) for o in outs)
      padded = np.full((len(outs), width), self.pad_id, np.int32)
      for i, o in enumerate(outs):
        padded[i, :len(o)] = o
      return {"tokens": padded}
    # an object/list column whose rows happen to share one length is not
    # ragged: stack the already-normalized rows
    prompts = np.stack(rows) if rows is not None else \
        np.asarray(raw, np.int32)
    if prompts.ndim == 1:          # one column of scalar token ids
      prompts = prompts[:, None]
    SERVING_STATS["rect_calls"] += 1
    gen = None
    if self.temperature > 0:
      gen = self._generator(prompts, dev)
    group = self._group()
    if group is not None:
      out = group.generate(params, self.cfg, prompts, self.num_steps,
                           eos_id=self.eos_id, pad_id=self.pad_id,
                           temperature=self.temperature, top_k=self.top_k,
                           seed=None if gen is None else gen.initial_seed())
      return {"tokens": out.astype(np.int32)}
    out = greedy_generate_kv(self._model(params, dev), prompts,
                             self.num_steps, eos_id=self.eos_id,
                             pad_id=self.pad_id,
                             temperature=self.temperature, top_k=self.top_k,
                             generator=gen)
    return {"tokens": out.cpu().numpy().astype(np.int32)}


def make_serving_predict_fn(cfg: TransformerConfig, num_steps: int,
                            temperature: float = 0.0, top_k: int = 0,
                            seed: int = 0, mesh=None, mesh_spec=None,
                            eos_id: Optional[int] = None, pad_id: int = 0,
                            num_slots: Optional[int] = None,
                            device=None) -> ServingPredictFn:
  """Build a ``predict_fn(params, batch)`` for ``pipeline.export_bundle``.

  The port of the reference's ``make_serving_predict_fn``: the batched
  KV-cache serving loop as a pipeline bundle. ``TFModel.transform``
  batches rows with ``yield_batch``; ``batch`` maps an input tensor name
  to a stacked prompt array ``[B, prompt_len]``; each batch decodes
  through :func:`greedy_generate_kv` (one prefill, then one token a
  step). Returns ``{"tokens": int32 [B, prompt_len + num_steps]}``, the
  reference's dtype, so signatures and CLI JSON match.

  With ``temperature > 0`` each batch samples (``top_k`` filtered) from a
  ``torch.Generator`` seeded from ``(seed, crc32 of the prompts, the
  call count)`` through a numpy ``SeedSequence``
  (:meth:`ServingPredictFn._generator`). ``eos_id`` stops a row on the
  rectangular path too.

  VARIABLE-LENGTH batches (an object column whose rows differ in length,
  ``TFModel.transform``'s ragged fallback) decode through a per-process
  continuous-batching ``ServingEngine`` (``num_slots`` slots, default
  ``TOS_SERVE_SLOTS``), cached per config and ``params_fingerprint``;
  outputs are right-padded with ``pad_id``. The engine is greedy-only, so
  a ragged batch with ``temperature > 0`` raises.

  ``mesh`` makes each serve decode over its axes (:func:`greedy_generate_kv`
  over a mesh: every rank of the mesh's group calls the predict fn with
  the same batch). A live mesh holds process groups and cannot ride a
  pickled bundle: for ``pipeline.export_bundle`` / ``TFModel.transform``
  pass ``mesh_spec`` (a picklable ``parallel.mesh.MeshSpec``) instead.
  Each executor then serves over its own serving group
  (``parallel.serving_group``): on its first serve it spawns the other
  ranks of ``mesh_spec`` (a ``-1`` absorbs its visible cards), sends
  them the whole weights once per fingerprint, and every rectangular
  batch decodes on all of them; the group stops when the executor exits.
  A spec that resolves to one process serves as without one.

  What differs from the reference: the predict fn is an instance of the
  module-level :class:`ServingPredictFn`, not a closure, since the port
  pickles with the standard ``pickle``; ``device=None`` is the card
  (raises without one; the tests pass ``"cpu"``); a ragged batch over a
  mesh raises (the engine over a mesh is ROADMAP Queue 1 item 10c, part
  3b-ii).
  """
  if mesh is not None and mesh_spec is not None:
    raise ValueError("pass mesh OR mesh_spec, not both")
  return ServingPredictFn(cfg, num_steps, temperature=temperature,
                          top_k=top_k, seed=seed, eos_id=eos_id,
                          pad_id=pad_id, num_slots=num_slots, device=device,
                          mesh=mesh, mesh_spec=mesh_spec)


def _mesh_loss(mesh) -> bool:
  """Whether a loss over ``mesh`` needs the mesh: its positions cut over
  ``sequence`` or its logits' vocabulary over ``tensor``. A mesh cut only
  over the data axes takes the one-card loss, a mean over equal local
  batches."""
  return mesh is not None and bool(mesh.wide(
      (mesh_lib.AXIS_SEQUENCE, mesh_lib.AXIS_TENSOR)))


def _lm_targets(tokens: torch.Tensor, mesh):
  """``(targets, n, scale)`` of this rank's block of a batch: the next
  token of each of its first ``n`` positions (a block cut over
  ``sequence`` takes its last one's from the next block through one
  ``ring_permute``; the last block has no label for its last position),
  and the factor that makes the block's sum of per-token losses its share
  of the global batch's mean: the batch-axes degree over the global
  count of labelled positions."""
  b, s = tokens.shape
  seq = mesh_lib.axis_size(mesh, mesh_lib.AXIS_SEQUENCE)
  targets = tokens[:, 1:]
  n = s - 1
  if seq > 1:
    first = collectives.ring_permute(tokens[:, :1].contiguous(), mesh,
                                     mesh_lib.AXIS_SEQUENCE, -1)
    targets = torch.cat([targets, first], dim=1)
    if mesh.coord(mesh_lib.AXIS_SEQUENCE) < seq - 1:
      n = s
  rows = b * mesh_lib.axis_size(mesh, *mesh_lib.data_axes(mesh))
  count = rows * (s * seq - 1)
  n_b = mesh_lib.axis_size(mesh, *sharding_lib.BATCH_AXES)
  return targets[:, :n].long(), n, n_b / count


def _lm_terms(logits: torch.Tensor, targets: torch.Tensor, mesh):
  """``(lse, label logit)`` per position of f32 ``logits`` whose last
  dimension is this rank's vocabulary columns when the tensor axis is
  above 1: the maximum and the sum of exponentials all-reduced over the
  axis (the label's logit from the rank that holds it), Megatron's
  vocab-parallel cross-entropy; whole logits otherwise."""
  t = mesh_lib.axis_size(mesh, mesh_lib.AXIS_TENSOR)
  if t == 1:
    return (torch.logsumexp(logits, dim=-1),
            logits.gather(-1, targets[..., None])[..., 0])
  per = logits.shape[-1]
  m = collectives.reduce_from(logits.detach().amax(dim=-1), mesh,
                              mesh_lib.AXIS_TENSOR, op="max")
  total = collectives.reduce_from(torch.exp(logits - m[..., None]).sum(-1),
                                  mesh, mesh_lib.AXIS_TENSOR)
  local = targets - mesh.coord(mesh_lib.AXIS_TENSOR) * per
  inside = (local >= 0) & (local < per)
  ll = logits.gather(-1, local.clamp(0, per - 1)[..., None])[..., 0]
  ll = collectives.reduce_from(ll * inside.to(ll.dtype), mesh,
                               mesh_lib.AXIS_TENSOR)
  return m + torch.log(total), ll


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   z_loss: float = 0.0, mesh=None) -> torch.Tensor:
  """Next-token cross-entropy (shifted); ignores the final position.

  ``z_loss`` > 0 adds ``z_loss * mean(logsumexp^2)`` (the PaLM/T5X
  stabiliser), as the JAX package's ``causal_lm_loss`` does. Over a
  ``mesh`` cut on ``sequence`` or ``tensor``, ``logits`` and ``tokens``
  are this rank's blocks (its positions; its vocabulary columns) and the
  result is its share of the global batch's loss, which the train step
  averages over the batch axes (:func:`_lm_targets`, :func:`_lm_terms`).
  """
  if not _mesh_loss(mesh):
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1].float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1))
    if z_loss:
      lse = torch.logsumexp(logits, dim=-1)
      ce = ce + z_loss * (lse ** 2).mean()
    return ce
  targets, n, scale = _lm_targets(tokens, mesh)
  lse, ll = _lm_terms(logits[:, :n].float(), targets, mesh)
  loss = (lse - ll).sum() * scale
  if z_loss:
    loss = loss + z_loss * (lse ** 2).sum() * scale
  return loss


def tied_embedding_table(model: Transformer) -> torch.Tensor:
  """The tied input/output embedding [vocab, d_model] of ``model``; over
  a mesh, the rank's vocabulary rows with whole columns (gathered over
  ``fsdp``)."""
  embed = model.embed
  if any(a == mesh_lib.AXIS_FSDP
         for a in model.plan.specs["embed.embedding"]):
    return model.plan.full(embed.embedding, "embed.embedding",
                           embed.embedding.dtype)
  return embed.embedding


def _chunk_terms(x: torch.Tensor, table: torch.Tensor, targets: torch.Tensor):
  """(sum of lse - label logit, sum of lse^2) over one chunk; its logits
  are computed in f32, as the reference's ``preferred_element_type``
  keeps them."""
  logits = x.float() @ table.float().t()                  # [B, C, V]
  lse = torch.logsumexp(logits, dim=-1)
  ll = logits.gather(-1, targets[..., None])[..., 0]
  return (lse - ll).sum(), (lse ** 2).sum()


def _chunk_terms_mesh(x, table, targets, mesh):
  lse, ll = _lm_terms(x.float() @ table.float().t(), targets, mesh)
  return (lse - ll).sum(), (lse ** 2).sum()


def causal_lm_loss_blocked(hidden: torch.Tensor, table: torch.Tensor,
                           tokens: torch.Tensor, chunk: int = 256,
                           z_loss: float = 0.0, mesh=None) -> torch.Tensor:
  """Next-token cross-entropy fused with the tied output projection.

  The ``[batch, seq, vocab]`` logits are never held: sequence chunks of
  ``chunk`` positions are projected against ``table`` (cast to the
  hidden dtype), reduced to (logsumexp, label logit) and dropped; each
  chunk runs under ``torch.utils.checkpoint``, so the backward recomputes
  its logits as ``jax.checkpoint`` makes the reference do. ``hidden``:
  ``model(tokens, return_hidden=True)``; ``table``:
  :func:`tied_embedding_table`. Matches :func:`causal_lm_loss` on the
  same inputs, ``z_loss`` included, to float tolerance; over a ``mesh``
  cut on ``sequence`` or ``tensor``, as :func:`causal_lm_loss` does over
  one (``table`` is the rank's vocabulary rows).
  """
  if _mesh_loss(mesh):
    targets, n, scale = _lm_targets(tokens, mesh)
    x = hidden[:, :n]
    if mesh_lib.axis_size(mesh, mesh_lib.AXIS_TENSOR) > 1:
      x = collectives.copy_to(x, mesh, mesh_lib.AXIS_TENSOR)
    tbl = table.to(x.dtype)
    total = z_total = None
    for start in range(0, n, chunk):
      t, z = checkpoint(_chunk_terms_mesh, x[:, start:start + chunk], tbl,
                        targets[:, start:start + chunk], mesh,
                        use_reentrant=False)
      total = t if total is None else total + t
      z_total = z if z_total is None else z_total + z
    loss = total * scale
    if z_loss:
      loss = loss + z_loss * z_total * scale
    return loss
  targets = tokens[:, 1:].long()
  x = hidden[:, :-1]
  b, s, _ = x.shape
  tbl = table.to(x.dtype)
  total = z_total = None
  for start in range(0, s, chunk):
    t, z = checkpoint(_chunk_terms, x[:, start:start + chunk], tbl,
                      targets[:, start:start + chunk], use_reentrant=False)
    total = t if total is None else total + t
    z_total = z if z_total is None else z_total + z
  loss = total / (b * s)
  if z_loss:
    loss = loss + z_loss * z_total / (b * s)
  return loss


def create_state(cfg: TransformerConfig, params: Union[int, Mapping[str, Any]],
                 tx=None, device=None, learning_rate: float = 3e-4):
  """A single-card :class:`~tensorflowonspark_tpu_torch.train_state.TrainState`:
  a ``trainable`` :class:`Transformer` (f32 master weights) and the
  optimizer state of ``tx``.

  ``params``: a seed (weights from
  :func:`~tensorflowonspark_tpu_torch.utils.params.init_params`) or a
  flat weight dict. ``tx``: an :mod:`~tensorflowonspark_tpu_torch.optim`
  transformation; by default the reference's ``optax.adamw(learning_rate,
  weight_decay=0.01)`` — b2 0.999 and no decay mask, which is not
  ``make_optimizer``'s recipe. ``device``: ``None`` is the card.
  """
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.train_state import TrainState
  from tensorflowonspark_tpu_torch.utils.params import init_params
  if isinstance(params, (int, np.integer)):
    params = init_params(cfg, seed=int(params))
  model = Transformer(cfg, params, device=device, trainable=True)
  if tx is None:
    tx = optim.adamw(learning_rate, weight_decay=0.01)
  return TrainState.create(model, tx)


def create_sharded_state(cfg: TransformerConfig,
                         params: Union[int, Mapping[str, Any]], mesh,
                         tx=None, device=None,
                         learning_rate: float = 3e-4):
  """:func:`create_state` laid out over ``mesh``
  (:func:`~tensorflowonspark_tpu_torch.parallel.mesh.build_mesh`):
  ``(state, sharding)``, as the reference's ``create_sharded_state``
  returns them. Each rank's model holds its blocks of the weights
  (:func:`param_logical` through ``LOGICAL_RULES``), its optimizer state
  mirrors them, and ``state.sharding`` is the
  :class:`~tensorflowonspark_tpu_torch.parallel.sharding.StateSharding`.
  Every block is taken from the rank at coordinate 0 of the axes it is
  whole on (a broadcast) and the optimizer state is made from the blocks,
  so ranks given other seeds or weights agree wherever they must; on a
  mesh cut only over ``data`` that is rank 0's whole state on every
  rank. The MoE layers' experts are cut over ``expert``.
  ``parallel.sharding.gather_state_params`` gives the whole weights back.
  """
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.train_state import TrainState
  from tensorflowonspark_tpu_torch.utils.params import init_params
  if isinstance(params, (int, np.integer)):
    params = init_params(cfg, seed=int(params))
  template = _Plan(cfg, mesh)
  logical = param_logical(cfg, mesh)

  def params_init():
    whole = dict(params)
    if cfg.fuse_qkv and template.kv:
      order = template.qkv_order()
      whole = {n: np.asarray(p)[:, order] if param_kind(n) == "attn.qkv"
               else p for n, p in whole.items()}
    return whole, {n: logical[param_kind(n)] for n in whole}

  def make_state(blocks, sharding):
    del sharding
    model = Transformer(cfg, blocks, device=device, trainable=True,
                        mesh=mesh, blocks=True)
    return TrainState.create(model, tx if tx is not None else optim.adamw(
        learning_rate, weight_decay=0.01))

  return sharding_lib.init_sharded_state(params_init, make_state, mesh)


# -- pipeline-parallel training (1F1B over the block stack) ------------------


def _layer_count(params: Mapping[str, Any]) -> int:
  return len({n.split(".")[1] for n in params if n.startswith("layers.")})


def pipeline_partition_params(params: Mapping[str, Any], n_stages: int):
  """Split a flat weight dict (tensors or numpy arrays, the port's names)
  for the 1F1B pipeline: ``(outer, stage)``. ``outer`` holds every weight
  outside the blocks (the embedding table, the final norm: first- and
  last-stage work); ``stage`` maps each block weight's name within its
  layer (``attn.q``, ``ln1.scale``, ...) to the layers stacked as ``[n_stages,
  layers_per_stage, ...]``, stage ``s`` owning layers ``[s*k, (s+1)*k)``."""
  num_layers = _layer_count(params)
  assert num_layers % n_stages == 0, \
      "%d layers do not split into %d stages" % (num_layers, n_stages)
  k = num_layers // n_stages
  subs = [n[len("layers.0."):] for n in params if n.startswith("layers.0.")]
  stage = {}
  for sub in subs:
    layers = [params["layers.%d.%s" % (i, sub)] for i in range(num_layers)]
    stacked = torch.stack(layers) if torch.is_tensor(layers[0]) \
        else np.stack(layers)
    stage[sub] = stacked.reshape((n_stages, k) + tuple(layers[0].shape))
  outer = {n: v for n, v in params.items() if not n.startswith("layers.")}
  return outer, stage


def pipeline_unpartition_grads(g_outer: Mapping[str, Any],
                               g_stage: Mapping[str, Any],
                               num_layers: int) -> dict:
  """The flat weight layout (the port's names) from pipeline gradients:
  the inverse of :func:`pipeline_partition_params`."""
  tree = dict(g_outer)
  for sub, g in g_stage.items():
    flat = g.reshape((num_layers,) + tuple(g.shape[2:]))
    for i in range(num_layers):
      tree["layers.%d.%s" % (i, sub)] = flat[i]
  return tree


class _Head(nn.Module):
  """The last stage's work: the final norm and the tied projection, the
  model's own modules (``ln_f``, ``TiedEmbed.attend``)."""

  def __init__(self, cfg: TransformerConfig, device, plan: _Plan):
    super().__init__()
    self.embed = TiedEmbed(cfg, device, True, plan)
    self.ln_f = LayerNorm(cfg, device, True)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.embed.attend(self.ln_f(x)).float()


def _gather_stages(g_stage: Mapping[str, torch.Tensor], mesh) -> dict:
  """Every stage's gradients, ``[n_stages, k, ...]`` each, from this
  rank's ``[1, k, ...]``: one all-gather over ``pipeline`` of them all
  flattened together."""
  names = list(g_stage)
  flat = torch.cat([g_stage[n].reshape(-1) for n in names])
  whole = collectives.all_gather(flat, mesh, mesh_lib.AXIS_PIPELINE,
                                 tiled=False)
  out, at = {}, 0
  for n in names:
    size = g_stage[n].numel()
    out[n] = whole[:, at:at + size].reshape((whole.shape[0],)
                                            + tuple(g_stage[n].shape[1:]))
    at += size
  return out


def make_pipeline_train_step(cfg: TransformerConfig, mesh,
                             num_microbatches: int):
  """``step(params, tokens) -> (loss, grads)``: the Transformer's loss
  and every gradient by the 1F1B schedule over the mesh's ``pipeline``
  axis (``parallel.pipeline_parallel``), the reference's
  ``make_pipeline_train_step``.

  ``params``: the flat weights (``state.params``: f32 master weights,
  whole on every rank); ``tokens``: the global ``[batch, seq]``, every
  rank the same. Stage ``s`` runs layers ``[s*k, (s+1)*k)`` with the
  model's own modules (``Block``, ``TiedEmbed``, ``LayerNorm``) and no
  mesh inside them; stage 0 embeds, the last stage runs ``ln_f``, the
  tied projection and ``causal_lm_loss``. ``cfg.remat`` recomputes each
  block in its backward, as the one-card forward does. The returned
  grads are keyed as ``params``: the stage grads gathered over
  ``pipeline``, the tied table's two contributions summed, all averaged
  over the data axes. ``step.partitioned(outer, stage, tokens) -> (loss,
  g_outer, g_stage)`` takes :func:`pipeline_partition_params`' layout
  and returns this rank's stage block of the gradients."""
  from torch.func import functional_call
  from tensorflowonspark_tpu_torch.parallel import pipeline_parallel as pp
  assert cfg.moe_experts == 0, "pipeline stages must be homogeneous"
  n_stages = mesh.shape[mesh_lib.AXIS_PIPELINE]
  plan = _Plan(cfg, None)
  meta = torch.device("meta")
  block = Block(cfg, meta, True, plan)
  head = _Head(cfg, meta, plan)
  remat_kw = {"context_fn": _dots_contexts} \
      if cfg.remat_policy == "dots" else {}

  def run_block(p, x, rope):
    return functional_call(block, p, (x, rope))

  def embed_fn(outer, tokens):
    return functional_call(head.embed, {"embedding": outer["embed.embedding"]},
                           (tokens,)).to(cfg.dtype)

  def stage_fn(stage_p, x):
    b, s = x.shape[:2]
    rope = _rope_tables(torch.arange(s, device=x.device).expand(b, s),
                        cfg.head_dim)
    remat = cfg.remat and torch.is_grad_enabled()
    for j in range(next(iter(stage_p.values())).shape[0]):
      p = {n: v[j] for n, v in stage_p.items()}
      if remat:
        x = checkpoint(run_block, p, x, rope, use_reentrant=False,
                       **remat_kw)
      else:
        x = run_block(p, x, rope)
    return x

  def head_loss_fn(outer, x, tokens):
    logits = functional_call(head, {"embed.embedding": outer[
        "embed.embedding"], "ln_f.scale": outer["ln_f.scale"]}, (x,))
    return causal_lm_loss(logits, tokens)

  def _tokens(tokens, like):
    return torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens)
                           else tokens).to(like.device)

  def partitioned_step(outer, stage, tokens):
    """(outer_params, stage_params, tokens) -> (loss, g_outer, g_stage),
    g_stage this rank's block of the stacked layout."""
    tokens = _tokens(tokens, outer["embed.embedding"])
    return pp.pipeline_lm_train_step(embed_fn, stage_fn, head_loss_fn, outer,
                                     stage, tokens, tokens, mesh,
                                     num_microbatches)

  def step(params, tokens):
    # only this rank's layers are stacked: the others' stay untouched
    num_layers = _layer_count(params)
    assert num_layers % n_stages == 0, \
        "%d layers do not split into %d stages" % (num_layers, n_stages)
    k = num_layers // n_stages
    first = mesh.coord(mesh_lib.AXIS_PIPELINE) * k
    subs = [n[len("layers.0."):] for n in params if n.startswith("layers.0.")]
    with torch.no_grad():
      own = {sub: torch.stack([params["layers.%d.%s" % (first + j, sub)]
                               for j in range(k)]) for sub in subs}
    outer = {n: v for n, v in params.items() if not n.startswith("layers.")}
    tokens = _tokens(tokens, outer["embed.embedding"])
    loss, g_outer, g_stage = pp.lm_stage_step(
        embed_fn, stage_fn, head_loss_fn, outer, own, tokens, tokens, mesh,
        num_microbatches)
    grads = pipeline_unpartition_grads(
        g_outer, _gather_stages(g_stage, mesh), num_layers)
    return loss, {n: grads[n] for n in params}

  step.partitioned = partitioned_step
  return step


__all__ = ["TransformerConfig", "KVCache", "zero_cache", "Transformer",
           "TiedEmbed", "Attention", "MLPBlock", "Block", "LayerNorm",
           "greedy_generate_kv", "speculative_generate_kv",
           "ServingPredictFn", "make_serving_predict_fn", "SERVING_STATS",
           "reset_serving_stats",
           "causal_lm_loss", "causal_lm_loss_blocked", "tied_embedding_table",
           "create_state", "create_sharded_state", "param_logical",
           "param_kind", "MoEBlock", "pipeline_partition_params",
           "pipeline_unpartition_grads", "make_pipeline_train_step"]
