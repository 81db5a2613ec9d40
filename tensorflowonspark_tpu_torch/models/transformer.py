"""Decoder-only Transformer on PyTorch: the port of the flagship model.

Counterpart of ``tensorflowonspark_tpu/models/transformer.py`` for the
serving and training paths: the config (same fields, same validation),
rotary positions, the tied embedding, pre-LN blocks, the non-decode
forward (with ``remat`` and ``return_hidden``), the KV-cache decode
(``Attention._decode_attend``) with a scalar cursor (rows in lockstep) or
a vector of per-row cursors (the serving slab), the losses
(:func:`causal_lm_loss`, :func:`causal_lm_loss_blocked`) and
:func:`create_state`.

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
  both, because the kernel takes them so.
* ``cfg.remat`` wraps each block of a differentiated forward in
  ``torch.utils.checkpoint`` (non-reentrant), as ``nn.remat(Block)`` does.
* the decode cache is a :class:`KVCache` updated IN PLACE (the flax cache
  is a returned pytree); one cursor serves every layer.
* the hot ops go through ``tensorflowonspark_tpu_torch.ops``: on the card
  the hand-written LayerNorm and flash-attention kernels (forward and
  backward) and, with ``ln_matmul_impl`` / ``act_matmul_impl`` "fused",
  the LN->matmul and GELU->matmul kernels; on the CPU their plain
  versions. There is no ``jit``; PyTorch runs eagerly.

Options outside this slice raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""

from dataclasses import dataclass
from typing import Any, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.utils.device import resolve_device

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
        (self.kv_cache_dtype == "int8", "kv_cache_dtype='int8'",
         "Queue 1 item 9, int8 KV serving"),
        (self.kv_page_size > 0, "kv_page_size > 0",
         "Queue 1 item 9, paged KV serving"),
        (self.moe_experts > 0, "moe_experts > 0",
         "Queue 1 item 10, multi-GPU parallelism"),
        (self.use_ring_attention, "use_ring_attention",
         "Queue 1 item 10, multi-GPU parallelism"),
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
  """
  k: List[torch.Tensor]
  v: List[torch.Tensor]
  index: Union[int, torch.Tensor] = 0


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


def _param(shape, cfg: TransformerConfig, device, trainable: bool,
           dtype: Optional[torch.dtype] = None) -> nn.Parameter:
  """A weight in ``dtype`` if given, else f32 master (``trainable``) or
  ``cfg.dtype`` (serving)."""
  if dtype is None:
    dtype = torch.float32 if trainable else cfg.dtype
  return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                      requires_grad=trainable)


def _dense(x: torch.Tensor, w: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
  """flax ``DenseGeneral(dtype=dtype)`` over the last axis: x [..., D] @
  w [D, *feats], both cast to ``dtype``."""
  out = x.to(dtype) @ w.to(dtype).reshape(w.shape[0], -1)
  return out.reshape(x.shape[:-1] + w.shape[1:])


class LayerNorm(nn.Module):
  """Bias-free LayerNorm, eps 1e-6, f32 scale; output in the input dtype
  (``ops.layer_norm``: the kernel on the card)."""

  def __init__(self, cfg: TransformerConfig, device, trainable: bool):
    super().__init__()
    self.scale = _param((cfg.d_model,), cfg, device, trainable,
                        torch.float32)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return ops.layer_norm(x, self.scale)


class TiedEmbed(nn.Module):
  """Tied input/output embedding (``embed.embedding`` [V, D]), used in
  ``cfg.dtype``."""

  def __init__(self, cfg: TransformerConfig, device, trainable: bool):
    super().__init__()
    self.dtype = cfg.dtype
    self.embedding = _param((cfg.vocab_size, cfg.d_model), cfg, device,
                            trainable)

  def forward(self, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, self.embedding.to(self.dtype))

  def attend(self, x: torch.Tensor) -> torch.Tensor:
    return x.to(self.dtype) @ self.embedding.to(self.dtype).t()


class Attention(nn.Module):

  def __init__(self, cfg: TransformerConfig, device, trainable: bool):
    super().__init__()
    self.cfg = cfg
    h, hk, d, dm = cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    if cfg.fuse_qkv:
      self.qkv = _param((dm, h + 2 * hk, d), cfg, device, trainable)
    else:
      self.q = _param((dm, h, d), cfg, device, trainable)
      self.k = _param((dm, hk, d), cfg, device, trainable)
      self.v = _param((dm, hk, d), cfg, device, trainable)
    self.out = _param((h, d, dm), cfg, device, trainable)

  def _project(self, x, ln_scale=None):
    cfg = self.cfg
    if cfg.fuse_qkv:
      h, hk = cfg.num_heads, cfg.kv_heads
      if ln_scale is not None:
        w = self.qkv.to(cfg.dtype).reshape(cfg.d_model, -1)
        qkv = ops.ln_matmul(x, ln_scale, w).reshape(
            x.shape[:-1] + (h + 2 * hk, cfg.head_dim))
      else:
        qkv = _dense(x, self.qkv, cfg.dtype)
      return qkv[..., :h, :], qkv[..., h:h + hk, :], qkv[..., h + hk:, :]
    if ln_scale is not None:
      raise ValueError("ln-fused attention requires fuse_qkv")
    return (_dense(x, self.q, cfg.dtype), _dense(x, self.k, cfg.dtype),
            _dense(x, self.v, cfg.dtype))

  def _out_proj(self, o: torch.Tensor) -> torch.Tensor:
    b, s = o.shape[:2]
    dt = self.cfg.dtype
    w = self.out.to(dt)
    return o.to(dt).reshape(b, s, -1) @ w.reshape(-1, w.shape[-1])

  def forward(self, x, rope, cache: Optional[KVCache] = None,
              layer: int = 0, ln_scale: Optional[torch.Tensor] = None):
    """``x`` arrives normalized; ``rope`` holds the (cos, sin) tables of
    its positions. With ``cache`` this is the decode path. With
    ``ln_scale`` (requires ``fuse_qkv``), ``x`` is the RAW residual
    stream and ln1 + the QKV projection run as one kernel
    (``ops.ln_matmul``)."""
    q, k, v = self._project(x, ln_scale)
    q = _apply_rotary(q, rope)
    k = _apply_rotary(k, rope)
    if cache is not None:
      return self._out_proj(self._decode_attend(q, k, v, cache, layer))
    # the kernel takes any length: the block rule only decides whether
    # "flash" refuses this one
    _flash_eligible(self.cfg, q.shape[1])
    out = ops.flash_attention(q, k, v, causal=True,
                              window=self.cfg.attention_window or None)
    return self._out_proj(out)

  def _decode_attend(self, q, k, v, cache: KVCache, layer: int):
    """Incremental attention against the KV cache (q, k already rotated
    to their cursor positions): write the new keys and values at the
    cursor, attend everything cached so far. The cursor itself advances
    once per forward, in :meth:`Transformer.forward`."""
    cfg = self.cfg
    b, seg = q.shape[:2]
    idx = cache.index
    vec = torch.is_tensor(idx)
    ck, cv = cache.k[layer], cache.v[layer]
    if vec:
      if seg != 1:
        raise NotImplementedError(
            "multi-token writes at per-row cursors come with speculative "
            "decoding (ROADMAP Queue 1 item 9)")
      # one token per row at its own cursor; a cursor is < max_seq_len by
      # the engine's submit-time budget check, frozen lanes included
      rows = torch.arange(b, device=q.device)
      ck[rows, idx] = k[:, 0].to(ck.dtype)
      cv[rows, idx] = v[:, 0].to(cv.dtype)
    else:
      if idx + seg > cfg.max_seq_len:
        raise ValueError("decode write of %d tokens at position %d overruns "
                         "the max_seq_len=%d cache"
                         % (seg, idx, cfg.max_seq_len))
      ck[:, idx:idx + seg] = k.to(ck.dtype)
      cv[:, idx:idx + seg] = v.to(cv.dtype)

    # PREFILL fast path: a fresh-cache multi-token segment attends only
    # within itself, so the flash op runs it over the grouped K/V directly
    # instead of the seg x max_seq_len dense scores. The cursor is a host
    # int here, so the branch costs no device sync.
    if not vec and idx == 0 and seg > 1 and _flash_eligible(cfg, seg):
      out = ops.flash_attention(q, k, v, causal=True,
                                window=cfg.attention_window or None)
      return out.to(q.dtype)
    return self._dense_attend(q, ck, cv, idx, vec)

  def _dense_attend(self, q, ck, cv, idx, vec):
    """q regrouped [b, seg, kv_head, group, d] against the whole cache
    with the causal + unwritten (+ window) mask, in f32."""
    cfg = self.cfg
    b, seg, h, d = q.shape
    hk = cfg.kv_heads
    kf, vf = ck.float(), cv.float()
    qg = q.reshape(b, seg, hk, h // hk, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * (1.0 / d ** 0.5)
    ar = torch.arange(seg, device=q.device)
    k_pos = torch.arange(cfg.max_seq_len, device=q.device)
    if vec:
      q_pos = idx[:, None, None] + ar[None, :, None]     # [b, seg, 1]
      keep = k_pos[None, None, :] <= q_pos                # [b, seg, max]
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
    o = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf)
    return o.reshape(b, seg, h, d).to(q.dtype)


class MLPBlock(nn.Module):

  def __init__(self, cfg: TransformerConfig, device, trainable: bool):
    super().__init__()
    self.dtype = cfg.dtype
    self.up = _param((cfg.d_model, cfg.d_ff), cfg, device, trainable)
    self.down = _param((cfg.d_ff, cfg.d_model), cfg, device, trainable)

  def forward(self, x, ln_scale: Optional[torch.Tensor] = None,
              act_fused: bool = False):
    """With ``ln_scale`` (the preceding LayerNorm's weight), ``x`` is the
    RAW residual stream and the norm + up-projection run as one kernel
    (``ops.ln_matmul``); without it ``x`` arrives normalized. With
    ``act_fused``, GELU + the down-projection run as one kernel over the
    pre-activation (``ops.gelu_matmul``)."""
    if ln_scale is not None:
      h = ops.ln_matmul(x, ln_scale, self.up.to(self.dtype))
    else:
      h = _dense(x, self.up, self.dtype)
    if act_fused:
      return ops.gelu_matmul(h, self.down.to(self.dtype))
    return _dense(F.gelu(h, approximate="tanh"), self.down, self.dtype)


class Block(nn.Module):
  """Pre-LN block: x + attn(ln1(x)), then + mlp(ln2(x)).

  Off the decode path (no cache), ``ln_matmul_impl="fused"`` runs ln2 +
  the up-projection as one kernel, and ln1 + the QKV projection too when
  ``fuse_qkv``; ``act_matmul_impl="fused"`` runs GELU + the
  down-projection as one. The LayerNorm modules keep their ``scale``
  either way (the parameter names do not change); only their forward is
  skipped. The decode path never fuses, as in the reference."""

  def __init__(self, cfg: TransformerConfig, device, trainable: bool):
    super().__init__()
    self.cfg = cfg
    self.ln1 = LayerNorm(cfg, device, trainable)
    self.attn = Attention(cfg, device, trainable)
    self.ln2 = LayerNorm(cfg, device, trainable)
    self.mlp = MLPBlock(cfg, device, trainable)

  def forward(self, x, rope, cache=None, layer=0):
    cfg = self.cfg
    fuse_ln = cfg.ln_matmul_impl == "fused" and cache is None
    if fuse_ln and cfg.fuse_qkv:
      x = x + self.attn(x, rope, ln_scale=self.ln1.scale)
    else:
      x = x + self.attn(self.ln1(x), rope, cache, layer)
    act_fused = cfg.act_matmul_impl == "fused" and cache is None
    if fuse_ln:
      return x + self.mlp(x, ln_scale=self.ln2.scale, act_fused=act_fused)
    return x + self.mlp(self.ln2(x), act_fused=act_fused)


class Transformer(nn.Module):
  """Causal LM: int token ids [batch, seq] -> f32 logits [batch, seq, V].

  ``params``: the flat float32 weight dict of
  :func:`~tensorflowonspark_tpu_torch.utils.params.init_params` or
  :func:`~tensorflowonspark_tpu_torch.utils.params.params_from_flax`.
  ``device``: ``None`` is the card (raises when there is none); the tests
  pass ``"cpu"``. ``trainable``: keep f32 master weights that require
  gradients (training) instead of ``cfg.dtype`` weights (serving); see
  the module docstring.
  """

  def __init__(self, cfg: TransformerConfig,
               params: Mapping[str, np.ndarray], device=None,
               trainable: bool = False):
    super().__init__()
    self.cfg = cfg
    self.device = resolve_device(device)
    self.trainable = trainable
    self.embed = TiedEmbed(cfg, self.device, trainable)
    self.layers = nn.ModuleList(
        [Block(cfg, self.device, trainable) for _ in range(cfg.num_layers)])
    self.ln_f = LayerNorm(cfg, self.device, trainable)
    self.load_params(params)

  @torch.no_grad()
  def load_params(self, params: Mapping[str, np.ndarray]) -> None:
    """Copy a flat weight dict in (cast to each parameter's dtype)."""
    own = dict(self.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
      raise KeyError("weights do not match the model: missing %s, "
                     "unexpected %s" % (missing[:4], extra[:4]))
    for name, p in own.items():
      arr = np.asarray(params[name])
      if arr.shape != tuple(p.shape):
        raise ValueError("%s: shape %s, model expects %s"
                         % (name, arr.shape, tuple(p.shape)))
      p.copy_(torch.tensor(arr, dtype=p.dtype))

  def init_cache(self, batch: int) -> KVCache:
    """A fresh zeroed cache for ``batch`` rows with the scalar cursor 0.
    (Zeros matter: unwritten entries are masked, but 0 * garbage could be
    NaN in the probs @ v product.)"""
    cfg = self.cfg
    shape = (batch, cfg.max_seq_len, cfg.kv_heads, cfg.head_dim)
    mk = lambda: torch.zeros(shape, dtype=cfg.dtype,  # noqa: E731
                             device=self.device)
    return KVCache([mk() for _ in range(cfg.num_layers)],
                   [mk() for _ in range(cfg.num_layers)], 0)

  def numpy_params(self) -> dict:
    """The weights as the flat f32 numpy dict ``load_params`` takes (see
    :func:`~tensorflowonspark_tpu_torch.utils.params.params_to_flax` for
    the flax tree)."""
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
    cache recomputes each block in the backward when ``cfg.remat``."""
    cfg = self.cfg
    if exit_layer is not None:
      raise NotImplementedError(
          "exit_layer (the shallow-exit draft of self-speculative decoding) "
          "is not ported to PyTorch yet (ROADMAP Queue 1 item 9)")
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    if remat and cfg.remat_policy == "dots":
      raise NotImplementedError(
          "remat_policy='dots' is not ported to PyTorch yet (ROADMAP Queue "
          "1 item 12); use remat_policy='none'")
    tokens = tokens.to(self.device)
    b, s = tokens.shape
    ar = torch.arange(s, device=self.device)
    if cache is None:
      positions = ar.expand(b, s)
    elif torch.is_tensor(cache.index):
      positions = cache.index[:, None] + ar[None, :]
    else:
      positions = (cache.index + ar).expand(b, s)
    rope = _rope_tables(positions, self.cfg.head_dim)
    x = self.embed(tokens)
    for i, block in enumerate(self.layers):
      if remat:
        x = checkpoint(block, x, rope, use_reentrant=False)
      else:
        x = block(x, rope, cache, i)
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


def greedy_generate_kv(model: Transformer, prompt, num_steps: int,
                       eos_id: Optional[int] = None, pad_id: int = 0,
                       temperature: float = 0.0) -> torch.Tensor:
  """Greedy decoding with a per-layer KV cache (the serving path).

  prompt: ``[batch, prompt_len]`` ints. Returns ``[batch, prompt_len +
  num_steps]`` int64 on the model's device. With ``eos_id``, a row that
  emits it keeps the EOS and every later position is ``pad_id``. The
  whole prompt is one fresh-cache prefill (flash where its length
  divides into kernel blocks), then one token per step.
  """
  cfg = model.cfg
  if temperature < 0:
    raise ValueError("temperature must be >= 0, got %r" % temperature)
  if temperature > 0:
    raise NotImplementedError("sampling (temperature > 0) is not ported to "
                              "PyTorch yet (ROADMAP Queue 1 item 9)")
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
  with torch.inference_mode():
    cache = model.init_cache(b)
    nxt = model(prompt, cache)[:, -1].argmax(dim=-1)
    done = nxt == eos_id if eos_id is not None \
        else torch.zeros_like(nxt, dtype=torch.bool)
    out, tok = [nxt], nxt
    for _ in range(num_steps - 1):
      new = model(tok[:, None], cache)[:, -1].argmax(dim=-1)
      if eos_id is not None:
        new = torch.where(done, torch.full_like(new, pad_id), new)
        done = done | (new == eos_id)
      out.append(new)
      tok = new
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   z_loss: float = 0.0) -> torch.Tensor:
  """Next-token cross-entropy (shifted); ignores the final position.

  ``z_loss`` > 0 adds ``z_loss * mean(logsumexp^2)`` (the PaLM/T5X
  stabiliser), as the JAX package's ``causal_lm_loss`` does.
  """
  targets = tokens[:, 1:].long()
  logits = logits[:, :-1].float()
  ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                       targets.reshape(-1))
  if z_loss:
    lse = torch.logsumexp(logits, dim=-1)
    ce = ce + z_loss * (lse ** 2).mean()
  return ce


def tied_embedding_table(model: Transformer) -> torch.Tensor:
  """The tied input/output embedding [vocab, d_model] of ``model``."""
  return model.embed.embedding


def _chunk_terms(x: torch.Tensor, table: torch.Tensor, targets: torch.Tensor):
  """(sum of lse - label logit, sum of lse^2) over one chunk; its logits
  are computed in f32, as the reference's ``preferred_element_type``
  keeps them."""
  logits = x.float() @ table.float().t()                  # [B, C, V]
  lse = torch.logsumexp(logits, dim=-1)
  ll = logits.gather(-1, targets[..., None])[..., 0]
  return (lse - ll).sum(), (lse ** 2).sum()


def causal_lm_loss_blocked(hidden: torch.Tensor, table: torch.Tensor,
                           tokens: torch.Tensor, chunk: int = 256,
                           z_loss: float = 0.0) -> torch.Tensor:
  """Next-token cross-entropy fused with the tied output projection.

  The ``[batch, seq, vocab]`` logits are never held: sequence chunks of
  ``chunk`` positions are projected against ``table`` (cast to the
  hidden dtype), reduced to (logsumexp, label logit) and dropped; each
  chunk runs under ``torch.utils.checkpoint``, so the backward recomputes
  its logits as ``jax.checkpoint`` makes the reference do. ``hidden``:
  ``model(tokens, return_hidden=True)``; ``table``:
  :func:`tied_embedding_table`. Matches :func:`causal_lm_loss` on the
  same inputs, ``z_loss`` included, to float tolerance.
  """
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
  """:func:`create_state` replicated over a data-parallel ``mesh``
  (:func:`~tensorflowonspark_tpu_torch.parallel.mesh.build_mesh`): every
  rank builds its state, then takes rank 0's weights and optimizer state
  (a broadcast over the data axis), so all ranks start bitwise equal
  whatever seed or weights each was given. The counterpart of the
  reference's ``create_sharded_state`` for a data-only mesh, where the
  state is replicated; it returns the state alone, since a replicated
  state needs no sharding. Any other axis above 1 raises (item 10).
  """
  from tensorflowonspark_tpu_torch.parallel import collectives
  from tensorflowonspark_tpu_torch.parallel import sharding
  sharding._refuse_mesh(mesh, None, ())
  state = create_state(cfg, params, tx=tx, device=device,
                       learning_rate=learning_rate)
  with torch.no_grad():
    for t in (list(state.model.parameters())
              + collectives.tensors_of(state.opt_state)):
      t.copy_(collectives.broadcast_from(t, mesh))
  return state


__all__ = ["TransformerConfig", "KVCache", "Transformer", "TiedEmbed",
           "Attention", "MLPBlock", "Block", "LayerNorm", "greedy_generate_kv",
           "causal_lm_loss", "causal_lm_loss_blocked", "tied_embedding_table",
           "create_state", "create_sharded_state"]
