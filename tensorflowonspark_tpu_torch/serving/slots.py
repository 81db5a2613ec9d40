"""Device side of continuous batching: the slot slab and its operations.

Counterpart of ``tensorflowonspark_tpu/serving/slots.py`` for the
CONTIGUOUS slab: per layer ``[num_slots, max_seq_len, kv_heads,
head_dim]`` key/value buffers plus a VECTOR cursor ``[num_slots]`` (the
per-row-cursor branch of ``Attention._decode_attend``). Every slot
reserves ``max_seq_len`` of device memory whether it needs it or not;
the paged slab and self-speculative decode arrive with later slices.

* :meth:`SlotDecoder.prefill` — one request's prompt through the model on
  a fresh single-row cache, in bucket-sized chunks. The first chunk is a
  fresh-cache prefill (the flash-attention kernel on the card); later
  chunks attend the warm cache through the dense path.
* :meth:`SlotDecoder.insert` — copy that row cache into the slab at a
  freed slot and set the slot's cursor to the prompt length.
* :meth:`SlotDecoder.step` — advance ALL slots one token in one
  fixed-shape call; inactive slots are frozen (their cursor bump is
  undone, their emitted token forced to ``pad_id``).
* :meth:`SlotDecoder.step_many` — ``horizon`` of those steps with the
  per-slot done-mask (EOS hit / budget spent) carried ON DEVICE, so the
  host syncs once per horizon instead of once per token.

The ``TOS_CHAOS_SERVE`` fault sites are the reference's: ``prefill``
(indexed by the prompt length) and ``decode`` (once per ``step_many``
dispatch), both consulted before any device work.

The slab is updated in place (the JAX package returns a new pytree per
call). The ``ServingEngine`` thread owns it and the host bookkeeping.

Obs seams (``TOS_OBS=1``): prefill, insert, step and step_many call
``obs.device.note_trace`` (``serve.prefill`` once per chunk shape,
``serve.insert``, ``serve.step``, ``serve.step_many`` once per horizon),
counting where the reference's jit retraces; a prefill handed a request
trace id records one ``serve.prefill.chunk`` span per chunk (dispatch to
dispatch: only the last chunk's token syncs the host).
"""

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflowonspark_tpu_torch.models.transformer import KVCache, Transformer
from tensorflowonspark_tpu_torch.obs import device as obs_device
from tensorflowonspark_tpu_torch.obs import metrics as obs_metrics
from tensorflowonspark_tpu_torch.obs import spans as obs_spans
from tensorflowonspark_tpu_torch.utils import chaos

#: prompt-chunk sizes for bucketed prefill, largest-first; 1 must be
#: reachable so every length decomposes
DEFAULT_BUCKETS = (512, 128, 32, 16, 8, 4, 2, 1)


def chunk_plan(plen: int, buckets: Sequence[int] = DEFAULT_BUCKETS):
  """Decompose a prompt length into descending bucket-sized chunks.

  Greedy largest-first: ``chunk_plan(37, (128, 32, 8, 4, 2, 1))`` ->
  ``[32, 4, 1]``. A trailing 1 is appended to the bucket set if missing
  so every positive length has a plan.
  """
  if plen < 1:
    raise ValueError("prompt length must be >= 1, got %d" % plen)
  sizes = sorted({int(b) for b in buckets if int(b) > 0}, reverse=True)
  if not sizes or sizes[-1] != 1:
    sizes.append(1)
  plan, rem = [], plen
  for b in sizes:
    while rem >= b:
      plan.append(b)
      rem -= b
  return plan


class SlotDecoder(object):
  """Slab operations for one (model, num_slots) serving shape.

  Greedy decode only: continuous batching's contract is that every
  request's tokens equal its own single-request decode, which sampling's
  batch-shaped random draw cannot promise.
  """

  def __init__(self, model: Transformer, num_slots: int, pad_id: int = 0,
               eos_id=None):
    if num_slots < 1:
      raise ValueError("num_slots must be >= 1, got %d" % num_slots)
    self.model = model
    self.cfg = model.cfg
    self.device = model.device
    self.num_slots = num_slots
    self.pad_id = int(pad_id)
    self.eos_id = None if eos_id is None else int(eos_id)
    # obs seam, cached: off = one None check per call
    self._obs = obs_metrics.active() is not None
    self._seen: set = set()      # this decoder's "jit cache" of shapes

  # -- slab construction ----------------------------------------------------

  def init_slabs(self) -> KVCache:
    """A fresh all-zeros slab with VECTOR per-slot cursors."""
    slabs = self.model.init_cache(self.num_slots)
    slabs.index = torch.zeros((self.num_slots,), dtype=torch.long,
                              device=self.device)
    return slabs

  # -- prefill (single row, bucketed chunks) --------------------------------

  @torch.inference_mode()
  def prefill(self, prompt, buckets: Sequence[int] = DEFAULT_BUCKETS,
              trace: Optional[str] = None) -> Tuple[KVCache, int]:
    """Prefill one prompt into a fresh ``[1, ...]`` row cache.

    Returns ``(row_cache, first_token)``: the warm cache (cursor at
    ``len(prompt)``) and the first generated token. Chunks follow
    :func:`chunk_plan`, so only the LAST chunk's logits matter; the one
    host sync is reading that token. ``trace`` (a request trace id) turns
    on the per-chunk ``serve.prefill.chunk`` spans when the obs recorder
    is live.
    """
    plen = len(prompt)
    if plen + 1 > self.cfg.max_seq_len:
      raise ValueError(
          "prompt of %d tokens leaves no decode room in the "
          "max_seq_len=%d cache" % (plen, self.cfg.max_seq_len))
    # deterministic fault site (TOS_CHAOS_SERVE): raise-or-stall here
    # stands in for a device failure during prefill. The index is the
    # prompt length, the one identity a spec can pin before request ids
    # exist (per-length specs make poison requests)
    chaos.serve_fault("prefill", index=plen)
    tokens = torch.as_tensor(np.asarray(prompt, np.int64).reshape(1, plen),
                             device=self.device)
    row = self.model.init_cache(1)
    rec = obs_spans.active() if trace is not None else None
    off, logits = 0, None
    for seg in chunk_plan(plen, buckets):
      t0 = time.monotonic()
      if self._obs:
        # the reference's prefill jit retraces once per chunk length
        obs_device.note_trace("serve.prefill", seg, cache=self._seen)
      logits = self.model(tokens[:, off:off + seg], row)
      if rec is not None:
        rec.record_span("serve.prefill.chunk", t0, time.monotonic() - t0,
                        trace=trace, chunk=seg, offset=off)
      off += seg
    return row, int(logits[0, -1].argmax())

  # -- slot insert ----------------------------------------------------------

  @torch.inference_mode()
  def insert(self, slabs: KVCache, row: KVCache, slot: int) -> KVCache:
    """Write a prefilled row cache into slab position ``slot`` (the whole
    row, so the previous occupant's entries are overwritten)."""
    if self._obs:
      obs_device.note_trace("serve.insert", cache=self._seen)
    for dst, src in zip(slabs.k + slabs.v, row.k + row.v):
      dst[slot].copy_(src[0])
    slabs.index[slot] = int(row.index)
    return slabs

  # -- decode step ----------------------------------------------------------

  def _one_step(self, slabs: KVCache, tok: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
    old = slabs.index
    logits = self.model(tok[:, None], slabs)
    # inactive slots must not advance: undo their cursor bump so the
    # garbage k/v their lane wrote stays masked and gets overwritten by
    # the next real token (or by the next insert)
    slabs.index = torch.where(active, slabs.index, old)
    nxt = logits[:, -1].argmax(dim=-1)
    return torch.where(active, nxt, torch.full_like(nxt, self.pad_id))

  def _device(self, arr, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(arr), dtype=dtype, device=self.device)

  @torch.inference_mode()
  def step(self, slabs: KVCache, last_tokens, active) -> torch.Tensor:
    """One token for every slot: returns ``next_tokens [num_slots]``.

    ``last_tokens``: ``[num_slots]`` ints (pad for inactive lanes);
    ``active``: ``[num_slots]`` bools. Inactive lanes compute but are
    frozen.
    """
    if self._obs:
      obs_device.note_trace("serve.step", cache=self._seen)
    return self._one_step(slabs, self._device(last_tokens, torch.long),
                          self._device(active, torch.bool))

  @torch.inference_mode()
  def step_many(self, slabs: KVCache, last_tokens, active, remaining,
                horizon: int):
    """``horizon`` decode steps with on-device EOS/budget stops.

    Returns ``(tokens, active, remaining)`` on the device: ``tokens`` is
    ``[horizon, num_slots]`` — a lane's stream is valid up to ITS stop
    (EOS inclusive / budget exhausted), pad after; the host replays the
    same stop rule to harvest. ``remaining``: each lane's unspent budget.
    """
    if horizon < 1:
      raise ValueError("horizon must be >= 1, got %d" % horizon)
    # deterministic fault site (TOS_CHAOS_SERVE): one count per decode
    # dispatch, so "decode#N:raise" crashes the Nth horizon step. The
    # reference also consults it once per speculative dispatch
    # (``step_spec``), which arrives here with ROADMAP Queue 1 item 9
    chaos.serve_fault("decode")
    if self._obs:
      # one compile per distinct horizon in the reference
      obs_device.note_trace("serve.step_many", horizon, cache=self._seen)
    tok = self._device(last_tokens, torch.long)
    active = self._device(active, torch.bool)
    remaining = self._device(remaining, torch.long)
    pad = torch.full_like(tok, self.pad_id)
    out = []
    for _ in range(horizon):
      nxt = self._one_step(slabs, tok, active)
      remaining = torch.where(active, remaining - 1, remaining)
      done_now = remaining <= 0
      if self.eos_id is not None:
        done_now = done_now | (nxt == self.eos_id)
      active = active & ~done_now
      tok = torch.where(active, nxt, pad)
      out.append(nxt)
    return torch.stack(out), active, remaining
