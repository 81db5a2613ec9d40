"""Device side of continuous batching: the slot slab and its operations.

Counterpart of ``tensorflowonspark_tpu/serving/slots.py``. Two slab
layouts exist:

* CONTIGUOUS (default): per layer ``[num_slots, max_seq_len, kv_heads,
  head_dim]`` key/value buffers (int8 with f32 scales under
  ``kv_cache_dtype="int8"``) plus a VECTOR cursor ``[num_slots]`` (the
  per-row-cursor branch of ``Attention._decode_attend``). Every slot
  reserves ``max_seq_len`` of device memory whether it needs it or not.
* PAGED (``page_size > 0``): per layer a page POOL ``[num_pages,
  page_size, kv_heads, head_dim]`` plus a per-slot ``page_table
  [num_slots, pages_per_slot]`` and the vector cursor: a slot holds only
  the pages its token mass needs. Page 0 is the reserved TRASH page; the
  host-side allocator is ``serving.scheduler.PagePool``. Paging also
  unlocks the shared-prefix cache (``serving.scheduler.PrefixCache``):
  requests sharing a prompt prefix fork read-only references to the
  prefix's full pages and prefill only their tail.

* :meth:`SlotDecoder.prefill` — one request's prompt through the model on
  a fresh single-row cache, in bucket-sized chunks. The first chunk is a
  fresh-cache prefill (the flash-attention kernel on the card); later
  chunks attend the warm cache through the dense path. ``resume`` starts
  from a warm row cache (a prefix hit's gathered pages).
* :meth:`SlotDecoder.insert` / :meth:`SlotDecoder.insert_pages` — copy
  that row cache into the slab at a freed slot (into its pages) and set
  the slot's cursor to the prompt length; :meth:`gather_pages` rebuilds a
  row cache from pool pages; :meth:`reset_slots` points freed slots'
  tables at the trash page.
* :meth:`SlotDecoder.step` — advance ALL slots one token in one
  fixed-shape call; inactive slots are frozen (their cursor bump is
  undone, their emitted token forced to ``pad_id``).
* :meth:`SlotDecoder.step_many` — ``horizon`` of those steps with the
  per-slot done-mask (EOS hit / budget spent) carried ON DEVICE, so the
  host syncs once per horizon instead of once per token.
* :meth:`SlotDecoder.step_spec` — SELF-SPECULATIVE decode
  (``spec_depth > 0``): each round drafts ``spec_depth`` tokens with a
  shallow-exit prefix of the model's own layers (``exit_layer=
  spec_layers``: shared weights, shared slab), rolls the cursor back,
  verifies the window with ONE full-model multi-token step, and keeps
  each lane's longest target-agreeing prefix plus the target's own
  correction token. Greedy verification keeps exactly the tokens
  ``greedy_generate_kv`` would emit; rejected draft entries sit past the
  rewound per-lane cursor, masked and overwritten.

The ``TOS_CHAOS_SERVE`` fault sites are the reference's: ``prefill``
(indexed by the prompt length) and ``decode`` (once per ``step_many`` or
``step_spec`` dispatch), both consulted before any device work.

The slab is updated in place (the JAX package returns a new pytree per
call). The ``ServingEngine`` thread owns it and the host bookkeeping.

Obs seams (``TOS_OBS=1``): every operation calls
``obs.device.note_trace`` (``serve.prefill`` once per chunk shape,
``serve.insert``, ``serve.insert_pages``, ``serve.gather_pages``,
``serve.reset_slots``, ``serve.step``, ``serve.step_many`` once per
horizon, ``serve.step_spec`` once per round count), counting where the
reference's jit retraces; a prefill handed a request trace id records one
``serve.prefill.chunk`` span per chunk (dispatch to dispatch: only the
last chunk's token syncs the host).
"""

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflowonspark_tpu_torch.models.transformer import (KVCache,
                                                            Transformer,
                                                            zero_cache)
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

  ``page_size > 0`` switches the slab to the PAGED layout (``num_pages``
  pool pages of ``page_size`` tokens and ``pages_per_slot =
  ceil(max_seq_len / page_size)`` table entries a slot, so a slot's table
  always spans ``max_seq_len``; the pool's default, ``num_slots`` of
  those plus the trash page, covers the contiguous worst case, so paging
  alone never shrinks capacity). ``spec_depth > 0`` enables
  :meth:`step_spec` with a ``spec_layers``-deep draft (default
  ``num_layers // 2``).
  """

  def __init__(self, model: Transformer, num_slots: int, pad_id: int = 0,
               eos_id=None, page_size: int = 0, num_pages: int = 0,
               spec_depth: int = 0, spec_layers: int = 0):
    if num_slots < 1:
      raise ValueError("num_slots must be >= 1, got %d" % num_slots)
    cfg = model.cfg
    self.model = model
    self.cfg = cfg
    self.device = model.device
    self.num_slots = num_slots
    self.pad_id = int(pad_id)
    self.eos_id = None if eos_id is None else int(eos_id)
    self.page_size = int(page_size)
    self.paged = self.page_size > 0
    # the row cache of a prefill is contiguous whatever the slab's layout
    self.row_cfg = dataclasses.replace(cfg, kv_page_size=0, kv_num_pages=0,
                                       kv_pages_per_slot=0)
    if self.paged:
      pps = -(-cfg.max_seq_len // self.page_size)
      self.pages_per_slot = pps
      self.num_pages = int(num_pages) or num_slots * pps + 1
      self.slab_cfg = dataclasses.replace(
          self.row_cfg, kv_page_size=self.page_size,
          kv_num_pages=self.num_pages, kv_pages_per_slot=pps)
    else:
      self.pages_per_slot = 0
      self.num_pages = 0
      self.slab_cfg = self.row_cfg
    self.spec_depth = int(spec_depth)
    if self.spec_depth < 0:
      raise ValueError("spec_depth must be >= 0, got %d" % self.spec_depth)
    self.spec_layers = int(spec_layers) or max(1, cfg.num_layers // 2)
    if self.spec_depth and not 1 <= self.spec_layers <= cfg.num_layers:
      raise ValueError(
          "spec_layers must be in [1, num_layers=%d], got %d"
          % (cfg.num_layers, self.spec_layers))
    # obs seam, cached: off = one None check per call
    self._obs = obs_metrics.active() is not None
    self._seen: set = set()      # this decoder's "jit cache" of shapes

  def _trace(self, label: str, *key) -> None:
    if self._obs:
      obs_device.note_trace(label, *key, cache=self._seen)

  # -- slab construction ----------------------------------------------------

  def init_slabs(self) -> KVCache:
    """A fresh all-zeros slab with VECTOR per-slot cursors (a paged slab
    is born with them, its page tables all-trash)."""
    slabs = zero_cache(self.slab_cfg, self.num_slots, self.device)
    if not self.paged:
      slabs.index = torch.zeros((self.num_slots,), dtype=torch.long,
                                device=self.device)
    return slabs

  # -- prefill (single row, bucketed chunks) --------------------------------

  @torch.inference_mode()
  def prefill(self, prompt, buckets: Sequence[int] = DEFAULT_BUCKETS,
              resume: Optional[Tuple[KVCache, int]] = None,
              trace: Optional[str] = None) -> Tuple[KVCache, int]:
    """Prefill one prompt into a fresh ``[1, ...]`` row cache.

    Returns ``(row_cache, first_token)``: the warm cache (cursor at
    ``len(prompt)``) and the first generated token. Chunks follow
    :func:`chunk_plan`, so only the LAST chunk's logits matter; the one
    host sync is reading that token.

    ``resume=(row_cache, start)`` skips the first ``start`` prompt
    tokens: the given warm cache already holds their KV (a prefix hit's
    :meth:`gather_pages`), so only the tail rides the chunked prefill,
    whose first chunk, at cursor ``start > 0``, takes the dense branch.
    ``start`` must leave at least one tail token (the last prompt token
    must run through the model to yield the first token).

    ``trace`` (a request trace id) turns on the per-chunk
    ``serve.prefill.chunk`` spans when the obs recorder is live.
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
    if resume is not None:
      row, off = resume
      off = int(off)
      if not 0 <= off < plen:
        raise ValueError(
            "prefill resume offset %d must be in [0, prompt_len=%d)"
            % (off, plen))
    else:
      row, off = zero_cache(self.row_cfg, 1, self.device), 0
    tokens = torch.as_tensor(np.asarray(prompt, np.int64).reshape(1, plen),
                             device=self.device)
    rec = obs_spans.active() if trace is not None else None
    logits = None
    for seg in chunk_plan(plen - off, buckets):
      t0 = time.monotonic()
      # the reference's prefill jit retraces once per chunk length
      self._trace("serve.prefill", seg)
      logits = self.model(tokens[:, off:off + seg], row)
      if rec is not None:
        rec.record_span("serve.prefill.chunk", t0, time.monotonic() - t0,
                        trace=trace, chunk=seg, offset=off)
      off += seg
    return row, int(logits[0, -1].argmax())

  # -- slot insert ----------------------------------------------------------

  @staticmethod
  def _leaves(cache: KVCache) -> List[torch.Tensor]:
    return cache.k + cache.v + (cache.k_scale or []) + (cache.v_scale or [])

  @torch.inference_mode()
  def insert(self, slabs: KVCache, row: KVCache, slot: int) -> KVCache:
    """Write a prefilled row cache into slab position ``slot`` (the whole
    row, an int8 cache's scales included, so the previous occupant's
    entries are overwritten)."""
    self._trace("serve.insert")
    for dst, src in zip(self._leaves(slabs), self._leaves(row)):
      dst[slot].copy_(src[0])
    slabs.index[slot] = int(row.index)
    return slabs

  # -- paged slab ops --------------------------------------------------------

  @torch.inference_mode()
  def insert_pages(self, slabs: KVCache, row: KVCache, slot: int, pages,
                   start: int = 0) -> KVCache:
    """Paged insert: write ``row``'s prompt tokens ``[start, len)`` into
    ``pages`` (a ``pages_per_slot``-long list, unused tail entries 0 =
    trash; ``pages[i]`` holds tokens ``[i * page_size, (i + 1) *
    page_size)``), and set slot ``slot``'s table row and cursor. The
    tokens below ``start`` live in shared read-only prefix pages that the
    table also names, and are not written."""
    self._trace("serve.insert_pages")
    ps, plen = self.page_size, int(row.index)
    table = torch.as_tensor(np.asarray(pages, np.int64), device=self.device)
    pos = torch.arange(int(start), plen, device=self.device)
    pg, off = table[pos // ps], pos % ps
    for dst, src in zip(slabs.k + slabs.v, row.k + row.v):
      dst[pg, off] = src[0, int(start):plen]
    slabs.page_table[slot] = table
    slabs.index[slot] = plen
    return slabs

  @torch.inference_mode()
  def gather_pages(self, slabs: KVCache, pages, n_tokens: int) -> KVCache:
    """A contiguous ``[1, ...]`` row cache holding the ``n_tokens``
    prefix tokens of pool ``pages`` (zeros past them), its cursor at
    ``n_tokens``: the warm cache a shared-prefix tail prefill resumes
    from."""
    self._trace("serve.gather_pages")
    n = int(n_tokens)
    used = np.asarray(pages, np.int64)[:-(-n // self.page_size)]
    table = torch.as_tensor(used, device=self.device)
    row = zero_cache(self.row_cfg, 1, self.device)
    for dst, src in zip(row.k + row.v, slabs.k + slabs.v):
      dst[0, :n] = src[table].reshape((-1,) + src.shape[2:])[:n]
    row.index = n
    return row

  @torch.inference_mode()
  def reset_slots(self, slabs: KVCache, freed_mask) -> KVCache:
    """Zero the page tables and cursors of freed slots: a freed slot's
    lane keeps computing (frozen), and its stale table would otherwise
    route its writes into pages the allocator has already handed to a
    new request; the reset points them at the trash page instead."""
    self._trace("serve.reset_slots")
    freed = self._device(freed_mask, torch.bool)
    slabs.page_table[freed] = 0
    slabs.index[freed] = 0
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
    self._trace("serve.step")
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
    # dispatch, so "decode#N:raise" crashes the Nth horizon step
    chaos.serve_fault("decode")
    # one compile per distinct horizon in the reference
    self._trace("serve.step_many", horizon)
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

  # -- self-speculative decode ----------------------------------------------

  @torch.inference_mode()
  def step_spec(self, slabs: KVCache, last_tokens, active, remaining,
                rounds: int):
    """``rounds`` SELF-SPECULATIVE rounds (requires ``spec_depth > 0``).
    Each round per lane: draft ``spec_depth`` tokens with the
    ``spec_layers``-deep shallow exit, roll the cursor back, verify the
    window with ONE full-model multi-token step, keep the longest
    target-agreeing prefix plus the target's correction token, and
    advance that lane's cursor by exactly the kept count, so every kept
    token is the target's own greedy emission and a round emits
    1..spec_depth tokens a live lane.

    Returns ``(tokens, counts, accepted, rejected, active, remaining)`` on
    the device: ``tokens [rounds, spec_depth, num_slots]`` (a lane's
    round is valid for its first ``counts[r, lane]`` positions, pad after:
    the counts are REQUIRED for the harvest, since rejection padding
    cannot be told from an emitted pad token), ``accepted`` /
    ``rejected [rounds, num_slots]`` the draft tokens' verdicts for the
    telemetry counters.

    The draft advances the one shared cursor (the reference advances
    only the visited layers'); it is restored to the round's start before
    the verify and set to start + kept after it, so both end in the same
    state, and the verify rewrites whatever the draft wrote past the
    start.
    """
    if not self.spec_depth:
      raise ValueError("step_spec requires spec_depth > 0")
    if rounds < 1:
      raise ValueError("rounds must be >= 1, got %d" % rounds)
    # the same deterministic fault site as step_many: one count per decode
    # dispatch, so TOS_CHAOS_SERVE schedules hit spec and non-spec alike
    chaos.serve_fault("decode")
    # one compile per distinct round count in the reference
    self._trace("serve.step_spec", rounds)
    k = self.spec_depth
    tok = self._device(last_tokens, torch.long)
    active = self._device(active, torch.bool)
    remaining = self._device(remaining, torch.long)
    pad = torch.full_like(tok, self.pad_id)
    cols = torch.arange(k, device=self.device)[None, :]
    ys = []
    for _ in range(rounds):
      cur0 = slabs.index
      t, proposals = tok, []
      for _ in range(k):
        t = self.model(t[:, None], slabs,
                       exit_layer=self.spec_layers)[:, -1].argmax(dim=-1)
        proposals.append(t)
      slabs.index = cur0
      p = torch.stack(proposals, dim=1)                     # [S, k]
      window = torch.cat([tok[:, None], p[:, :k - 1]], dim=1)
      t = self.model(window, slabs).argmax(dim=-1)          # [S, k]
      m = torch.cumprod((p == t).long(), dim=1).sum(dim=1)  # [S] in [0, k]
      bonus = t.gather(1, m.clamp(max=k - 1)[:, None])[:, 0]
      # kept stream: m agreed proposals, then (m < k) the target's
      # correction — never more than k tokens, all target-greedy
      emit = torch.where(cols == m[:, None], bonus[:, None], p)
      limit = torch.minimum(torch.where(m < k, m + 1, k), remaining)
      if self.eos_id is not None:
        iseos = (emit == self.eos_id) & (cols < limit[:, None])
        has_eos = iseos.any(dim=1)
        stop = torch.where(has_eos, iseos.long().argmax(dim=1) + 1, limit)
      else:
        has_eos = torch.zeros_like(active)
        stop = limit
      stop = torch.where(active, stop, torch.zeros_like(stop))
      toks = torch.where(cols < stop[:, None], emit, pad[:, None])
      remaining = torch.where(active, remaining - stop, remaining)
      new_active = active & ~((remaining <= 0) | has_eos)
      newlast = emit.gather(1, (stop - 1).clamp(0, k - 1)[:, None])[:, 0]
      slabs.index = cur0 + stop
      ys.append((toks.t(), stop, torch.minimum(stop, m),
                 torch.where(active, k - m, torch.zeros_like(m))))
      tok = torch.where(new_active, newlast, pad)
      active = new_active
    toks, counts, accepted, rejected = (torch.stack(y) for y in zip(*ys))
    return toks, counts, accepted, rejected, active, remaining
