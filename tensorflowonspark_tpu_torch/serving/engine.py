"""ServingEngine: slot-based in-flight (continuous) batching on PyTorch.

Counterpart of ``tensorflowonspark_tpu/serving/engine.py``, greedy. One
loop thread keeps a fixed-capacity slot slab
(``serving.slots.SlotDecoder``) advancing; the moment a slot's request
hits EOS or its token budget the slot is freed, the next queued request
is prefilled straight into that cache region, and decoding goes on.

Per-request outputs equal the single-request ``greedy_generate_kv``
decode of the same prompt: rows are independent, per-slot cursors mask
each lane to its own length, and prefill chunking changes which code
computes a value but not the value (up to float rounding order).

The self-healing surface is the reference's:

* admission control — the queue is bounded by request count AND queued
  token mass; ``submit`` raises a structured ``ServingOverloaded`` with
  a retry-after hint instead of growing without bound;
* deadlines & cancellation — checked at admission and at every horizon
  boundary; ``cancel(rid)`` frees an in-flight slot exactly like EOS;
* crash-replay recovery — an exception in the loop thread rebuilds the
  slab and replays every in-flight request from its prompt (the already
  emitted prefix is suppressed), with capped consecutive restarts +
  backoff and poison detection;
* graceful drain — ``drain(timeout)`` stops admission, finishes every
  accepted request, then stops.

Usage::

    eng = ServingEngine(params, cfg, num_slots=8, eos_id=2).start()
    rid = eng.submit(prompt_ids, max_new_tokens=128, ttl=30.0)
    tokens = eng.result(rid, timeout=60)        # prompt + generated
    eng.drain(timeout=30)                       # or eng.stop()

The fleet surface is the reference's too: the load properties a router
scores replicas by (:attr:`queue_depth`, :attr:`queued_tokens`,
:attr:`tokens_per_sec`, :attr:`slots_in_use`, :attr:`occupancy_now`; host
state only, none syncs the card), :meth:`poll`, :meth:`stats_snapshot`
and the terminal-death seam :meth:`kill` that ``serving.fleet`` drives.
The ``TOS_CHAOS_SERVE`` fault sites sit in ``serving.slots`` (``prefill``
and ``decode``): an injected raise is healed by crash replay like any
other loop crash.

The decode-speed stack is the reference's, each stage composable with the
self-healing surface and keeping every request's tokens equal to its
single-request decode:

* paged KV slab — ``page_size > 0`` swaps the per-slot ``max_seq_len``
  reservation for a page pool and per-slot page tables
  (``serving.slots``): a request holds only the pages its prompt + budget
  needs, and one that cannot get pages waits in the queue (completions
  free pages) instead of failing;
* shared-prefix cache — ``prefix_pages > 0`` (requires paging) keeps a
  radix trie over prompt prefixes at page granularity
  (``serving.scheduler.PrefixCache``): requests sharing a prefix prefill
  it once and fork read-only page references; eviction is ref-counted
  LRU;
* self-speculative decode — ``spec_depth > 0`` drafts with a
  ``spec_layers``-deep shallow-exit prefix of the same model and verifies
  with one full-model step a round (``SlotDecoder.step_spec``).

Knobs: ``TOS_SERVE_SLOTS``, ``TOS_SERVE_BUCKETS``, ``TOS_SERVE_POLL``,
``TOS_SERVE_HORIZON``, ``TOS_SERVE_MAX_QUEUE``,
``TOS_SERVE_MAX_QUEUED_TOKENS``, ``TOS_SERVE_TTL``,
``TOS_SERVE_MAX_RESTARTS``, ``TOS_SERVE_RESTART_BACKOFF``,
``TOS_SERVE_POISON_CRASHES``, ``TOS_SERVE_PAGE_SIZE``,
``TOS_SERVE_NUM_PAGES``, ``TOS_SERVE_PREFIX_PAGES``,
``TOS_SERVE_SPEC_DEPTH``, ``TOS_SERVE_SPEC_LAYERS``; an explicit argument
beats its variable.

Obs seams (``TOS_OBS=1``; handles cached at construction, so with the
plane off each seam is one None check): the reference's ``serve.*``
counters and gauges (``kv_pages_*`` move only on a paged engine), the
``serve.decode_ms``
histogram, the ``serve.ttft_ms`` / ``tpot_ms`` / ``e2e_ms`` /
``queue_wait_ms`` sketches, the ``serve.queue`` / ``prefill`` /
``decode`` / ``decode.slot`` / ``stream`` spans and the
``serve.replay`` / ``serve.restart`` events; ``TOS_OBS_TRACE_DETAIL=0``
drops the per-lane and per-chunk detail spans. Seams pass host ints
only: a span attribute handed a card tensor would sync the host.
"""

import contextlib
import logging
import os
import queue as std_queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from tensorflowonspark_tpu_torch.models.transformer import Transformer
from tensorflowonspark_tpu_torch.obs import metrics as obs_metrics
from tensorflowonspark_tpu_torch.obs import spans as obs_spans
from tensorflowonspark_tpu_torch.serving import scheduler as sched
from tensorflowonspark_tpu_torch.serving import slots as slots_lib

logger = logging.getLogger(__name__)

#: default slot capacity when the caller passes ``num_slots=None``
ENV_SERVE_SLOTS = "TOS_SERVE_SLOTS"
#: idle-loop poll interval (seconds) — the bound on every engine wait
ENV_SERVE_POLL = "TOS_SERVE_POLL"
#: decode horizon: how many tokens one dispatch advances before the host
#: harvests (see SlotDecoder.step_many)
ENV_SERVE_HORIZON = "TOS_SERVE_HORIZON"
#: admission bound on queued request count (0 disables)
ENV_SERVE_MAX_QUEUE = "TOS_SERVE_MAX_QUEUE"
#: admission bound on queued token mass (0 disables)
ENV_SERVE_MAX_QUEUED_TOKENS = "TOS_SERVE_MAX_QUEUED_TOKENS"
#: default per-request TTL in seconds (0 = no default deadline)
ENV_SERVE_TTL = "TOS_SERVE_TTL"
#: consecutive loop crashes tolerated before the engine dies terminally
ENV_SERVE_MAX_RESTARTS = "TOS_SERVE_MAX_RESTARTS"
#: base restart backoff in seconds (doubles per consecutive crash)
ENV_SERVE_RESTART_BACKOFF = "TOS_SERVE_RESTART_BACKOFF"
#: a request blamed for this many consecutive crashes is failed
ENV_SERVE_POISON_CRASHES = "TOS_SERVE_POISON_CRASHES"
#: paged KV slab: tokens per page (0 = contiguous per-slot reservation)
ENV_SERVE_PAGE_SIZE = "TOS_SERVE_PAGE_SIZE"
#: paged KV slab: pool size in pages, incl. the reserved trash page 0
#: (0 = auto: num_slots x ceil(max_seq_len / page_size) + 1, the
#: contiguous worst case; set lower to spend less device memory)
ENV_SERVE_NUM_PAGES = "TOS_SERVE_NUM_PAGES"
#: shared-prefix cache budget in pages (0 = off; requires paging)
ENV_SERVE_PREFIX_PAGES = "TOS_SERVE_PREFIX_PAGES"
#: self-speculative decode: draft-window depth per round (0 = off)
ENV_SERVE_SPEC_DEPTH = "TOS_SERVE_SPEC_DEPTH"
#: self-speculative decode: shallow-exit draft depth in layers
#: (0 = auto: num_layers // 2)
ENV_SERVE_SPEC_LAYERS = "TOS_SERVE_SPEC_LAYERS"
#: request-trace detail spans (``serve.decode.slot`` per lane per
#: dispatch + ``serve.prefill.chunk`` per bucket chunk): ``0`` keeps
#: request tracing on (queue/prefill/stream spans, trace ids) but drops
#: the high-volume detail records
ENV_OBS_TRACE_DETAIL = "TOS_OBS_TRACE_DETAIL"

_DEFAULT_SLOTS = 4
_DEFAULT_POLL = 0.05
_DEFAULT_HORIZON = 4
_DEFAULT_MAX_QUEUE = 1024
_DEFAULT_MAX_QUEUED_TOKENS = 1 << 20
_DEFAULT_MAX_RESTARTS = 5
_DEFAULT_RESTART_BACKOFF = 0.05
_DEFAULT_POISON_CRASHES = 2
_BACKOFF_CAP = 2.0
_COLD_RETRY_AFTER = 0.25
_RESTART_LOG_CAP = 64
#: stats keys whose ``serve.<key>`` counter moves with them
_STATS_TWINS = ("submitted", "completed", "prefills", "rejected", "expired",
                "cancelled", "replays", "engine_restarts", "poisoned",
                "prefix_hits", "prefix_evictions", "spec_accepted",
                "spec_rejected")


def _env_int(name: str, default: int) -> int:
  return int(os.environ.get(name, str(default)))


def _env_float(name: str, default: float) -> float:
  return float(os.environ.get(name, str(default)))


class ServingEngine(object):
  """Continuous-batching serving runtime over one model + weight set.

  ``params``: the flat weight dict (``utils.params.init_params`` or
  ``params_from_flax``); ``cfg``: the port's ``TransformerConfig``;
  ``device``: ``None`` is the card (raises when there is none), the tests
  pass ``"cpu"``. The model the engine built is :attr:`model`. ``mesh``:
  the reference's argument; a mesh of one process serves as without one,
  and a wider one raises (the engine over a mesh, with rank 0's loop
  mirrored to the other ranks, is ROADMAP Queue 1 item 10c, part 3b-ii).
  """

  def __init__(self, params, cfg, num_slots: Optional[int] = None,
               eos_id: Optional[int] = None, pad_id: int = 0,
               max_new_tokens: int = 64, buckets=None, mesh=None,
               poll_interval: Optional[float] = None,
               horizon: Optional[int] = None,
               max_queue: Optional[int] = None,
               max_queued_tokens: Optional[int] = None,
               default_ttl: Optional[float] = None,
               max_restarts: Optional[int] = None,
               restart_backoff: Optional[float] = None,
               poison_crashes: Optional[int] = None,
               page_size: Optional[int] = None,
               num_pages: Optional[int] = None,
               prefix_pages: Optional[int] = None,
               spec_depth: Optional[int] = None,
               spec_layers: Optional[int] = None,
               device=None):
    if mesh is not None and mesh.size > 1:
      raise NotImplementedError(
          "ServingEngine over a mesh %s is not ported to PyTorch yet "
          "(ROADMAP Queue 1 item 10c, part 3b-ii): decode a rectangular "
          "batch over the mesh with greedy_generate_kv"
          % (dict(mesh.shape),))
    if eos_id is not None and int(eos_id) == int(pad_id):
      raise ValueError("eos_id and pad_id must differ (both %d)"
                       % int(pad_id))
    if num_slots is None:
      num_slots = _env_int(ENV_SERVE_SLOTS, _DEFAULT_SLOTS)
    if horizon is None:
      horizon = _env_int(ENV_SERVE_HORIZON, _DEFAULT_HORIZON)
    if horizon < 1:
      raise ValueError("horizon must be >= 1, got %d" % horizon)
    self.cfg = cfg
    self.model = Transformer(cfg, params=params, device=device)
    self.eos_id = None if eos_id is None else int(eos_id)
    self.pad_id = int(pad_id)
    self.horizon = horizon
    self.default_max_new_tokens = int(max_new_tokens)
    self.buckets = tuple(buckets) if buckets is not None \
        else sched.buckets_from_env(slots_lib.DEFAULT_BUCKETS)
    self.max_queue = int(max_queue if max_queue is not None
                         else _env_int(ENV_SERVE_MAX_QUEUE,
                                       _DEFAULT_MAX_QUEUE))
    self.max_queued_tokens = int(
        max_queued_tokens if max_queued_tokens is not None
        else _env_int(ENV_SERVE_MAX_QUEUED_TOKENS,
                      _DEFAULT_MAX_QUEUED_TOKENS))
    ttl = default_ttl if default_ttl is not None \
        else _env_float(ENV_SERVE_TTL, 0.0)
    self.default_ttl = float(ttl) if ttl and ttl > 0 else None
    self.max_restarts = int(max_restarts if max_restarts is not None
                            else _env_int(ENV_SERVE_MAX_RESTARTS,
                                          _DEFAULT_MAX_RESTARTS))
    self.restart_backoff = float(
        restart_backoff if restart_backoff is not None
        else _env_float(ENV_SERVE_RESTART_BACKOFF,
                        _DEFAULT_RESTART_BACKOFF))
    self.poison_crashes = max(1, int(
        poison_crashes if poison_crashes is not None
        else _env_int(ENV_SERVE_POISON_CRASHES, _DEFAULT_POISON_CRASHES)))
    # explicit arguments beat the env knobs (the num_slots rule)
    self.page_size = int(page_size if page_size is not None
                         else _env_int(ENV_SERVE_PAGE_SIZE, 0))
    self.num_pages = int(num_pages if num_pages is not None
                         else _env_int(ENV_SERVE_NUM_PAGES, 0))
    self.prefix_pages = int(prefix_pages if prefix_pages is not None
                            else _env_int(ENV_SERVE_PREFIX_PAGES, 0))
    self.spec_depth = int(spec_depth if spec_depth is not None
                          else _env_int(ENV_SERVE_SPEC_DEPTH, 0))
    spec_layers = int(spec_layers if spec_layers is not None
                      else _env_int(ENV_SERVE_SPEC_LAYERS, 0))
    if self.prefix_pages > 0 and self.page_size <= 0:
      raise ValueError(
          "the shared-prefix cache shares POOL PAGES — "
          "TOS_SERVE_PREFIX_PAGES > 0 requires TOS_SERVE_PAGE_SIZE > 0")
    self.decoder = slots_lib.SlotDecoder(
        self.model, num_slots, pad_id=pad_id, eos_id=self.eos_id,
        page_size=self.page_size, num_pages=self.num_pages,
        spec_depth=self.spec_depth, spec_layers=spec_layers)
    # spec rounds per dispatch: each round emits 1..spec_depth tokens,
    # so this keeps the best-case tokens-per-dispatch near the horizon
    self._spec_rounds = max(1, -(-horizon // max(1, self.spec_depth)))
    self._poll = float(poll_interval if poll_interval is not None
                       else os.environ.get(ENV_SERVE_POLL, _DEFAULT_POLL))
    self._queue = sched.RequestQueue()
    self._lock = threading.Lock()
    self._stats_lock = threading.Lock()
    self._requests = {}                    # rid -> Request (in flight or done)
    self._slots: List[Optional[sched.Request]] = [None] * num_slots
    self._slabs = None                     # built lazily on start()
    # paged-KV host state, (re)built with the slab (_ensure_slabs): the
    # allocator and the trie describe the slab's pages
    self._pool: Optional[sched.PagePool] = None
    self._prefix: Optional[sched.PrefixCache] = None
    self._req_pages = {}                   # rid -> [page ids] (one ref each)
    self._last = np.full((num_slots,), self.pad_id, np.int64)
    self._stop_evt = threading.Event()
    self._thread: Optional[threading.Thread] = None
    self._loop_error: Optional[BaseException] = None
    self._draining = False
    self._admitting: Optional[sched.Request] = None
    self._crash_streak = 0
    self._tok_rate = 0.0                   # EMA tokens/s over decode passes
    #: bounded record of crash recoveries: {t, duration_s, replayed,
    #: poisoned, streak, error}
    self.restart_log: List[dict] = []
    #: monotonic counters; ``decode_s`` sums the wall time of decode
    #: dispatches (each ends in the host harvest, so it includes the
    #: device work)
    self.stats = {"steps": 0, "live_slot_steps": 0, "emitted_tokens": 0,
                  "prefills": 0, "submitted": 0, "completed": 0,
                  "rejected": 0, "expired": 0, "cancelled": 0,
                  "replays": 0, "engine_restarts": 0, "poisoned": 0,
                  "replay_mismatches": 0, "prefix_hits": 0,
                  "prefix_evictions": 0, "spec_accepted": 0,
                  "spec_rejected": 0, "decode_s": 0.0}
    # obs seam: cached handles; disabled = one None check per seam
    self._rec = obs_spans.active()
    self._trace_detail = os.environ.get(ENV_OBS_TRACE_DETAIL,
                                        "1") not in ("0",)
    reg = obs_metrics.active()
    self._obs_m = None if reg is None else {
        # stats twins, bumped by _count
        **{key: reg.counter("serve." + key) for key in _STATS_TWINS},
        "tokens": reg.counter("serve.tokens"),
        "steps": reg.counter("serve.steps"),
        "occupancy": reg.gauge("serve.occupancy"),
        "queue_depth": reg.gauge("serve.queue_depth"),
        "slots_active": reg.gauge("serve.slots_active"),
        "kv_pages_in_use": reg.gauge("serve.kv_pages_in_use"),
        "kv_pages_free": reg.gauge("serve.kv_pages_free"),
        "decode_ms": reg.histogram("serve.decode_ms"),
    }
    # the SLO plane's latency objects (obs.quantiles): mergeable
    # streaming sketches — per-executor sketches ship whole over the OBS
    # verb and the driver MERGES them
    self._obs_q = None if reg is None else {
        "ttft_ms": reg.quantiles("serve.ttft_ms"),
        "tpot_ms": reg.quantiles("serve.tpot_ms"),
        "e2e_ms": reg.quantiles("serve.e2e_ms"),
        "queue_wait_ms": reg.quantiles("serve.queue_wait_ms"),
    }

  def _count(self, key: str, n: int = 1) -> None:
    """Bump a stats key and its obs counter twin (when the plane is
    on). Locked: some keys are bumped from client threads (submit,
    cancel) AND the loop thread."""
    with self._stats_lock:
      self.stats[key] += n
    if self._obs_m is not None and key in _STATS_TWINS:
      self._obs_m[key].inc(n)

  def stats_snapshot(self) -> obs_metrics.StatsSnapshot:
    """Subtraction baseline over the live ``stats`` dict: the safe way to
    read per-pass deltas while the loop thread keeps mutating it."""
    return obs_metrics.snapshot_stats(self.stats)

  @property
  def occupancy(self) -> float:
    """Live-slot fraction over all decode steps so far (goodput proxy)."""
    steps = self.stats["steps"]
    if not steps:
      return 0.0
    return self.stats["live_slot_steps"] / float(steps * self.num_slots)

  # -- load telemetry (the fleet router's dispatch inputs) -------------------

  @property
  def queue_depth(self) -> int:
    """Queued-or-admitting request count: a request the loop popped but
    has not finished prefilling into a slot is still backlog, or a
    load-aware router double-books the replica busiest admitting."""
    adm = self._admitting
    return len(self._queue) + (1 if adm is not None else 0)

  @property
  def queued_tokens(self) -> int:
    """Queued-or-admitting token mass: prompt + budget over the backlog
    (the :attr:`queue_depth` rule for a request mid-admission)."""
    adm = self._admitting
    extra = (len(adm.prompt) + adm.max_new_tokens) if adm is not None \
        else 0
    return self._queue.token_mass + extra

  @property
  def tokens_per_sec(self) -> float:
    """Live tokens/s EMA over decode passes (0.0 before the first)."""
    return self._tok_rate

  @property
  def slots_in_use(self) -> int:
    with self._lock:
      return sum(1 for r in self._slots if r is not None)

  @property
  def occupancy_now(self) -> float:
    """Instantaneous occupied-slot fraction (against the historical
    :attr:`occupancy`)."""
    return self.slots_in_use / float(self.num_slots)

  def kill(self, cause: Optional[BaseException] = None,
           timeout: float = 5.0) -> None:
    """Terminal-death seam: die as if the loop spent its restart budget.
    The loop thread exits, :attr:`alive` turns False, and every waiter
    (queued, in flight, future) fails fast with ``cause``. The fleet's
    ``TOS_CHAOS_FLEET`` kill action and the failover tests drive it;
    production code uses :meth:`stop` or :meth:`drain`."""
    err = cause if cause is not None else RuntimeError(
        "serving engine killed")
    self._stop_evt.set()                   # the loop exits its next pass
    self._die(err)
    t = self._thread
    if t is not None:
      t.join(timeout=timeout)

  # -- lifecycle ------------------------------------------------------------

  @property
  def num_slots(self) -> int:
    return self.decoder.num_slots

  @property
  def kv_pages_in_use(self) -> int:
    """Allocated pool pages (0 when paging is off / engine not started)."""
    pool = self._pool
    return 0 if pool is None else pool.in_use

  @property
  def kv_pages_free(self) -> int:
    pool = self._pool
    return 0 if pool is None else pool.free_pages

  def _drop_slabs(self) -> None:
    """Drop the slab and the host page state describing it: a new slab
    means every old page id is meaningless (replayed requests allocate
    again at re-admission)."""
    self._slabs = None
    self._pool = None
    self._prefix = None
    self._req_pages = {}

  def _ensure_slabs(self) -> None:
    """(Re)build the device slab, and with a paged one its allocator and
    prefix trie (crash recovery starts from new ones)."""
    if self._slabs is not None:
      return
    self._slabs = self.decoder.init_slabs()
    if self.decoder.paged:
      self._pool = sched.PagePool(self.decoder.num_pages)
      self._prefix = sched.PrefixCache(self.page_size, self.prefix_pages) \
          if self.prefix_pages > 0 else None
      self._req_pages = {}

  def start(self) -> "ServingEngine":
    if self._thread is not None and self._thread.is_alive():
      return self
    self._stop_evt.clear()
    self._loop_error = None
    self._draining = False
    self._crash_streak = 0
    self._queue.reopen()
    self._ensure_slabs()
    self._thread = threading.Thread(target=self._loop, daemon=True,
                                    name="tos-torch-serving-engine")
    self._thread.start()
    return self

  def stop(self, timeout: float = 30.0) -> None:
    """Stop the loop thread; unfinished requests (queued AND in flight)
    are failed. Idempotent, and safe before :meth:`start`."""
    self._stop_evt.set()
    t = self._thread
    if t is not None:
      t.join(timeout=timeout)
      if t.is_alive():
        logger.warning("serving loop did not stop within %.1fs", timeout)
    err = RuntimeError("serving engine stopped")
    for req in self._queue.close(err):
      req.finish(err)
    with self._lock:
      live = [r for r in self._slots if r is not None]
      self._slots = [None] * self.num_slots
      adm, self._admitting = self._admitting, None
    if adm is not None:
      live.append(adm)
    for req in live:
      req.finish(err)                      # finish() is idempotent
    self._drop_slabs()                     # next start() gets a fresh slab

  def drain(self, timeout: float) -> bool:
    """Graceful shutdown: stop admission, finish every accepted request
    (queued and in flight), then stop. Returns True when all accepted
    work completed inside ``timeout``."""
    deadline = time.monotonic() + max(0.0, float(timeout))
    self._draining = True                  # submit() rejects from here on
    while time.monotonic() < deadline:
      if self._loop_error is not None:
        break
      t = self._thread
      if t is None or not t.is_alive():
        break
      if self._idle():
        break
      time.sleep(min(0.05, self._poll))
    completed = self._idle() and self._loop_error is None
    self.stop(timeout=max(1.0, deadline - time.monotonic()))
    return completed

  def _idle(self) -> bool:
    # the queue is checked FIRST: a pop marks the request mid-admission
    # under the queue lock, so once the queue reads empty any popped
    # request is already visible in _admitting or a slot
    if len(self._queue) > 0:
      return False
    with self._lock:
      return not (any(r is not None for r in self._slots)
                  or self._admitting is not None)

  def __enter__(self):
    return self.start()

  def __exit__(self, *exc):
    self.stop()

  # -- client API -----------------------------------------------------------

  def submit(self, prompt, max_new_tokens: Optional[int] = None,
             deadline: Optional[float] = None,
             ttl: Optional[float] = None,
             trace_id: Optional[str] = None) -> int:
    """Queue one prompt; returns the request id.

    ``deadline`` is an absolute ``time.monotonic()`` bound; ``ttl`` is
    seconds from now (pass one or the other). Raises
    ``ServingOverloaded`` instead of queueing without bound.
    """
    budget = int(max_new_tokens if max_new_tokens is not None
                 else self.default_max_new_tokens)
    if budget < 1:
      raise ValueError("max_new_tokens must be >= 1, got %d" % budget)
    now = time.monotonic()
    if deadline is not None and ttl is not None:
      raise ValueError("pass deadline OR ttl, not both")
    if ttl is None and deadline is None and self.default_ttl is not None:
      ttl = self.default_ttl
    if ttl is not None:
      deadline = now + float(ttl)
    req = sched.Request(prompt, budget, deadline=deadline,
                        trace_id=trace_id)
    if len(req.prompt) < 1:
      raise ValueError("prompt must contain at least one token")
    if len(req.prompt) + budget > self.cfg.max_seq_len:
      raise ValueError(
          "prompt of %d tokens + budget %d exceeds the max_seq_len=%d "
          "slot cache" % (len(req.prompt), budget, self.cfg.max_seq_len))
    if self.decoder.paged:
      needed = -(-(len(req.prompt) + budget) // self.page_size)
      if needed > self.decoder.num_pages - 1:
        # reject here, not in the loop: a request no amount of
        # completions can ever page in would pin admission forever
        raise ValueError(
            "prompt of %d tokens + budget %d needs %d KV pages but the "
            "pool holds %d allocatable (TOS_SERVE_NUM_PAGES=%d minus "
            "the trash page)" % (len(req.prompt), budget, needed,
                                 self.decoder.num_pages - 1,
                                 self.decoder.num_pages))
    self._count("submitted")
    if req.expired(now):
      self._count("expired")
      raise sched.DeadlineExceeded(
          "request dead on arrival: its deadline already passed at "
          "submit")
    if self._draining:
      self._count("rejected")
      raise sched.ServingOverloaded(
          "serving engine is draining — admission is closed",
          queue_depth=len(self._queue),
          queued_tokens=self._queue.token_mass,
          retry_after=self._retry_after(self._queue.token_mass),
          draining=True)
    if self._loop_error is not None:
      raise RuntimeError("serving loop died") from self._loop_error
    with self._lock:
      self._requests[req.rid] = req
    try:
      self._queue.push_bounded(req, self.max_queue, self.max_queued_tokens)
    except sched.ServingOverloaded as e:
      with self._lock:
        self._requests.pop(req.rid, None)
      self._count("rejected")
      e.retry_after = self._retry_after(e.queued_tokens)
      raise
    except sched.QueueClosed:
      with self._lock:
        self._requests.pop(req.rid, None)
      if self._loop_error is not None:
        raise RuntimeError("serving loop died") from self._loop_error
      raise RuntimeError("serving engine stopped")
    return req.rid

  def _retry_after(self, queued_tokens: int) -> float:
    """How long until the live decode rate clears the backlog (a bounded
    default while the rate is still cold)."""
    rate = self._tok_rate
    if rate <= 0:
      return round(max(self._poll, _COLD_RETRY_AFTER), 3)
    return round(min(60.0, max(self._poll, queued_tokens / rate)), 3)

  def cancel(self, rid: int, timeout: float) -> bool:
    """Cancel a request: queued -> failed without taking a slot; in
    flight -> its slot frees at the next horizon boundary. Blocks
    (bounded) until the request finished; returns True when it did."""
    req = self._req(rid)
    if req.done.is_set():
      return True
    req.cancelled.set()
    t = self._thread
    if t is None or not t.is_alive():
      self._reap_queue(time.monotonic())
    req.done.wait(timeout=timeout)
    return req.done.is_set()

  def _req(self, rid: int) -> sched.Request:
    with self._lock:
      try:
        return self._requests[rid]
      except KeyError:
        raise KeyError("unknown request id %r" % (rid,))

  def request(self, rid: int) -> sched.Request:
    """The live Request handle (timing fields ride on it). Hold it before
    :meth:`result` or :meth:`poll`, which drop the registry entry."""
    return self._req(rid)

  def poll(self, rid: int) -> Optional[np.ndarray]:
    """The finished output (prompt + generated), or None if in flight."""
    req = self._req(rid)
    if not req.done.is_set():
      return None
    return self._result_of(req)

  def result(self, rid: int, timeout: float = 600.0) -> np.ndarray:
    """Block (bounded) for one request's output (prompt + generated).
    Fails fast, with the loop's root cause, on a dead engine."""
    req = self._req(rid)
    self._wait_done(req, timeout, "request %d" % rid)
    return self._result_of(req)

  def _wait_done(self, req: sched.Request, timeout: float,
                 what: str) -> None:
    deadline = time.monotonic() + timeout
    chunk = max(0.05, self._poll)
    while True:
      remaining = deadline - time.monotonic()
      if req.done.wait(timeout=max(0.0, min(chunk, remaining))):
        return
      self._raise_if_dead(req, what)
      if deadline - time.monotonic() <= 0:
        raise TimeoutError("%s not finished within %.1fs"
                           % (what, timeout))

  def _raise_if_dead(self, req: Optional[sched.Request],
                     what: str) -> None:
    if req is not None and req.done.is_set():
      return
    if self._loop_error is not None:
      raise RuntimeError("serving loop died; %s cannot finish"
                         % what) from self._loop_error
    t = self._thread
    if t is None:
      raise RuntimeError(
          "serving engine was never started — call start() before "
          "waiting on %s" % what)
    if not t.is_alive():
      raise RuntimeError("serving engine is stopped; %s cannot finish"
                         % what)

  def _result_of(self, req: sched.Request) -> np.ndarray:
    with self._lock:
      self._requests.pop(req.rid, None)
    err = req.error
    if isinstance(err, (sched.DeadlineExceeded, sched.RequestCancelled,
                        sched.PoisonedRequest)):
      raise err
    if err is not None:
      raise RuntimeError("request %d failed" % req.rid) from err
    return req.output()

  def stream(self, rid: int, timeout: float = 600.0):
    """Yield generated tokens as they are produced (EOS inclusive); crash
    replays are invisible (the re-emitted prefix is suppressed)."""
    req = self._req(rid)
    deadline = time.monotonic() + timeout
    t0 = time.monotonic()
    emitted = 0
    while True:
      remaining = deadline - time.monotonic()
      if remaining <= 0:
        raise TimeoutError("stream for request %d stalled" % rid)
      try:
        tok = req.stream_q.get(timeout=min(remaining, self._poll * 10))
      except std_queue.Empty:
        self._raise_if_dead(req, "request %d" % rid)
        continue
      if tok is None:
        break
      emitted += 1
      yield tok
    if self._rec is not None:
      # the delivery phase of the waterfall: stream attach → sentinel
      self._rec.record_span("serve.stream", t0, time.monotonic() - t0,
                            trace=req.trace_id, rid=rid, tokens=emitted)
    with self._lock:
      self._requests.pop(rid, None)
    err = req.error
    if isinstance(err, (sched.DeadlineExceeded, sched.RequestCancelled,
                        sched.PoisonedRequest)):
      raise err
    if err is not None:
      raise RuntimeError("request %d failed after %d token(s)"
                         % (rid, emitted)) from err

  def generate(self, prompts: Sequence,
               max_new_tokens: Optional[int] = None,
               timeout: float = 600.0, detailed: bool = False) -> List:
    """Submit a batch of prompts and wait for all outputs (in order). A
    mid-list rejection cancels the already-submitted prefix first.
    ``detailed=True`` returns ``{"tokens", "trace_id", "timing"}`` per
    prompt: the request's timing ledger (``Request.timing``)."""
    rids = []
    try:
      for p in prompts:
        rids.append(self.submit(p, max_new_tokens=max_new_tokens))
    except BaseException:
      for rid in rids:
        with contextlib.suppress(Exception):
          self.cancel(rid, timeout=1.0)
      raise
    deadline = time.monotonic() + timeout
    outs = []
    for rid in rids:
      req = self._req(rid)      # hold the handle: result() pops the map
      out = self.result(rid, timeout=max(0.001,
                                         deadline - time.monotonic()))
      outs.append({"tokens": out, "trace_id": req.trace_id,
                   "timing": req.timing()} if detailed else out)
    return outs

  @property
  def alive(self) -> bool:
    """False once the engine is terminally dead or stopped."""
    if self._loop_error is not None:
      return False
    t = self._thread
    return t is None or t.is_alive()

  # -- engine loop ----------------------------------------------------------

  def _loop(self) -> None:
    # inference mode is thread-local: the loop thread enters its own
    with torch.inference_mode():
      while not self._stop_evt.is_set():
        try:
          self._ensure_slabs()             # rebuilt after a crash
          self._reap()
          self._admit()
          if not any(r is not None for r in self._slots):
            self._queue.wait_nonempty(timeout=self._poll)
            continue
          self._decode_once()
          self._crash_streak = 0           # a full decode pass = healthy
        except BaseException as e:  # noqa: BLE001 - crash-replay recovery;
          # terminal failures are forwarded to every waiter by _die
          if not self._recover(e):
            return

  # -- crash-replay recovery -------------------------------------------------

  def _recover(self, error: BaseException) -> bool:
    """Heal from a loop crash: rebuild the slab and replay every in-flight
    request from its prompt. Returns False when the engine must die
    instead (stopping, or the consecutive-restart budget is spent)."""
    if self._stop_evt.is_set():
      return False
    t_crash = time.monotonic()
    self._crash_streak += 1
    streak = self._crash_streak
    if streak > self.max_restarts:
      logger.exception("serving loop died terminally (%d consecutive "
                       "crashes > max_restarts=%d)",
                       streak, self.max_restarts)
      self._die(error)
      return False
    logger.warning("serving loop crashed (consecutive crash %d/%d), "
                   "recovering: %r", streak, self.max_restarts, error)
    self._count("engine_restarts")
    with self._lock:
      victims = [r for r in self._slots if r is not None]
      self._slots = [None] * self.num_slots
      adm, self._admitting = self._admitting, None
    if adm is not None:
      victims.append(adm)
    self._last[:] = self.pad_id
    # the crash took the slab's pages with it: allocator, prefix trie and
    # per-request page lists rebuild with the slab
    self._drop_slabs()
    # blame: a crash during admission implicates exactly the request
    # being prefilled; a crash mid-decode implicates every lane
    for req in victims:
      if adm is None or req is adm:
        req.crash_count += 1
    now = time.monotonic()
    replay: List[sched.Request] = []
    poisoned = 0
    for req in victims:
      if req.done.is_set():
        continue
      if req.cancelled.is_set():
        self._count("cancelled")
        req.finish(sched.RequestCancelled(
            "request %d cancelled" % req.rid))
        continue
      if req.expired(now):
        self._count("expired")
        req.finish(sched.DeadlineExceeded(
            "request %d deadline passed during crash recovery" % req.rid))
        continue
      if req.crash_count >= self.poison_crashes:
        poisoned += 1
        self._count("poisoned")
        err = sched.PoisonedRequest(
            "request %d was in flight across %d consecutive engine "
            "crashes — failed, not replayed" % (req.rid, req.crash_count))
        err.__cause__ = error
        req.finish(err)
        continue
      replay.append(req)
    try:
      for req in reversed(replay):        # original order, ahead of backlog
        req.begin_replay()
        self._queue.push_front(req)
    except sched.QueueClosed:
      err = RuntimeError("serving engine stopped")
      for req in replay:
        req.finish(err)
      return False
    if replay:
      self._count("replays", len(replay))
      if self._rec is not None:
        for req in replay:
          # the crash-replay suppression window on the request's trace
          self._rec.event("serve.replay", trace=req.trace_id,
                          rid=req.rid, suppressed=len(req.tokens),
                          streak=streak)
    if poisoned:
      # removing the suspected cause IS progress
      self._crash_streak = 0
    backoff = min(_BACKOFF_CAP,
                  self.restart_backoff * (2 ** (streak - 1)))
    if backoff > 0:
      self._stop_evt.wait(backoff)         # interruptible by stop()
    self.restart_log.append(
        {"t": t_crash, "duration_s": time.monotonic() - t_crash,
         "replayed": len(replay), "poisoned": poisoned, "streak": streak,
         "error": repr(error)[:200]})
    del self.restart_log[:-_RESTART_LOG_CAP]
    if self._rec is not None:
      self._rec.event("serve.restart", replayed=len(replay),
                      poisoned=poisoned, streak=streak)
    return True

  def _die(self, error: BaseException) -> None:
    """Terminal loop death: mark the root cause, then fail every waiter
    — queued, in flight, and mid-admission."""
    self._loop_error = error
    for req in self._queue.close(error):
      req.finish(error)
    with self._lock:
      live = [r for r in self._slots if r is not None]
      self._slots = [None] * self.num_slots
      adm, self._admitting = self._admitting, None
    if adm is not None:
      live.append(adm)
    for req in live:
      req.finish(error)

  # -- reaping (deadlines & cancellation) ------------------------------------

  def _reap(self) -> None:
    """Fail expired/cancelled requests: queued ones without ever taking
    a slot, in-flight ones by freeing their slot at this boundary."""
    now = time.monotonic()
    self._reap_queue(now)
    freed = []
    for slot in range(self.num_slots):
      req = self._slots[slot]
      if req is None:
        continue
      if not (req.cancelled.is_set() or req.expired(now)):
        continue
      self._fail_reaped(req, now)
      with self._lock:
        self._slots[slot] = None
      self._last[slot] = self.pad_id
      if self.decoder.paged:
        self._release_pages(req.rid)
        freed.append(slot)
    self._reset_freed(freed)

  def _reset_freed(self, freed: List[int]) -> None:
    """Point freed slots' page tables at the trash page BEFORE the next
    decode dispatch: a freed lane keeps computing (frozen), and its stale
    table would otherwise write into pages the allocator may already have
    handed to a new request."""
    if not freed:
      return
    mask = np.zeros((self.num_slots,), bool)
    mask[freed] = True
    self.decoder.reset_slots(self._slabs, mask)

  def _reap_queue(self, now: float) -> None:
    for req in self._queue.reap(
        lambda r: r.cancelled.is_set() or r.expired(now)):
      self._fail_reaped(req, now)

  def _fail_reaped(self, req: sched.Request, now: float) -> None:
    if req.cancelled.is_set():
      self._count("cancelled")
      req.finish(sched.RequestCancelled(
          "request %d cancelled" % req.rid))
    else:
      self._count("expired")
      req.finish(sched.DeadlineExceeded(
          "request %d missed its deadline by %.3fs"
          % (req.rid, now - (req.deadline or now))))

  # -- admission -------------------------------------------------------------

  def _alloc_pages(self, req: sched.Request):
    """Page in one request: ``(all pages in token order, shared token
    count)``, or None when the pool cannot host it right now (the caller
    requeues; completions free pages).

    Prefix-cache hits fork read-only references to the prefix's FULL
    pages (pinned before any eviction can free them); the divergence page
    and the tail and budget pages are fresh private allocations. A full
    pool shrinks the prefix cache LRU-first before giving up.
    """
    plen = len(req.prompt)
    shared = []
    if self._prefix is not None:
      hit = self._prefix.lookup(req.prompt)
      # always leave >= 1 tail token: the last prompt token must run
      # through the model to yield the first token, and the divergence
      # page is never shared (the copy-on-write boundary)
      shared = hit[:min(len(hit), (plen - 1) // self.page_size)]
      for p in shared:               # pin BEFORE eviction can free them
        self._pool.ref(p)
    need = -(-(plen + req.max_new_tokens) // self.page_size) - len(shared)
    fresh = self._pool.alloc(need)
    while fresh is None and self._prefix is not None \
        and self._prefix.pages_held > 0:
      # evict the whole deficit in one trie walk; stop once a round frees
      # nothing (every evicted page still held by live readers)
      if self._evict_prefix(need - self._pool.free_pages) == 0:
        break
      fresh = self._pool.alloc(need)
    if fresh is None:
      for p in shared:
        self._pool.unref(p)
      return None
    return shared + fresh, len(shared) * self.page_size

  def _evict_prefix(self, n: int) -> int:
    """Evict up to ``n`` LRU prefix pages; returns how many came FREE (a
    page still held by live readers leaves the cache but stays allocated
    until its last ref drops)."""
    freed = 0
    for p in self._prefix.evict(max(1, n)):
      self._count("prefix_evictions")
      freed += bool(self._pool.unref(p))
    return freed

  def _release_pages(self, rid: int) -> None:
    """Drop the request's page refs EXACTLY once (pop, then unref: a
    second call for the same rid does nothing; pages shared with the
    prefix cache or other readers stay allocated until their last ref
    drops)."""
    for p in self._req_pages.pop(rid, None) or ():
      self._pool.unref(p)

  def _admit(self) -> None:
    """Prefill queued requests into free slots (EOS-freed or virgin)."""
    for slot in range(self.num_slots):
      if self._slots[slot] is not None:
        continue
      req = None
      while req is None:
        # on_pop marks the request mid-admission atomically with the pop
        req = self._queue.pop_nowait(on_pop=self._mark_admitting)
        if req is None:
          return
        now = time.monotonic()
        if req.cancelled.is_set() or req.expired(now):
          self._fail_reaped(req, now)
          self._admitting = None
          req = None
      pages, shared_tokens, table = None, 0, None
      if self.decoder.paged:
        alloc = self._alloc_pages(req)
        if alloc is None:
          # pool exhausted: requeue AHEAD of the backlog (it was already
          # admitted; the bounds do not apply again) and stop admitting
          # until a completion frees pages
          self._queue.push_front(req)
          self._admitting = None
          return
        pages, shared_tokens = alloc
        table = pages + [0] * (self.decoder.pages_per_slot - len(pages))
      if req.started_at is None:
        req.started_at = time.monotonic()
        if self._rec is not None:
          # the queue-wait phase of the waterfall, at FIRST admission (a
          # crash-replay re-admission is not a client-visible queue wait)
          self._rec.record_span("serve.queue", req.submitted_at,
                                req.started_at - req.submitted_at,
                                trace=req.trace_id, rid=req.rid)
      cm = self._rec.span("serve.prefill", trace=req.trace_id,
                          rid=req.rid, prompt_len=len(req.prompt),
                          slot=slot, shared_tokens=shared_tokens) \
          if self._rec is not None else contextlib.nullcontext()
      with cm:
        resume = None
        if shared_tokens:
          # prefix hit: rebuild the warm row cache from the shared pages
          # and prefill only the tail
          self._count("prefix_hits")
          resume = (self.decoder.gather_pages(self._slabs, table,
                                              shared_tokens), shared_tokens)
        row_cache, first = self.decoder.prefill(
            req.prompt, self.buckets, resume=resume,
            trace=req.trace_id if self._rec is not None
            and self._trace_detail else None)
      if req.prefill_done_at is None:   # replays keep the original stamp
        req.prefill_done_at = time.monotonic()
      self._count("prefills")
      if not req.emit(first):
        self._count("replay_mismatches")
      self._count("emitted_tokens")
      if self._finished(req, first):
        for p in pages or ():    # never inserted: nothing else holds them
          self._pool.unref(p)
        self._complete(req)
        self._admitting = None
        continue                 # slot stays free for the next request
      if self.decoder.paged:
        self.decoder.insert_pages(self._slabs, row_cache, slot, table,
                                  start=shared_tokens)
        if self._prefix is not None:
          # the prompt's full pages become shareable: the cache takes its
          # own ref on each newly cached page, outliving this request;
          # then the LRU budget is enforced
          for p in self._prefix.register(req.prompt, pages):
            self._pool.ref(p)
          over = self._prefix.over_budget
          if over:
            self._evict_prefix(over)
        self._req_pages[req.rid] = pages
      else:
        self.decoder.insert(self._slabs, row_cache, slot)
      with self._lock:
        self._slots[slot] = req
      self._admitting = None
      self._last[slot] = first

  def _mark_admitting(self, req: sched.Request) -> None:
    self._admitting = req

  def _finished(self, req: sched.Request, token: int) -> bool:
    if self.eos_id is not None and int(token) == self.eos_id:
      return True
    return req.generated >= req.max_new_tokens

  def _complete(self, req: sched.Request) -> None:
    self._count("completed")
    req.finish(None)
    if self._obs_q is not None:
      # the request's timing ledger feeds the mergeable latency sketches
      # (completed requests only: a rejected request has no latency)
      q = self._obs_q
      if req.ttft is not None:
        q["ttft_ms"].observe(req.ttft * 1e3)
      if req.tpot is not None:
        q["tpot_ms"].observe(req.tpot * 1e3)
      if req.latency is not None:
        q["e2e_ms"].observe(req.latency * 1e3)
      if req.queue_wait is not None:
        q["queue_wait_ms"].observe(req.queue_wait * 1e3)

  # -- decode ----------------------------------------------------------------

  def _decode_once(self) -> None:
    """One dispatch + host-side harvest: the ``horizon``-step
    :meth:`_decode_plain`, or :meth:`_decode_spec` with ``spec_depth``.
    The device carries each lane's EOS/budget done-mask; the host replays
    the same stop rule over the returned tokens, so the views agree."""
    t0 = time.monotonic()
    tokens_before = self.stats["emitted_tokens"]
    active = np.asarray([r is not None for r in self._slots], bool)
    remaining = np.asarray(
        [0 if r is None else r.max_new_tokens - r.generated
         for r in self._slots], np.int64)
    if self.spec_depth > 0:
      steps, lanes = self._decode_spec(active, remaining)
    else:
      steps, lanes = self._decode_plain(active, remaining)
    dt = time.monotonic() - t0
    emitted = self.stats["emitted_tokens"] - tokens_before
    self._count("decode_s", dt)
    if dt > 0 and emitted:
      # live tokens/s EMA — the denominator of the retry-after hint
      rate = emitted / dt
      self._tok_rate = rate if self._tok_rate <= 0 \
          else 0.5 * self._tok_rate + 0.5 * rate
    if self._rec is not None or self._obs_m is not None:
      self._obs_decode(t0, dt, int(active.sum()), steps, emitted, lanes)

  def _harvest_lanes(self, toks: np.ndarray, counts: np.ndarray):
    """Harvest one dispatch: ``toks[r, j, slot]`` for rounds ``r``, the
    lane valid for its first ``counts[r, slot]`` positions of a round.
    Frees finished slots (and resets their page tables). Returns the
    per-lane ``(slot, trace_id, emitted)`` list for the decode spans
    (built only while the recorder is live)."""
    want_lanes = self._rec is not None and self._trace_detail
    lanes: List[tuple] = []
    freed: List[int] = []
    for slot in range(self.num_slots):
      req = self._slots[slot]
      if req is None:
        continue
      done, emitted, last_tok = False, 0, None
      for r in range(toks.shape[0]):
        for j in range(int(counts[r, slot])):
          last_tok = int(toks[r, j, slot])
          emitted += 1
          if self._harvest(req, last_tok, slot, freed):
            done = True
            break
        if done:
          break
      if not done and last_tok is not None:
        self._last[slot] = last_tok
      if want_lanes:
        lanes.append((slot, req.trace_id, emitted))
    self._reset_freed(freed)
    return lanes

  def _decode_plain(self, active, remaining):
    """The non-speculative horizon (``SlotDecoder.step_many``): one round
    of ``horizon`` positions. Returns ``(steps, lanes)``."""
    toks, _, _ = self.decoder.step_many(self._slabs, self._last, active,
                                        remaining, self.horizon)
    toks = toks.cpu().numpy()[None]           # [1, horizon, num_slots]
    self._count("steps", self.horizon)
    counts = np.full((1, self.num_slots), self.horizon)
    return self.horizon, self._harvest_lanes(toks, counts)

  def _decode_spec(self, active, remaining):
    """The self-speculative dispatch (``SlotDecoder.step_spec``):
    ``counts[r, lane]`` bounds each lane's valid tokens a round (the
    device's accept/EOS/budget verdict); the draft verdicts feed the
    ``spec_accepted`` / ``spec_rejected`` counters. Returns ``(steps,
    lanes)``."""
    k, rounds = self.spec_depth, self._spec_rounds
    toks, counts, acc, rej, _, _ = self.decoder.step_spec(
        self._slabs, self._last, active, remaining, rounds)
    toks = toks.cpu().numpy()          # [rounds, spec_depth, num_slots]
    counts = counts.cpu().numpy()      # [rounds, num_slots]
    # a round's slot-step opportunity is its verify window (k wide):
    # occupancy then reads as the useful-token share, rejections included
    self._count("steps", rounds * k)
    self._count("spec_accepted", int(acc.sum()))
    self._count("spec_rejected", int(rej.sum()))
    return rounds * k, self._harvest_lanes(toks, counts)

  def _obs_decode(self, t0: float, dt: float, active: int, steps: int,
                  emitted: int, lanes: List[tuple]) -> None:
    """One decode dispatch into the obs plane: the ``serve.decode`` span
    and its per-lane ``serve.decode.slot`` children, the token/step
    counters, the dispatch histogram and the load and page gauges.
    ``active`` is the host's count of lanes that entered the dispatch."""
    if self._rec is not None:
      self._rec.record_span("serve.decode", t0, dt, horizon=self.horizon,
                            active=active)
      for slot, trace, tokens in lanes:
        self._rec.record_span("serve.decode.slot", t0, dt, trace=trace,
                              slot=slot, tokens=tokens)
    m = self._obs_m
    if m is not None:
      m["steps"].inc(steps)
      m["tokens"].inc(emitted)
      m["decode_ms"].observe(dt * 1e3)
      m["occupancy"].set(self.occupancy)
      m["queue_depth"].set(len(self._queue))
      m["slots_active"].set(sum(1 for r in self._slots if r is not None))
      if self._pool is not None:
        m["kv_pages_in_use"].set(self._pool.in_use)
        m["kv_pages_free"].set(self._pool.free_pages)

  def _harvest(self, req: sched.Request, tok: int, slot: int,
               freed: List[int]) -> bool:
    """Record one emitted token; on the request's stop, free its slot
    (and pages) exactly like EOS. Returns True when the slot freed."""
    if not req.emit(tok):
      self._count("replay_mismatches")
    self._count("emitted_tokens")
    self._count("live_slot_steps")
    if not self._finished(req, tok):
      return False
    with self._lock:
      self._slots[slot] = None
    self._last[slot] = self.pad_id
    if self.decoder.paged:
      # released before the waiter wakes: a caller whose last result has
      # returned reads the pool settled
      self._release_pages(req.rid)
      freed.append(slot)
    self._complete(req)
    return True
