"""Host side of continuous batching: requests, the admission queue and the
prompt-bucket policy.

The port's own copy of ``tensorflowonspark_tpu/serving/scheduler.py``
(which it may not import): pure bookkeeping, no device work. The engine
thread pops :class:`Request` objects off the :class:`RequestQueue`
whenever a slot frees and prefills them in (``serving.slots``); callers
hold the request handle and wait on its event / stream queue. Every
blocking wait is timeout-bounded. The paged-KV bookkeeping is here too: the
page allocator (:class:`PagePool`) and the shared-prefix trie
(:class:`PrefixCache`).

The robustness vocabulary:

* :class:`ServingOverloaded` — structured admission rejection (queue
  depth / queued-token mass over the bound, or the engine is draining),
  carrying a ``retry_after`` hint derived from the live decode rate;
* :class:`DeadlineExceeded` — a request's TTL ran out (at submit, while
  queued, or mid-flight at a horizon boundary);
* :class:`RequestCancelled` — the client called ``cancel(rid)``;
* :class:`PoisonedRequest` — the request was in flight across
  ``poison_crashes`` consecutive engine crashes and is failed instead of
  replayed.
"""

import collections
import heapq
import itertools
import os
import queue as std_queue
import threading
import time
import uuid
from typing import List, Optional

import numpy as np

#: comma list overriding the default prefill bucket sizes
#: (``serving.slots.DEFAULT_BUCKETS``)
ENV_SERVE_BUCKETS = "TOS_SERVE_BUCKETS"

_request_ids = itertools.count(1)


def new_trace_id() -> str:
  """A fresh request-scoped trace id (16 hex chars, unique across
  processes), minted once per logical request at submit."""
  return uuid.uuid4().hex[:16]


class ServingOverloaded(RuntimeError):
  """Admission rejected: the queue bound would be exceeded (or the
  engine is draining). ``retry_after`` (seconds, may be None) is derived
  from the engine's live tokens/s rate over the queued token mass."""

  def __init__(self, message: str, queue_depth: int = 0,
               queued_tokens: int = 0, retry_after=None,
               draining: bool = False):
    super().__init__(message)
    self.queue_depth = int(queue_depth)
    self.queued_tokens = int(queued_tokens)
    self.retry_after = retry_after
    self.draining = bool(draining)

  def __reduce__(self):
    # the default Exception reduction replays __init__ with the message
    # alone, which would drop the structured fields the fleet's retry
    # logic keys on across any pickle boundary
    return (type(self), (self.args[0] if self.args else "",
                         self.queue_depth, self.queued_tokens,
                         self.retry_after, self.draining))


class DeadlineExceeded(TimeoutError):
  """The request's deadline/TTL expired before it finished."""

  def __reduce__(self):
    return (type(self), tuple(self.args))


class RequestCancelled(RuntimeError):
  """The client cancelled the request (``ServingEngine.cancel``)."""

  def __reduce__(self):
    return (type(self), tuple(self.args))


class PoisonedRequest(RuntimeError):
  """Failed instead of replayed: the request was in flight across N
  consecutive engine crashes (the crash-loop breaker)."""

  def __reduce__(self):
    return (type(self), tuple(self.args))


class QueueClosed(RuntimeError):
  """Internal: push on a closed queue (engine stopped or loop dead).
  Carries the closing cause so submit can fail fast with the root."""


class Request(object):
  """One in-flight generation request.

  ``tokens`` accumulates generated ids (EOS inclusive, never pad);
  ``done`` fires when the request finishes or fails; ``stream_q``
  receives each token as it is emitted, then a ``None`` sentinel.
  ``deadline`` is an absolute ``time.monotonic()`` bound (None = no
  deadline); ``cancelled`` is the client-side cancellation flag the
  engine loop reaps; ``crash_count`` counts engine crashes this request
  was blamed for (poison detection).

  The timing ledger (all ``time.monotonic``): ``submitted_at``,
  ``started_at`` (admitted to a slot), ``prefill_done_at``,
  ``first_token_at`` and ``finished_at``, plus the derived :attr:`ttft`
  and :attr:`latency`. A crash replay regenerates already-delivered
  positions but never resets ``first_token_at``.
  """

  __slots__ = ("rid", "prompt", "max_new_tokens", "tokens", "done",
               "stream_q", "error", "submitted_at", "started_at",
               "prefill_done_at", "first_token_at",
               "finished_at", "deadline", "cancelled", "crash_count",
               "replays", "trace_id", "_suppress")

  def __init__(self, prompt, max_new_tokens: int, deadline=None,
               trace_id: Optional[str] = None):
    self.rid = next(_request_ids)
    self.prompt = np.asarray(prompt, np.int32).ravel()
    self.max_new_tokens = int(max_new_tokens)
    self.tokens: List[int] = []
    self.done = threading.Event()
    self.stream_q: std_queue.Queue = std_queue.Queue()
    self.error: Optional[BaseException] = None
    self.submitted_at = time.monotonic()
    self.started_at: Optional[float] = None
    self.prefill_done_at: Optional[float] = None
    self.first_token_at: Optional[float] = None
    self.finished_at: Optional[float] = None
    self.deadline = None if deadline is None else float(deadline)
    self.cancelled = threading.Event()
    self.crash_count = 0
    #: crash replays this request rode
    self.replays = 0
    self.trace_id = trace_id if trace_id is not None else new_trace_id()
    # crash-replay suppression: how many upcoming emits regenerate
    # already-delivered positions (greedy => bit-identical) and must not
    # reach tokens/stream a second time
    self._suppress = 0

  @property
  def token_cost(self) -> int:
    """Worst-case token mass this request puts on the engine (prompt to
    prefill + budget to decode) — the unit of the queued-token bound."""
    return len(self.prompt) + self.max_new_tokens

  @property
  def generated(self) -> int:
    """Tokens generated in the CURRENT engine incarnation (``len(tokens)``
    except mid-replay, where recorded tokens are being regenerated)."""
    return len(self.tokens) - self._suppress

  def expired(self, now: Optional[float] = None) -> bool:
    if self.deadline is None:
      return False
    return (time.monotonic() if now is None else now) >= self.deadline

  def begin_replay(self) -> None:
    """Arm suppression for a crash replay: the next ``len(tokens)``
    emits re-derive positions the client already holds."""
    self._suppress = len(self.tokens)
    self.replays += 1

  def emit(self, token: int) -> bool:
    """Record one generated token. Returns replay parity: False when a
    suppressed (replayed) emit disagrees with the recorded token."""
    token = int(token)
    if self.first_token_at is None:
      self.first_token_at = time.monotonic()
    if self._suppress:
      idx = len(self.tokens) - self._suppress
      self._suppress -= 1
      return self.tokens[idx] == token
    self.tokens.append(token)
    self.stream_q.put_nowait(token)        # unbounded: never blocks
    return True

  def finish(self, error: Optional[BaseException] = None) -> None:
    """Idempotent: the first verdict (and one stream sentinel) wins."""
    if self.done.is_set():
      return
    self.error = error
    self.finished_at = time.monotonic()
    self.stream_q.put_nowait(None)         # unbounded: never blocks
    self.done.set()

  @property
  def latency(self) -> Optional[float]:
    if self.finished_at is None:
      return None
    return self.finished_at - self.submitted_at

  @property
  def ttft(self) -> Optional[float]:
    """Time to first token (seconds since submit; None before it)."""
    if self.first_token_at is None:
      return None
    return self.first_token_at - self.submitted_at

  @property
  def queue_wait(self) -> Optional[float]:
    """Submit → admitted-to-a-slot wait (None while still queued)."""
    if self.started_at is None:
      return None
    return self.started_at - self.submitted_at

  @property
  def tpot(self) -> Optional[float]:
    """Per-output-token time: decode seconds per generated token past
    the first (None until finished with >= 2 tokens)."""
    if self.finished_at is None or self.first_token_at is None:
      return None
    n = len(self.tokens) - 1
    if n < 1:
      return None
    return (self.finished_at - self.first_token_at) / n

  def timing(self) -> dict:
    """The timing ledger as one plain dict (``generate(detailed=True)``
    reads it): raw ``time.monotonic`` stamps and derived seconds."""
    return {"trace_id": self.trace_id, "rid": self.rid,
            "submitted": self.submitted_at, "admitted": self.started_at,
            "prefill_done": self.prefill_done_at,
            "first_token": self.first_token_at,
            "finished": self.finished_at,
            "ttft": self.ttft, "e2e": self.latency,
            "queue_wait": self.queue_wait, "tpot": self.tpot,
            "generated": len(self.tokens), "replays": self.replays}

  def output(self) -> np.ndarray:
    """prompt + generated tokens (EOS inclusive, no padding)."""
    return np.concatenate(
        [self.prompt, np.asarray(self.tokens, np.int32)])


def buckets_from_env(default):
  """The prefill bucket set: ``TOS_SERVE_BUCKETS`` (comma ints) or
  ``default``."""
  raw = os.environ.get(ENV_SERVE_BUCKETS, "").strip()
  if not raw:
    return tuple(default)
  try:
    sizes = tuple(int(p) for p in raw.split(",") if p.strip())
  except ValueError:
    raise ValueError("%s must be a comma list of ints, got %r"
                     % (ENV_SERVE_BUCKETS, raw))
  if not sizes or min(sizes) < 1:
    raise ValueError("%s must name positive chunk sizes, got %r"
                     % (ENV_SERVE_BUCKETS, raw))
  return sizes


class PagePool(object):
  """Ref-counted free-list allocator over a paged KV slab's page pool.

  Page 0 is the reserved TRASH page (frozen-lane writes and unused
  page-table entries land there) and is never allocated. ``alloc`` is
  all-or-nothing: a request either gets every page its prompt+budget
  token mass needs or waits in the queue for completions to free pages.
  Sharing (the prefix cache, every additional reader of a prefix page)
  rides ``ref``/``unref``; a page rejoins the free list exactly when its
  last ref drops. Engine-loop-thread-only: no locking.
  """

  def __init__(self, num_pages: int):
    if num_pages < 2:
      raise ValueError("PagePool needs num_pages >= 2 (page 0 is the "
                       "reserved trash page), got %d" % num_pages)
    self.num_pages = int(num_pages)
    self._free = collections.deque(range(1, self.num_pages))
    self._refs = [0] * self.num_pages

  @property
  def capacity(self) -> int:
    """Allocatable pages (the pool minus the trash page)."""
    return self.num_pages - 1

  @property
  def free_pages(self) -> int:
    return len(self._free)

  @property
  def in_use(self) -> int:
    return self.capacity - len(self._free)

  def alloc(self, n: int) -> Optional[List[int]]:
    """``n`` fresh pages (each at refcount 1), or None if the pool
    cannot satisfy the whole request right now (all-or-nothing: partial
    grants would deadlock two half-admitted requests against each
    other)."""
    if n < 0:
      raise ValueError("alloc count must be >= 0, got %d" % n)
    if n > len(self._free):
      return None
    pages = [self._free.popleft() for _ in range(n)]
    for p in pages:
      self._refs[p] = 1
    return pages

  def ref(self, page: int) -> None:
    """One more holder of an allocated page (prefix sharing)."""
    if self._refs[page] <= 0:
      raise ValueError("ref on free page %d" % page)
    self._refs[page] += 1

  def unref(self, page: int) -> bool:
    """Drop one ref; returns True when this freed the page. Raises on a
    double free — page accounting bugs must be loud, not leaks."""
    r = self._refs[page]
    if page <= 0 or r <= 0:
      raise ValueError("unref of free/trash page %d (double free?)"
                       % page)
    self._refs[page] = r - 1
    if r == 1:
      self._free.append(page)
      return True
    return False


class PrefixCache(object):
  """Host-side radix trie over prompt-token prefixes, page-granular.

  Each trie node caches ONE full page of a prompt: the tuple of
  ``page_size`` tokens it covers maps to the pool page holding their KV.
  Lookup walks a prompt's full-page chunks and returns the longest
  cached run; a hit means those tokens are never re-prefilled — the
  engine gathers the pages into a warm row cache and prefills only the
  tail. Only FULL pages are cached/shared: the divergence page (the
  prompt's partial last page, where requests write their own tails) is
  always private, which is copy-on-write at page granularity with the
  copy replaced by a ≤ page_size-token recompute.

  The cache holds one pool ref per cached page (taken by the engine via
  ``PagePool.ref`` on ``register``), so cached prefixes survive their
  originating request. Eviction is LRU over leaf nodes, bounded by
  ``max_pages`` (``TOS_SERVE_PREFIX_PAGES``); evicted pages are returned
  for the engine to unref. Engine-loop-thread-only: no locking.
  """

  def __init__(self, page_size: int, max_pages: int):
    if page_size < 1:
      raise ValueError("page_size must be >= 1, got %d" % page_size)
    self.page_size = int(page_size)
    self.max_pages = int(max_pages)
    self._root: dict = {}       # chunk tuple -> node
    self._clock = 0
    self.pages_held = 0

  def _chunks(self, prompt):
    ps = self.page_size
    full = len(prompt) // ps
    return [tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            for i in range(full)]

  def lookup(self, prompt) -> List[int]:
    """Pool pages for the longest cached full-page prefix of ``prompt``
    (possibly empty). Touches the matched path's LRU stamps; the caller
    refs each returned page before using it."""
    self._clock += 1
    pages, children = [], self._root
    for chunk in self._chunks(prompt):
      node = children.get(chunk)
      if node is None:
        break
      node["stamp"] = self._clock
      pages.append(node["page"])
      children = node["children"]
    return pages

  def register(self, prompt, page_ids) -> List[int]:
    """Cache ``prompt``'s full pages (``page_ids[i]`` holds tokens
    ``[i·page_size, (i+1)·page_size)``). Chunks already cached keep
    their existing page; new chunks take the request's page. Returns the
    NEWLY cached pages — the caller must take a pool ref on each (the
    cache's own ref, outliving the registering request)."""
    self._clock += 1
    new, children = [], self._root
    for i, chunk in enumerate(self._chunks(prompt)):
      node = children.get(chunk)
      if node is None:
        node = children[chunk] = {"page": int(page_ids[i]),
                                  "children": {}, "stamp": self._clock}
        new.append(node["page"])
        self.pages_held += 1
      else:
        node["stamp"] = self._clock
      children = node["children"]
    return new

  def _leaves(self, children):
    for chunk, node in children.items():
      if node["children"]:
        for leaf in self._leaves(node["children"]):
          yield leaf
      else:
        yield node["stamp"], children, chunk, node

  def evict(self, count: int = 1) -> List[int]:
    """Drop up to ``count`` least-recently-used LEAF pages (a shared
    interior page cannot go while a longer cached prefix still rides
    through it). Returns the released pages for the caller to unref.

    One trie walk evicts a whole batch of current leaves in LRU order;
    only when the batch is spent (deleting leaves exposed parents as
    NEW leaves) does it re-enumerate — so evicting E pages costs
    O(depth) walks, not E of them (eviction runs on the admission path
    whenever the pool is tight, the cache's steady state)."""
    released = []
    while len(released) < count:
      batch = heapq.nsmallest(count - len(released),
                              self._leaves(self._root),
                              key=lambda x: x[0])
      if not batch:
        break
      for _, children, chunk, node in batch:
        del children[chunk]
        self.pages_held -= 1
        released.append(node["page"])
    return released

  @property
  def over_budget(self) -> int:
    """How many pages past ``max_pages`` the cache currently holds."""
    return max(0, self.pages_held - self.max_pages)


class RequestQueue(object):
  """Thread-safe FIFO of pending requests with bounded waits, bounded
  admission, and a closed state.

  * ``push_bounded`` enforces the request-count AND queued-token-mass
    bounds (``ServingOverloaded``); an oversized request is still
    admitted when the queue is empty (the bound is about backlog).
  * ``close(error)`` atomically (under the one lock ``push`` uses)
    marks the queue dead and returns the drained backlog: a push lands
    before or after the close, never between the dying loop's drain and
    its error mark.
  * ``push_front`` re-queues crash-replay requests ahead of the backlog
    (they were already admitted; bounds don't re-apply).
  """

  def __init__(self):
    self._items = collections.deque()
    self._cond = threading.Condition()
    self._tokens = 0                       # queued token mass
    self._closed: Optional[BaseException] = None

  def _check_open_locked(self):
    if self._closed is not None:
      raise QueueClosed("request queue is closed") from self._closed

  def push_front(self, request: Request) -> None:
    """Replay re-queue: ahead of the backlog, exempt from bounds."""
    with self._cond:
      self._check_open_locked()
      self._items.appendleft(request)
      self._tokens += request.token_cost
      self._cond.notify_all()

  def push_bounded(self, request: Request, max_requests: int = 0,
                   max_tokens: int = 0) -> None:
    """Admit under the bounds (0 disables a bound) or raise
    :class:`ServingOverloaded` / :class:`QueueClosed`."""
    with self._cond:
      self._check_open_locked()
      depth, tokens = len(self._items), self._tokens
      if max_requests and depth >= max_requests:
        raise ServingOverloaded(
            "serving queue full: %d queued request(s) at the "
            "TOS_SERVE_MAX_QUEUE=%d bound" % (depth, max_requests),
            queue_depth=depth, queued_tokens=tokens)
      if max_tokens and self._items and \
          tokens + request.token_cost > max_tokens:
        raise ServingOverloaded(
            "serving queue full: %d queued tokens + %d for this request "
            "exceeds the TOS_SERVE_MAX_QUEUED_TOKENS=%d bound"
            % (tokens, request.token_cost, max_tokens),
            queue_depth=depth, queued_tokens=tokens)
      self._items.append(request)
      self._tokens += request.token_cost
      self._cond.notify_all()

  def pop_nowait(self, on_pop=None) -> Optional[Request]:
    """Pop the head; ``on_pop(req)`` runs UNDER the queue lock — the
    engine uses it to mark the request as mid-admission atomically with
    the pop, so a drain checking queue-then-admitting never observes the
    gap between the two."""
    with self._cond:
      if self._items:
        req = self._items.popleft()
        self._tokens -= req.token_cost
        if on_pop is not None:
          on_pop(req)
        return req
      return None

  def reap(self, pred) -> List[Request]:
    """Remove (and return) every queued request matching ``pred``."""
    with self._cond:
      kept, removed = collections.deque(), []
      for req in self._items:
        if pred(req):
          removed.append(req)
          self._tokens -= req.token_cost
        else:
          kept.append(req)
      self._items = kept
      return removed

  def wait_nonempty(self, timeout: float) -> bool:
    """Block (bounded) until at least one request is queued."""
    with self._cond:
      if self._items:
        return True
      self._cond.wait(timeout=timeout)
      return bool(self._items)

  def close(self, error: BaseException) -> List[Request]:
    """Mark closed and return the drained backlog, atomically. A queue
    closed with an earlier error stays closed with THAT error."""
    with self._cond:
      if self._closed is None:
        self._closed = error
      items = list(self._items)
      self._items.clear()
      self._tokens = 0
      self._cond.notify_all()
      return items

  def reopen(self) -> None:
    with self._cond:
      self._closed = None

  @property
  def token_mass(self) -> int:
    with self._cond:
      return self._tokens

  def __len__(self) -> int:
    with self._cond:
      return len(self._items)
