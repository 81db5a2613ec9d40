"""Host side of continuous batching: requests, the admission queue and the
prompt-bucket policy.

The port's own copy of ``tensorflowonspark_tpu/serving/scheduler.py``
(which it may not import): pure bookkeeping, no device work. The engine
thread pops :class:`Request` objects off the :class:`RequestQueue`
whenever a slot frees and prefills them in (``serving.slots``); callers
hold the request handle and wait on its event / stream queue. Every
blocking wait is timeout-bounded. The paged-KV bookkeeping (``PagePool``,
``PrefixCache``) arrives with the paged slice.

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
