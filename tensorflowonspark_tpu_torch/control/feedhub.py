"""Per-executor feed hub: queues + key-value state shared across processes.

The port's copy of ``tensorflowonspark_tpu/control/feedhub.py``. Capability
parity with TensorFlowOnSpark's ``TFManager.py``: a
``multiprocessing.managers.BaseManager`` exposing named joinable queues and a
key-value store, started in ``'local'`` mode for workers (loopback only) or
``'remote'`` mode for ps/evaluator nodes so the driver can reach them across
the network (TFManager.py:40-65). The state machine lives under key
``'state'``: ``'running' → 'terminating' → 'stopped'``.

Accelerator-first redesign: TensorFlowOnSpark moved one pickled row per
proxy round-trip (TFSparkNode.py:500-502 / TFNode.py:276-300) — two IPC
hops per row, which would starve an accelerator. The hub therefore exposes **batch transfer**
(``put_many`` / ``get_many``) so the feeder pushes whole chunks and the
training process pops up to a full batch per round-trip, while preserving the
exact queue semantics the DataFeed API depends on: blocking ``put``,
``task_done``/``join`` backpressure, ``None`` end-of-feed and ``EndPartition``
markers as in-band items.
"""

import collections
import logging
import os
import socket
import threading
import time
from multiprocessing import connection as _mpconn
from multiprocessing.managers import BaseManager
from typing import Dict, List, Optional, Sequence, Tuple

from tensorflowonspark_tpu_torch.control.marker import Marker

logger = logging.getLogger(__name__)


def _sock_nodelay(conn) -> None:
  """Disable Nagle on a live manager connection.

  CPython's ``Connection._send_bytes`` writes the length header and the
  body as TWO separate ``send()`` calls for payloads over 16 KiB; with
  Nagle on, that interacts with the peer's delayed ACK into an ~40 ms
  stall per message EACH WAY for mid-size (16–64 KiB) payloads —
  exactly where wire-encoded chunk envelopes land (measured: 88 ms per
  put+get round trip vs 0.4 ms just above 64 KiB). Socket options stick
  to the underlying socket, so setting them through a dup'd fd covers
  the Connection's own handle. Non-TCP transports raise and are left
  untouched.
  """
  try:
    s = socket.fromfd(conn.fileno(), socket.AF_INET, socket.SOCK_STREAM)
    try:
      s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    finally:
      s.close()
  except (OSError, ValueError):  # tosa: ignore[TOS004] - non-TCP transport
    pass


_nodelay_installed = False


def _install_nodelay() -> None:
  """Patch ``multiprocessing.connection`` so every manager socket this
  process dials or accepts runs with TCP_NODELAY (idempotent; called on
  the server via ``_init_server`` and on clients via start/connect —
  proxies dial lazily per thread, so per-call hooks cannot cover them)."""
  global _nodelay_installed
  if _nodelay_installed:
    return
  _nodelay_installed = True
  orig_client = _mpconn.SocketClient

  def _client_nodelay(address):
    c = orig_client(address)
    _sock_nodelay(c)
    return c

  _mpconn.SocketClient = _client_nodelay
  orig_accept = _mpconn.SocketListener.accept

  def _accept_nodelay(self):
    c = orig_accept(self)
    _sock_nodelay(c)
    return c

  _mpconn.SocketListener.accept = _accept_nodelay


class ChunkEnvelope(object):
  """A codec-encoded feed chunk traveling the hub queue as ONE item.

  ``n`` rows ride inside ``payload`` (control/chunkcodec.py bytes); the
  queue's bound and unfinished-task counter both weigh the envelope as
  ``n`` rows, so backpressure and ``join`` semantics are identical to
  the same rows enqueued individually — but the manager round-trip moves
  one bytes object instead of pickling every row."""

  __slots__ = ("n", "payload")

  def __init__(self, n: int, payload: bytes):
    self.n = n
    self.payload = payload

  def __reduce__(self):
    return (ChunkEnvelope, (self.n, self.payload))


def _item_weight(item) -> int:
  return item.n if isinstance(item, ChunkEnvelope) else 1


class FeedQueue(object):
  """A joinable, bounded, batch-aware queue (thread-safe).

  Semantics match ``multiprocessing.JoinableQueue``: every item put increments
  an unfinished-task counter which ``task_done`` decrements; ``join`` blocks
  until it reaches zero. Adds ``put_many``/``get_many`` so a whole chunk moves
  per manager round-trip, and ``put_chunk``/``get_chunk`` so a chunk moves as
  ONE :class:`ChunkEnvelope` item (weighted as its row count) with markers
  delivered as chunk-boundary envelopes.
  """

  def __init__(self, maxsize: int = 0):
    self._maxsize = maxsize
    self._items = collections.deque()
    self._size = 0          # weighted length: envelopes count their rows
    self._cond = threading.Condition()
    self._unfinished = 0

  def _has_room(self, n: int) -> bool:
    return self._maxsize <= 0 or self._size + n <= self._maxsize

  def put(self, item, block: bool = True, timeout: Optional[float] = None):
    self.put_many([item], block=block, timeout=timeout)

  def put_many(self, items: Sequence, block: bool = True,
               timeout: Optional[float] = None) -> None:
    """Enqueue items, spilling chunks larger than ``maxsize`` in pieces.

    A blocking put of a chunk bigger than the queue bound must not deadlock:
    admit whatever fits (at least one item at a time) and keep going as the
    consumer drains. Non-blocking puts are all-or-nothing: if the whole
    chunk cannot be admitted immediately, nothing is enqueued. A timed-out
    blocking put raises :class:`QueueFull` with ``.admitted`` set to the
    number of items already enqueued, so callers can avoid re-feeding them.
    """
    items = list(items)
    deadline = None if timeout is None else time.monotonic() + timeout
    pos = 0
    with self._cond:
      if not block and not self._has_room(len(items)):
        raise QueueFull(0)
      while pos < len(items):
        room = (len(items) - pos if self._maxsize <= 0
                else self._maxsize - self._size)
        if room <= 0:
          if not block:
            raise QueueFull(pos)
          remaining = None if deadline is None else deadline - time.monotonic()
          if remaining is not None and remaining <= 0:
            raise QueueFull(pos)
          self._cond.wait(remaining if remaining is not None else 1.0)
          continue
        chunk = items[pos:pos + room]
        self._items.extend(chunk)
        weight = sum(_item_weight(it) for it in chunk)
        self._size += weight
        self._unfinished += weight
        pos += len(chunk)
        self._cond.notify_all()

  def get(self, block: bool = True, timeout: Optional[float] = None):
    got = self.get_many(1, block=block, timeout=timeout)
    if not got:
      raise QueueEmpty()
    return got[0]

  def get_many(self, max_items: int, block: bool = True,
               timeout: Optional[float] = None) -> List:
    """Pop up to ``max_items``; blocks for at least one item when ``block``.

    Stops early at a control marker boundary is NOT done here — marker
    interpretation belongs to the DataFeed layer; this is a plain queue.
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    with self._cond:
      while not self._items:
        if not block:
          return []
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
          return []
        self._cond.wait(remaining if remaining is not None else 1.0)
      out = []
      while self._items and len(out) < max_items:
        item = self._items.popleft()
        self._size -= _item_weight(item)
        out.append(item)
      self._cond.notify_all()
      return out

  # -- chunk-granular delivery ----------------------------------------------

  def put_chunk(self, n: int, payload: bytes, block: bool = True,
                timeout: Optional[float] = None) -> None:
    """Enqueue one codec-encoded chunk of ``n`` rows as a single envelope.

    The envelope is atomic (it cannot spill in pieces): admission waits
    for ``n`` rows of room, or for the queue to be empty — so a chunk
    larger than the whole bound still streams through alone instead of
    deadlocking. Weighted exactly like ``n`` individual rows for both the
    bound and the ``join`` counter.
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    with self._cond:
      while not (self._has_room(n) or self._size == 0):
        if not block:
          raise QueueFull(0)
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
          raise QueueFull(0)
        self._cond.wait(remaining if remaining is not None else 1.0)
      self._items.append(ChunkEnvelope(n, payload))
      self._size += n
      self._unfinished += n
      self._cond.notify_all()

  def get_chunk(self, max_rows: int = 1024, block: bool = True,
                timeout: Optional[float] = None):
    """Pop ONE chunk-boundary unit; ``None`` on timeout.

    Returns a wire tuple (the caller acks with ``task_done(weight)``):

    - ``("enc", n, payload)`` — one codec-encoded envelope (weight n);
    - ``("marker", m)`` — an end-of-feed ``None`` or a ``Marker``
      instance, always delivered alone at a chunk boundary (weight 1);
    - ``("rows", [..])`` — contiguous legacy raw rows, gathered up to
      ``max_rows`` and stopping BEFORE any envelope/marker (weight =
      row count).
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    with self._cond:
      while not self._items:
        if not block:
          return None
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
          return None
        self._cond.wait(remaining if remaining is not None else 1.0)
      head = self._items[0]
      if isinstance(head, ChunkEnvelope):
        self._items.popleft()
        self._size -= head.n
        self._cond.notify_all()
        return ("enc", head.n, head.payload)
      if head is None or isinstance(head, Marker):
        self._items.popleft()
        self._size -= 1
        self._cond.notify_all()
        return ("marker", head)
      out = []
      while self._items and len(out) < max_rows:
        item = self._items[0]
        if isinstance(item, ChunkEnvelope) or item is None \
            or isinstance(item, Marker):
          break
        out.append(self._items.popleft())
        self._size -= 1
      self._cond.notify_all()
      return ("rows", out)

  def task_done(self, n: int = 1) -> None:
    with self._cond:
      if n > self._unfinished:
        raise ValueError("task_done(%d) called with only %d unfinished" %
                         (n, self._unfinished))
      self._unfinished -= n
      self._cond.notify_all()

  def join(self, timeout: Optional[float] = None) -> bool:
    """Block until all items have been processed; True if drained."""
    deadline = None if timeout is None else time.monotonic() + timeout
    with self._cond:
      while self._unfinished > 0:
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
          return False
        self._cond.wait(remaining if remaining is not None else 1.0)
      return True

  def qsize(self) -> int:
    """Pending ROWS (envelopes weigh their row count), not deque entries."""
    with self._cond:
      return self._size

  def empty(self) -> bool:
    return self.qsize() == 0


class QueueFull(Exception):
  """Raised when a put cannot complete; ``admitted`` counts items that were
  already enqueued before the failure (0 for non-blocking puts)."""

  def __init__(self, admitted: int = 0):
    super().__init__("queue full (admitted=%d)" % admitted)
    self.admitted = admitted

  def __reduce__(self):
    # BaseManager proxies pickle server-side exceptions back to the caller;
    # the default Exception reduction replays __init__ with the formatted
    # message string, which "%d" rejects — clients then saw a bare
    # TypeError instead of QueueFull (and lost the admitted count)
    return (QueueFull, (self.admitted,))


class QueueEmpty(Exception):
  pass


# --- manager plumbing -------------------------------------------------------
# Module-level registries that live inside the manager *server* process.
_queues: Dict[str, FeedQueue] = {}
_kv: Dict[str, object] = {}
_kv_lock = threading.Lock()


def _init_server(queue_names, qmax):
  global _queues, _kv
  # runs in the manager SERVER process before its Listener is created, so
  # every accepted connection gets TCP_NODELAY (see _install_nodelay)
  _install_nodelay()
  _queues = {name: FeedQueue(maxsize=qmax) for name in queue_names}
  # the error queue must never block its writer
  if "error" in _queues:
    _queues["error"] = FeedQueue(maxsize=0)
  _kv = {"state": "running"}


def _get_queue(name: str) -> FeedQueue:
  q = _queues.get(name)
  if q is None:
    raise KeyError("no such feed queue: %r (have %r)" % (name, list(_queues)))
  return q


def _kv_get(key: str):
  with _kv_lock:
    return _kv.get(key)


def _kv_set(key: str, value) -> None:
  with _kv_lock:
    _kv[key] = value


def _force_exit():
  """Schedule hard exit of the manager SERVER process (returns first).

  BaseManager has no remote shutdown for non-owners, but fault recovery
  needs one: when a node is SIGKILLed its hub manager survives as an
  orphan (daemonic children die with a clean parent exit, not a SIGKILL),
  still answering with state 'running'. The supervisor/reclaim path calls
  this after draining the dead node's queues so orphaned managers don't
  accumulate across relaunches.
  """
  t = threading.Timer(0.2, os._exit, args=(0,))
  t.daemon = True
  t.start()
  return True


_QUEUE_METHODS = ["put", "put_many", "put_chunk", "get", "get_many",
                  "get_chunk", "task_done", "join", "qsize", "empty"]


class FeedHubManager(BaseManager):
  pass


FeedHubManager.register("get_queue", callable=_get_queue,
                        exposed=_QUEUE_METHODS)
FeedHubManager.register("get", callable=_kv_get)
FeedHubManager.register("set", callable=_kv_set)
FeedHubManager.register("force_exit", callable=_force_exit)


class FeedHub(object):
  """Client/owner handle for a feed hub (parity: TFManager start/connect)."""

  def __init__(self, manager: BaseManager, addr: Tuple[str, int],
               authkey: bytes, owned: bool):
    self._manager = manager
    self.addr = addr
    self.authkey = authkey
    self._owned = owned

  def get_queue(self, name: str):
    return self._manager.get_queue(name)

  def get(self, key: str):
    # BaseManager proxies wrap results; use _getvalue to unbox plain values
    v = self._manager.get(key)
    try:
      return v._getvalue()
    except AttributeError:
      return v

  def set(self, key: str, value) -> None:
    self._manager.set(key, value)

  def force_exit(self) -> None:
    """Hard-stop the hub SERVER process (see ``_force_exit``); usable by
    any connected client, unlike ``shutdown`` which only the owner may
    call. Best-effort: an already-dead server raises, callers catch."""
    self._manager.force_exit()

  def shutdown(self) -> None:
    if self._owned:
      try:
        self._manager.shutdown()
      except Exception:  # noqa: BLE001 - already-dead manager is fine
        pass


# Hubs held alive per process. The owner of a hub must keep referencing the
# manager object or BaseManager's finalizer tears the server down; the node
# task that starts a hub returns before the node's life ends, so the holder
# is THIS module, which outlives the task in the executor process. (Parity
# role: the TFSparkNode holder class, TFSparkNode.py:111-125.)
_held: Dict[object, "FeedHub"] = {}


def hold(key, hub: "FeedHub") -> None:
  """Keep ``hub`` alive in this process until released."""
  _held[key] = hub


def held(key) -> Optional["FeedHub"]:
  return _held.get(key)


def release(key) -> None:
  hub = _held.pop(key, None)
  if hub is not None:
    hub.shutdown()


def start(authkey: bytes, queue_names: Sequence[str],
          mode: str = "local", qmax: int = 1024,
          host: Optional[str] = None) -> FeedHub:
  """Start a feed hub server process.

  Args:
    authkey: shared secret for manager authentication.
    queue_names: names of queues to create (e.g. ['input','output','error']).
    mode: ``'local'`` binds loopback (workers); ``'remote'`` binds all
      interfaces so the driver can connect (ps/evaluator nodes) —
      parity: TFManager.py:40-65.
    qmax: per-queue bound, the backpressure window (in items/chunks).
    host: advertised host for remote mode (defaults to this host's IP).
  """
  bind_host = "127.0.0.1" if mode == "local" else ""
  _install_nodelay()
  # spawn, not fork: the caller (an engine executor) typically has live
  # queue-feeder threads, and forking a process that holds their locks can
  # deadlock the manager child before it ever listens
  import multiprocessing as mp
  mgr = FeedHubManager(address=(bind_host, 0), authkey=authkey,
                       ctx=mp.get_context("spawn"))
  mgr.start(initializer=_init_server, initargs=(list(queue_names), qmax))
  actual = mgr.address
  if mode == "remote":
    from tensorflowonspark_tpu_torch.utils.hostinfo import get_ip_address
    advertise = host if host else get_ip_address()
    actual = (advertise, actual[1])
  logger.info("feed hub started (%s) at %s", mode, actual)
  return FeedHub(mgr, actual, authkey, owned=True)


def connect(addr: Tuple[str, int], authkey: bytes) -> FeedHub:
  """Connect to an existing feed hub (parity: TFManager.py:68-83)."""
  _install_nodelay()
  mgr = FeedHubManager(address=(addr[0], int(addr[1])), authkey=authkey)
  mgr.connect()
  return FeedHub(mgr, (addr[0], int(addr[1])), authkey, owned=False)
