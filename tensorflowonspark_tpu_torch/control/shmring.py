"""The shared-memory feed ring: Python side of ``native/shmring.cpp``.

The port's copy of ``tensorflowonspark_tpu/control/shmring.py``. The
high-throughput alternative to the manager-proxy feed queues
(:mod:`.feedhub`): serialized chunks move through POSIX shared memory with
no per-row IPC round-trips, where TensorFlowOnSpark moved one pickled row
per manager call (``TFSparkNode.py:500-502``).

Topology: one producer (the feeder task) and one consumer (the node's data
loader) per ring, which is what the engine guarantees. Chunks are encoded
with the columnar chunk codec (:mod:`.chunkcodec`): homogeneous row chunks
ship as raw column buffers in a msgpack envelope, anything else as a pickle
inside the codec.

The native library is the port's own copy of the C++ ring
(``tensorflowonspark_tpu_torch/native/shmring.cpp``, the same layout as
the JAX package's ``native/shmring.cpp``, so either package's rings open in
the other's library). It is built at first use with ``g++`` into
``build/shmring/`` at the root of the checkout, named by a digest of the
source and flags, and loaded with :mod:`ctypes`. There is no fallback: a
failed build raises :class:`RingBuildError` with the compiler's message,
and a node asked for the ring (``feed_transport="shm"``) fails its
bring-up with it.
"""

import atexit
import collections
import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

from tensorflowonspark_tpu_torch.control import chunkcodec

logger = logging.getLogger(__name__)

NATIVE_SRC = Path(__file__).resolve().parent.parent / "native" / "shmring.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "shmring"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_BUILD_TIMEOUT_S = 120

_lib = None
_lib_lock = threading.Lock()


class RingBuildError(RuntimeError):
  """``g++`` could not build (or ``ctypes`` could not load) the ring."""


def library_path() -> Path:
  """Where the ring library lives for the current source and flags."""
  h = hashlib.sha256(NATIVE_SRC.read_bytes())
  h.update(" ".join(GXX_FLAGS).encode())
  return BUILD_DIR / ("libshmring.%s.so" % h.hexdigest()[:16])


def _build(out: Path) -> None:
  """Compile the ring into a per-process temporary, then move it into
  place atomically: concurrent builders never see half a library."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
  # -lrt: shm_open/shm_unlink live in librt on older glibc; linking it is
  # harmless where they moved into libc
  cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC), "-lrt"]
  try:
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=_BUILD_TIMEOUT_S)
  except (OSError, subprocess.SubprocessError) as e:
    raise RingBuildError("could not run g++ on %s: %s" % (NATIVE_SRC, e)) \
        from e
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RingBuildError("g++ failed (%d) on %s:\n%s"
                         % (proc.returncode, NATIVE_SRC,
                            proc.stdout + proc.stderr))
  os.replace(tmp, out)


def _bind(so: str):
  lib = ctypes.CDLL(so)
  lib.tos_ring_create.restype = ctypes.c_void_p
  lib.tos_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
  lib.tos_ring_open.restype = ctypes.c_void_p
  lib.tos_ring_open.argtypes = [ctypes.c_char_p]
  lib.tos_ring_write.restype = ctypes.c_int
  lib.tos_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint32, ctypes.c_int]
  lib.tos_ring_read.restype = ctypes.c_int64
  lib.tos_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint32, ctypes.c_int]
  lib.tos_ring_close_write.restype = None
  lib.tos_ring_close_write.argtypes = [ctypes.c_void_p]
  lib.tos_ring_pending.restype = ctypes.c_uint64
  lib.tos_ring_pending.argtypes = [ctypes.c_void_p]
  lib.tos_ring_free.restype = None
  lib.tos_ring_free.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int]
  return lib


def load():
  """The loaded ring library, built on first use; raises
  :class:`RingBuildError` when it cannot be built or loaded."""
  global _lib
  with _lib_lock:
    if _lib is None:
      path = library_path()
      if not path.exists():
        _build(path)
      try:
        _lib = _bind(str(path))
      except (OSError, AttributeError) as e:
        raise RingBuildError("the ring library %s does not load: %s"
                             % (path, e)) from e
    return _lib


def available() -> bool:
  """True when the ring library builds and loads on this host."""
  try:
    load()
    return True
  except RingBuildError as e:
    logger.warning("shm ring unavailable: %s", e)
    return False


# rings held alive per process (the lifetime pattern of feedhub.hold),
# freed explicitly at shutdown or by the atexit sweep: POSIX shm persists
# past process death, so a leaked segment would hold /dev/shm (RAM) until
# reboot
_held = {}
_atexit_registered = False


def hold(key, ring: "ShmRing") -> None:
  global _atexit_registered
  _held[key] = ring
  if not _atexit_registered:
    atexit.register(release_all)
    _atexit_registered = True


def release(key) -> None:
  """Free (and unlink) a held ring."""
  ring = _held.pop(key, None)
  if ring is not None:
    ring.free()


def release_all() -> None:
  for key in list(_held):
    release(key)


def unlink_stale(name: str) -> None:
  """Best-effort unlink of a ring segment whose owner died without
  freeing it. Relaunched nodes reap their dead predecessor's segment this
  way before creating a fresh, generation-suffixed ring."""
  try:
    os.unlink(os.path.join("/dev/shm", name.lstrip("/")))
  except OSError:
    pass


class RingClosed(Exception):
  pass


class RingTimeout(Exception):
  pass


_open_cache = {}


def open_cached(name: str) -> "ShmRing":
  """Open a ring once per process (the mapping is reused across feeder
  tasks)."""
  if name not in _open_cache:
    _open_cache[name] = ShmRing.open(name)
  return _open_cache[name]


class RingQueueAdapter(object):
  """Feed-queue facade over a :class:`ShmRing`.

  Exposes the subset of the feed-queue API the feeder tasks and
  ``DataFeed`` use (``put``/``put_many``/``put_chunk``/``get_many``/
  ``get_chunk``/``task_done``/``join``), so the queue and shared-memory
  transports share one code path. ``task_done`` is a no-op (the ring's
  tail pointer is the consumption acknowledgment) and ``join`` waits for
  the ring to drain.
  """

  #: keep any single ring payload well below the ring capacity, so a write
  #: can always be placed after a drain; one bound shared with
  #: ``node.put_rows_chunk`` so both producer paths split identically
  MAX_PAYLOAD = chunkcodec.MAX_PAYLOAD

  def __init__(self, ring: "ShmRing"):
    self._ring = ring
    self._end_sent = False   # synthesized end-of-feed delivered (either API)
    self._buffer = collections.deque()

  # producer side ------------------------------------------------------------

  def put_many(self, items, block: bool = True, timeout=None) -> None:
    items = list(items)
    t = None if (block and timeout is None) else (timeout if block else 0.0)
    payload = chunkcodec.encode(items)
    if len(payload) > self.MAX_PAYLOAD and len(items) > 1:
      # split oversized chunks so large rows stream through
      half = len(items) // 2
      self.put_many(items[:half], block=block, timeout=timeout)
      self.put_many(items[half:], block=block, timeout=timeout)
      return
    self._ring.put_payload(payload, timeout=t)

  def put(self, item, block: bool = True, timeout=None) -> None:
    self.put_many([item], block=block, timeout=timeout)

  def put_chunk(self, n: int, payload: bytes, block: bool = True,
                timeout=None) -> None:
    """Enqueue one already-encoded chunk (``n`` is informational: the
    ring's byte accounting is its own backpressure). The signature of
    ``FeedQueue.put_chunk``, so producers treat both transports alike."""
    t = None if (block and timeout is None) else (timeout if block else 0.0)
    self._ring.put_payload(payload, timeout=t)

  def join(self, timeout=None) -> bool:
    deadline = None if timeout is None else time.monotonic() + timeout
    while self._ring.pending_bytes() > 0:
      if deadline is not None and time.monotonic() > deadline:
        return False
      time.sleep(0.005)
    return True

  # consumer side ------------------------------------------------------------

  def get_many(self, max_items: int, block: bool = True, timeout=None):
    if not self._buffer:
      if self._end_sent:
        return []
      try:
        got = self._ring.get_batch(
            timeout=(timeout if timeout is not None else
                     (None if block else 0.0)))
        self._buffer.extend(got)
      except RingTimeout:
        return []
      except RingClosed:
        # the producer closed the ring without an in-band end-of-feed
        # marker (it died): synthesize one, exactly once, so the feed ends
        # instead of polling an empty closed ring forever
        self._end_sent = True
        return [None]
    out = []
    while self._buffer and len(out) < max_items:
      out.append(self._buffer.popleft())
    return out

  def get_chunk(self, max_rows: int = 1024, block: bool = True,
                timeout=None):
    """Dequeue ONE chunk without materializing rows; ``None`` on timeout.

    Returns ``("data", ColumnChunk | row_list)`` or ``("marker", m)``: one
    ring payload is one chunk, decoded by ``chunkcodec.decode_columns``
    straight from the scratch buffer (the decoded columns own their bytes,
    so a later read cannot touch a handed-off chunk). A ring closed
    without an in-band marker synthesizes ``("marker", None)`` once.
    """
    if self._buffer:
      # rows left over from interleaved get_many use
      out = []
      while self._buffer and len(out) < max_rows:
        out.append(self._buffer.popleft())
      return ("rows", out)
    if self._end_sent:
      return None
    try:
      payload = self._ring.get_payload(
          timeout=(timeout if timeout is not None else
                   (None if block else 0.0)))
    except RingTimeout:
      return None
    except RingClosed:
      self._end_sent = True
      return ("marker", None)
    return chunkcodec.classify_decoded(chunkcodec.decode_columns(payload))

  def task_done(self, n: int = 1) -> None:
    pass

  def qsize(self) -> int:
    return len(self._buffer) + (1 if self._ring.pending_bytes() else 0)

  def empty(self) -> bool:
    return self.qsize() == 0


class ShmRing(object):
  """One endpoint of a shared-memory chunk ring."""

  def __init__(self, name: str, handle, lib, owner: bool):
    self.name = name
    self._h = handle
    self._lib = lib
    self._owner = owner
    self._buf = ctypes.create_string_buffer(1 << 20)

  # -- constructors ----------------------------------------------------------

  @classmethod
  def create(cls, name: str, capacity: int = 64 * 1024 * 1024) -> "ShmRing":
    lib = load()
    h = lib.tos_ring_create(name.encode(), capacity)
    if not h:
      raise OSError("failed to create shm ring %r" % name)
    return cls(name, h, lib, owner=True)

  @classmethod
  def open(cls, name: str) -> "ShmRing":
    lib = load()
    h = lib.tos_ring_open(name.encode())
    if not h:
      raise OSError("failed to open shm ring %r" % name)
    return cls(name, h, lib, owner=False)

  # -- chunk API -------------------------------------------------------------

  def put_batch(self, batch, timeout: Optional[float] = None) -> None:
    """Encode (chunk codec) and enqueue one batch of rows."""
    self.put_payload(chunkcodec.encode(batch), timeout=timeout)

  def put_payload(self, payload: bytes,
                  timeout: Optional[float] = None) -> None:
    """Enqueue an already-encoded chunk."""
    rc = self._lib.tos_ring_write(
        self._h, payload, len(payload),
        -1 if timeout is None else int(timeout * 1000))
    if rc == 0:
      return
    if rc == 1:
      raise RingTimeout("ring %r write timed out" % self.name)
    if rc == 2:
      raise RingClosed("ring %r is closed" % self.name)
    raise ValueError("batch of %d bytes exceeds ring capacity"
                     % len(payload))

  def get_batch(self, timeout: Optional[float] = None):
    """Dequeue one batch of rows; raises RingClosed when drained after
    close."""
    return chunkcodec.decode(self.get_payload(timeout=timeout))

  def get_payload(self, timeout: Optional[float] = None):
    """Dequeue one raw record as a memoryview over the reader's scratch
    buffer, valid until the next read: decode it before reading again
    (msgpack copies bin data into owned bytes while parsing)."""
    t = -1 if timeout is None else int(timeout * 1000)
    while True:
      n = self._lib.tos_ring_read(self._h, self._buf, len(self._buf), t)
      if n >= 0:
        return memoryview(self._buf)[:n]
      if n == -1:
        raise RingTimeout("ring %r read timed out" % self.name)
      if n == -2:
        raise RingClosed("ring %r closed and drained" % self.name)
      # -3: record larger than the scratch buffer: grow it and read again
      self._buf = ctypes.create_string_buffer(len(self._buf) * 2)

  def close_write(self) -> None:
    """Producer signals end-of-stream (the consumer drains, then
    RingClosed)."""
    self._lib.tos_ring_close_write(self._h)

  def pending_bytes(self) -> int:
    return self._lib.tos_ring_pending(self._h)

  def free(self) -> None:
    if self._h:
      self._lib.tos_ring_free(self._h, self.name.encode(),
                              1 if self._owner else 0)
      self._h = None

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.free()
