"""L4' user-code API: consume engine-fed data inside the main fn.

The port's copy of ``tensorflowonspark_tpu/datafeed.py``, itself the
counterpart of TensorFlowOnSpark's ``TFNode.DataFeed`` (``TFNode.py:
234-343``):

- ``next_batch(n)`` pulls up to ``n`` items; ``None`` marks end-of-feed
  (sets ``should_stop``); ``EndPartition`` is skipped in train mode but ends
  the batch early in inference mode so results stay aligned per partition
  (``TFNode.py:278-301``);
- ``batch_results`` pushes inference outputs to the output queue
  (``:307-318``);
- ``terminate()`` flips the hub state to ``'terminating'`` and drains the
  input queue so blocked feeders finish (``:320-343``);
- ``input_mapping`` transposes row-tuples into a dict of named columns
  (``:251,274,294-298``).

The columnar feed plane: items move through the hub (or the node's
shared-memory ring, :mod:`.control.shmring`) in chunk-boundary envelopes
(one codec-encoded chunk per transport unit, :mod:`.control.chunkcodec`),
and the feed keeps a chunk-granular buffer. Homogeneous array chunks stay
columnar from the feeder to batch assembly: ``next_batch_arrays`` /
``input_mapping`` batches are built by slicing and concatenating column
ndarray views across chunk boundaries, with no per-row Python loop; the
one copy is the concatenation that hands the batch off (a batch inside one
chunk is handed out as a read-only view). Heterogeneous or pickled chunks
and the row-list ``next_batch`` API fall back to row materialization. A
bounded background fetch thread (``TOS_FEED_PIPELINE``) runs the hub or
ring reads and the decode under the caller's step, and composes with
:func:`prefetch_to_device` (the port's ``data.readers.device_prefetch``)
for the host-to-card leg.

The module imports no torch: feeder tasks and drains run it in processes
that never touch the card. ``next_slab_arrays``, ``prefetch_to_device``
and ``next_batch_synced`` import what they need when called.
"""

import collections
import logging
import os
import queue as std_queue
import threading
import time
from typing import Dict, List, Optional, Sequence

from tensorflowonspark_tpu_torch import node as node_mod
from tensorflowonspark_tpu_torch.control import chunkcodec
from tensorflowonspark_tpu_torch.control.marker import EndPartition, Marker
from tensorflowonspark_tpu_torch.obs import metrics as obs_metrics
from tensorflowonspark_tpu_torch.obs import spans as obs_spans

logger = logging.getLogger(__name__)

#: depth of the background fetch pipeline (chunks buffered ahead of the
#: consumer); 0 disables the fetch thread (env registry: TOS008)
ENV_FEED_PIPELINE = "TOS_FEED_PIPELINE"

#: raw-row gather cap per chunk fetch (legacy unframed streams only —
#: envelope chunks keep their own boundaries)
DEFAULT_FETCH_ROWS = 1024

#: bound on every blocking wait inside the fetch thread (TOS001: a wedged
#: hub must never pin the thread past its stop flag check)
_PIPELINE_POLL = 0.5


class FeedStalledError(TimeoutError):
  """The feed produced no data (and no end-of-feed marker) for longer than
  ``liveness_timeout`` — the feeder process is presumed dead."""


def _chunk_weight(got) -> int:
  """task_done weight of one ``get_chunk`` wire unit."""
  kind = got[0]
  if kind == "enc":
    return got[1]
  if kind == "rows":
    return len(got[1])
  if kind == "data":
    chunk = got[1]
    return chunk.n if isinstance(chunk, chunkcodec.ColumnChunk) \
        else len(chunk)
  return 1  # marker


def _fetch_chunk(channel, max_rows: int, timeout, stats=None):
  """One chunk-granular fetch + ack off ``channel``.

  Normalizes every transport's wire format to ``("data", ColumnChunk |
  row_list)`` / ``("marker", m)`` / ``None`` (timeout), acking the
  channel with the unit's row weight immediately after the fetch (the
  same eager-ack the row path always used)."""
  t0 = time.perf_counter() if stats is not None else 0.0
  got = channel.get_chunk(max_rows, block=True, timeout=timeout)
  if stats is not None:
    stats["fetch_s"] += time.perf_counter() - t0
  if not got:
    return None
  channel.task_done(_chunk_weight(got))
  kind = got[0]
  if kind != "enc":
    if kind == "rows":
      return ("data", got[1])
    return got  # already normalized ("data", ...) / ("marker", m)
  t0 = time.perf_counter() if stats is not None else 0.0
  chunk = chunkcodec.decode_columns(got[2])
  if stats is not None:
    stats["decode_s"] += time.perf_counter() - t0
  return chunkcodec.classify_decoded(chunk)


class _FetchPipeline(object):
  """Bounded background chunk fetcher (the hub-RPC overlap plane).

  One daemon thread repeats ``_fetch_chunk`` into a depth-bounded local
  queue so the manager round-trip AND the msgpack decode of chunk N+1 run
  under the caller's jitted step for chunk N. Every blocking call is
  timeout-bounded (TOS001); a fetch error is forwarded and re-raised in
  the consumer; the thread retires itself at end-of-feed.
  """

  def __init__(self, channel, depth: int, max_rows: int, stats):
    self._channel = channel
    self._max_rows = max_rows
    self._stats = stats
    self._out = std_queue.Queue(maxsize=max(1, depth))
    self._stop = threading.Event()
    self._thread = threading.Thread(target=self._run, daemon=True,
                                    name="tos-feed-fetch")
    self._thread.start()

  def _run(self):
    while not self._stop.is_set():
      try:
        got = _fetch_chunk(self._channel, self._max_rows,
                           timeout=_PIPELINE_POLL, stats=self._stats)
      except BaseException as e:  # noqa: BLE001 - re-raised consumer-side
        self._forward(("err", e))
        return
      if got is None:
        continue
      if not self._forward(got):
        return
      if got[0] == "marker" and got[1] is None:
        return  # end-of-feed: the stream is over, retire the thread

  def _forward(self, item) -> bool:
    while not self._stop.is_set():
      try:
        self._out.put(item, timeout=_PIPELINE_POLL)
        return True
      except std_queue.Full:
        continue
    return False

  def get(self, timeout: float):
    """Next fetched chunk, or None; re-raises a fetch-thread error."""
    try:
      item = self._out.get(timeout=timeout)
    except std_queue.Empty:
      return None
    if item[0] == "err":
      raise item[1]
    return item

  def stop(self) -> None:
    """Stop the thread and discard buffered chunks (already acked)."""
    self._stop.set()
    self._thread.join(timeout=5.0)
    while True:
      try:
        self._out.get(block=False)
      except std_queue.Empty:
        return


class DataFeed(object):
  """Pull-based reader over this node's feed hub."""

  def __init__(self, hub, train_mode: bool = True, qname_in: str = "input",
               qname_out: str = "output",
               input_mapping: Optional[Dict[str, str]] = None,
               liveness_timeout: Optional[float] = 600.0,
               pipeline_depth: Optional[int] = None):
    self.hub = hub
    self.train_mode = train_mode
    self.qname_in = qname_in
    self.qname_out = qname_out
    self.liveness_timeout = liveness_timeout
    self.done_feeding = False
    # sorted-column order matches the estimator's dataset.select(sorted(...))
    # convention (reference pipeline.py:414, TFNode.py:251)
    self.input_tensors = ([input_mapping[col] for col in
                           sorted(input_mapping)] if input_mapping else None)
    # the input stream rides the shared-memory ring when the node
    # advertises one (feed_transport='shm'), PLUS the hub queue for
    # feeders on other hosts; output/control stay on the hub
    self._queue_in = node_mod.consumer_channel(hub, qname_in)
    self._queue_out = hub.get_queue(qname_out)
    #: chunk-granular buffer: ["cols", ColumnChunk, offset] (mutable — the
    #: offset advances as batches slice the chunk), ("rows", deque) for
    #: heterogeneous/legacy chunks, ("marker", m) for chunk-boundary markers
    self._chunks = collections.deque()
    if pipeline_depth is None:
      pipeline_depth = int(os.environ.get(ENV_FEED_PIPELINE, "2"))
    self._pipeline_depth = max(0, pipeline_depth)
    self._pipeline: Optional[_FetchPipeline] = None
    #: per-stage accounting (seconds / counts), filled on the hot path
    #: (snapshot it with :meth:`stats_snapshot`, never by zeroing: the
    #: fetch thread keeps read-modify-writing these entries)
    self.stats = {"fetch_s": 0.0, "decode_s": 0.0, "assemble_s": 0.0,
                  "chunks": 0, "columnar_chunks": 0, "aligned_batches": 0}
    # obs seam (docs/OBSERVABILITY.md): cached once so the disabled case
    # is one None check per batch
    self._rec = obs_spans.active()
    self._obs_stage_t = 0.0   # last empty-poll stage-gauge mirror
    reg = obs_metrics.active()
    self._obs_m = None if reg is None else {
        "batches": reg.counter("feed.batches"),
        "rows": reg.counter("feed.rows"),
        "fetch_s": reg.gauge("feed.fetch_s"),
        "decode_s": reg.gauge("feed.decode_s"),
        "assemble_s": reg.gauge("feed.assemble_s"),
        "chunks": reg.gauge("feed.chunks"),
        "batch_ms": reg.histogram("feed.batch_ms"),
    }

  def stats_snapshot(self) -> obs_metrics.StatsSnapshot:
    """Subtraction baseline over the LIVE ``stats`` dict — the one safe
    way to read steady-state stage deltas while the fetch thread keeps
    mutating them (obs.metrics.StatsSnapshot)."""
    return obs_metrics.snapshot_stats(self.stats)

  def channel_chunks(self) -> Optional[Dict[str, int]]:
    """Wire units (chunks and markers) this feed has taken from each input
    channel, ``{"ring": n, "queue": m}``, when the node advertises a
    shared-memory ring; ``None`` when the input is the hub queue alone."""
    if not isinstance(self._queue_in, node_mod.DualInput):
      return None
    return dict(self._queue_in.delivered)

  def _obs_stages(self) -> None:
    """Mirror the live stage seconds into the registry gauges."""
    m = self._obs_m
    m["fetch_s"].set(self.stats["fetch_s"])
    m["decode_s"].set(self.stats["decode_s"])
    m["assemble_s"].set(self.stats["assemble_s"])
    m["chunks"].set(self.stats["chunks"])

  def _obs_batch(self, t0: float, n: int) -> None:
    """Record one delivered batch into the obs plane (active only)."""
    dt = time.monotonic() - t0
    if self._rec is not None:
      self._rec.record_span("feed.batch", t0, dt, rows=n)
    m = self._obs_m
    if m is not None:
      m["batches"].inc()
      if n:
        m["rows"].inc(n)
      m["batch_ms"].observe(dt * 1e3)
      self._obs_stages()

  # -- fetch plane -----------------------------------------------------------

  def _fetch(self, timeout: float = 1.0) -> bool:
    """One fetch attempt; True if a chunk entry was appended."""
    if self._pipeline_depth > 0:
      if self._pipeline is None:
        self._pipeline = _FetchPipeline(self._queue_in, self._pipeline_depth,
                                        DEFAULT_FETCH_ROWS, self.stats)
      got = self._pipeline.get(timeout)
    else:
      got = _fetch_chunk(self._queue_in, DEFAULT_FETCH_ROWS,
                         timeout=timeout, stats=self.stats)
    if got is None:
      # a STALLED consumer delivers no batches, so batch-boundary gauge
      # mirroring freezes exactly when the feed-stall detector needs the
      # stage seconds to keep moving — mirror them on empty polls too
      # (throttled: the poll loop can spin at sub-second cadence)
      if self._obs_m is not None:
        now = time.monotonic()
        if now - self._obs_stage_t >= 0.5:
          self._obs_stage_t = now
          self._obs_stages()
      return False
    kind, payload = got
    if kind == "marker":
      self._chunks.append(("marker", payload))
      return True
    self.stats["chunks"] += 1
    if isinstance(payload, chunkcodec.ColumnChunk):
      self.stats["columnar_chunks"] += 1
      self._chunks.append(["cols", payload, 0])
    else:
      self._chunks.append(("rows", collections.deque(payload)))
    return True

  def _stop_pipeline(self) -> None:
    """Retire the fetch thread (already-acked buffered chunks discard)."""
    if self._pipeline is not None:
      self._pipeline.stop()
      self._pipeline = None

  def _check_liveness(self, stalled_since: float) -> None:
    """Raise instead of polling forever when the producer side died.

    A feeder that crashes without pushing markers would leave
    ``next_batch``'s empty-poll loop spinning. On each empty poll: surface
    worker/feeder tracebacks from the error queue (peek-and-put-back, the
    protocol of ``node._check_errors``, TFSparkNode.py:508-515), honor a
    hub moved to ``terminating``/``stopped``, and give up after
    ``liveness_timeout`` seconds without data.
    """
    try:
      self._check_liveness_inner(stalled_since)
    except BaseException:
      # the feed is being abandoned via this raise: retire the fetch
      # thread NOW or it keeps polling (and eagerly acking) the hub
      # forever — racing any replacement DataFeed for chunks it would
      # then bury in its dead queue
      self._stop_pipeline()
      raise

  def _check_liveness_inner(self, stalled_since: float) -> None:
    node_mod._check_errors(self.hub, "next_batch")
    try:
      state = self.hub.get("state")
    except Exception:  # noqa: BLE001 - hub manager itself may be gone
      raise FeedStalledError("feed hub is unreachable from next_batch — "
                             "the node's manager process died")
    if state in ("terminating", "stopped"):
      logger.info("hub state %r during next_batch; stopping feed", state)
      self.done_feeding = True
      return
    if (self.liveness_timeout is not None
        and time.monotonic() - stalled_since > self.liveness_timeout):
      raise FeedStalledError(
          "no data and no end-of-feed marker for %.0fs (hub state %r) — "
          "feeder presumed dead" % (self.liveness_timeout, state))

  # -- batch assembly --------------------------------------------------------

  def _assemble_columns(self, batch_size: int, dtype=None,
                        require_single: bool = False):
    """Columnar fast path: a batch as a list of column arrays, or None.

    Plans up to ``batch_size`` rows over PENDING chunks first (fetching
    more as needed), committing nothing until the whole batch is known to
    be assemblable from ColumnChunks with matching schemas — any
    heterogeneous/legacy row chunk in the stretch returns None and the
    untouched buffer falls back to the row path. Markers keep their exact
    row-path semantics: end-of-feed ends the batch (partial OK) and sets
    ``done_feeding``; ``EndPartition`` is skipped in train mode and ends
    the batch in inference mode. Each output column is ONE
    ``np.concatenate`` over chunk slices — the only copy on the path —
    and an ALIGNED batch (the whole stretch inside one chunk) skips even
    that: the column slices hand out directly as READ-ONLY zero-copy
    views of the decoded chunk (``stats["aligned_batches"]`` counts
    them). Callers must treat batch arrays as immutable on that path —
    the views share the chunk's buffer with sibling batches.
    """
    import numpy as np
    plan = []             # (ColumnChunk, start, stop)
    pops = 0              # buffer entries fully consumed, in order
    tail_off = None       # new offset for a partially-consumed head chunk
    end_of_feed = False
    need = batch_size
    sig = None            # (ncols, per-col (dtype, trailing shape))
    stalled_since = time.monotonic()
    while need > 0:
      if pops >= len(self._chunks):
        if self.done_feeding:
          break
        if not self._fetch(1.0):
          if not self.done_feeding:
            self._check_liveness(stalled_since)
          continue
        stalled_since = time.monotonic()
        continue
      entry = self._chunks[pops]
      kind = entry[0]
      if kind == "rows":
        return None
      if kind == "marker":
        m = entry[1]
        if m is None:
          end_of_feed = True
          pops += 1
          break
        if self.train_mode:
          pops += 1
          continue
        if not plan:
          # partition boundary with ZERO planned rows: leave the marker
          # (nothing was committed) so the row fallback pops it and
          # returns the same empty boundary batch the row path always
          # produced when batch_size exactly divides the partition
          return None
        pops += 1
        break  # inference: batch ends at the partition boundary
      cc, off = entry[1], entry[2]
      if require_single and (cc.tuples or len(cc.cols) != 1):
        return None
      this_sig = (len(cc.cols),
                  tuple((a.dtype.str, a.shape[1:]) for a in cc.cols))
      if sig is None:
        sig = this_sig
      elif this_sig != sig:
        return None  # schema changed mid-batch: row fallback handles it
      take = min(need, cc.n - off)
      plan.append((cc, off, off + take))
      need -= take
      if off + take >= cc.n:
        pops += 1
        tail_off = None
      else:
        tail_off = off + take
        break  # batch filled from a partial chunk

    if not plan:
      # nothing columnar to hand out; commit marker effects and fall back
      for _ in range(pops):
        self._chunks.popleft()
      if end_of_feed:
        logger.info("end-of-feed marker received")
        self.done_feeding = True
      return None

    t0 = time.perf_counter()
    for _ in range(pops):
      self._chunks.popleft()
    if tail_off is not None:
      self._chunks[0][2] = tail_off
    if end_of_feed:
      logger.info("end-of-feed marker received")
      self.done_feeding = True
    ncols = len(plan[0][0].cols)
    if self.input_tensors is not None:
      ncols = min(ncols, len(self.input_tensors))
    out = []
    aligned = len(plan) == 1
    for j in range(ncols):
      if aligned:
        # aligned fast path: the whole batch sits inside one chunk, so
        # the slice IS the column — a zero-copy read-only view (safe to
        # hand out: the decoded chunk's buffer is msgpack-owned bytes,
        # never a transport scratch buffer)
        cc, a, b = plan[0]
        arr = cc.cols[j][a:b]
      else:
        pieces = [cc.cols[j][a:b] for cc, a, b in plan]
        arr = np.concatenate(pieces)  # the hand-off copy
      if dtype is not None and arr.dtype != np.dtype(dtype):
        arr = arr.astype(dtype)
      out.append(arr)
    if aligned:
      self.stats["aligned_batches"] += 1
    self.stats["assemble_s"] += time.perf_counter() - t0
    return out

  def _next_rows(self, batch_size: int) -> List:
    """Row-granular batch loop (the legacy semantics, unchanged)."""
    batch: List = []
    stalled_since = time.monotonic()
    while len(batch) < batch_size:
      if not self._chunks:
        if self.done_feeding:
          break
        if not self._fetch(1.0):
          if self.done_feeding:
            break
          self._check_liveness(stalled_since)
          continue
        stalled_since = time.monotonic()
        continue
      entry = self._chunks[0]
      kind = entry[0]
      if kind == "marker":
        self._chunks.popleft()
        m = entry[1]
        if m is None:
          logger.info("end-of-feed marker received")
          self.done_feeding = True
          break
        if self.train_mode:
          continue
        break  # inference: batch ends at the partition boundary
      if kind == "cols":
        # row-list consumers materialize the chunk (same per-row cost the
        # old decode paid eagerly for every chunk)
        self._chunks[0] = ("rows",
                           collections.deque(entry[1].rows(entry[2])))
        continue
      rows = entry[1]
      stop = False
      while rows and len(batch) < batch_size:
        item = rows.popleft()
        if item is None:
          logger.info("end-of-feed marker received")
          self.done_feeding = True
          stop = True
          break
        if isinstance(item, (Marker, EndPartition)):
          if self.train_mode:
            continue
          stop = True  # inference: batch ends at the partition boundary
          break
        batch.append(item)
      if not rows:
        self._chunks.popleft()
      if stop:
        break
    return batch

  def next_batch(self, batch_size: int):
    """Return up to ``batch_size`` items (or a dict of columns when an
    input_mapping is configured). Blocks until data arrives.

    With an input_mapping, homogeneous array chunks take the columnar
    fast path and the dict values are stacked ndarrays; heterogeneous /
    legacy row chunks keep the historical list values. The plain row-list
    form (no mapping) is unchanged.

    Raises :class:`FeedStalledError` (or the worker's own error, re-raised
    from the error queue) instead of blocking forever when the producer
    side has died; see ``liveness_timeout``.
    """
    if self._rec is None and self._obs_m is None:
      return self._next_batch_impl(batch_size)
    t0 = time.monotonic()
    out = self._next_batch_impl(batch_size)
    if isinstance(out, dict):
      n = len(next(iter(out.values()))) if out else 0
    else:
      n = len(out)
    self._obs_batch(t0, n)
    return out

  def _next_batch_impl(self, batch_size: int):
    if self.input_tensors is not None:
      cols = self._assemble_columns(batch_size)
      if cols is not None:
        return dict(zip(self.input_tensors, cols))
    batch = self._next_rows(batch_size)
    if self.input_tensors is None:
      return batch
    # transpose rows -> named columns
    cols: Dict[str, List] = {name: [] for name in self.input_tensors}
    for row in batch:
      for name, value in zip(self.input_tensors, row):
        cols[name].append(value)
    return cols

  def should_stop(self) -> bool:
    """True once the end-of-feed marker was consumed (parity :303-305)."""
    return self.done_feeding

  def batch_results(self, results: Sequence,
                    timeout: Optional[float] = None) -> None:
    """Push a batch of inference results (parity :307-318).

    Bounded (TOS001): the push blocks at most ``timeout`` seconds
    (default: this feed's ``liveness_timeout``). An unbounded put here
    wedged the node forever when the inference collector died — the
    worker kept its executor busy and a pinned relaunch could never
    schedule behind it (the PR 1 slot-deadlock class).
    """
    timeout = timeout if timeout is not None else self.liveness_timeout
    try:
      self._queue_out.put_many(list(results), block=True, timeout=timeout)
    except Exception as e:  # noqa: BLE001 - recast ONLY the queue-full
      # timeout (which may arrive as a proxy-re-raised feedhub.QueueFull)
      if type(e).__name__ != "QueueFull":
        raise
      admitted = getattr(e, "admitted", 0)
      err = FeedStalledError(
          "output queue still full after %.0fs pushing %d result(s) (%d "
          "already enqueued — skip them on retry) — the inference collector "
          "is presumed dead" % (timeout or 0, len(results), admitted))
      # a timed-out put_many may have enqueued a prefix; callers that retry
      # must resume at results[admitted:] or they double-deliver
      err.admitted = admitted
      raise err from e

  def terminate(self, settle_rounds: int = 3,
                settle_timeout: float = 0.1) -> None:
    """Request early termination: mark the hub terminating and drain the
    input queue so blocked feeders can finish (parity :320-343).

    The drain settles after ``settle_rounds`` consecutive empty polls of
    ``settle_timeout`` seconds each — an already-empty queue costs
    ``settle_rounds * settle_timeout`` (0.3 s at the defaults), not the
    3 s the old fixed 1-second polls burned on every teardown."""
    logger.info("terminate() requested; draining input queue")
    self.hub.set("state", "terminating")
    self.done_feeding = True
    self._stop_pipeline()  # buffered chunks were already acked; discard
    self._chunks.clear()
    empty_rounds = 0
    while empty_rounds < settle_rounds:
      got = self._queue_in.get_chunk(DEFAULT_FETCH_ROWS, block=True,
                                     timeout=settle_timeout)
      if got:
        self._queue_in.task_done(_chunk_weight(got))
        empty_rounds = 0
      else:
        empty_rounds += 1

  def next_batch_synced(self, batch_size: int):
    """``next_batch`` with a step agreement across the process group.

    Synchronous data-parallel training deadlocks if one worker's feed runs
    dry while the others enter a collective. Before handing out a batch,
    every process votes "I have a full batch" (one ``all_reduce(MIN)`` of
    a one-element tensor); if anyone is short, every process stops,
    returning an empty batch with ``should_stop()`` true. At most one
    partial batch per worker is dropped at the end of the data.
    """
    batch = self.next_batch(batch_size)
    n = len(batch[self.input_tensors[0]]) if isinstance(batch, dict) \
        else len(batch)
    ok = n == batch_size and not self.done_feeding
    if not _all_processes_agree(ok):
      self.done_feeding = True
      return {k: [] for k in batch} if isinstance(batch, dict) else []
    return batch

  # -- host staging ----------------------------------------------------------

  def next_batch_arrays(self, batch_size: int, dtype=None):
    """Like ``next_batch`` but returns stacked numpy arrays, ready for
    the copy to the card (the host-staging step of the feed plane).

    Columnar chunks assemble with NO per-row loop: one concatenate of
    column views per output column (single-column chunks without an
    input_mapping return one array; with a mapping, a dict of arrays).
    Row/heterogeneous chunks fall back to the historical stack."""
    import numpy as np
    obs_on = self._rec is not None or self._obs_m is not None
    t0 = time.monotonic() if obs_on else 0.0
    cols = self._assemble_columns(
        batch_size, dtype=dtype, require_single=self.input_tensors is None)
    if cols is not None:
      if obs_on:
        self._obs_batch(t0, len(cols[0]))
      if self.input_tensors is None:
        return cols[0]
      return dict(zip(self.input_tensors, cols))
    # the row fallback delegates to next_batch, which records its own
    # obs batch — no double counting
    batch = self.next_batch(batch_size)
    if isinstance(batch, dict):
      return {k: np.asarray(v, dtype=dtype) for k, v in batch.items()}
    return np.asarray(batch, dtype=dtype)

  def next_slab_arrays(self, batch_size: int, unroll: int, dtype=None):
    """``unroll`` batches assembled as ONE ``[unroll, batch_size, ...]``
    slab — the chunk-buffer source of the fused train loop.

    One ``next_batch_arrays(batch_size * unroll)`` call plans the whole
    stretch over the chunk buffer (still a single concatenate per
    column; markers keep their exact per-batch semantics — train mode
    skips ``EndPartition`` inside a slab exactly like per-batch
    assembly does), and a full stretch reshapes for free into the slab
    (``data.readers.Slab``). A SHORT stretch (end-of-feed, or an
    inference-mode partition boundary) returns the flat arrays
    unchanged, exactly as ``next_batch_arrays`` would — the caller
    (``data.readers.slab_batches``) splits them back into per-step
    batches so batch order matches the per-step path bit for bit.
    """
    from tensorflowonspark_tpu_torch.data.readers import Slab
    if unroll <= 1:
      return self.next_batch_arrays(batch_size, dtype=dtype)
    want = batch_size * unroll
    got = self.next_batch_arrays(want, dtype=dtype)

    def _rows(x):
      if isinstance(x, dict):
        return len(next(iter(x.values()))) if x else 0
      return len(x)

    def _stack(arr):
      # reshape of the freshly-concatenated (contiguous) column: no copy
      return arr.reshape((unroll, batch_size) + arr.shape[1:])

    if _rows(got) != want:
      return got
    if isinstance(got, dict):
      return Slab({k: _stack(v) for k, v in got.items()})
    return Slab(_stack(got))


def drain_pending_rows(hub, qname: str = "input", settle_rounds: int = 3,
                       settle_timeout: float = 0.1,
                       keep_markers: bool = False) -> List:
  """Pull every undelivered row out of a (presumed dead) node's feed queue.

  Fault-recovery primitive: when a worker dies mid-feed, rows already
  pushed into its hub queue would otherwise be lost — and the feeder tasks
  blocked in ``queue.join()`` would wedge until their feed timeout. This
  drains the queue chunk by chunk (expanding codec envelopes back into
  rows), acking each unit with ``task_done`` so blocked feeders complete,
  and returns the data rows for requeueing through the engine feed path
  (``ClusterSupervisor`` refeeds them to live workers).

  End-of-feed ``None`` markers are always dropped: the requeued rows ride
  a fresh feed round with its own end-of-feed. ``EndPartition`` (and any
  other ``Marker``) is dropped by default but PRESERVED in stream order
  with ``keep_markers=True`` — inference feeds need the partition
  boundaries to keep per-partition result alignment across a refeed (the
  supervisor passes this for inference recovery). The drain keeps
  sweeping until ``settle_rounds`` consecutive empty polls, catching a
  feeder caught mid-put.

  Only call this against a hub whose consumer is KNOWN dead — draining a
  live node's queue steals its input.
  """
  queue = hub.get_queue(qname)
  rows: List = []
  empty = 0
  while empty < settle_rounds:
    got = queue.get_chunk(DEFAULT_FETCH_ROWS, block=True,
                          timeout=settle_timeout)
    if not got:
      empty += 1
      continue
    empty = 0
    queue.task_done(_chunk_weight(got))
    kind = got[0]
    if kind == "marker":
      if keep_markers and got[1] is not None:
        rows.append(got[1])
      continue
    if kind == "enc":
      ckind, decoded = chunkcodec.classify_decoded(
          chunkcodec.decode_columns(got[2]))
      if ckind == "marker":
        items = [decoded]
      elif isinstance(decoded, chunkcodec.ColumnChunk):
        items = decoded.rows()
      else:
        items = decoded
    else:  # "rows"
      items = got[1]
    rows.extend(r for r in items
                if r is not None
                and (keep_markers or not isinstance(r, Marker)))
  return rows


def prefetch_to_device(batches, size: int = 2, device=None):
  """Overlap the host-to-card copy with the step on the card.

  Wraps an iterator of host batches (numpy arrays, or dicts of them) and
  yields batches on ``device`` (``None``: the card), with up to ``size``
  copies in flight, so batch N+1's copy runs while the caller's step on
  batch N executes::

      for x in prefetch_to_device(feed_batches(feed, B), size=2):
          state, loss = step(state, x)

  (``data.readers.feed_batches(feed, B)`` is the host loop over
  ``next_batch_arrays``.) It is ``data.readers.device_prefetch``, the
  FILES-mode prefetcher, so there is one implementation of the overlap:
  pinned host copies and a side stream. With the feed's fetch thread
  (``TOS_FEED_PIPELINE``) three stages overlap: the hub or ring read and
  the decode, the copy to the card, and the step.
  """
  from tensorflowonspark_tpu_torch.data.readers import device_prefetch
  return device_prefetch(batches, size=size, device=device)


def _all_processes_agree(ok: bool) -> bool:
  """True when every process of the ``torch.distributed`` group votes
  ``ok``: one ``all_reduce(MIN)`` of a one-element tensor, on the card
  under NCCL and on the CPU otherwise; the local vote when no group is
  initialized. (The JAX package's ``parallel.collectives.
  all_processes_agree``; the port's collectives are ROADMAP Queue 1 item
  10.)"""
  import torch
  import torch.distributed as dist
  if not (dist.is_available() and dist.is_initialized()):
    return bool(ok)
  device = "cuda" if dist.get_backend() == "nccl" else "cpu"
  vote = torch.tensor([1 if ok else 0], dtype=torch.int32, device=device)
  dist.all_reduce(vote, op=dist.ReduceOp.MIN)
  return bool(vote.item())
