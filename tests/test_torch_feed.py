"""The port's engine feed plane against the JAX package: ``DataFeed``, the
shared-memory ring and the feeder half of ``node.py``.

- the contract subset of ``tests/test_datafeed.py`` and
  ``tests/test_shmring.py`` on the port's copies: end of feed,
  ``EndPartition`` in both modes, batches across chunks, aligned read-only
  views, slabs, ``terminate``, the liveness errors, the ring's order,
  wrap-around and cross-process transfer;
- the wire across packages: rows pushed by one package's
  ``put_rows_chunk`` into the other's hub queue or shm ring come out of
  the consumer's ``DataFeed`` bit-identical to the JAX package's
  end-to-end, both ways, and each package's ring library opens the other's
  rings;
- ``drain_pending_rows``, and ``next_batch_synced`` in 2 gloo processes.

JAX is imported inside the tests that use it: the spawned helper processes
import this module and need only numpy and the port.
"""

import multiprocessing as mp
import os
import threading
import time

import numpy as np
import pytest

from tensorflowonspark_tpu_torch import datafeed as port_datafeed
from tensorflowonspark_tpu_torch import node as port_node
from tensorflowonspark_tpu_torch.control import chunkcodec, feedhub, shmring
from tensorflowonspark_tpu_torch.control.marker import EndPartition
from tensorflowonspark_tpu_torch.data.readers import Slab
from tensorflowonspark_tpu_torch.datafeed import DataFeed, FeedStalledError


def _name():
  return "/tos_torch_test_%d_%d" % (os.getpid(),
                                    int(time.time() * 1e6) % 10 ** 9)


@pytest.fixture()
def hub():
  h = feedhub.start(b"k", ["input", "output", "error"], mode="local")
  yield h
  h.shutdown()


def _fill(hub, chunks, end=True):
  q = hub.get_queue("input")
  for chunk in chunks:
    port_node.put_rows_chunk(q, chunk, timeout=5)
  if end:
    q.put(None)


def _token_chunks():
  """3 chunks x 4 rows of (float32[3], int) rows, row i = value i."""
  return [[(np.full(3, 4 * c + i, np.float32), 4 * c + i)
           for i in range(4)] for c in range(3)]


# -- the contract subset of tests/test_datafeed.py ---------------------------

def test_batches_and_end_of_feed(hub):
  hub.get_queue("input").put_many(list(range(10)) + [None])
  feed = DataFeed(hub, train_mode=True)
  assert feed.next_batch(4) == [0, 1, 2, 3]
  assert not feed.should_stop()
  assert feed.next_batch(4) == [4, 5, 6, 7]
  assert feed.next_batch(4) == [8, 9]
  assert feed.should_stop()
  assert feed.next_batch(4) == []


@pytest.mark.parametrize("train_mode,want", [
    (True, [[0, 1, 2, 10, 11, 12]]),
    (False, [[0, 1, 2], [10, 11, 12]]),
], ids=["train_skips", "inference_ends_batch"])
def test_end_partition_at_chunk_boundary(hub, train_mode, want):
  q = hub.get_queue("input")
  port_node.put_rows_chunk(q, [(np.float32(i) * np.ones(2),)
                               for i in range(3)], timeout=5)
  q.put(EndPartition())
  port_node.put_rows_chunk(q, [(np.float32(10 + i) * np.ones(2),)
                               for i in range(3)], timeout=5)
  q.put(None)
  feed = DataFeed(hub, train_mode=train_mode, pipeline_depth=0,
                  input_mapping={"only": "x"})
  got = [feed.next_batch_arrays(10)["x"][:, 0].tolist() for _ in want]
  assert got == want
  assert feed.should_stop()


@pytest.mark.parametrize("pipeline_depth", [0, 2])
def test_batch_spans_chunk_boundaries(hub, pipeline_depth):
  _fill(hub, _token_chunks())
  feed = DataFeed(hub, pipeline_depth=pipeline_depth,
                  input_mapping={"a_x": "x", "b_y": "y"})
  batch = feed.next_batch_arrays(6)                  # chunks 0 + 1
  assert batch["x"].shape == (6, 3) and batch["x"].flags.writeable
  np.testing.assert_array_equal(batch["y"], np.arange(6))
  np.testing.assert_array_equal(batch["x"][5], np.full(3, 5, np.float32))
  batch = feed.next_batch_arrays(6)                  # chunk 1's tail + 2
  np.testing.assert_array_equal(batch["y"], np.arange(6, 12))
  assert feed.stats["columnar_chunks"] == feed.stats["chunks"] == 3


def test_aligned_batch_is_a_read_only_view(hub):
  _fill(hub, [[(np.full(3, i, np.float32), i) for i in range(8)]])
  feed = DataFeed(hub, pipeline_depth=0,
                  input_mapping={"c0": "x", "c1": "y"})
  batch = feed.next_batch_arrays(4)
  assert feed.stats["aligned_batches"] == 1
  assert not batch["x"].flags.writeable and batch["x"].base is not None
  tail = feed.next_batch_arrays(4)
  np.testing.assert_array_equal(tail["y"], np.arange(4, 8))
  np.testing.assert_array_equal(batch["x"][:, 0], np.arange(4))


def test_slab_short_tail_equals_next_batch_arrays(hub):
  """A full stretch reshapes into a ``Slab``; the short tail comes back
  flat, equal to what ``next_batch_arrays`` gives on the same rows."""
  chunks = [[np.full(5, 8 * c + i, np.int32) for i in range(8)]
            for c in range(2)]                       # 16 single-column rows
  _fill(hub, chunks)
  feed = DataFeed(hub, pipeline_depth=0)
  slab = feed.next_slab_arrays(3, 4)                 # 12 of 16 rows
  assert isinstance(slab, Slab) and slab.data.shape == (4, 3, 5)
  np.testing.assert_array_equal(slab.data[:, :, 0],
                                np.arange(12).reshape(4, 3))
  tail = feed.next_slab_arrays(3, 4)
  assert not isinstance(tail, Slab) and feed.should_stop()

  h2 = feedhub.start(b"k", ["input", "output", "error"], mode="local")
  try:
    _fill(h2, chunks)
    ref = DataFeed(h2, pipeline_depth=0)
    ref.next_batch_arrays(12)
    np.testing.assert_array_equal(tail, ref.next_batch_arrays(12))
  finally:
    h2.shutdown()


def test_terminate_drains_and_flags(hub):
  q = hub.get_queue("input")
  for c in range(4):
    port_node.put_rows_chunk(q, [np.full(2, i) for i in range(50)],
                             timeout=5)
  feed = DataFeed(hub)
  assert len(feed.next_batch_arrays(10)) == 10
  feed.terminate()
  assert feed.should_stop()
  assert hub.get("state") == "terminating"
  assert q.qsize() == 0          # drained, so blocked feeders can finish
  assert q.join(timeout=2)       # and every row was acknowledged


def test_dead_feeder_raises_feed_stalled(hub):
  feed = DataFeed(hub, liveness_timeout=1.0)
  t0 = time.monotonic()
  with pytest.raises(FeedStalledError, match="presumed dead"):
    feed.next_batch(4)
  assert 0.9 < time.monotonic() - t0 < 15.0


def test_worker_error_surfaces_in_next_batch(hub):
  hub.get_queue("error").put("Traceback: boom in feeder")
  feed = DataFeed(hub, liveness_timeout=30.0)
  with pytest.raises(RuntimeError, match="boom in feeder"):
    feed.next_batch(4)
  # peek-and-put-back: shutdown's check still sees it
  assert hub.get_queue("error").get_many(4, block=False) == \
      ["Traceback: boom in feeder"]


def test_full_output_queue_is_feed_stalled_with_admitted():
  h = feedhub.start(b"k", ["input", "output", "error"], qmax=4)
  try:
    feed = DataFeed(h, train_mode=False)
    feed.batch_results([1, 2, 3])                    # fits (3 of 4)
    with pytest.raises(FeedStalledError) as ei:
      feed.batch_results([4, 5], timeout=0.5)        # admits 1, then full
    assert ei.value.admitted == 1
    assert h.get_queue("output").get_many(10) == [1, 2, 3, 4]
  finally:
    h.shutdown()


def test_drain_pending_rows_releases_feeders_and_keeps_markers(hub):
  """The port's analogue of ``tests/test_chaos.py:297``: draining a dead
  consumer's queue returns the data rows (markers dropped, or kept in
  order on request) and acknowledges them, so a feeder blocked in
  ``join`` completes."""
  q = hub.get_queue("input")
  port_node.put_rows_chunk(q, [np.full(2, i) for i in range(3)], timeout=5)
  q.put(EndPartition())
  q.put_many([7, None])
  joined = []
  feeder = threading.Thread(target=lambda: joined.append(q.join(timeout=20)))
  feeder.start()
  rows = port_datafeed.drain_pending_rows(hub, "input", keep_markers=True)
  feeder.join(timeout=30)
  assert joined == [True] and not feeder.is_alive()
  assert [r[0] if isinstance(r, np.ndarray) else r for r in rows] == \
      [0, 1, 2, EndPartition(), 7]
  q.put_many([1, EndPartition(), 2, None])
  assert port_datafeed.drain_pending_rows(hub, "input") == [1, 2]
  assert q.join(timeout=5)


# -- the contract subset of tests/test_shmring.py ----------------------------

def test_ring_order_and_wraparound():
  with shmring.ShmRing.create(_name(), capacity=1 << 14) as ring:
    payload = np.arange(256, dtype=np.float32)       # wraps many times
    for i in range(200):
      ring.put_batch((i, payload), timeout=5)
      j, arr = ring.get_batch(timeout=5)
      assert j == i
      np.testing.assert_array_equal(arr, payload)
    for i in range(20):
      ring.put_batch({"i": i})
    assert [ring.get_batch(timeout=5)["i"] for _ in range(20)] == \
        list(range(20))
    ring.close_write()
    with pytest.raises(shmring.RingClosed):
      ring.get_batch(timeout=2)


def test_ring_adapter_and_dual_input_hold_the_end_marker():
  """The adapter synthesizes one end-of-feed on a closed ring; DualInput
  keeps a ring end-of-feed behind rows still in the hub queue."""
  with shmring.ShmRing.create(_name(), capacity=1 << 16) as ring:
    q = shmring.RingQueueAdapter(ring)
    port_node.put_rows_chunk(q, [(np.full(4, i, np.float32), i)
                                 for i in range(6)], timeout=5)
    q.put(None)
    kind, cc = q.get_chunk(timeout=2)
    assert kind == "data" and isinstance(cc, chunkcodec.ColumnChunk)
    assert cc.n == 6
    assert q.get_chunk(timeout=2) == ("marker", None)
    ring.close_write()
    assert q.get_chunk(timeout=2) == ("marker", None)
    assert q.get_chunk(timeout=2) is None
  h = feedhub.start(b"k", ["input"], mode="local")
  try:
    with shmring.ShmRing.create(_name(), capacity=1 << 16) as ring:
      adapter = shmring.RingQueueAdapter(ring)
      adapter.put_many([1, 2])
      adapter.put_many([None])
      h.get_queue("input").put_many([10, 11])
      dual = port_node.DualInput(adapter, h.get_queue("input"))
      assert dual.get_many(8, timeout=0.5) == [1, 2]
      assert dual.get_many(8, timeout=0.5) == [10, 11]
      dual.task_done(2)
      assert dual.get_many(8, timeout=0.5) == [None]
      assert dual.delivered == {"ring": 2, "queue": 1}
  finally:
    h.shutdown()


def _ring_producer(name, n_batches, rows_per_batch):
  ring = shmring.ShmRing.open(name)
  payload = np.arange(rows_per_batch, dtype=np.float32)
  for i in range(n_batches):
    ring.put_batch((i, payload), timeout=30)
  ring.close_write()


def test_ring_cross_process_transfer():
  name = _name()
  with shmring.ShmRing.create(name, capacity=1 << 22) as ring:
    p = mp.get_context("spawn").Process(target=_ring_producer,
                                        args=(name, 50, 1000))
    p.start()
    seen = 0
    while True:
      try:
        i, arr = ring.get_batch(timeout=30)
      except shmring.RingClosed:
        break
      assert i == seen and len(arr) == 1000
      seen += 1
    p.join(timeout=30)
    assert not p.is_alive() and p.exitcode == 0
    assert seen == 50


def test_ring_library_is_the_ports_own_build():
  assert shmring.available()
  path = shmring.library_path()
  assert path.exists() and path.parent == shmring.BUILD_DIR
  assert shmring.NATIVE_SRC.parent.parent.name == \
      "tensorflowonspark_tpu_torch"


# -- the wire across packages ------------------------------------------------

def _partitions():
  """Feed partitions of (int32 tokens[16], float label) rows and of
  single-column rows, seeded; lengths that do not divide the batch."""
  rng = np.random.default_rng(3)
  tuple_parts = [[(rng.integers(0, 1000, 16).astype(np.int32),
                   float(rng.standard_normal())) for _ in range(n)]
                 for n in (7, 12, 5)]
  single_parts = [[rng.integers(0, 1000, 16).astype(np.int32)
                   for _ in range(n)] for n in (9, 4)]
  return tuple_parts, single_parts


def _drain(feed_cls, hub, mapping, batch, slab):
  """Every batch ``DataFeed`` gives: ``next_batch_arrays`` then, once the
  feed is known to hold more, ``next_slab_arrays``."""
  feed = feed_cls(hub, pipeline_depth=2, input_mapping=mapping)
  out = []
  first = True
  while not feed.should_stop():
    got = feed.next_batch_arrays(batch) if first else \
        feed.next_slab_arrays(batch, slab)
    first = False
    # each package has its own Slab class
    data = got.data if type(got).__name__ == "Slab" else got
    arrays = [data[k] for k in sorted(data)] if isinstance(data, dict) \
        else [data]
    if len(arrays[0]):
      out.append([np.asarray(a) for a in arrays])
  return out, feed.stats["columnar_chunks"], feed.stats["chunks"]


class _Package(object):
  """One package's feedhub, shmring, put_rows_chunk and DataFeed."""

  def __init__(self, which):
    if which == "jax":
      from tensorflowonspark_tpu import datafeed, node
      from tensorflowonspark_tpu.control import feedhub as fh
      from tensorflowonspark_tpu.control import shmring as sr
    else:
      datafeed, node, fh, sr = port_datafeed, port_node, feedhub, shmring
    self.DataFeed = datafeed.DataFeed
    self.put_rows_chunk = node.put_rows_chunk
    self.feedhub = fh
    self.shmring = sr


def _run_wire(producer, consumer, transport, parts, mapping, batch, slab):
  """Rows from ``producer``'s ``put_rows_chunk`` through ``consumer``'s hub
  (or a ring the consumer's library created, opened by the producer's)
  into ``consumer``'s ``DataFeed``."""
  hub = consumer.feedhub.start(b"k", ["input", "output", "error"],
                               mode="local")
  ring = None
  try:
    if transport == "shm":
      name = _name()
      ring = consumer.shmring.ShmRing.create(name, capacity=1 << 20)
      hub.set("ring_name", name)
      channel = producer.shmring.RingQueueAdapter(
          producer.shmring.ShmRing.open(name))
    else:
      channel = hub.get_queue("input")

    def feed():
      for part in parts:
        producer.put_rows_chunk(channel, part, timeout=30)
      channel.put(None, block=True, timeout=30)

    t = threading.Thread(target=feed)
    t.start()
    got = _drain(consumer.DataFeed, hub, mapping, batch, slab)
    t.join(timeout=30)
    assert not t.is_alive()
    return got
  finally:
    if ring is not None:
      ring.free()
    hub.shutdown()


@pytest.mark.parametrize("transport", ["queue", "shm"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wire_parity_with_the_jax_package(direction, transport):
  jax_pkg, port_pkg = _Package("jax"), _Package("torch")
  producer, consumer = (jax_pkg, port_pkg) if direction == "jax_to_port" \
      else (port_pkg, jax_pkg)
  tuple_parts, single_parts = _partitions()
  for parts, mapping in ((tuple_parts, {"a_tok": "tok", "b_lab": "lab"}),
                         (single_parts, None)):
    want = _run_wire(jax_pkg, jax_pkg, transport, parts, mapping, 4, 2)
    got = _run_wire(producer, consumer, transport, parts, mapping, 4, 2)
    assert got[1] == got[2] == want[1] == want[2] == len(parts)  # columnar
    assert len(got[0]) == len(want[0]) and got[0]
    for g, w in zip(got[0], want[0]):
      assert len(g) == len(w)
      for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# -- next_batch_synced across processes --------------------------------------

def _synced_worker(rank, rows, port, out):
  import torch.distributed as dist
  h = feedhub.start(b"k", ["input", "output", "error"], mode="local")
  try:
    h.get_queue("input").put_many(list(range(rows)) + [None])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            rank=rank, world_size=2)
    try:
      feed = DataFeed(h)
      steps = 0
      while True:
        batch = feed.next_batch_synced(2)
        if not batch:
          break
        steps += 1
      with open(out, "w") as f:
        f.write("%d %s" % (steps, feed.should_stop()))
    finally:
      dist.destroy_process_group()
  finally:
    h.shutdown()


def test_next_batch_synced_stops_every_process_together(tmp_path):
  """Two gloo processes with uneven feeds (10 and 7 rows, batches of 2):
  the shorter runs dry after 3 full batches, and both stop there."""
  from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port
  port = get_free_port()
  ctx = mp.get_context("spawn")
  outs = [str(tmp_path / ("rank%d.txt" % r)) for r in range(2)]
  procs = [ctx.Process(target=_synced_worker, args=(r, rows, port, outs[r]))
           for r, rows in enumerate((10, 7))]
  for p in procs:
    p.start()
  for p in procs:
    p.join(timeout=120)
  assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
      [p.exitcode for p in procs]
  assert [open(o).read() for o in outs] == ["3 True", "3 True"]


def test_next_batch_synced_single_process(hub):
  hub.get_queue("input").put_many([1, 2, 3, None])
  feed = DataFeed(hub)
  assert feed.next_batch_synced(2) == [1, 2]
  assert feed.next_batch_synced(2) == []   # one row left: everyone stops
  assert feed.should_stop()
