"""FILES-mode input pipeline, batches and slabs for the train loop.

Counterpart of ``tensorflowonspark_tpu/data/readers.py``: deterministic
file sharding (:func:`shard_files`), a TFRecord example reader
(:func:`read_tfrecord_examples`), a seeded shuffle buffer
(:func:`shuffled`), batch assembly (:func:`batched`) and the
double-buffered host-to-card copy (:func:`device_prefetch`); plus
:class:`Slab` and the generators :func:`feed_batches` /
:func:`slab_batches` that the fused train loop consumes. A feed is any
object with the ``DataFeed`` surface these use — ``should_stop()``,
``next_batch_arrays(batch_size, dtype=)`` and ``next_slab_arrays(
batch_size, unroll, dtype=)`` (a :class:`Slab`, or the partial tail's
rows): the port's ``DataFeed`` (InputMode.SPARK), or a stand-in.
"""

import collections
import itertools
import random
from typing import (Any, Callable, Iterable, Iterator, List, NamedTuple,
                    Optional, Sequence)

import numpy as np
import torch

from tensorflowonspark_tpu_torch.data import (dfutil, example_codec, fs,
                                              tfrecord)
from tensorflowonspark_tpu_torch.parallel.sharding import resolve_unroll
from tensorflowonspark_tpu_torch.utils.device import resolve_device


class Slab(NamedTuple):
  """``unroll`` host batches stacked into one ``[K, B, ...]`` array (or a
  dict of them): the transport unit of the fused train loop
  (:func:`~tensorflowonspark_tpu_torch.parallel.sharding.make_train_loop`),
  K optimizer steps per slab."""
  data: Any


def _rows(batch) -> int:
  return len(next(iter(batch.values()))) if isinstance(batch, dict) \
      else len(batch)


def feed_batches(feed, batch_size: int, dtype=None) -> Iterator:
  """Host batches from ``feed.next_batch_arrays(batch_size)`` until the
  feed's end, skipping the empty tail batch."""
  while not feed.should_stop():
    batch = feed.next_batch_arrays(batch_size, dtype=dtype)
    if _rows(batch):
      yield batch


def slab_batches(feed, batch_size: int, unroll: Optional[int] = None,
                 dtype=None) -> Iterator:
  """:class:`Slab`\\ s of ``unroll`` stacked ``batch_size`` batches until
  the feed can no longer fill one; the partial tail degrades to plain
  per-batch yields in the same order :func:`feed_batches` would give,
  which the loop's per-step path takes — so the fused trajectory equals
  the per-step one. ``unroll=None`` reads ``TOS_TRAIN_UNROLL`` (1 = plain
  :func:`feed_batches`)."""
  unroll = resolve_unroll(unroll)
  if unroll <= 1:
    yield from feed_batches(feed, batch_size, dtype=dtype)
    return
  while not feed.should_stop():
    got = feed.next_slab_arrays(batch_size, unroll, dtype=dtype)
    if isinstance(got, Slab):
      yield got
      continue
    n = _rows(got)
    for i in range(0, n, batch_size):
      if isinstance(got, dict):
        yield {k: v[i:i + batch_size] for k, v in got.items()}
      else:
        yield got[i:i + batch_size]


def shard_files(pattern_or_paths, num_shards: int, shard_index: int
                ) -> List[str]:
  """Deterministically assign files to one of ``num_shards`` readers:
  the sorted matches of a glob pattern (a remote one lists through fsspec
  and gives scheme-qualified paths) or the sorted paths given,
  every ``num_shards``-th from ``shard_index``."""
  if isinstance(pattern_or_paths, str):
    paths = sorted(fs.glob_files(pattern_or_paths))
  else:
    paths = sorted(pattern_or_paths)
  if not paths:
    raise FileNotFoundError("no input files match %r" % (pattern_or_paths,))
  if num_shards <= 1:
    return paths
  return paths[shard_index::num_shards]


def read_tfrecord_examples(paths: Sequence[str], schema=None,
                           repeat: bool = False) -> Iterator:
  """Decoded rows (tuples per ``schema``) or raw feature dicts from
  TFRecord files, file by file; ``repeat`` cycles the files forever."""

  def _once():
    for path in paths:
      for record in tfrecord.TFRecordReader(path):
        if schema is not None:
          yield dfutil.from_example(record, schema)
        else:
          yield example_codec.decode_example(record)

  if not repeat:
    yield from _once()
    return
  if not paths:
    # an empty shard must not busy-spin forever
    raise ValueError(
        "repeat=True with an empty path list would spin forever; this "
        "worker's file shard is empty (more workers than files?)")
  while True:
    yield from _once()


def shuffled(rows: Iterable, buffer_size: int, seed: int = 0) -> Iterator:
  """Streaming shuffle buffer: holds ``buffer_size`` rows and yields a
  uniformly drawn one as each new row arrives, then drains the buffer
  shuffled. The same ``random.Random(seed)`` draws as the reference, so
  the same rows give the same order."""
  if buffer_size <= 1:
    yield from rows
    return
  rnd = random.Random(seed)
  buf = []
  for row in rows:
    if len(buf) < buffer_size:
      buf.append(row)
      continue
    i = rnd.randrange(buffer_size)
    yield buf[i]
    buf[i] = row
  rnd.shuffle(buf)
  yield from buf


def batched(rows: Iterable, batch_size: int, drop_remainder: bool = True,
            collate: Optional[Callable] = None) -> Iterator:
  """Group rows into batches; ``collate`` maps a list of rows to arrays
  (default: numpy-stack each column)."""

  def _default_collate(batch):
    if isinstance(batch[0], (tuple, list)):
      return tuple(np.asarray([row[i] for row in batch])
                   for i in range(len(batch[0])))
    return np.asarray(batch)

  collate = collate or _default_collate
  it = iter(rows)
  while True:
    batch = list(itertools.islice(it, batch_size))
    if not batch:
      return
    if len(batch) < batch_size and drop_remainder:
      return
    yield collate(batch)


def _map_batch(batch, fn):
  """``fn`` over every array of a batch: an array or tensor, or a dict,
  tuple, list or :class:`Slab` of them."""
  if isinstance(batch, dict):
    return {k: _map_batch(v, fn) for k, v in batch.items()}
  if isinstance(batch, tuple) and hasattr(batch, "_fields"):
    return type(batch)(*(_map_batch(v, fn) for v in batch))
  if isinstance(batch, (tuple, list)):
    return type(batch)(_map_batch(v, fn) for v in batch)
  return fn(batch)


def _as_tensor(a) -> torch.Tensor:
  if torch.is_tensor(a):
    return a
  # a read-only view (DataFeed hands those out) is copied, not shared
  return torch.from_numpy(np.require(a, requirements=("C", "W")))


def _pinned_copy(a) -> torch.Tensor:
  """A copy of ``a`` in pinned host memory: the source of an asynchronous
  copy to the card, and never a view of the caller's array."""
  if torch.is_tensor(a):
    return torch.empty_like(a, device="cpu", pin_memory=True).copy_(a)
  a = np.asarray(a)
  pinned = torch.empty(a.shape, dtype=torch.from_numpy(a[:0].copy()).dtype,
                       pin_memory=True)
  pinned.numpy()[...] = a
  return pinned


def device_prefetch(batches: Iterable, size: int = 2, device=None,
                    stream: Optional["torch.cuda.Stream"] = None
                    ) -> Iterator:
  """Double-buffered host-to-card transfer (the reference's
  ``device_prefetch``): at most ``size`` batches (clamped to >= 1) are on
  their way or on the card, so the copy of batch N+1 overlaps the compute
  on batch N; with a blocking source the first yield comes after ``size``
  batches have been staged.

  ``device``: ``None`` is the card. There each array of a batch is copied
  into pinned host memory, then to the card by ``non_blocking`` copies on
  a side stream (``stream``, else a new one); an event recorded after the
  copies is waited on by the consuming stream (the current stream when
  the batch is yielded) before anything queued there can use the batch.
  For ``device="cpu"`` batches are only converted to tensors.
  """
  size = max(1, size)
  dev = resolve_device(device)
  if dev.type != "cuda":
    for batch in batches:
      yield _map_batch(batch, _as_tensor)
    return
  side = stream if stream is not None else torch.cuda.Stream(dev)
  queue = collections.deque()

  def _ready(moved, done):
    consumer = torch.cuda.current_stream(dev)
    consumer.wait_event(done)
    # the caching allocator must not hand the memory back to the side
    # stream while the consumer may still read it
    _map_batch(moved, lambda t: t.record_stream(consumer))
    return moved

  for batch in batches:
    host = _map_batch(batch, _pinned_copy)
    with torch.cuda.stream(side):
      moved = _map_batch(host, lambda t: t.to(dev, non_blocking=True))
      done = torch.cuda.Event()
      done.record(side)
    queue.append((moved, done))
    if len(queue) >= size:
      yield _ready(*queue.popleft())
  while queue:
    yield _ready(*queue.popleft())
