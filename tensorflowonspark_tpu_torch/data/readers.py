"""Batches and slabs for the train loop.

Counterpart of the parts of ``tensorflowonspark_tpu/data/readers.py``
that the fused train loop consumes: :class:`Slab` and the generators
:func:`feed_batches` / :func:`slab_batches` over a feed. A feed is any
object with the ``DataFeed`` surface these use — ``should_stop()``,
``next_batch_arrays(batch_size, dtype=)`` and ``next_slab_arrays(
batch_size, unroll, dtype=)`` (a :class:`Slab`, or the partial tail's
rows). The port's own ``DataFeed`` and the double-buffered
``device_prefetch`` come with the data-feed slice (ROADMAP Queue 1 item
14).
"""

from typing import Any, Iterator, NamedTuple, Optional

from tensorflowonspark_tpu_torch.parallel.sharding import resolve_unroll


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
