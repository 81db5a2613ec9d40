"""Checkpointable FILES-mode input: deterministic index-based sampling.

The port's copy of ``tensorflowonspark_tpu/data/indexed.py``: the input
stream that resumes mid-epoch from a checkpoint.

- :func:`build_index`: per-file record offsets (one header-skip scan,
  cached in a ``.tosidx`` sidecar of the same ``TOSIDX2`` layout, so a
  sidecar written by either package opens in the other) make TFRecord
  files random-access.
- :class:`IndexedTFRecordDataset`: a global ``[0, N)`` index space over a
  list of files with ``record(i)`` random access.
- :func:`permute_index`: a 4-round Feistel cipher over the index domain,
  the same bijection as the reference's, index for index.
- :class:`CheckpointableInput`: batches from the permuted index stream;
  its whole state is one position plus the config, a small JSON dict that
  rides in a checkpoint (``CheckpointManager.save(data_state=...)``). The
  states are the reference's, so either package resumes the other's.

Epoch ordering differs per epoch (the cipher key folds the epoch in), and
sharding happens in sample space (worker w of W takes positions ``w::W``
of the permuted stream).
"""

import collections
import hashlib
import logging
import os
import struct
from typing import Iterator, Optional, Sequence

import numpy as np

from tensorflowonspark_tpu_torch.data import dfutil, example_codec, fs

logger = logging.getLogger(__name__)

_IDX_MAGIC = b"TOSIDX2\n"
_IDX_SUFFIX = ".tosidx"


# -- record index --------------------------------------------------------------


def _scan_offsets(path: str) -> np.ndarray:
  """One pass over a TFRecord file reading only the 12-byte headers
  (``[len u64][len_crc u32][payload][payload_crc u32]``); payloads are
  skipped with seek."""
  offsets = []
  with fs.open_file(path, "rb") as f:
    pos = 0
    while True:
      header = f.read(12)
      if not header:
        break
      if len(header) < 12:
        raise IOError("truncated TFRecord header in %s at %d" % (path, pos))
      (length,) = struct.unpack("<Q", header[:8])
      offsets.append(pos)
      pos += 12 + length + 4
      f.seek(pos)
  return np.asarray(offsets, dtype=np.int64)


def _sidecar_path(path: str) -> str:
  return path + _IDX_SUFFIX


def build_index(path: str, cache: bool = True) -> np.ndarray:
  """Record byte offsets of one TFRecord file, cached in a sidecar that
  records the file's (size, mtime_ns): a same-size rewrite whose record
  boundaries moved is seen by its mtime. A remote file (fsspec) is
  indexed but never cached: writing next to remote data is often not
  permitted."""
  remote = fs.is_remote(path)
  cache = cache and not remote
  data_size = fs.file_size(path)
  mtime_ns = 0 if remote else os.stat(fs.strip_scheme(path)).st_mtime_ns
  side = _sidecar_path(fs.strip_scheme(path))
  if cache and os.path.exists(side):
    try:
      with open(side, "rb") as f:
        magic = f.read(len(_IDX_MAGIC))
        if magic == _IDX_MAGIC:
          (indexed_size, indexed_mtime,
           count) = struct.unpack("<QQQ", f.read(24))
          if indexed_size == data_size and indexed_mtime == mtime_ns:
            offsets = np.frombuffer(f.read(8 * count), dtype="<i8")
            if len(offsets) == count:
              return offsets.astype(np.int64)
        logger.warning("stale/corrupt index sidecar %s; rebuilding", side)
    except (OSError, struct.error) as e:
      logger.warning("unreadable index sidecar %s (%s); rebuilding", side, e)
  offsets = _scan_offsets(path)
  if cache:
    tmp = side + ".tmp.%d" % os.getpid()
    try:
      with open(tmp, "wb") as f:
        f.write(_IDX_MAGIC)
        f.write(struct.pack("<QQQ", data_size, mtime_ns, len(offsets)))
        f.write(offsets.astype("<i8").tobytes())
      os.replace(tmp, side)   # atomic: concurrent builders race benignly
    except OSError as e:
      logger.warning("cannot write index sidecar %s (%s)", side, e)
  return offsets


# -- random-access dataset -----------------------------------------------------


class IndexedTFRecordDataset(object):
  """A global random-access view over a list of TFRecord files.

  ``record(i)`` decodes as ``readers.read_tfrecord_examples`` does (schema
  tuple rows via ``dfutil``, else raw feature dicts). File handles open
  lazily and stay open in an LRU of ``max_open_files``.
  """

  def __init__(self, paths: Sequence[str], schema=None, cache: bool = True,
               max_open_files: int = 64):
    if not paths:
      raise ValueError("IndexedTFRecordDataset needs at least one file")
    self.paths = list(paths)
    self.schema = schema
    self.max_open_files = max(1, max_open_files)
    self._offsets = [build_index(p, cache=cache) for p in self.paths]
    counts = np.asarray([len(o) for o in self._offsets], dtype=np.int64)
    self._starts = np.concatenate([[0], np.cumsum(counts)])
    self._files = collections.OrderedDict()   # LRU of open handles

  def __len__(self) -> int:
    return int(self._starts[-1])

  def fingerprint(self) -> str:
    """Identity of the file layout (basenames + per-file record counts),
    carried in ``CheckpointableInput`` states so a resume against
    re-sharded data of equal total length fails loudly."""
    parts = ["%s:%d" % (os.path.basename(p), len(o))
             for p, o in zip(self.paths, self._offsets)]
    return hashlib.md5("|".join(parts).encode()).hexdigest()[:16]

  def _locate(self, index: int):
    if not 0 <= index < len(self):
      raise IndexError("record %d out of range [0, %d)" % (index, len(self)))
    file_i = int(np.searchsorted(self._starts, index, side="right") - 1)
    return file_i, int(index - self._starts[file_i])

  def _file(self, file_i: int):
    f = self._files.get(file_i)
    if f is not None:
      self._files.move_to_end(file_i)
      return f
    while len(self._files) >= self.max_open_files:
      _, old = self._files.popitem(last=False)
      old.close()
    f = fs.open_file(self.paths[file_i], "rb")
    self._files[file_i] = f
    return f

  def raw_record(self, index: int) -> bytes:
    file_i, rec_i = self._locate(index)
    f = self._file(file_i)
    f.seek(int(self._offsets[file_i][rec_i]))
    header = f.read(12)
    if len(header) < 12:
      raise IOError("truncated header for record %d in %s (stale index? "
                    "delete %s)" % (rec_i, self.paths[file_i],
                                    _sidecar_path(self.paths[file_i])))
    (length,) = struct.unpack("<Q", header[:8])
    payload = f.read(length)
    if len(payload) < length:
      raise IOError("truncated record %d in %s" % (rec_i, self.paths[file_i]))
    return payload

  def record(self, index: int):
    raw = self.raw_record(index)
    if self.schema is not None:
      return dfutil.from_example(raw, self.schema)
    return example_codec.decode_example(raw)

  def close(self) -> None:
    for f in self._files.values():
      f.close()
    self._files.clear()


# -- Feistel index permutation -------------------------------------------------


def _mix(x: int, key: int) -> int:
  """splitmix64-style avalanche; the Feistel round function."""
  x = (x + key) & 0xFFFFFFFFFFFFFFFF
  x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
  x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
  return x ^ (x >> 31)


def permute_index(i: int, n: int, key: int, rounds: int = 4) -> int:
  """The position of ``i`` under a seeded bijection of ``[0, n)``: a
  balanced Feistel network over the smallest even-bit-width domain
  covering ``n``, cycle-walking values that land outside ``[0, n)``."""
  if n <= 1:
    return 0
  half_bits = ((n - 1).bit_length() + 1) // 2
  mask = (1 << half_bits) - 1
  while True:
    left, right = i >> half_bits, i & mask
    for r in range(rounds):
      left, right = right, left ^ (_mix(right, key + r) & mask)
    i = (left << half_bits) | right
    if i < n:
      return i


# -- checkpointable iterator ---------------------------------------------------


class CheckpointableInput(object):
  """Deterministic, sharded, resumable batch iterator.

  Position ``p`` of this worker's stream maps to global sample position
  ``p * num_shards + shard_index``, which maps through the epoch's Feistel
  key to a record index. The state is ``p`` (``get_state()`` /
  ``set_state()`` / ``state``): two iterators with equal config and state
  yield identical batches. ``num_epochs=None`` streams indefinitely; with
  ``shuffle=False`` the permutation is the identity.
  """

  def __init__(self, dataset, batch_size: int, shard_index: int = 0,
               num_shards: int = 1, seed: int = 0, shuffle: bool = True,
               num_epochs: Optional[int] = None, drop_remainder: bool = True,
               collate=None):
    if num_shards < 1 or not 0 <= shard_index < num_shards:
      raise ValueError("bad shard spec %d/%d" % (shard_index, num_shards))
    if batch_size < 1:
      raise ValueError("batch_size must be >= 1")
    self.dataset = dataset
    self.batch_size = batch_size
    self.shard_index = shard_index
    self.num_shards = num_shards
    self.seed = seed
    self.shuffle = shuffle
    self.num_epochs = num_epochs
    self.drop_remainder = drop_remainder
    self._collate = collate or self._default_collate
    self._pos = 0

  @staticmethod
  def _default_collate(batch):
    if isinstance(batch[0], (tuple, list)):
      return tuple(np.asarray([row[i] for row in batch])
                   for i in range(len(batch[0])))
    return np.asarray(batch)

  # -- state -------------------------------------------------------------------

  @property
  def state(self) -> dict:
    return self.get_state()

  def get_state(self) -> dict:
    """A small JSON-safe dict; ``config`` rides along so a restore into a
    differently configured iterator fails loudly."""
    cfg = {"len": len(self.dataset), "seed": self.seed,
           "shard_index": self.shard_index,
           "num_shards": self.num_shards,
           "batch_size": self.batch_size,
           "shuffle": self.shuffle}
    fp = getattr(self.dataset, "fingerprint", None)
    if fp is not None:
      cfg["data_fingerprint"] = fp()
    return {"position": self._pos, "config": cfg}

  def set_state(self, state: dict) -> None:
    cfg = state.get("config")
    if cfg is not None and cfg != self.get_state()["config"]:
      raise ValueError(
          "iterator state was saved under a different input config: "
          "%r vs %r — resume with identical data/shard/batch settings"
          % (cfg, self.get_state()["config"]))
    self._pos = int(state["position"])

  # -- iteration ---------------------------------------------------------------

  def _epoch_len(self) -> int:
    """Samples per epoch for THIS worker."""
    base, extra = divmod(len(self.dataset), self.num_shards)
    return base + (1 if self.shard_index < extra else 0)

  def _record_index(self, worker_pos: int) -> int:
    epoch, within = divmod(worker_pos, self._epoch_len())
    global_pos = within * self.num_shards + self.shard_index
    if not self.shuffle:
      return global_pos
    return permute_index(global_pos, len(self.dataset),
                         _mix(self.seed, epoch))

  def __iter__(self) -> Iterator:
    per_epoch = self._epoch_len()
    if per_epoch == 0:
      # more shards than records: an empty stream when finite; streaming,
      # an endless empty iterator would hang a training loop
      if self.num_epochs is None:
        raise ValueError(
            "streaming iteration over an empty shard (%d records, shard "
            "%d/%d) would never yield; size shards to workers instead"
            % (len(self.dataset), self.shard_index, self.num_shards))
      return
    while True:
      if self.num_epochs is not None:
        end = self.num_epochs * per_epoch
        if self._pos >= end:
          return
        room = end - self._pos
        if room < self.batch_size and self.drop_remainder:
          self._pos = end
          return
        take = min(self.batch_size, room)
      else:
        take = self.batch_size
      rows = [self.dataset.record(self._record_index(self._pos + j))
              for j in range(take)]
      # the state advances only after a batch is fully assembled
      self._pos += take
      yield self._collate(rows)


def checkpointable_input(pattern_or_paths, batch_size: int, schema=None,
                         shard_index: int = 0, num_shards: int = 1,
                         seed: int = 0, shuffle: bool = True,
                         num_epochs: Optional[int] = None,
                         drop_remainder: bool = True,
                         collate=None) -> CheckpointableInput:
  """Glob/list -> :class:`CheckpointableInput` in one call. Every worker
  indexes the full sorted file list and takes its slice in sample space."""
  if isinstance(pattern_or_paths, str):
    paths = sorted(fs.glob_files(pattern_or_paths))
  else:
    paths = sorted(pattern_or_paths)
  if not paths:
    raise FileNotFoundError("no input files match %r" % (pattern_or_paths,))
  ds = IndexedTFRecordDataset(paths, schema=schema)
  return CheckpointableInput(
      ds, batch_size, shard_index=shard_index, num_shards=num_shards,
      seed=seed, shuffle=shuffle, num_epochs=num_epochs,
      drop_remainder=drop_remainder, collate=collate)


__all__ = ["build_index", "IndexedTFRecordDataset", "permute_index",
           "CheckpointableInput", "checkpointable_input"]
