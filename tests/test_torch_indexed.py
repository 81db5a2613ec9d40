"""The port's checkpointable FILES input (``data/indexed.py``) held against
the JAX package's on the CPU.

- ``permute_index`` and ``_mix`` equal to the reference's, index for
  index, over a sweep of (n, key);
- record offsets and decoded records equal, on files written by either
  package; a ``.tosidx`` sidecar written by each package read by the
  other without a rescan;
- ``CheckpointableInput`` batches and ``get_state()`` dicts equal to the
  reference's over two epochs and two shards, and a reference state
  accepted by the port's ``set_state`` (and the other way round);
- the mismatch, truncation, LRU and empty-shard cases of
  ``tests/test_readers_checkpoint.py``'s ``TestIndexedPipeline``.
"""

import os
import time

import numpy as np
import pytest

from tensorflowonspark_tpu.data import dfutil as ref_dfutil
from tensorflowonspark_tpu.data import indexed as ref
from tensorflowonspark_tpu.data.schema import parse_schema as ref_schema
from tensorflowonspark_tpu_torch.data import example_codec, fs, indexed, tfrecord
from tensorflowonspark_tpu_torch.data.schema import parse_schema

SCHEMA = "struct<x:float,y:long>"


def _write(root, num_files=4, rows_per=5):
  """Rows ``(f * 100 + i, f)`` in ``num_files`` files, by the reference's
  writer; returns the glob pattern."""
  out = str(root / "ds")
  parts = [[(float(f * 100 + i), f) for i in range(rows_per)]
           for f in range(num_files)]
  ref_dfutil.save_as_tfrecords(parts, ref_schema(SCHEMA), out)
  return os.path.join(out, "*.tfrecord")


def _write_port(path, rows):
  with tfrecord.TFRecordWriter(path) as w:
    for x, y in rows:
      w.write(example_codec.encode_example({"x": [x], "y": [y]}))


def _both(pattern, **kw):
  """(reference input, port input) over ``pattern`` with ``kw``."""
  return (ref.checkpointable_input(pattern, schema=ref_schema(SCHEMA), **kw),
          indexed.checkpointable_input(pattern, schema=parse_schema(SCHEMA),
                                       **kw))


def _assert_batches_equal(a, b):
  assert len(a) == len(b)
  for x, y in zip(a, b):
    for u, v in zip(x, y):
      np.testing.assert_array_equal(u, v)


# -- the permutation -------------------------------------------------------------

KEYS = (0, 1, 42, 2 ** 40 + 3, 2 ** 63 + 5)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 17, 257, 1000, 4097])
def test_permute_index_equals_the_reference(n):
  for key in KEYS + (ref._mix(7, 3),):
    got = [indexed.permute_index(i, n, key) for i in range(n)]
    assert got == [ref.permute_index(i, n, key) for i in range(n)], key
    assert sorted(got) == list(range(n))
  for rounds in (1, 3, 6):
    assert [indexed.permute_index(i, n, 9, rounds) for i in range(n)] == \
        [ref.permute_index(i, n, 9, rounds) for i in range(n)]


def test_mix_equals_the_reference():
  rng = np.random.default_rng(0)
  for x, key in rng.integers(0, 2 ** 63, size=(64, 2)).tolist() + [
      (0, 0), (2 ** 64 - 1, 2 ** 64 - 1), (5, 2 ** 64 - 3)]:
    assert indexed._mix(x, key) == ref._mix(x, key)


# -- offsets, records and the sidecar ---------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_offsets_and_records_equal(tmp_path, writer):
  if writer == "reference":
    paths = sorted(fs.glob_files(_write(tmp_path, num_files=3, rows_per=7)))
  else:
    rng = np.random.default_rng(1)
    paths = []
    for f in range(3):
      p = str(tmp_path / ("p%d.tfrecord" % f))
      _write_port(p, [(float(v), int(v) % 5) for v in rng.integers(0, 99, 7)])
      paths.append(p)
  for p in paths:
    np.testing.assert_array_equal(indexed._scan_offsets(p),
                                  ref._scan_offsets(p))
  mine = indexed.IndexedTFRecordDataset(paths, schema=parse_schema(SCHEMA),
                                        cache=False)
  theirs = ref.IndexedTFRecordDataset(paths, schema=ref_schema(SCHEMA),
                                      cache=False)
  assert len(mine) == len(theirs) == 21
  assert mine.fingerprint() == theirs.fingerprint()
  for i in (20, 0, 7, 13, 14, 6):
    assert mine.record(i) == theirs.record(i)
    assert mine.raw_record(i) == theirs.raw_record(i)
  raw = indexed.IndexedTFRecordDataset(paths, cache=False)
  assert raw.record(3) == ref.IndexedTFRecordDataset(paths, cache=False) \
      .record(3)
  for ds in (mine, theirs, raw):
    ds.close()


@pytest.mark.parametrize("first", ["reference", "port"])
def test_sidecar_written_by_one_package_opens_in_the_other(tmp_path,
                                                           monkeypatch, first):
  path = sorted(fs.glob_files(_write(tmp_path, num_files=1, rows_per=6)))[0]
  build = {"reference": ref, "port": indexed}
  other = "port" if first == "reference" else "reference"
  offsets = build[first].build_index(path)
  with open(path + ".tosidx", "rb") as f:
    sidecar = f.read()
  assert sidecar.startswith(b"TOSIDX2\n")

  def no_rescan(p):
    raise AssertionError("the sidecar was not used")

  monkeypatch.setattr(build[other], "_scan_offsets", no_rescan)
  np.testing.assert_array_equal(build[other].build_index(path), offsets)
  monkeypatch.undo()
  # each package writes the same bytes
  os.remove(path + ".tosidx")
  build[other].build_index(path)
  with open(path + ".tosidx", "rb") as f:
    assert f.read() == sidecar


def test_sidecar_cache_and_staleness(tmp_path):
  path = sorted(fs.glob_files(_write(tmp_path, num_files=1, rows_per=3)))[0]
  offsets = indexed.build_index(path)
  assert len(offsets) == 3
  assert os.path.exists(path + ".tosidx")
  np.testing.assert_array_equal(indexed.build_index(path), offsets)
  _write_port(path, [(float(i), i) for i in range(4)])
  assert len(indexed.build_index(path)) == 4


def test_sidecar_detects_same_size_rewrite(tmp_path):
  path = str(tmp_path / "same_size.tfrecord")
  with tfrecord.TFRecordWriter(path) as w:
    w.write(b"aaaa")
    w.write(b"bbbbbbbb")
  assert len(indexed.build_index(path)) == 2
  time.sleep(0.01)
  with tfrecord.TFRecordWriter(path) as w:
    w.write(b"aaaaaaaa")
    w.write(b"bbbb")
  second = indexed.build_index(path)
  assert second[1] - second[0] == 12 + 8 + 4


# -- the checkpointable input -------------------------------------------------------


@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_and_states_equal_over_two_epochs_and_two_shards(tmp_path,
                                                                 shuffle):
  pattern = _write(tmp_path, num_files=3, rows_per=5)     # 15 rows
  for shard in range(2):
    theirs, mine = _both(pattern, batch_size=2, shard_index=shard,
                         num_shards=2, seed=11, shuffle=shuffle, num_epochs=2,
                         drop_remainder=False)
    got_t, got_m = [], []
    for it, got in ((theirs, got_t), (mine, got_m)):
      for batch in it:
        got.append((batch, it.get_state()))
    assert [s for _, s in got_m] == [s for _, s in got_t]
    _assert_batches_equal([b for b, _ in got_m], [b for b, _ in got_t])
    assert sum(len(b[0]) for b, _ in got_m) == 2 * (8 if shard == 0 else 7)


def test_states_cross_between_the_packages(tmp_path):
  pattern = _write(tmp_path)
  theirs, mine = _both(pattern, batch_size=3, seed=7)
  it = iter(theirs)
  for _ in range(4):
    next(it)
  snap = theirs.get_state()
  expected = [next(it) for _ in range(5)]
  mine.set_state(snap)
  im = iter(mine)
  _assert_batches_equal([next(im) for _ in range(5)], expected)
  # and back: the port's state resumes the reference
  back = ref.checkpointable_input(pattern, batch_size=3,
                                  schema=ref_schema(SCHEMA), seed=7)
  back.set_state(mine.get_state())
  _assert_batches_equal([next(iter(back)) for _ in range(2)],
                        [next(im) for _ in range(2)])


def test_resume_is_exact(tmp_path):
  def make():
    return indexed.checkpointable_input(_write(tmp_path), batch_size=3,
                                        schema=parse_schema(SCHEMA), seed=7)

  a = make()
  ia = iter(a)
  for _ in range(4):
    next(ia)
  snap = a.get_state()
  expected = [next(ia) for _ in range(5)]
  b = make()
  b.set_state(snap)
  ib = iter(b)
  _assert_batches_equal([next(ib) for _ in range(5)], expected)


def test_shards_cover_each_epoch_exactly_once(tmp_path):
  pattern = _write(tmp_path)   # 20 rows
  seen = []
  for w in range(3):
    it = indexed.checkpointable_input(pattern, batch_size=1,
                                      schema=parse_schema(SCHEMA),
                                      shard_index=w, num_shards=3, seed=5,
                                      num_epochs=1, drop_remainder=False)
    seen.extend(float(b[0][0]) for b in it)
  assert len(seen) == 20 and len(set(seen)) == 20


def test_epochs_reshuffle(tmp_path):
  it = indexed.checkpointable_input(_write(tmp_path), batch_size=20,
                                    schema=parse_schema(SCHEMA), seed=0,
                                    num_epochs=2)
  e1, e2 = [tuple(b[0].tolist()) for b in it]
  assert sorted(e1) == sorted(e2)
  assert e1 != e2


def test_set_state_rejects_config_mismatch(tmp_path):
  pattern = _write(tmp_path)
  theirs, _ = _both(pattern, batch_size=3, seed=7)
  _, other = _both(pattern, batch_size=4, seed=7)
  with pytest.raises(ValueError, match="different input config"):
    other.set_state(theirs.get_state())


def test_resume_rejects_different_data_layout(tmp_path):
  a = ref.checkpointable_input(_write(tmp_path / "a", num_files=4,
                                      rows_per=5),
                               batch_size=3, schema=ref_schema(SCHEMA), seed=7)
  snap = a.get_state()
  assert "data_fingerprint" in snap["config"]
  b = indexed.checkpointable_input(_write(tmp_path / "b", num_files=2,
                                          rows_per=10),
                                   batch_size=3, schema=parse_schema(SCHEMA),
                                   seed=7)
  with pytest.raises(ValueError, match="different input config"):
    b.set_state(snap)


def test_empty_shard_behavior(tmp_path):
  pattern = _write(tmp_path, num_files=1, rows_per=3)
  finite = indexed.checkpointable_input(
      pattern, batch_size=1, schema=parse_schema(SCHEMA), shard_index=7,
      num_shards=8, num_epochs=1, drop_remainder=False)
  assert list(finite) == []
  streaming = indexed.checkpointable_input(
      pattern, batch_size=1, schema=parse_schema(SCHEMA), shard_index=7,
      num_shards=8)
  with pytest.raises(ValueError, match="empty shard"):
    next(iter(streaming))


def test_file_handle_lru_eviction(tmp_path):
  paths = sorted(fs.glob_files(_write(tmp_path, num_files=4, rows_per=5)))
  ds = indexed.IndexedTFRecordDataset(paths, schema=parse_schema(SCHEMA),
                                      max_open_files=2)
  rows = [ds.record(i) for i in range(len(ds))]
  assert len(ds._files) <= 2
  assert ds.record(0) == rows[0]
  ds.close()
  assert not ds._files


def test_truncated_file_raises_descriptive_error(tmp_path):
  path = sorted(fs.glob_files(_write(tmp_path, num_files=1, rows_per=3)))[0]
  ds = indexed.IndexedTFRecordDataset([path], schema=parse_schema(SCHEMA),
                                      cache=False)
  with open(path, "r+b") as f:
    f.truncate(os.path.getsize(path) - 10)
  with pytest.raises(IOError, match="truncated"):
    ds.record(2)
  ds.close()
  last = int(indexed._scan_offsets(path)[-1])
  with open(path, "r+b") as f:
    f.truncate(last + 5)                    # the last header cut short
  with pytest.raises(IOError, match="truncated TFRecord header"):
    indexed.build_index(path, cache=False)


def test_bad_specs_are_refused(tmp_path):
  pattern = _write(tmp_path, num_files=1, rows_per=3)
  with pytest.raises(ValueError, match="bad shard spec"):
    indexed.checkpointable_input(pattern, batch_size=1, shard_index=2,
                                 num_shards=2)
  with pytest.raises(ValueError, match="batch_size"):
    indexed.checkpointable_input(pattern, batch_size=0)
  with pytest.raises(FileNotFoundError):
    indexed.checkpointable_input(str(tmp_path / "none-*.tfrecord"), 1)
  with pytest.raises(ValueError, match="at least one file"):
    indexed.IndexedTFRecordDataset([])


def test_checkpoint_carries_data_state(tmp_path):
  import torch
  from tensorflowonspark_tpu_torch.utils.checkpoint import CheckpointManager

  def make():
    return indexed.checkpointable_input(_write(tmp_path), batch_size=3,
                                        schema=parse_schema(SCHEMA), seed=7)

  it = make()
  stream = iter(it)
  state = {"w": torch.zeros(2)}
  mgr = CheckpointManager(str(tmp_path / "ck"), save_interval_steps=1)
  for step in range(3):
    batch = next(stream)
    state = {"w": state["w"] + float(batch[0][0])}
    assert mgr.save(step, state, data_state=it.get_state())
  expected_next = [next(stream) for _ in range(2)]
  it2 = make()
  restored, next_step = CheckpointManager(
      str(tmp_path / "ck"), save_interval_steps=1).restore_or(
          {"w": torch.zeros(2)}, data_iterator=it2)
  assert next_step == 3
  assert torch.equal(restored["w"], state["w"])
  i2 = iter(it2)
  _assert_batches_equal([next(i2) for _ in range(2)], expected_next)
