"""Remote storage in the PyTorch port, on fsspec's ``memory://`` filesystem.

The port routes any ``scheme://`` but ``file://`` through fsspec, as the
JAX package does (``tests/test_data.py``'s ``TestRemoteFS``): TFRecord
files, ``shard_files``, ``save_as_tfrecords`` / ``load_tfrecords``, the
indexed reader, checkpoints and exports. ``gs://`` takes the same code
path through gcsfs.
"""

import sys

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.data import tfrecord as jax_tfrecord
from tensorflowonspark_tpu_torch import optim
from tensorflowonspark_tpu_torch.data import (dfutil, example_codec, fs,
                                              indexed, readers, schema,
                                              tfrecord)
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.parallel import sharding
from tensorflowonspark_tpu_torch.utils import compat
from tensorflowonspark_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                          params_fingerprint)

TOKENS = schema.parse_schema("struct<tokens:array<long>>")


@pytest.fixture(autouse=True)
def memfs():
  """fsspec's in-memory filesystem, emptied around each test."""
  import fsspec
  mem = fsspec.filesystem("memory")
  mem.store.clear()
  mem.pseudo_dirs[:] = [""]
  yield mem
  mem.store.clear()
  mem.pseudo_dirs[:] = [""]


def _records(n, seed=0):
  rng = np.random.default_rng(seed)
  return [example_codec.encode_example(
      {"tokens": [int(v) for v in rng.integers(0, 1000, 1 + i % 9)]})
      for i in range(n)] + [b""]


def test_tfrecord_round_trip_remote():
  records = [b"alpha", b"", b"\x01\x02" * 500] + _records(5)
  with tfrecord.TFRecordWriter("memory://bucket/data/x.tfrecord") as w:
    assert isinstance(w, tfrecord.PyTFRecordWriter)
    for r in records:
      w.write(r)
  assert list(tfrecord.TFRecordReader("memory://bucket/data/x.tfrecord")) \
      == records
  # the reference reads the port's remote file, and the port the
  # reference's, byte for byte
  assert list(jax_tfrecord.TFRecordReader(
      "memory://bucket/data/x.tfrecord")) == records
  with jax_tfrecord.TFRecordWriter("memory://bucket/data/y.tfrecord") as w:
    for r in records:
      w.write(r)
  with fs.open_file("memory://bucket/data/x.tfrecord") as a, \
      fs.open_file("memory://bucket/data/y.tfrecord") as b:
    assert a.read() == b.read()


def test_shard_files_remote_pattern():
  for i in range(5):
    with tfrecord.TFRecordWriter("memory://bucket/ds/part-%02d" % i) as w:
      w.write(b"r%d" % i)
  shards0 = readers.shard_files("memory://bucket/ds/part-*", 2, 0)
  shards1 = readers.shard_files("memory://bucket/ds/part-*", 2, 1)
  assert len(shards0) + len(shards1) == 5
  assert not set(shards0) & set(shards1)
  assert all(p.startswith("memory://") for p in shards0 + shards1)
  rows = [rec for p in sorted(shards0 + shards1)
          for rec in tfrecord.TFRecordReader(p)]
  assert rows == [b"r0", b"r1", b"r2", b"r3", b"r4"]


def test_file_scheme_uses_the_native_codec(tmp_path):
  path = "file://" + str(tmp_path / "y.tfrecord")
  with tfrecord.TFRecordWriter(path) as w:
    assert isinstance(w, tfrecord.NativeTFRecordWriter)
    w.write(b"local")
  reader = tfrecord.TFRecordReader(path)
  assert isinstance(reader, tfrecord.NativeTFRecordReader)
  assert list(reader) == [b"local"]


def test_dfutil_round_trip_remote():
  sch = schema.parse_schema("struct<idx:long,name:string>")
  rows = [(i, "n%d" % i) for i in range(8)]
  paths = dfutil.save_as_tfrecords([rows[:4], rows[4:]], sch,
                                   "memory://bucket/out")
  assert paths == ["memory://bucket/out/part-00000.tfrecord",
                   "memory://bucket/out/part-00001.tfrecord"]
  loaded, _ = dfutil.load_tfrecords("memory://bucket/out", schema=sch)
  assert sorted(r for p in loaded for r in p) == rows
  lazy, inferred = dfutil.load_tfrecords("memory://bucket/out", lazy=True)
  assert [f.name for f in inferred.fields] == ["idx", "name"]
  assert sorted(r for p in lazy for r in p()) == rows
  assert dfutil.is_loaded_path("memory://bucket/out")


def test_read_tfrecord_examples_remote():
  dfutil.save_as_tfrecords([[(7,)], [(9,)]],
                           schema.parse_schema("struct<idx:long>"),
                           "memory://bucket/ex")
  got = sorted(readers.read_tfrecord_examples(
      readers.shard_files("memory://bucket/ex/part-*", 1, 0),
      schema=schema.parse_schema("struct<idx:long>")))
  assert got == [(7,), (9,)]


def test_indexed_reader_remote_equals_local(tmp_path, memfs):
  """``checkpointable_input`` over remote files gives the local files'
  batches and states; remote files are indexed but get no sidecar."""
  for f in range(3):
    recs = _records(6, seed=f)
    for root in ("memory://bucket/idx", str(tmp_path)):
      with tfrecord.TFRecordWriter(fs.join(root, "part-%d.tfrecord" % f)) \
          as w:
        for r in recs[:-1]:
          w.write(r)
  kw = dict(batch_size=4, schema=TOKENS, seed=3, num_epochs=2,
            collate=lambda rows: [r[0] for r in rows])
  remote = indexed.checkpointable_input("memory://bucket/idx/part-*", **kw)
  local = indexed.checkpointable_input(str(tmp_path / "part-*"), **kw)
  got, want = list(remote), list(local)
  assert got == want and len(got) == 9
  assert remote.get_state() == local.get_state()
  assert not any(p.endswith(".tosidx") for p in memfs.store)
  assert indexed.build_index("memory://bucket/idx/part-0.tfrecord").tolist() \
      == indexed.build_index(str(tmp_path / "part-0.tfrecord")).tolist()


SMALL = dict(vocab_size=64, num_layers=1, num_heads=4, d_model=32, d_ff=64,
             max_seq_len=16, dtype=torch.float32)


def _state():
  tx = optim.make_optimizer(learning_rate=1e-2, optimizer="adafactor")
  return tfm.create_state(tfm.TransformerConfig(**SMALL), 0, tx=tx,
                          device="cpu")


def test_checkpoint_save_restore_remote(memfs):
  """A train state saved to ``memory://`` each step (3 kept), with the
  input position, restores to the bit; no commit marker is written."""
  step = sharding.make_train_step(lambda m, t: tfm.causal_lm_loss(m(t), t))
  batches = [np.random.default_rng(i).integers(0, 64, (2, 16))
             for i in range(5)]
  mgr = CheckpointManager("memory://ckpt/run/", save_interval_steps=1,
                          max_to_keep=3)
  straight, losses = _state(), []
  for i, b in enumerate(batches):
    straight, loss = step(straight, b)
    losses.append(float(loss))
    if i < 3:
      assert mgr.save(i, straight, data_state={"position": i})
  assert mgr.all_steps() == [0, 1, 2] and mgr.latest_step() == 2
  assert not any(".commit-" in p for p in memfs.store)
  assert mgr.save(3, straight) and mgr.all_steps() == [1, 2, 3]
  fs.remove_tree("memory://ckpt/run/3")          # back to step 2
  resumed, start = CheckpointManager("memory://ckpt/run").restore_or(_state())
  assert start == 3 and resumed.step == 3
  assert mgr.restore(_state(), step=2, with_data=True)[1] == {"position": 2}
  got = []
  for b in batches[start:]:
    resumed, loss = step(resumed, b)
    got.append(float(loss))
  assert got == losses[3:]
  assert params_fingerprint(resumed.params) == \
      params_fingerprint(straight.params)


def test_remote_restore_skips_a_step_without_its_tree(memfs):
  """A save cut short before ``state.json`` leaves a step that does not
  load: ``restore_or`` falls back to the newest step that does."""
  mgr = CheckpointManager("memory://ckpt/torn", save_interval_steps=1)
  for i in range(2):
    assert mgr.save(i, {"w": torch.full((3,), float(i))})
  memfs.rm("/ckpt/torn/1/state.json")
  state, start = mgr.restore_or({"w": torch.zeros(3)})
  assert start == 1 and torch.equal(state["w"], torch.zeros(3))


def test_export_and_import_remote():
  state = _state()
  out = compat.export_model(state.params, "memory://exports/m", True)
  assert out == "memory://exports/m"
  back = compat.import_model("memory://exports/m")
  assert sorted(back) == sorted(state.params)
  for name, p in state.params.items():
    assert torch.equal(back[name], p.detach()), name
  # a second export replaces the first
  compat.export_model({"w": torch.ones(2)}, "memory://exports/m/", True)
  assert list(compat.import_model("memory://exports/m")) == ["w"]
  # a non-chief writes to a local temporary directory, never the target
  other = compat.export_model({"w": torch.zeros(2)}, "memory://exports/m",
                              False)
  assert not fs.is_remote(other)
  assert torch.equal(compat.import_model("memory://exports/m")["w"],
                     torch.ones(2))


def test_remote_paths_need_fsspec(monkeypatch):
  monkeypatch.setitem(sys.modules, "fsspec", None)
  for call in (lambda: fs.open_file("memory://bucket/x"),
               lambda: readers.shard_files("memory://bucket/part-*", 1, 0),
               lambda: CheckpointManager("memory://ckpt/x")):
    with pytest.raises(ImportError, match="fsspec"):
      call()
