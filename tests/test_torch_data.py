"""The port's data feed against the JAX package's, on the CPU.

TFRecord files written by either package are read by the other, record
for record; the FILES-mode pipeline (``shard_files`` -> ``shuffled`` ->
``batched``) gives the same batches from the same files and seed; the
port's ``train_gpt`` reads the batches the reference's ``batch_stream``
makes and trains on them.
"""

import os

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.data import dfutil as jax_dfutil
from tensorflowonspark_tpu.data import example_codec as jax_codec
from tensorflowonspark_tpu.data import readers as jax_readers
from tensorflowonspark_tpu.data import schema as jax_schema
from tensorflowonspark_tpu.data import tfrecord as jax_tfrecord
from tensorflowonspark_tpu_torch.data import (dfutil, example_codec,
                                              readers, schema, tfrecord)
from tensorflowonspark_tpu_torch.examples import train_gpt

TOKENS = "struct<tokens:array<long>>"
MIXED = "struct<label:long,x:array<float>,name:string,tokens:array<long>>"


def _mixed_rows(n, seed):
  rng = np.random.default_rng(seed)
  return [(int(rng.integers(-5, 5)), [float(v) for v in rng.random(3)],
           "row-%d" % i, [int(v) for v in rng.integers(0, 2 ** 40, 1 + i % 7)])
          for i in range(n)]


def _write(writer_cls, path, records):
  w = writer_cls(path)
  for r in records:
    w.write(r)
  w.close()


def _read_bytes(path):
  with open(path, "rb") as f:
    return f.read()


def test_codec_and_schema_match_the_reference():
  for row in _mixed_rows(5, 0):
    feats = {"label": [row[0]], "x": row[1], "name": [row[2].encode()],
             "tokens": row[3]}
    enc = example_codec.encode_example(feats)
    assert enc == jax_codec.encode_example(feats)
    assert example_codec.decode_example(enc) == jax_codec.decode_example(enc)
  assert str(schema.parse_schema(MIXED)) == str(jax_schema.parse_schema(MIXED))


def test_jax_written_tfrecords_read_by_the_port(tmp_path):
  sch_j = jax_schema.parse_schema(MIXED)
  records = [jax_dfutil.to_example(r, sch_j) for r in _mixed_rows(12, 1)]
  jpath = str(tmp_path / "jax.tfrecord")
  _write(jax_tfrecord.TFRecordWriter, jpath, records)
  got = list(tfrecord.TFRecordReader(jpath))
  assert got == records                                # byte-identical
  sch = schema.parse_schema(MIXED)
  assert [dfutil.from_example(r, sch) for r in got] == \
      [jax_dfutil.from_example(r, sch_j) for r in records]
  # the port's writer frames the same records into the same bytes
  tpath = str(tmp_path / "port.tfrecord")
  _write(tfrecord.TFRecordWriter, tpath, records)
  assert _read_bytes(tpath) == _read_bytes(jpath)


def test_port_written_tfrecords_read_by_jax(tmp_path):
  records = [example_codec.encode_example({"tokens": r[3], "label": [r[0]]})
             for r in _mixed_rows(9, 2)]
  path = "file://" + str(tmp_path / "port.tfrecord")   # the scheme is local
  _write(tfrecord.TFRecordWriter, path, records)
  assert list(jax_tfrecord.TFRecordReader(path)) == records
  rows = list(jax_readers.read_tfrecord_examples(
      [path], schema=jax_schema.parse_schema("struct<tokens:array<long>>")))
  assert [r[0] for r in rows] == [r[3] for r in _mixed_rows(9, 2)]


@pytest.mark.parametrize("damage", ["length_crc", "data_crc", "truncated"])
def test_a_damaged_record_raises_in_both_readers(tmp_path, damage):
  path = str(tmp_path / "bad.tfrecord")
  _write(tfrecord.TFRecordWriter, path,
         [example_codec.encode_example({"tokens": [1, 2, 3]})] * 2)
  raw = bytearray(_read_bytes(path))
  if damage == "length_crc":
    raw[8] ^= 0xFF                         # the first record's length crc
  elif damage == "data_crc":
    raw[len(raw) - 1] ^= 0xFF              # the last record's data crc
  else:
    raw = raw[:-2]
  with open(path, "wb") as f:
    f.write(bytes(raw))
  for reader in (tfrecord.TFRecordReader, jax_tfrecord.TFRecordReader):
    with pytest.raises(IOError):
      list(reader(path))


@pytest.fixture
def token_files(tmp_path):
  """Five TFRecord files of ragged token rows, written by the port."""
  rng = np.random.default_rng(7)
  paths = []
  for f in range(5):
    path = str(tmp_path / ("part-%05d.tfrecord" % f))
    _write(tfrecord.TFRecordWriter, path,
           [example_codec.encode_example(
               {"tokens": [int(v) for v in rng.integers(0, 50, n)]})
            for n in rng.integers(3, 20, 6)])
    paths.append(path)
  return str(tmp_path / "part-*.tfrecord"), paths


@pytest.mark.parametrize("num_shards,index,seed,buffer",
                         [(1, 0, 0, 64), (2, 1, 3, 4), (3, 0, 5, 1)])
def test_pipeline_gives_the_reference_batches(token_files, num_shards, index,
                                              seed, buffer):
  pattern, _ = token_files
  files = readers.shard_files(pattern, num_shards, index)
  assert files == jax_readers.shard_files(pattern, num_shards, index)

  def collate(batch):
    return np.asarray([len(r[0]) for r in batch]), [r[0] for r in batch]

  def stream(mod, sch):
    rows = mod.shuffled(mod.read_tfrecord_examples(files, schema=sch),
                        buffer_size=buffer, seed=seed)
    return list(mod.batched(rows, 3, collate=collate))

  got = stream(readers, schema.parse_schema(TOKENS))
  want = stream(jax_readers, jax_schema.parse_schema(TOKENS))
  assert len(got) == len(want) > 0
  for (ga, gb), (wa, wb) in zip(got, want):
    assert np.array_equal(ga, wa) and gb == wb
  # no schema: raw feature dicts; default collate stacks each column
  plain = list(readers.batched(readers.read_tfrecord_examples(files), 2,
                               drop_remainder=False))
  assert plain and all(isinstance(b[0], dict) for b in plain)
  with pytest.raises(ValueError, match="empty path list"):
    next(readers.read_tfrecord_examples([], repeat=True))
  with pytest.raises(FileNotFoundError):
    readers.shard_files(pattern + ".none", 1, 0)


@pytest.mark.parametrize("size", [1, 2, 3])
def test_device_prefetch_on_cpu_keeps_order_and_values(size):
  rng = np.random.default_rng(9)
  batches = []
  for i in range(5):
    a = rng.integers(0, 100, (2, 4)).astype(np.int32)
    a.setflags(write=False)                  # DataFeed hands out read-only views
    batches.append(a if i % 2 else {"tokens": a, "w": np.float32(i)})
  batches.append(readers.Slab(np.stack([batches[1], batches[3]])))
  out = list(readers.device_prefetch(iter(batches), size=size, device="cpu"))
  assert len(out) == len(batches)
  for got, want in zip(out, batches):
    if isinstance(want, dict):
      assert set(got) == set(want)
      assert all(torch.is_tensor(t) for t in got.values())
      assert np.array_equal(got["tokens"].numpy(), want["tokens"])
    elif isinstance(want, readers.Slab):
      assert isinstance(got, readers.Slab)
      assert np.array_equal(got.data.numpy(), want.data)
    else:
      assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def _reference_batch_stream(args):
  """The reference ``batch_stream`` (examples/transformer/train_gpt.py
  :98-123) over the JAX package's readers."""
  sch = jax_schema.parse_schema("struct<tokens:array<long>>")
  files = jax_readers.shard_files(args.data, 1, 0)
  rows = jax_readers.shuffled(
      jax_readers.read_tfrecord_examples(files, schema=sch, repeat=True),
      buffer_size=max(64, 4 * args.batch))

  def collate(batch):
    arr = np.zeros((len(batch), args.seq_len), "int32")
    for i, r in enumerate(batch):
      t = np.asarray(r[0], "int64")[:args.seq_len]
      arr[i, :len(t)] = t
    return arr

  yield from jax_readers.batched(rows, args.batch, collate=collate)


TINY = ["--device", "cpu", "--layers", "2", "--d_model", "32", "--heads",
        "4", "--kv_heads", "2", "--seq_len", "16", "--vocab", "50",
        "--batch", "3"]


def test_train_gpt_reads_the_reference_batches_and_trains(token_files,
                                                          capsys):
  pattern, _ = token_files
  args = train_gpt.parse_args(TINY + ["--data", pattern, "--steps", "2"])
  got, want = train_gpt.batch_stream(args), _reference_batch_stream(args)
  for _ in range(25):                  # past one pass over the 30 rows
    a, b = next(got), next(want)
    assert a.dtype == np.int32 and a.shape == (3, 16)
    assert np.array_equal(a, b)
  losses = train_gpt.run(args)
  assert len(losses) == 2 and all(np.isfinite(losses))
  out = capsys.readouterr().out
  assert "step 1 loss" in out and "tokens/step = 48" in out
  # the fused loop takes the same batches in slabs
  args = train_gpt.parse_args(TINY + ["--data", pattern, "--steps", "3",
                                      "--unroll", "2"])
  assert len(train_gpt.run(args)) == 3


def test_train_gpt_checks_the_vocabulary(token_files):
  pattern, _ = token_files
  args = train_gpt.parse_args(TINY + ["--vocab", "10", "--data", pattern])
  with pytest.raises(ValueError, match="--vocab 10"):
    next(train_gpt.batch_stream(args))


def test_train_gpt_pp_trains_over_a_group_of_its_ranks(token_files):
  """``--pp 2`` is the 1F1B pipeline: its flags parse (one process takes
  ``--dp 1``), and outside a process group of its ranks it asks for one
  (``tests/test_torch_pipeline_parallel.py`` trains it in gloo ranks)."""
  pattern, _ = token_files
  args = train_gpt.parse_args(TINY + ["--pp", "2", "--microbatches", "3",
                                      "--data", pattern])
  assert (args.pp, args.dp, args.microbatches) == (2, 1, 3)
  with pytest.raises(ValueError, match="--pp 2 needs a torch.distributed"):
    train_gpt.make_mesh(args)


@pytest.mark.parametrize("unroll", [0, 2])
def test_train_gpt_trains_with_adafactor_and_dots(token_files, unroll):
  """``--optimizer adafactor --remat_policy dots`` from TFRecords, per step
  and in slabs: the losses of ``--remat_policy none`` (remat changes no
  number), Adafactor's factored state in the train state."""
  pattern, _ = token_files
  argv = TINY + ["--data", pattern, "--steps", "3", "--optimizer",
                 "adafactor", "--unroll", str(unroll)]
  args = train_gpt.parse_args(argv + ["--remat_policy", "dots"])
  cfg = train_gpt.make_config(args)
  assert cfg.remat_policy == "dots"
  state = train_gpt.make_state(args, cfg)
  # clip_by_global_norm, adafactor's chain, the lr-scaled decay
  assert type(state.opt_state[1][0]).__name__ == "FactoredState"
  dots = train_gpt.run(args)
  none = train_gpt.run(train_gpt.parse_args(argv))
  assert len(dots) == 3 and all(np.isfinite(dots))
  np.testing.assert_allclose(dots, none, rtol=1e-6)


def test_train_gpt_builds_the_reference_config():
  args = train_gpt.parse_args(["--device", "cpu", "--layers", "12",
                               "--d_model", "768", "--heads", "12",
                               "--kv_heads", "4", "--seq_len", "16384",
                               "--vocab", "32000", "--fused"])
  cfg = train_gpt.make_config(args)
  assert (cfg.vocab_size, cfg.num_layers, cfg.num_heads, cfg.d_model,
          cfg.d_ff, cfg.max_seq_len, cfg.num_kv_heads) == \
      (32000, 12, 12, 768, 3072, 16384, 4)
  assert cfg.fuse_qkv and cfg.ln_matmul_impl == cfg.act_matmul_impl == "fused"
  assert cfg.dtype == torch.bfloat16
  assert os.path.basename(train_gpt.__file__) == "train_gpt.py"
