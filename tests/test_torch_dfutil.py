"""The PyTorch port's ``data/dfutil.py`` on the CPU, held against the JAX
package's: ``to_example`` byte for byte for every dtype, ``infer_schema``,
``save_as_tfrecords`` / ``load_tfrecords`` files crossing between the
packages both ways (eager, lazy, repartitioned), the loaded-path
registry, the executor-side writer and remote paths refused by name."""

import os
import pickle

import numpy as np
import pytest

from tensorflowonspark_tpu.data import dfutil as jax_dfutil
from tensorflowonspark_tpu.data import schema as jax_schema
from tensorflowonspark_tpu_torch.data import dfutil, schema

SCHEMA = ("struct<i:int,l:long,b:boolean,f:float,d:double,s:string,"
          "bin:binary,ai:array<int>,al:array<long>,af:array<float>,"
          "ad:array<double>,as:array<string>,abin:array<binary>>")


def _rows(n, seed=0):
  rng = np.random.default_rng(seed)
  rows = []
  for k in range(n):
    m = 1 + k % 3
    rows.append((
        int(rng.integers(-2 ** 31, 2 ** 31)), int(rng.integers(-2 ** 62,
                                                               2 ** 62)),
        bool(k % 2), float(np.float32(rng.standard_normal())),
        float(np.float32(rng.standard_normal())), "sé%d" % k,
        bytes(rng.integers(0, 256, 5, dtype=np.uint8)),
        [int(x) for x in rng.integers(-100, 100, m)],
        [int(x) for x in rng.integers(-2 ** 40, 2 ** 40, m)],
        [float(np.float32(x)) for x in rng.standard_normal(m)],
        [float(np.float32(x)) for x in rng.standard_normal(m)],
        ["w%d" % j for j in range(m)],
        [bytes([j, 255 - j]) for j in range(m)]))
  return rows


def _schemas(text=SCHEMA):
  return jax_schema.parse_schema(text), schema.parse_schema(text)


@pytest.mark.parametrize("field", SCHEMA[7:-1].split(","))
def test_to_example_bytes_equal_the_reference_for_every_dtype(field):
  jsch, tsch = _schemas("struct<%s>" % field)
  col = [f.name for f in tsch.fields]
  full = schema.parse_schema(SCHEMA).names()
  for row in _rows(6):
    value = (row[full.index(col[0])],)
    assert dfutil.to_example(value, tsch) == \
        jax_dfutil.to_example(value, jsch)


def test_from_example_and_infer_schema_agree_with_the_reference():
  jsch, tsch = _schemas()
  for row in _rows(4):
    data = dfutil.to_example(row, tsch)
    assert dfutil.from_example(data, tsch) == \
        jax_dfutil.from_example(data, jsch)
    for hint in (None, {"bin", "abin"}):
      got = dfutil.infer_schema(data, hint)
      want = jax_dfutil.infer_schema(data, hint)
      assert str(got) == str(want)
  # arrays of one value infer as scalars in both, as on the wire
  assert "ai:long" in str(dfutil.infer_schema(dfutil.to_example(
      _rows(1)[0], tsch)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_cross_between_the_packages(tmp_path, writer):
  jsch, tsch = _schemas()
  parts = [_rows(5, seed=1), _rows(3, seed=2)]
  out = str(tmp_path / "tfr")
  if writer == "port":
    paths = dfutil.save_as_tfrecords(parts, tsch, out)
  else:
    paths = jax_dfutil.save_as_tfrecords(parts, jsch, out)
  assert [os.path.basename(p) for p in paths] == ["part-00000.tfrecord",
                                                  "part-00001.tfrecord"]
  for load, sch in ((dfutil.load_tfrecords, tsch),
                    (jax_dfutil.load_tfrecords, jsch)):
    got, _ = load(out, schema=sch)
    assert got == parts
  # schema inferred from the first record, in both
  got, inferred = dfutil.load_tfrecords(out, binary_features={"bin",
                                                              "abin"})
  want, ref = jax_dfutil.load_tfrecords(out, binary_features={"bin",
                                                              "abin"})
  assert str(inferred) == str(ref) and got == want
  # repartitioned, and from a glob
  got, _ = dfutil.load_tfrecords(os.path.join(out, "part-*"), schema=tsch,
                                 num_partitions=3)
  want, _ = jax_dfutil.load_tfrecords(os.path.join(out, "part-*"),
                                      schema=jsch, num_partitions=3)
  assert got == want and len(got) == 3


def test_lazy_partitions_are_picklable_handles(tmp_path):
  _, tsch = _schemas()
  parts = [_rows(4, seed=3), _rows(2, seed=4), _rows(3, seed=5)]
  out = str(tmp_path / "tfr")
  dfutil.save_as_tfrecords(parts, tsch, out)
  lazy, sch = dfutil.load_tfrecords(out, schema=tsch, lazy=True,
                                    num_partitions=2)
  assert len(lazy) == 2 and sch == tsch
  handles = pickle.loads(pickle.dumps(lazy))
  assert sorted(r for h in handles for r in h()) == \
      sorted(r for p in parts for r in p)
  assert dfutil.is_loaded_path(out)
  assert not dfutil.is_loaded_path(str(tmp_path / "elsewhere"))
  lazy, inferred = dfutil.load_tfrecords(out, lazy=True)
  assert len(lazy) == 3 and inferred.names() == sorted(tsch.names())


def test_the_executor_writer_task_and_lazy_handles(tmp_path):
  """What ``save_as_tfrecords(engine=...)`` ships: a picklable writer
  task, run here as an executor runs it, on row lists and on lazy
  handles (resolved on the executor)."""
  _, tsch = _schemas()
  parts = [_rows(3, seed=6), _rows(2, seed=7)]
  src = str(tmp_path / "src")
  dfutil.save_as_tfrecords(parts, tsch, src)
  lazy, _ = dfutil.load_tfrecords(src, schema=tsch, lazy=True)

  class _InProcess(object):
    def map_partitions(self, partitions, fn):
      task = pickle.loads(pickle.dumps(fn))
      return [p for part in partitions
              for p in task(iter(pickle.loads(pickle.dumps(part))))]

  out = str(tmp_path / "copy")
  paths = dfutil.save_as_tfrecords(lazy, tsch, out, engine=_InProcess())
  assert len(paths) == 2
  assert dfutil.load_tfrecords(out, schema=tsch)[0] == parts
  paths = dfutil.save_as_tfrecords(iter(parts), tsch, str(tmp_path / "it"),
                                   engine=_InProcess())
  assert dfutil.load_tfrecords(str(tmp_path / "it"), schema=tsch)[0] == parts


def test_errors_and_file_uris(tmp_path):
  _, tsch = _schemas()
  with pytest.raises(FileNotFoundError, match="no TFRecord files"):
    dfutil.load_tfrecords(str(tmp_path / "none"))
  empty = tmp_path / "empty.tfrecord"
  empty.write_bytes(b"")
  with pytest.raises(ValueError, match="no records"):
    dfutil.load_tfrecords(str(empty))
  with pytest.raises(ValueError, match="no records"):
    dfutil.load_tfrecords(str(empty), lazy=True)
  rows = _rows(2)
  out = dfutil.save_as_tfrecords([rows], tsch,
                                 "file://" + str(tmp_path / "f"))
  assert dfutil.load_tfrecords("file://" + str(tmp_path / "f"),
                               schema=tsch)[0] == [rows]
  assert out == [str(tmp_path / "f" / "part-00000.tfrecord")]
