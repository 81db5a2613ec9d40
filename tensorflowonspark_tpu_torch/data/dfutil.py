"""Rows <-> TFRecord/tf.Example conversion with schema inference.

The port's copy of ``tensorflowonspark_tpu/data/dfutil.py`` (TensorFlowOnSpark's
``dfutil.py``): ``save_as_tfrecords`` / ``load_tfrecords`` round-trip
partitioned rows through TFRecord files, ``infer_schema`` reads the first
record with a ``binary_features`` hint to tell bytes from strings,
``to_example`` / ``from_example`` map dtypes onto Int64List / FloatList /
BytesList, and a loaded-path registry mirrors ``isLoadedDF``. A
"dataframe" here is (partitions, Schema): partitions are lists of row
tuples ordered by the schema's fields.

Built on the port's own ``example_codec``, ``tfrecord`` and ``schema``,
so files written by either package read in the other. What differs from
the reference:

* remote paths (``gs://`` and any other scheme but ``file://``) go
  through fsspec (:mod:`.fs`), as in the reference;
* a partition handle and the executor-side writer travel by the standard
  ``pickle``, so they are instances of module-level classes
  (:class:`_LazyFileReader`, :class:`_WriteTask`); a partition given as a
  lambda or a closure cannot reach an executor.
"""

import glob
import logging
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from tensorflowonspark_tpu_torch.data import example_codec, fs, tfrecord
from tensorflowonspark_tpu_torch.data.schema import Field, Schema

logger = logging.getLogger(__name__)

# paths loaded through load_tfrecords, with their schemas — so pipelines can
# skip re-conversion (parity: dfutil.isLoadedDF)
_loaded_paths: Dict[str, Schema] = {}


def _path_key(path: str) -> str:
  return path if fs.is_remote(path) else os.path.abspath(fs.strip_scheme(path))


def is_loaded_path(path: str) -> bool:
  return _path_key(path) in _loaded_paths


def to_example(row: Sequence, schema: Schema) -> bytes:
  """Encode one row (ordered per schema) as a serialized tf.train.Example."""
  features = {}
  for field, value in zip(schema.fields, row):
    values = list(value) if field.is_array else [value]
    if field.dtype in ("int", "long", "boolean"):
      features[field.name] = [int(v) for v in values]
    elif field.dtype in ("float", "double"):
      features[field.name] = [float(v) for v in values]
    elif field.dtype == "string":
      features[field.name] = [v.encode("utf-8") if isinstance(v, str) else
                              bytes(v) for v in values]
    elif field.dtype == "binary":
      features[field.name] = [bytes(v) for v in values]
    else:
      raise TypeError("unsupported field type %r" % field.dtype)
  return example_codec.encode_example(features)


def from_example(data: bytes, schema: Schema) -> Tuple:
  """Decode a serialized Example into a row tuple ordered per schema."""
  feats = example_codec.decode_example(data)
  row = []
  for field in schema.fields:
    values = feats.get(field.name, [])
    if field.dtype in ("int", "long"):
      values = [int(v) for v in values]
    elif field.dtype == "boolean":
      values = [bool(v) for v in values]
    elif field.dtype in ("float", "double"):
      values = [float(v) for v in values]
    elif field.dtype == "string":
      values = [v.decode("utf-8") if isinstance(v, bytes) else str(v)
                for v in values]
    elif field.dtype == "binary":
      values = [bytes(v) for v in values]
    row.append(list(values) if field.is_array else
               (values[0] if values else None))
  return tuple(row)


def infer_schema(example_bytes: bytes,
                 binary_features: Optional[Set[str]] = None) -> Schema:
  """Infer a Schema from one serialized Example.

  ``binary_features`` marks BytesList features to type as ``binary`` rather
  than ``string`` — the wire format cannot distinguish them.
  Multi-value features become arrays.
  """
  binary_features = binary_features or set()
  feats = example_codec.decode_example(example_bytes)
  fields = []
  for name in sorted(feats):
    values = feats[name]
    if values and isinstance(values[0], bytes):
      dtype = "binary" if name in binary_features else "string"
    elif values and isinstance(values[0], float):
      dtype = "float"
    else:
      dtype = "long"
    fields.append(Field(name, dtype, is_array=len(values) > 1))
  return Schema(tuple(fields))


def _part_path(output_dir: str, index: int) -> str:
  return fs.join(output_dir, "part-%05d.tfrecord" % index)


def _write_partition(output_dir: str, schema: Schema, index: int,
                     rows) -> str:
  path = _part_path(output_dir, index)
  if callable(rows):
    rows = rows()
  with tfrecord.TFRecordWriter(path) as w:
    for row in rows:
      w.write(to_example(row, schema))
  return path


class _WriteTask(object):
  """Engine task of :func:`save_as_tfrecords`: writes each ``(index,
  rows)`` item of its partition to its part file, on the executor."""

  def __init__(self, output_dir: str, schema: Schema):
    self.output_dir = output_dir
    self.schema = schema

  def __call__(self, it):
    return [_write_partition(self.output_dir, self.schema, index, rows)
            for index, rows in it]


def save_as_tfrecords(partitions: Sequence[Iterable], schema: Schema,
                      output_dir: str, engine=None) -> List[str]:
  """Write one ``part-NNNNN.tfrecord`` file per partition.

  With an engine, partitions are written by the executors in parallel
  (TensorFlowOnSpark wrote from the executors too) and the driver ships
  only partition HANDLES: a partition may be a zero-arg callable returning
  an iterable (an instance of a module-level class, such as
  ``load_tfrecords(lazy=True)``'s handles), in which case rows are
  produced on the executor. Plain lists still work (and are pickled
  whole, fine for small data). ``output_dir`` may be a remote URI: the
  writers stream through fsspec.
  """
  if not fs.is_remote(output_dir):
    output_dir = fs.strip_scheme(output_dir)
  fs.makedirs(output_dir, exist_ok=True)
  if engine is None:
    return [_write_partition(output_dir, schema, i, p)
            for i, p in enumerate(partitions)]

  # one engine partition per output file; a one-shot iterator cannot
  # cross the process boundary, so it alone is materialized here
  def _shippable(i, p):
    if callable(p) or isinstance(p, (list, tuple)):
      return p
    logger.warning(
        "save_as_tfrecords: partition %d is a one-shot iterator; "
        "materializing it on the DRIVER (O(partition) driver memory). "
        "Ship a zero-arg callable (e.g. load_tfrecords(lazy=True) "
        "handles) to produce rows executor-side instead.", i)
    return list(p)

  indexed = [[(i, _shippable(i, p))] for i, p in enumerate(partitions)]
  return sorted(engine.map_partitions(indexed,
                                      _WriteTask(output_dir, schema)))


def _list_tfrecord_files(path: str) -> List[str]:
  if fs.is_remote(path):
    base = path.rstrip("/")
    files = sorted(fs.glob_files(base + "/*.tfrecord")) or \
        sorted(fs.glob_files(base + "/part-*")) or \
        sorted(fs.glob_files(path))
    if not files:
      raise FileNotFoundError("no TFRecord files at %r" % path)
    return files
  path = fs.strip_scheme(path)
  if os.path.isdir(path):
    files = sorted(glob.glob(os.path.join(path, "*.tfrecord"))) or \
        sorted(glob.glob(os.path.join(path, "part-*")))
  elif os.path.exists(path):
    files = [path]
  else:
    files = sorted(glob.glob(path))
  if not files:
    raise FileNotFoundError("no TFRecord files at %r" % path)
  return files


class _LazyFileReader(object):
  """A zero-arg callable streaming the decoded rows of ``files``: the lazy
  partition handle that ``save_as_tfrecords`` and the cluster feeders
  (``node._materialize_partition``) resolve on the executor."""

  def __init__(self, files: List[str], schema: Schema):
    self.files = list(files)
    self.schema = schema

  def __call__(self):
    return (from_example(record, self.schema)
            for f in self.files for record in tfrecord.TFRecordReader(f))


def _lazy_file_reader(files: List[str], schema: Schema) -> _LazyFileReader:
  return _LazyFileReader(files, schema)


def load_tfrecords(path: str, schema: Optional[Schema] = None,
                   binary_features: Optional[Set[str]] = None,
                   num_partitions: Optional[int] = None,
                   lazy: bool = False):
  """Load TFRecord file(s) into (partitions, schema).

  ``path`` may be a file, a directory of part files, or a glob. The schema
  is inferred from the first record when not given.

  With ``lazy=True`` the driver reads at most ONE record (for schema
  inference): each returned partition is a zero-arg callable producing the
  rows of one part file, resolved executor-side by ``cluster.train`` /
  ``cluster.inference`` feeders and by ``save_as_tfrecords(engine=...)``.
  """
  files = _list_tfrecord_files(path)

  inferred = schema
  if lazy:
    if inferred is None:
      # scan files until the first record (a leading part file may be
      # empty); only that one record is ever decoded on the driver
      for f in files:
        for record in tfrecord.TFRecordReader(f):
          inferred = infer_schema(record, binary_features)
          logger.info("inferred schema: %s", inferred)
          break
        if inferred is not None:
          break
      if inferred is None:
        raise ValueError(
            "no records in %r to infer a schema from; pass schema=" % path)
    k = max(1, min(num_partitions, len(files))) if num_partitions \
        else len(files)
    groups = [files[i::k] for i in range(k)]
    partitions = [_lazy_file_reader(g, inferred) for g in groups if g]
    _loaded_paths[_path_key(path)] = inferred
    return partitions, inferred

  partitions: List[List[Tuple]] = []
  for f in files:
    rows = []
    for record in tfrecord.TFRecordReader(f):
      if inferred is None:
        inferred = infer_schema(record, binary_features)
        logger.info("inferred schema: %s", inferred)
      rows.append(from_example(record, inferred))
    partitions.append(rows)

  if inferred is None:
    raise ValueError(
        "no records found in %r to infer a schema from; pass schema= or a "
        "schema hint" % path)

  if num_partitions and num_partitions != len(partitions):
    flat = [r for p in partitions for r in p]
    k = max(1, num_partitions)
    partitions = [flat[i::k] for i in range(k)]

  _loaded_paths[_path_key(path)] = inferred
  return partitions, inferred
