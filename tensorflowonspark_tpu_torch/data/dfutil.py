"""Rows from tf.Example records.

Counterpart of ``from_example`` in ``tensorflowonspark_tpu/data/dfutil.py``
(the rest of that module, schema inference and the partitioned
save/load, is not ported yet).
"""

from typing import Tuple

from tensorflowonspark_tpu_torch.data import example_codec
from tensorflowonspark_tpu_torch.data.schema import Schema


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
