"""Schema types and the ``struct<name:type,...>`` hint-string parser.

Counterpart of ``tensorflowonspark_tpu/data/schema.py`` (the port keeps
its own copy): 8 base types plus 1-D arrays, e.g.
``struct<label:int,features:array<float>>``.
"""

import re
from dataclasses import dataclass
from typing import List

BASE_TYPES = ("binary", "boolean", "double", "float", "int", "bigint",
              "long", "string")

# normalization: Spark SQL-ish names -> canonical
_ALIASES = {"bigint": "long", "int": "int", "integer": "int"}


@dataclass(frozen=True)
class Field:
  name: str
  dtype: str          # canonical base type
  is_array: bool = False

  def __str__(self):
    t = "array<%s>" % self.dtype if self.is_array else self.dtype
    return "%s:%s" % (self.name, t)


@dataclass(frozen=True)
class Schema:
  fields: tuple

  def names(self) -> List[str]:
    return [f.name for f in self.fields]

  def field(self, name: str) -> Field:
    for f in self.fields:
      if f.name == name:
        return f
    raise KeyError(name)

  def __str__(self):
    return "struct<%s>" % ",".join(str(f) for f in self.fields)


_FIELD_RE = re.compile(
    r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*:\s*"
    r"(?:array\s*<\s*([a-z]+)\s*>|([a-z]+))\s*$")


def _split_fields(body: str) -> List[str]:
  """Split on commas not nested inside array<...>."""
  parts, depth, cur = [], 0, []
  for ch in body:
    if ch == "<":
      depth += 1
    elif ch == ">":
      depth -= 1
    if ch == "," and depth == 0:
      parts.append("".join(cur))
      cur = []
    else:
      cur.append(ch)
  if cur:
    parts.append("".join(cur))
  return parts


def parse_schema(text: str) -> Schema:
  """Parse ``struct<name:type,...>`` (types: 8 base types + array<base>)."""
  text = text.strip()
  m = re.match(r"^struct\s*<(.*)>$", text, re.DOTALL)
  if not m:
    raise ValueError("schema must look like struct<name:type,...>: %r" % text)
  fields = []
  for part in _split_fields(m.group(1)):
    if not part.strip():
      continue
    fm = _FIELD_RE.match(part)
    if not fm:
      raise ValueError("unparseable schema field: %r" % part)
    name, array_type, base_type = fm.groups()
    dtype = array_type or base_type
    dtype = _ALIASES.get(dtype, dtype)   # normalize before validation
    if dtype not in BASE_TYPES:
      raise ValueError("unknown type %r in field %r (known: %s)"
                       % (dtype, name, ", ".join(BASE_TYPES)))
    fields.append(Field(name, dtype, is_array=bool(array_type)))
  if not fields:
    raise ValueError("empty schema: %r" % text)
  return Schema(tuple(fields))
