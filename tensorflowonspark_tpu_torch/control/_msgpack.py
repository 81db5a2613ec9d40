"""The msgpack subset the control plane's frames carry.

The JAX package frames its rendezvous messages and chunk envelopes with
the ``msgpack`` package (``packb(..., use_bin_type=True)`` and
``unpackb(..., raw=False)``). The port imports only the standard library,
numpy and torch, so it keeps this codec of its own for the types those
frames hold: nil, bool, int, float64, str, bin, array and map. Its output
is byte for byte what ``msgpack.packb(obj, use_bin_type=True)`` writes,
so a client of one package talks to a server of the other.

Tuples pack as arrays and ``bytearray`` / ``memoryview`` as bin, as in
msgpack; anything else (numpy scalars included) raises ``TypeError``.
Unpacking gives lists, dicts, ``str`` and ``bytes``; it also reads the
float32 format, which msgpack writes only on request.
"""

import struct

_NEST_LIMIT = 512


def packb(obj) -> bytes:
  """``obj`` as msgpack bytes (``msgpack.packb(obj, use_bin_type=True)``)."""
  out = []
  _pack(obj, out, _NEST_LIMIT)
  return b"".join(out)


def _header(n: int, fix: int, fix_max: int, codes, what: str) -> bytes:
  """The length header of a str / bin / array / map of ``n`` entries:
  ``fix | n`` below ``fix_max`` (when the type has a fix format), else the
  8-, 16- or 32-bit form (``codes``; None where the type has no 8-bit
  form)."""
  if fix is not None and n < fix_max:
    return struct.pack("B", fix | n)
  c8, c16, c32 = codes
  if c8 is not None and n <= 0xFF:
    return struct.pack("BB", c8, n)
  if n <= 0xFFFF:
    return struct.pack(">BH", c16, n)
  if n <= 0xFFFFFFFF:
    return struct.pack(">BI", c32, n)
  raise ValueError("%s is too large for msgpack (%d)" % (what, n))


def _pack_int(obj: int) -> bytes:
  # the formats and their order are msgpack's: unsigned for n >= 0, the
  # smallest signed one for n < 0
  if 0 <= obj < 0x80:
    return struct.pack("B", obj)
  if -0x20 <= obj < 0:
    return struct.pack("b", obj)
  if 0x80 <= obj <= 0xFF:
    return struct.pack("BB", 0xCC, obj)
  if -0x80 <= obj < 0:
    return struct.pack(">Bb", 0xD0, obj)
  if 0xFF < obj <= 0xFFFF:
    return struct.pack(">BH", 0xCD, obj)
  if -0x8000 <= obj < -0x80:
    return struct.pack(">Bh", 0xD1, obj)
  if 0xFFFF < obj <= 0xFFFFFFFF:
    return struct.pack(">BI", 0xCE, obj)
  if -0x80000000 <= obj < -0x8000:
    return struct.pack(">Bi", 0xD2, obj)
  if 0xFFFFFFFF < obj <= 0xFFFFFFFFFFFFFFFF:
    return struct.pack(">BQ", 0xCF, obj)
  if -0x8000000000000000 <= obj < -0x80000000:
    return struct.pack(">Bq", 0xD3, obj)
  raise OverflowError("Integer value out of range")


def _pack(obj, out: list, depth: int) -> None:
  if depth < 0:
    raise ValueError("recursion limit exceeded")
  if obj is None:
    out.append(b"\xc0")
  elif isinstance(obj, bool):
    out.append(b"\xc3" if obj else b"\xc2")
  elif isinstance(obj, int):
    out.append(_pack_int(obj))
  elif isinstance(obj, (bytes, bytearray, memoryview)):
    data = obj.tobytes() if isinstance(obj, memoryview) else bytes(obj)
    out.append(_header(len(data), None, 0, (0xC4, 0xC5, 0xC6), "bin"))
    out.append(data)
  elif isinstance(obj, str):
    data = obj.encode("utf-8")
    out.append(_header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), "str"))
    out.append(data)
  elif isinstance(obj, float):
    out.append(struct.pack(">Bd", 0xCB, obj))
  elif isinstance(obj, (list, tuple)):
    out.append(_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD), "array"))
    for item in obj:
      _pack(item, out, depth - 1)
  elif isinstance(obj, dict):
    out.append(_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF), "map"))
    for k, v in obj.items():
      _pack(k, out, depth - 1)
      _pack(v, out, depth - 1)
  else:
    raise TypeError("Cannot serialize %r" % (obj,))


class _Reader(object):
  """A cursor over one msgpack buffer."""

  __slots__ = ("buf", "pos")

  def __init__(self, buf):
    # one copy of a non-bytes buffer: the bin values sliced from it are
    # then bytes the caller owns, whatever scratch ``buf`` was
    self.buf = buf if isinstance(buf, bytes) else bytes(buf)
    self.pos = 0

  def take(self, n: int) -> bytes:
    end = self.pos + n
    if end > len(self.buf):
      raise ValueError("truncated msgpack data")
    chunk = self.buf[self.pos:end]
    self.pos = end
    return chunk

  def unpack(self, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, self.take(size))[0]


# first byte -> (kind, struct format of the length or value)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_SCALAR = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
           0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _unpack(r: _Reader, depth: int):
  if depth < 0:
    raise ValueError("recursion limit exceeded")
  b = r.take(1)[0]
  if b <= 0x7F:
    return b
  if b >= 0xE0:
    return b - 0x100
  if 0xA0 <= b <= 0xBF:
    return r.take(b & 0x1F).decode("utf-8")
  if 0x90 <= b <= 0x9F:
    return [_unpack(r, depth - 1) for _ in range(b & 0x0F)]
  if 0x80 <= b <= 0x8F:
    return _unpack_map(r, b & 0x0F, depth)
  if b == 0xC0:
    return None
  if b in (0xC2, 0xC3):
    return b == 0xC3
  fmt = _SCALAR.get(b)
  if fmt is not None:
    return r.unpack(fmt)
  sized = _SIZED.get(b)
  if sized is None:
    raise ValueError("unsupported msgpack format byte 0x%02x" % b)
  kind, fmt = sized
  n = r.unpack(fmt)
  if kind == "bin":
    return r.take(n)
  if kind == "str":
    return r.take(n).decode("utf-8")
  if kind == "array":
    return [_unpack(r, depth - 1) for _ in range(n)]
  return _unpack_map(r, n, depth)


def _unpack_map(r: _Reader, n: int, depth: int) -> dict:
  out = {}
  for _ in range(n):
    k = _unpack(r, depth - 1)
    out[k] = _unpack(r, depth - 1)
  return out


def unpackb(data):
  """One msgpack object from ``data`` (any buffer); trailing bytes raise,
  as ``msgpack.unpackb`` does."""
  r = _Reader(data)
  obj = _unpack(r, _NEST_LIMIT)
  if r.pos != len(r.buf):
    raise ValueError("extra data after the msgpack object")
  return obj
