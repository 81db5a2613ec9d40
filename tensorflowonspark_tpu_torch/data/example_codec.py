"""Dependency-free protobuf wire codec for ``tf.train.Example``.

Counterpart of ``tensorflowonspark_tpu/data/example_codec.py`` (the port
keeps its own copy): the small fixed subset of the protobuf wire format
that ``tf.train.Example`` uses, so TFRecord/Example interop needs neither
TensorFlow nor a JVM.

Message layout (tensorflow/core/example/{example,feature}.proto):
  Example        { Features features = 1; }
  Features       { map<string, Feature> feature = 1; }
  Feature        { oneof kind: BytesList=1, FloatList=2, Int64List=3 }
  BytesList      { repeated bytes value = 1; }
  FloatList      { repeated float value = 1 [packed=true]; }
  Int64List      { repeated int64 value = 1 [packed=true]; }

``decode_example`` accepts packed and unpacked repeated encodings (both are
legal on the wire); ``encode_example`` emits the canonical packed form.
"""

import struct
from typing import Dict, List, Tuple, Union

FeatureValue = Union[List[bytes], List[float], List[int]]


# --- varint / wire primitives ----------------------------------------------


def _write_varint(out: bytearray, value: int) -> None:
  while True:
    b = value & 0x7F
    value >>= 7
    if value:
      out.append(b | 0x80)
    else:
      out.append(b)
      return


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
  result = 0
  shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7
    if shift > 63:
      raise ValueError("varint too long")


def _write_tag(out: bytearray, field: int, wire_type: int) -> None:
  _write_varint(out, (field << 3) | wire_type)


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
  _write_tag(out, field, 2)
  _write_varint(out, len(payload))
  out.extend(payload)


# --- encoding ---------------------------------------------------------------


def _encode_feature(values: FeatureValue) -> bytes:
  if not values:
    # empty feature: a BytesList message with zero entries
    out = bytearray()
    _write_len_delimited(out, 1, b"")
    return bytes(out)

  first = values[0]
  if isinstance(first, (bytes, bytearray, str)):
    blist = bytearray()
    for v in values:
      if isinstance(v, str):
        v = v.encode("utf-8")
      _write_len_delimited(blist, 1, bytes(v))
    kind_field = 1
    payload = bytes(blist)
  elif isinstance(first, float):
    packed = struct.pack("<%df" % len(values), *values)
    flist = bytearray()
    _write_len_delimited(flist, 1, packed)
    kind_field = 2
    payload = bytes(flist)
  elif isinstance(first, (int,)):
    packed = bytearray()
    for v in values:
      _write_varint(packed, v & 0xFFFFFFFFFFFFFFFF)
    ilist = bytearray()
    _write_len_delimited(ilist, 1, bytes(packed))
    kind_field = 3
    payload = bytes(ilist)
  else:
    raise TypeError("unsupported feature value type: %r" % type(first))

  out = bytearray()
  _write_len_delimited(out, kind_field, payload)
  return bytes(out)


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
  """Serialize {name: list-of-values} to a tf.train.Example proto."""
  features_msg = bytearray()
  for name in sorted(features):
    entry = bytearray()
    _write_len_delimited(entry, 1, name.encode("utf-8"))
    _write_len_delimited(entry, 2, _encode_feature(features[name]))
    _write_len_delimited(features_msg, 1, bytes(entry))
  example = bytearray()
  _write_len_delimited(example, 1, bytes(features_msg))
  return bytes(example)


# --- decoding ---------------------------------------------------------------


def _iter_fields(buf: bytes):
  pos = 0
  n = len(buf)
  while pos < n:
    tag, pos = _read_varint(buf, pos)
    field, wire_type = tag >> 3, tag & 7
    if wire_type == 0:
      value, pos = _read_varint(buf, pos)
    elif wire_type == 2:
      length, pos = _read_varint(buf, pos)
      value = buf[pos:pos + length]
      pos += length
    elif wire_type == 5:
      value = buf[pos:pos + 4]
      pos += 4
    elif wire_type == 1:
      value = buf[pos:pos + 8]
      pos += 8
    else:
      raise ValueError("unsupported wire type %d" % wire_type)
    yield field, wire_type, value


def _decode_feature(buf: bytes) -> FeatureValue:
  for field, wire_type, value in _iter_fields(buf):
    if field == 1:      # BytesList
      return [bytes(v) for f, _, v in _iter_fields(value) if f == 1]
    if field == 2:      # FloatList
      out: List[float] = []
      for f, wt, v in _iter_fields(value):
        if f != 1:
          continue
        if wt == 2:     # packed
          out.extend(struct.unpack("<%df" % (len(v) // 4), v))
        else:           # unpacked fixed32
          out.extend(struct.unpack("<f", v))
      return out
    if field == 3:      # Int64List
      ints: List[int] = []
      for f, wt, v in _iter_fields(value):
        if f != 1:
          continue
        if wt == 2:     # packed varints
          pos = 0
          while pos < len(v):
            raw, pos = _read_varint(v, pos)
            ints.append(raw - (1 << 64) if raw >= (1 << 63) else raw)
        else:
          ints.append(v - (1 << 64) if v >= (1 << 63) else v)
      return ints
  return []


def decode_example(data: bytes) -> Dict[str, FeatureValue]:
  """Parse a serialized tf.train.Example into {name: list-of-values}."""
  features: Dict[str, FeatureValue] = {}
  for field, _, value in _iter_fields(data):
    if field != 1:
      continue
    for f2, _, entry in _iter_fields(value):
      if f2 != 1:
        continue
      name = None
      feat: FeatureValue = []
      for f3, _, v3 in _iter_fields(entry):
        if f3 == 1:
          name = v3.decode("utf-8")
        elif f3 == 2:
          feat = _decode_feature(v3)
      if name is not None:
        features[name] = feat
  return features
