"""TFRecord file reader and writer.

Counterpart of ``tensorflowonspark_tpu/data/tfrecord.py``: the same
framing (little-endian u64 length, masked CRC32C of the length, the
record, masked CRC32C of the record) in pure Python, byte for byte the
files the JAX package writes. The reader checks both CRCs and raises
``IOError`` on a corrupt or truncated record, as the reference does. The
reference's native codec (``native/tfrecord_codec.cpp``) is not ported
yet.
"""

import struct
from typing import Iterator, List

from tensorflowonspark_tpu_torch.data import fs

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
  if not _CRC_TABLE:
    for i in range(256):
      c = i
      for _ in range(8):
        c = (0x82F63B78 ^ (c >> 1)) if c & 1 else (c >> 1)
      _CRC_TABLE.append(c)
  return _CRC_TABLE


def crc32c(data: bytes) -> int:
  """CRC32C (Castagnoli) of ``data``."""
  table = _crc_table()
  crc = 0xFFFFFFFF
  for b in data:
    crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
  """TFRecord's masked CRC32C."""
  crc = crc32c(data)
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class TFRecordWriter(object):
  """Write records to a local TFRecord file."""

  def __init__(self, path: str):
    self.path = path
    self._file = fs.open_file(path, "wb")

  def write(self, record: bytes) -> None:
    length = struct.pack("<Q", len(record))
    self._file.write(length)
    self._file.write(struct.pack("<I", masked_crc(length)))
    self._file.write(record)
    self._file.write(struct.pack("<I", masked_crc(record)))

  def close(self) -> None:
    if self._file:
      self._file.close()
      self._file = None

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


class TFRecordReader(object):
  """Iterate the records of a local TFRecord file."""

  def __init__(self, path: str):
    self.path = path
    self._file = fs.open_file(path, "rb")

  def __iter__(self) -> Iterator[bytes]:
    return self

  def _fail(self, what: str):
    self.close()
    return IOError("%s in %s" % (what, self.path))

  def __next__(self) -> bytes:
    if self._file is None:
      raise StopIteration
    header = self._file.read(12)
    if len(header) == 0:
      self.close()
      raise StopIteration
    if len(header) < 12:
      raise self._fail("truncated TFRecord header")
    (length,), (len_crc,) = struct.unpack("<Q", header[:8]), \
        struct.unpack("<I", header[8:])
    if masked_crc(header[:8]) != len_crc:
      raise self._fail("corrupt TFRecord length crc")
    data = self._file.read(length)
    crc_raw = self._file.read(4)
    if len(data) < length or len(crc_raw) < 4:
      raise self._fail("truncated TFRecord data")
    if masked_crc(data) != struct.unpack("<I", crc_raw)[0]:
      raise self._fail("corrupt TFRecord data")
    return data

  def close(self) -> None:
    if self._file:
      self._file.close()
      self._file = None

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
