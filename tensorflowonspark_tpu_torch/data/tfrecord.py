"""TFRecord file reader and writer.

Counterpart of ``tensorflowonspark_tpu/data/tfrecord.py``: the same
framing (little-endian u64 length, masked CRC32C of the length, the
record, masked CRC32C of the record), byte for byte the files the JAX
package writes. Readers check both CRCs and raise ``IOError`` on a corrupt
or truncated record, as the reference's do.

Two implementations of the framing, chosen by the path as the reference
chooses:

* local paths and ``file://`` URIs go through the native codec, the
  port's own copy of the reference's C++ (``native/tfrecord_codec.cpp``),
  built at first use with ``g++`` into ``build/tfrecord/`` at the root of
  the checkout, named by a digest of the source and flags, and loaded
  with :mod:`ctypes`. There is no fallback: a failed build raises
  :class:`CodecBuildError` with the compiler's message (the reference
  drops to Python quietly);
* remote URIs (any other ``scheme://``, through :mod:`.fs`) stream through
  the pure-Python framing, :class:`PyTFRecordWriter` and
  :class:`PyTFRecordReader`, which also serve as the plain version the
  native codec is held to.
"""

import ctypes
import hashlib
import os
import platform
import struct
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterator, List

from tensorflowonspark_tpu_torch.data import fs
from tensorflowonspark_tpu_torch.obs import device as obs_device

NATIVE_SRC = Path(__file__).resolve().parent.parent / "native" / \
    "tfrecord_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tfrecord"
# the source picks the SSE4.2 CRC at run time where the CPU has it
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17") + (
    ("-msse4.2",) if platform.machine() in ("x86_64", "AMD64") else ())
_BUILD_TIMEOUT_S = 120

_lib = None
_lib_lock = threading.Lock()


class CodecBuildError(RuntimeError):
  """``g++`` could not build (or ``ctypes`` could not load) the codec."""


def library_path() -> Path:
  """Where the codec library lives for the current source and flags."""
  h = hashlib.sha256(NATIVE_SRC.read_bytes())
  h.update(" ".join(GXX_FLAGS).encode())
  return BUILD_DIR / ("libtfrecord.%s.so" % h.hexdigest()[:16])


def _build(out: Path) -> None:
  """Compile the codec into a per-process temporary, then move it into
  place atomically: concurrent builders never see half a library."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
  cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC)]
  try:
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=_BUILD_TIMEOUT_S)
  except (OSError, subprocess.SubprocessError) as e:
    raise CodecBuildError("could not run g++ on %s: %s" % (NATIVE_SRC, e)) \
        from e
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise CodecBuildError("g++ failed (%d) on %s:\n%s"
                          % (proc.returncode, NATIVE_SRC,
                             proc.stdout + proc.stderr))
  os.replace(tmp, out)


def _bind(so: str):
  lib = ctypes.CDLL(so)
  lib.tos_writer_open.restype = ctypes.c_void_p
  lib.tos_writer_open.argtypes = [ctypes.c_char_p]
  lib.tos_writer_write.restype = ctypes.c_int
  lib.tos_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint64]
  lib.tos_writer_close.restype = ctypes.c_int
  lib.tos_writer_close.argtypes = [ctypes.c_void_p]
  lib.tos_reader_open.restype = ctypes.c_void_p
  lib.tos_reader_open.argtypes = [ctypes.c_char_p]
  lib.tos_reader_next.restype = ctypes.c_int64
  lib.tos_reader_next.argtypes = [
      ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
  lib.tos_reader_close.restype = ctypes.c_int
  lib.tos_reader_close.argtypes = [ctypes.c_void_p]
  lib.tos_masked_crc32c.restype = ctypes.c_uint32
  lib.tos_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
  return lib


def load():
  """The loaded codec library, built on first use; raises
  :class:`CodecBuildError` when it cannot be built or loaded."""
  global _lib
  with _lib_lock:
    if _lib is None:
      path = library_path()
      t0, cached = time.monotonic(), path.exists()
      if not cached:
        _build(path)
      # the port's compile event (obs.device): g++ at first use
      obs_device.note_build("tfrecord_codec", time.monotonic() - t0, cached)
      try:
        _lib = _bind(str(path))
      except (OSError, AttributeError) as e:
        raise CodecBuildError("the codec library %s does not load: %s"
                              % (path, e)) from e
    return _lib


# -- the pure-Python framing ---------------------------------------------------

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
  """CRC32C (Castagnoli) of ``data``, in Python."""
  table = _crc_table()
  crc = 0xFFFFFFFF
  for b in data:
    crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


def masked_crc_py(data: bytes) -> int:
  """TFRecord's masked CRC32C, in Python."""
  crc = crc32c(data)
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
  """TFRecord's masked CRC32C, by the native codec."""
  return load().tos_masked_crc32c(data, len(data))


class _Closing(object):
  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


class PyTFRecordWriter(_Closing):
  """Write records to a TFRecord file at any path (remote URIs through
  fsspec) with the pure-Python framing."""

  def __init__(self, path: str):
    self.path = path
    self._file = fs.open_file(path, "wb")

  def write(self, record: bytes) -> None:
    length = struct.pack("<Q", len(record))
    self._file.write(length)
    self._file.write(struct.pack("<I", masked_crc_py(length)))
    self._file.write(record)
    self._file.write(struct.pack("<I", masked_crc_py(record)))

  def close(self) -> None:
    if self._file:
      self._file.close()
      self._file = None


class PyTFRecordReader(_Closing):
  """Iterate the records of a TFRecord file at any path (remote URIs
  stream record at a time through fsspec's buffered reads) with the
  pure-Python framing."""

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
    if masked_crc_py(header[:8]) != len_crc:
      raise self._fail("corrupt TFRecord length crc")
    data = self._file.read(length)
    crc_raw = self._file.read(4)
    if len(data) < length or len(crc_raw) < 4:
      raise self._fail("truncated TFRecord data")
    if masked_crc_py(data) != struct.unpack("<I", crc_raw)[0]:
      raise self._fail("corrupt TFRecord data")
    return data

  def close(self) -> None:
    if self._file:
      self._file.close()
      self._file = None


# -- the native codec ----------------------------------------------------------


class NativeTFRecordWriter(_Closing):
  """Write records to a local TFRecord file (or ``file://`` URI) through
  the native codec."""

  def __init__(self, path: str):
    if fs.is_remote(path):
      raise ValueError("the native codec writes local files only, not %r"
                       % path)
    self.path = path
    self._lib = load()
    self._handle = self._lib.tos_writer_open(
        fs.strip_scheme(path).encode())
    if not self._handle:
      raise OSError("cannot open %s for writing" % path)

  def write(self, record: bytes) -> None:
    if self._lib.tos_writer_write(self._handle, record, len(record)):
      raise OSError("write failed on %s" % self.path)

  def close(self) -> None:
    if self._handle:
      handle, self._handle = self._handle, None
      if self._lib.tos_writer_close(handle):
        raise OSError("close failed on %s" % self.path)


class NativeTFRecordReader(_Closing):
  """Iterate the records of a local TFRecord file (or ``file://`` URI)
  through the native codec."""

  def __init__(self, path: str):
    if fs.is_remote(path):
      raise ValueError("the native codec reads local files only, not %r"
                       % path)
    self.path = path
    self._lib = load()
    self._handle = self._lib.tos_reader_open(fs.strip_scheme(path).encode())
    if not self._handle:
      raise OSError("cannot open %s" % path)

  def __iter__(self) -> Iterator[bytes]:
    return self

  def __next__(self) -> bytes:
    if not self._handle:
      raise StopIteration
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = self._lib.tos_reader_next(self._handle, ctypes.byref(out))
    if n == -1:
      self.close()
      raise StopIteration
    if n < 0:
      self.close()
      raise IOError("corrupt or truncated TFRecord in %s" % self.path)
    return ctypes.string_at(out, n)

  def close(self) -> None:
    if self._handle:
      handle, self._handle = self._handle, None
      self._lib.tos_reader_close(handle)


def TFRecordWriter(path: str):
  """A writer for ``path``: the native codec for a local path or
  ``file://`` URI, the pure-Python framing through fsspec for a remote
  URI (the reference's rule)."""
  return PyTFRecordWriter(path) if fs.is_remote(path) \
      else NativeTFRecordWriter(path)


def TFRecordReader(path: str):
  """A reader for ``path``, chosen as :func:`TFRecordWriter` chooses."""
  return PyTFRecordReader(path) if fs.is_remote(path) \
      else NativeTFRecordReader(path)
