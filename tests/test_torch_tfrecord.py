"""The port's TFRecord codec: native, pure Python and the reference's.

Files written by the port's native codec, the port's pure-Python framing
and the JAX package's writer are byte-equal and read back through each of
the three readers; a damaged record raises ``IOError`` in both of the
port's readers; the native masked CRC32C agrees with the Python one on
random bytes; a codec that does not build raises with the compiler's
message.
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tensorflowonspark_tpu.data import tfrecord as jax_tfrecord
from tensorflowonspark_tpu_torch.data import example_codec, tfrecord

WRITERS = {"native": tfrecord.NativeTFRecordWriter,
           "python": tfrecord.PyTFRecordWriter,
           "reference": jax_tfrecord.TFRecordWriter}
READERS = {"native": tfrecord.NativeTFRecordReader,
           "python": tfrecord.PyTFRecordReader,
           "reference": jax_tfrecord.TFRecordReader}


def _records():
  rng = np.random.default_rng(11)
  out = [b"", b"x", bytes(range(256)) * 400]
  for n in (1, 17, 1000, 16384):
    out.append(example_codec.encode_example(
        {"tokens": [int(v) for v in rng.integers(0, 32000, n)]}))
  return out


def _write(cls, path, records):
  with cls(path) as w:
    for r in records:
      w.write(r)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
  """The same records written by each of the three writers."""
  root = tmp_path_factory.mktemp("codec")
  records = _records()
  paths = {}
  for name, cls in WRITERS.items():
    paths[name] = str(root / ("%s.tfrecord" % name))
    _write(cls, paths[name], records)
  return records, paths


def _bytes(path):
  with open(path, "rb") as f:
    return f.read()


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_writers_frame_the_same_bytes(files, writer):
  _, paths = files
  assert _bytes(paths[writer]) == _bytes(paths["reference"])


@pytest.mark.parametrize("reader", sorted(READERS))
@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_each_reader_reads_each_writer(files, writer, reader):
  records, paths = files
  assert list(READERS[reader](paths[writer])) == records


@pytest.mark.parametrize("reader", ["native", "python"])
@pytest.mark.parametrize("damage", ["length_crc", "data_crc", "data",
                                    "truncated_header", "truncated_data"])
def test_a_damaged_record_raises_ioerror(tmp_path, damage, reader):
  path = str(tmp_path / "bad.tfrecord")
  _write(tfrecord.NativeTFRecordWriter, path, [b"abcdefgh"] * 3)
  raw = bytearray(_bytes(path))
  step = 12 + 8 + 4                                 # one record's frame
  if damage == "length_crc":
    raw[step + 8] ^= 0xFF                           # the second record's
  elif damage == "data_crc":
    raw[-1] ^= 0xFF
  elif damage == "data":
    raw[step + 12] ^= 0x01
  elif damage == "truncated_header":
    raw = raw[:2 * step + 5]
  else:
    raw = raw[:-2]
  with open(path, "wb") as f:
    f.write(bytes(raw))
  it = READERS[reader](path)
  if damage not in ("length_crc", "data", "truncated_header"):
    assert next(it) == b"abcdefgh"
  with pytest.raises(IOError):
    list(it)


@settings(max_examples=200, deadline=None)
@given(st.binary(max_size=4096))
def test_masked_crc_native_equals_python(data):
  want = tfrecord.masked_crc_py(data)
  assert tfrecord.masked_crc(data) == want
  crc = jax_tfrecord._crc32c_py(data)
  assert want == (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def test_native_codec_refuses_remote_paths():
  with pytest.raises(ValueError, match="local files only"):
    tfrecord.NativeTFRecordWriter("memory://bucket/x.tfrecord")
  with pytest.raises(ValueError, match="local files only"):
    tfrecord.NativeTFRecordReader("memory://bucket/x.tfrecord")


def test_a_failed_build_raises_with_the_compilers_message(tmp_path,
                                                          monkeypatch):
  """No fallback: a codec that does not compile raises, and the error
  carries g++'s own words; nothing is left in the build directory."""
  broken = tmp_path / "tfrecord_codec.cpp"
  broken.write_text("int tos_masked_crc32c( { this is not C++\n")
  monkeypatch.setattr(tfrecord, "NATIVE_SRC", broken)
  monkeypatch.setattr(tfrecord, "BUILD_DIR", tmp_path / "build")
  monkeypatch.setattr(tfrecord, "_lib", None)
  with pytest.raises(tfrecord.CodecBuildError, match="g\\+\\+ failed") as e:
    tfrecord.TFRecordWriter(str(tmp_path / "x.tfrecord"))
  assert "error" in str(e.value) and str(broken) in str(e.value)
  assert os.listdir(tmp_path / "build") == []


def test_the_library_is_named_by_source_and_flags():
  path = tfrecord.library_path()
  assert path.parent == tfrecord.BUILD_DIR
  assert path.name.startswith("libtfrecord.") and path.suffix == ".so"
  tfrecord.load()
  assert path.exists()
