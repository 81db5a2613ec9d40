"""Columnar chunk codec for the feed data plane.

The port's copy of ``tensorflowonspark_tpu/control/chunkcodec.py``: the
same wire format byte for byte, with the port's own msgpack subset
(:mod:`._msgpack`) in place of the ``msgpack`` package and the standard
``pickle`` in place of ``cloudpickle`` for the fallback envelope.

The feed plane moves chunks (lists of rows) between processes. Pickling a
list of numpy rows costs a per-row object walk on both sides; most feed
traffic is homogeneous (every row an ndarray, or a fixed-arity tuple of
ndarrays/scalars — exactly what ``dfutil``/``DataFeed`` produce). Such
chunks are encoded COLUMNAR: each column is stacked into one contiguous
buffer and shipped as raw bytes inside a msgpack envelope — no pickle on
the hot path, one memcpy per column. Anything heterogeneous falls back to
pickle transparently.

Format: msgpack map ``{"f": format, ...}``; format 0 = pickle
payload under ``"p"``; format 1 = columnar with ``"t"`` (rows are tuples)
and ``"c"`` (list of columns, each ``{"d": dtype, "s": shape, "b": bytes,
"y": python-scalar flag}``). A column may additionally carry ``"e"`` — a
per-column WIRE ENCODING id (absent = raw bytes, the original format,
byte-identical). Per column per chunk a cheap sampled heuristic picks one
of the registry's encodings when it is allowed and pays:

- ``dict`` — low-cardinality integer columns (labels, category ids):
  unique values plus a uint8 index stream;
- ``delta`` — monotone non-decreasing integer columns (row ids,
  timestamps): first value plus per-element deltas in the narrowest
  unsigned dtype that holds them;
- ``bitpack`` — bool columns at one bit per element;
- ``zlib`` — stdlib byte-level fallback for any column whose sampled
  compression ratio clears the threshold.

Every encoding round-trips EXACTLY (bit-identical values), so consumers
cannot observe which encoding a chunk rode in on. The candidate set comes
from ``TOS_FEED_WIRE_ENCODINGS`` (comma-separated registry names;
``raw``/empty disables every encoder).

Two decode modes:

- :func:`decode` — row materialization (pickle parity: writable rows),
  the legacy hot path;
- :func:`decode_columns` — returns a :class:`ColumnChunk` whose column
  arrays are READ-ONLY: ``raw`` columns are ZERO-COPY views over the
  msgpack bin payload (msgpack owns the bytes, so the views outlive any
  transport scratch buffer the payload was parsed from); encoded columns
  materialize exactly once at decode (they are smaller by construction).
  Consumers assemble batches by slicing and concatenating these columns;
  the concatenation at batch hand-off is the single copy on that path
  (and ``datafeed._assemble_columns`` elides even that when a batch falls
  inside one chunk).
"""

import os
import pickle
import zlib
from typing import List, Optional

import numpy as np

from tensorflowonspark_tpu_torch.control import _msgpack as msgpack

_F_PICKLE = 0
_F_COLUMNAR = 1

_SCALARS = (bool, int, float)

#: chunk payloads above this ENCODED size are split at the row level
#: before transport (a ring record larger than ~half the ring capacity
#: can wedge against the wrap-around padding; hub-queue envelopes just
#: get cheaper to pickle). Compression widens the effective row budget —
#: the split always measures the encoded payload, never the raw rows.
MAX_PAYLOAD = 4 * 1024 * 1024

#: candidate per-column wire encodings: comma-separated ``_ENCODERS``
#: names; ``raw`` or empty disables every encoder (env registry: TOS008)
ENV_FEED_WIRE_ENCODINGS = "TOS_FEED_WIRE_ENCODINGS"

DEFAULT_WIRE_ENCODINGS = "dict,delta,bitpack,zlib"

# wire ids (a column's "e" key; an absent key means _E_RAW)
_E_RAW = 0
_E_DICT = 1
_E_DELTA = 2
_E_BITPACK = 3
_E_ZLIB = 4

#: columns below this raw size always ship raw: the heuristic probe and
#: the decode-side materialization both out-price the byte savings
MIN_ENCODE_BYTES = 512
_SAMPLE_ELEMS = 64         # cardinality probe sample size
_DICT_PROBE_MAX = 16       # sampled distinct values above this: no dict
_DICT_MAX = 256            # full distinct bound (uint8 index stream)
_ZLIB_PROBE_BYTES = 4096   # leading slice test-compressed by the probe
                           # (level-1 ratio estimates stabilize well under
                           # 4 KiB; a declined probe is the hot path on
                           # incompressible columns, so it must stay cheap)
_ZLIB_PROBE_RATIO = 0.7    # probe must compress below this to continue
_ZLIB_LEVEL = 1            # speed over ratio: the feeder is a hot path


class OversizedRowError(ValueError):
  """A SINGLE row's encoded payload exceeds ``MAX_PAYLOAD``: it cannot be
  split further at the row level, so no transport can carry it. Raised as
  a structured error by ``node.put_rows_chunk`` instead of recursing."""


def _enc_bitpack(arr: np.ndarray, raw: bytes) -> Optional[dict]:
  if arr.dtype.kind != "b":
    return None
  return {"e": _E_BITPACK, "b": np.packbits(arr.reshape(-1)).tobytes()}


def _dec_bitpack(col: dict, count: int) -> np.ndarray:
  bits = np.unpackbits(np.frombuffer(col["b"], np.uint8), count=count)
  return bits.view(np.bool_)


def _enc_dict(arr: np.ndarray, raw: bytes) -> Optional[dict]:
  if arr.dtype.kind not in "iu":
    return None
  flat = arr.reshape(-1)
  # strided cardinality probe before the O(n log n) full unique
  step = max(1, flat.size // _SAMPLE_ELEMS)
  if np.unique(flat[::step]).size > _DICT_PROBE_MAX:
    return None
  uniq, inv = np.unique(flat, return_inverse=True)
  if uniq.size > _DICT_MAX:
    return None
  idx = inv.astype(np.uint8).reshape(-1)
  if uniq.nbytes + idx.nbytes >= len(raw):
    return None
  return {"e": _E_DICT, "b": idx.tobytes(), "u": uniq.tobytes()}


def _dec_dict(col: dict, count: int) -> np.ndarray:
  uniq = np.frombuffer(col["u"], dtype=np.dtype(col["d"]))
  idx = np.frombuffer(col["b"], dtype=np.uint8)
  return uniq[idx]


def _enc_delta(arr: np.ndarray, raw: bytes) -> Optional[dict]:
  # scalar-per-row integer columns only; values must fit python->msgpack
  # int64 and the span must fit uint32 so the int64 delta math is exact
  if arr.dtype.kind not in "iu" or arr.ndim != 1 or arr.size < 2 \
      or arr.dtype.itemsize < 2:
    return None
  lo, hi = int(arr[0]), int(arr[-1])
  if lo < -(1 << 63) or hi > (1 << 63) - 1 or hi - lo > 0xFFFFFFFF:
    return None
  if not bool(np.all(arr[1:] >= arr[:-1])):
    return None
  deltas = arr[1:].astype(np.int64) - arr[:-1].astype(np.int64)
  dmax = int(deltas.max())
  wire = np.uint8 if dmax <= 0xFF else \
      np.uint16 if dmax <= 0xFFFF else np.uint32
  if np.dtype(wire).itemsize >= arr.dtype.itemsize:
    return None
  return {"e": _E_DELTA, "b": deltas.astype(wire).tobytes(),
          "w": np.dtype(wire).str, "m": lo}


def _dec_delta(col: dict, count: int) -> np.ndarray:
  out = np.empty(count, dtype=np.int64)
  out[0] = col["m"]
  if count > 1:
    deltas = np.frombuffer(col["b"], dtype=np.dtype(col["w"]))
    np.cumsum(deltas, dtype=np.int64, out=out[1:])
    out[1:] += col["m"]
  # exact: every value sits inside the original dtype's range
  return out.astype(np.dtype(col["d"]))


def _enc_zlib(arr: np.ndarray, raw: bytes) -> Optional[dict]:
  probe = raw[:_ZLIB_PROBE_BYTES]
  if len(zlib.compress(probe, _ZLIB_LEVEL)) > _ZLIB_PROBE_RATIO * len(probe):
    return None  # sampled ratio says incompressible: don't pay the full pass
  comp = zlib.compress(raw, _ZLIB_LEVEL)
  if len(comp) >= len(raw):
    return None
  return {"e": _E_ZLIB, "b": comp}


def _dec_zlib(col: dict, count: int) -> np.ndarray:
  return np.frombuffer(zlib.decompress(col["b"]), dtype=np.dtype(col["d"]))


#: the wire-encoding registry. Contract (analyzer rule TOS014): every
#: ``_ENCODERS`` key MUST have a matching ``_DECODERS`` arm — an encoder
#: alone emits payloads no consumer can open. Decoder-only arms are fine
#: (kept for wire compatibility after an encoder retires).
_ENCODERS = {
    "dict": _enc_dict,
    "delta": _enc_delta,
    "bitpack": _enc_bitpack,
    "zlib": _enc_zlib,
}

_DECODERS = {
    "dict": _dec_dict,
    "delta": _dec_delta,
    "bitpack": _dec_bitpack,
    "zlib": _dec_zlib,
}

#: heuristic try-order: cheap structural encodings first, byte-level
#: zlib last (it is the most expensive probe and the slowest decode)
_PRECEDENCE = ("bitpack", "delta", "dict", "zlib")

_WIRE_IDS = {"dict": _E_DICT, "delta": _E_DELTA, "bitpack": _E_BITPACK,
             "zlib": _E_ZLIB}
_ID_NAMES = {v: k for k, v in _WIRE_IDS.items()}

_allowed_cache: dict = {}

#: probe hysteresis: a column that declined EVERY enabled encoder backs
#: off exponentially (skip 1, 2, 4, ... _PROBE_BACKOFF_MAX chunks between
#: probes) — a declining column keeps declining, so steady-state probe
#: cost on incompressible data amortizes to ~zero, while a distribution
#: shift is still caught within _PROBE_BACKOFF_MAX chunks. Keyed by
#: (column position, dtype) in the sender process; any successful pick
#: resets the column's backoff. Single-writer state (one feeder thread
#: encodes a given stream); a racing reader at worst probes early.
_PROBE_BACKOFF_MAX = 32
_probe_backoff: dict = {}


def _allowed_encodings() -> tuple:
  """Enabled encoder names in precedence order (memoized per env value)."""
  spec = os.environ.get(ENV_FEED_WIRE_ENCODINGS, DEFAULT_WIRE_ENCODINGS)
  got = _allowed_cache.get(spec)
  if got is None:
    names = {s.strip() for s in spec.split(",")}
    got = tuple(n for n in _PRECEDENCE if n in names)
    _allowed_cache[spec] = got
  return got


def _encode_array(arr: np.ndarray, shape: list, scalar: int,
                  stats=None, col_key=None) -> dict:
  """One stacked ``(n, *shape)`` column array -> wire descriptor.

  Runs the sampled heuristic over the enabled encodings; a raw column's
  descriptor is byte-identical to the pre-registry format (no ``"e"``).
  ``col_key`` (the column's position in its chunk) opts the column into
  probe backoff; direct callers without a stable identity leave it None
  and probe every time."""
  raw = arr.tobytes()
  allowed = _allowed_encodings()
  if len(raw) >= MIN_ENCODE_BYTES and allowed:
    key = (col_key, arr.dtype.str) if col_key is not None else None
    state = _probe_backoff.get(key) if key is not None else None
    if state is not None and state[1] > 0:
      state[1] -= 1            # backing off: ship raw without probing
    else:
      for name in allowed:
        ext = _ENCODERS[name](arr, raw)
        if ext is not None:
          if key is not None:
            _probe_backoff.pop(key, None)
          if stats is not None:
            stats[name] = stats.get(name, 0) + 1
          desc = {"d": arr.dtype.str, "s": shape, "y": scalar}
          desc.update(ext)
          return desc
      if key is not None:
        skip = min(_PROBE_BACKOFF_MAX, state[0] * 2 if state else 1)
        _probe_backoff[key] = [skip, skip]
  if stats is not None:
    stats["raw"] = stats.get("raw", 0) + 1
  return {"d": arr.dtype.str, "s": shape, "b": raw, "y": scalar}


def _encode_column(values, stats=None, col_key=None) -> Optional[dict]:
  """One column (len(chunk) values) -> descriptor, or None if ineligible."""
  first = values[0]
  if isinstance(first, np.ndarray):
    dtype, shape = first.dtype, first.shape
    if dtype == object or not all(
        isinstance(v, np.ndarray) and v.dtype == dtype and v.shape == shape
        for v in values):
      return None
    return _encode_array(np.stack(values), list(shape), 0, stats, col_key)
  if isinstance(first, _SCALARS):
    kind = type(first)
    # EXACT python types only: decode materializes .item() python scalars,
    # so np.float64 (a float subclass that passes the isinstance above)
    # would silently come back retyped — pickle round-trips it instead
    if kind not in _SCALARS or not all(type(v) is kind for v in values):
      return None
    try:
      arr = np.asarray(values)
    except OverflowError:   # int outside every numpy integer range
      return None
    # the array dtype must round-trip the value kind EXACTLY: ints beyond
    # int64 coerce to float64 (silent rounding + retyping), so ineligible
    if arr.dtype.kind != {bool: "b", int: "i", float: "f"}[kind]:
      return None
    return _encode_array(arr, [], 1, stats, col_key)
  return None


def _view_column(col: dict, n: int) -> np.ndarray:
  """Column descriptor -> (n, *shape) ndarray view over the bin payload.

  Zero-copy: the array is read-only and backed by the bytes object
  msgpack produced for the bin — no bytearray copy, no per-row list."""
  arr = np.frombuffer(col["b"], dtype=np.dtype(col["d"]))
  return arr.reshape((n,) + tuple(col["s"]))


def _decode_column(col: dict, n: int) -> np.ndarray:
  """Column descriptor -> (n, *shape) ndarray, READ-ONLY either way:
  ``raw`` stays the zero-copy :func:`_view_column` path; encoded columns
  materialize exactly once here."""
  wire_id = col.get("e", _E_RAW)
  if wire_id == _E_RAW:
    return _view_column(col, n)
  name = _ID_NAMES.get(wire_id)
  if name is None:
    raise ValueError("unknown wire-encoding id %r (sender newer than this "
                     "decoder?)" % (wire_id,))
  shape = (n,) + tuple(col["s"])
  count = 1
  for dim in shape:
    count *= int(dim)
  arr = _DECODERS[name](col, count).reshape(shape)
  arr.flags.writeable = False
  return arr


class ColumnChunk(object):
  """A decoded columnar chunk: per-column ndarray views sharing one payload.

  ``cols[j]`` has shape ``(n, *row_shape)`` and is READ-ONLY (raw columns
  alias the msgpack bin bytes; encoded columns are frozen decode output).
  ``scalar[j]`` marks columns whose row values were python scalars;
  ``tuples`` says whether rows were tuples.
  :meth:`rows` materializes the exact row list :func:`decode` returns
  (writable, pickle parity) — the fallback for row-granular consumers.
  """

  __slots__ = ("cols", "scalar", "tuples", "n")

  def __init__(self, cols: List[np.ndarray], scalar: List[int],
               tuples: bool, n: int):
    self.cols = cols
    self.scalar = scalar
    self.tuples = tuples
    self.n = n

  def rows(self, start: int = 0) -> List:
    """Materialize rows ``start..n`` (writable copies, decode() parity)."""
    per_col = []
    for arr, y in zip(self.cols, self.scalar):
      part = arr[start:]
      if y:
        per_col.append([v.item() for v in part])
      else:
        # one copy per column; rows come out as non-overlapping WRITABLE
        # views of it (consumers mutate rows in place, e.g. `row /= 255.0`)
        per_col.append(list(part.copy()))
    if not self.tuples:
      return per_col[0]
    return [tuple(col[i] for col in per_col) for i in range(self.n - start)]


def _dumps(obj) -> bytes:
  """The fallback envelope's payload, in the protocol cloudpickle writes."""
  return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def _encode_chunk(chunk: "ColumnChunk", stats=None) -> bytes:
  """Encode an in-process :class:`ColumnChunk` (already-stacked columns —
  e.g. a feeder-side pushdown segment's output) without re-materializing
  rows. Falls back to pickle under the same eligibility rules as the
  row-list path (object columns, pure-scalar chunks)."""
  if chunk.n and not any(c.dtype == object for c in chunk.cols) and \
      any(not y for y in chunk.scalar):
    tally: dict = {}
    cols = [_encode_array(arr, list(arr.shape[1:]), int(bool(y)), tally, j)
            for j, (arr, y) in enumerate(zip(chunk.cols, chunk.scalar))]
    if stats is not None:
      for k, v in tally.items():
        stats[k] = stats.get(k, 0) + v
    return msgpack.packb({"f": _F_COLUMNAR, "n": chunk.n,
                          "t": 1 if chunk.tuples else 0, "c": cols})
  return msgpack.packb({"f": _F_PICKLE, "p": _dumps(chunk.rows())})


def encode(chunk, stats=None) -> bytes:
  """Serialize a chunk (any object; lists of homogeneous rows go columnar).

  ``chunk`` may also be a :class:`ColumnChunk`, whose stacked columns
  encode directly. ``stats``: optional dict tallying per-column encoding
  counts (``{"raw": 2, "dict": 1, ...}``) for chunks that ship columnar."""
  if isinstance(chunk, ColumnChunk):
    return _encode_chunk(chunk, stats)
  if isinstance(chunk, list) and chunk:
    cols = None
    tally: dict = {}
    first = chunk[0]
    if isinstance(first, tuple) and first and all(
        isinstance(r, tuple) and len(r) == len(first) for r in chunk):
      cols = [_encode_column([r[j] for r in chunk], tally, j)
              for j in range(len(first))]
      tuples = 1
    elif not isinstance(first, tuple):
      cols = [_encode_column(chunk, tally, 0)]
      tuples = 0
    # columnar only pays when real array data avoids the pickle walk;
    # pure-scalar chunks are faster (and smaller) through pickle
    if cols is not None and all(c is not None for c in cols) and \
        any(not c["y"] for c in cols):
      if stats is not None:
        for k, v in tally.items():
          stats[k] = stats.get(k, 0) + v
      return msgpack.packb({"f": _F_COLUMNAR, "n": len(chunk),
                            "t": tuples, "c": cols})
  return msgpack.packb({"f": _F_PICKLE, "p": _dumps(chunk)})


def decode_columns(payload):
  """Decode WITHOUT materializing rows: columnar chunks come back as a
  :class:`ColumnChunk` of read-only column arrays (zero-copy views for
  ``raw`` columns); pickle-format payloads return the original object
  (typically a row list). ``payload`` may be any buffer (bytes or a
  memoryview over a transport scratch — msgpack copies bin data into
  owned bytes during the parse, so the returned views never alias the
  caller's buffer)."""
  msg = msgpack.unpackb(payload)
  if msg["f"] == _F_PICKLE:
    return pickle.loads(msg["p"])
  n = msg["n"]
  return ColumnChunk([_decode_column(c, n) for c in msg["c"]],
                     [c["y"] for c in msg["c"]], bool(msg["t"]), n)


def decode(payload):
  out = decode_columns(payload)
  if isinstance(out, ColumnChunk):
    return out.rows()
  return out


def classify_decoded(chunk):
  """Normalize a :func:`decode_columns` result to the consumer wire union.

  THE single definition of the chunk-boundary contract every transport's
  ``get_chunk`` and the feed's fetch path share: ``("data", ColumnChunk |
  row_list)`` for payload chunks, ``("marker", m)`` for a single-marker
  chunk (an end-of-feed ``None`` or a ``Marker`` shipped alone at a chunk
  boundary); bare pickled scalars wrap into a one-row list."""
  from tensorflowonspark_tpu_torch.control.marker import Marker
  if isinstance(chunk, ColumnChunk):
    return ("data", chunk)
  if isinstance(chunk, list):
    if len(chunk) == 1 and (chunk[0] is None or isinstance(chunk[0], Marker)):
      return ("marker", chunk[0])
    return ("data", chunk)
  return ("data", [chunk])
