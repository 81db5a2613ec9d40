"""Fixed-memory mergeable streaming quantile sketch.

The port's copy of ``tensorflowonspark_tpu/obs/quantiles.py``, unchanged.

The obs plane's histograms answer "how many observations fell in this
fixed bucket" — good for rates, useless for principled tail latency:
the p99 of a fixed-bucket histogram is whatever bucket edge it straddles,
and two processes' histograms only merge if someone chose the bucket
bounds right for a latency distribution nobody has seen yet. This module
is the latency object the SLO plane (``obs.slo``) and the serving-plane
benches share instead: a KLL-style compactor-stack sketch —

- **fixed memory**: ~``k·log(n/k)`` stored values regardless of stream
  length (a few KiB at the default k);
- **mergeable**: ``merge`` of two sketches is a sketch of the
  concatenated streams with the error bounds ADDING, not compounding —
  which is what makes cluster-true percentiles possible: every executor
  ships its sketch over the OBS verb and the driver merges, instead of
  each process reporting its own local p99 (the mean of per-process
  p99s is not a p99 of anything);
- **bounded, self-reported error**: rank queries are exact until the
  first compaction (streams shorter than ``k`` are stored outright) and
  off by at most :attr:`rank_error` observations after — the sketch
  TRACKS the bound as it compacts, so a consumer can assert against it
  (``serve_bench --smoke`` does exactly that against the sorted list).

Compaction is DETERMINISTIC (per-level alternating parity instead of
KLL's coin flip): the same stream always yields the same sketch, so
parity-style tests and the delta-shipping plane never see nondeterminism.
The classic randomized analysis gives expected error ~1/k; the
deterministic variant keeps the worst-case bound this module reports
(each compaction of a weight-``w`` level displaces any rank by at most
``w``) at the cost of adversarial-stream tightness we don't need —
latencies are not adversarial.

Registered as a first-class metric kind (``MetricsRegistry.quantiles``,
type ``"sketch"``) in ``obs.metrics``: snapshots are plain msgpack/json
dicts, ``snapshot_delta`` ships the full (fixed-memory) sketch whenever
its count moved, ``apply_delta`` keeps last-write per executor, and the
read plane merges across executors (:func:`merge_snapshots`).
"""

from typing import List, Optional, Sequence

#: default compactor width: rank error after one compaction pass is
#: <= n/k-ish; at 256 the sketch holds every observation outright until
#: 256 samples (exact), and a day of per-request latencies stays ~KiB
DEFAULT_K = 256

#: hard ceiling on retained values independent of k (paranoia bound:
#: levels * k stays small anyway, but the invariant should not depend on
#: the analysis being right)
_MAX_LEVELS = 64


class QuantileSketch(object):
  """KLL-style mergeable quantile sketch with deterministic compaction.

  ``levels[i]`` holds UNSORTED values of weight ``2**i``; level 0 is the
  raw stream. When a level overflows its capacity (``k`` for the top
  levels, shrinking geometrically for lower ones), it is sorted and
  every other element is promoted to the next level — the classic KLL
  compactor, with the surviving parity alternating per level instead of
  random, so identical streams produce identical sketches.

  Thread-safety: same contract as the other metric hot paths
  (``obs.metrics``) — plain list appends under the GIL; a rare racing
  ``add`` can lose one observation, never corrupt the structure. Reads
  (``quantile``/``rank``/``snapshot``) are driver/report-side.
  """

  __slots__ = ("k", "levels", "count", "vmin", "vmax", "_compactions",
               "_parity")

  def __init__(self, k: int = DEFAULT_K):
    if k < 8:
      raise ValueError("sketch k must be >= 8, got %d" % k)
    self.k = int(k)
    self.levels: List[List[float]] = [[]]
    self.count = 0
    self.vmin: Optional[float] = None
    self.vmax: Optional[float] = None
    # per-level compaction counters: the error bound is computed from
    # these, so the sketch can report how wrong it may be
    self._compactions: List[int] = [0]
    self._parity: List[int] = [0]

  # -- write path ------------------------------------------------------------

  def add(self, value) -> None:
    v = float(value)
    self.count += 1
    if self.vmin is None or v < self.vmin:
      self.vmin = v
    if self.vmax is None or v > self.vmax:
      self.vmax = v
    self.levels[0].append(v)
    if len(self.levels[0]) >= self._capacity(0):
      self._compress()

  def extend(self, values) -> None:
    for v in values:
      self.add(v)

  def _capacity(self, level: int) -> int:
    # lower levels may shrink geometrically (they carry less weight);
    # keep it simple and safe: full k everywhere — memory is still
    # O(k log(n/k)) and the bound only tightens
    return self.k

  def _compress(self) -> None:
    for i in range(len(self.levels)):
      buf = self.levels[i]
      if len(buf) < self._capacity(i):
        continue
      if i + 1 == len(self.levels):
        if len(self.levels) >= _MAX_LEVELS:
          # unreachable in practice (2**64 observations); drop to half
          # rather than grow without bound
          buf.sort()
          del buf[::2]
          self._compactions[i] += 1
          continue
        self.levels.append([])
        self._compactions.append(0)
        self._parity.append(0)
      buf.sort()
      # alternating parity: deterministic, and successive compactions
      # cancel rather than accumulate one-sided rank drift
      start = self._parity[i] & 1
      self._parity[i] ^= 1
      promoted = buf[start::2]
      self.levels[i + 1].extend(promoted)
      self._compactions[i] += 1
      del buf[:]

  # -- read path -------------------------------------------------------------

  @property
  def rank_error(self) -> int:
    """Worst-case rank displacement (in observations) any quantile
    answer can carry: each compaction of a weight-``2**i`` level moves
    any rank by at most ``2**i``. Zero until the first compaction —
    short streams are EXACT."""
    return sum(c * (1 << i) for i, c in enumerate(self._compactions))

  @property
  def relative_error(self) -> float:
    """``rank_error`` as a fraction of the stream (0.0 when empty)."""
    if not self.count:
      return 0.0
    return self.rank_error / float(self.count)

  def _weighted(self) -> List[tuple]:
    out = []
    for i, buf in enumerate(self.levels):
      w = 1 << i
      out.extend((v, w) for v in buf)
    out.sort(key=lambda vw: vw[0])
    return out

  def quantile(self, q: float) -> Optional[float]:
    """The value at quantile ``q`` in [0, 1] (None when empty): the
    smallest retained value whose cumulative weight reaches ``q·count``
    — nearest-rank semantics, exact until the first compaction."""
    if not 0.0 <= q <= 1.0:
      raise ValueError("quantile must be in [0, 1], got %r" % (q,))
    items = self._weighted()
    if not items:
      return None
    target = q * self.count
    cum = 0
    for v, w in items:
      cum += w
      if cum >= target:
        return v
    return items[-1][0]

  def rank(self, value) -> int:
    """Approximate count of observations <= ``value`` (the CDF numerator
    — ``count - rank(threshold)`` is the over-threshold count the SLO
    plane's bad-fraction rides on)."""
    v = float(value)
    total = 0
    for i, buf in enumerate(self.levels):
      w = 1 << i
      for x in buf:
        if x <= v:
          total += w
    return min(total, self.count)

  # -- merge + serialization -------------------------------------------------

  def merge(self, other: "QuantileSketch") -> "QuantileSketch":
    """Fold ``other`` into self (returns self). Error bounds ADD: the
    merged ``rank_error`` is at most the sum of both plus whatever new
    compactions the fold itself triggers."""
    if other.count == 0:
      return self
    while len(self.levels) < len(other.levels):
      self.levels.append([])
      self._compactions.append(0)
      self._parity.append(0)
    for i, buf in enumerate(other.levels):
      self.levels[i].extend(buf)
      self._compactions[i] += other._compactions[i] \
          if i < len(other._compactions) else 0
    self.count += other.count
    if other.vmin is not None and (self.vmin is None
                                   or other.vmin < self.vmin):
      self.vmin = other.vmin
    if other.vmax is not None and (self.vmax is None
                                   or other.vmax > self.vmax):
      self.vmax = other.vmax
    self._compress()
    return self

  def to_dict(self) -> dict:
    """msgpack/json-safe snapshot (the ``"sketch"`` metric payload)."""
    return {"k": self.k, "count": self.count, "min": self.vmin,
            "max": self.vmax, "levels": [list(b) for b in self.levels],
            "compactions": list(self._compactions)}

  @classmethod
  def from_dict(cls, d: dict) -> "QuantileSketch":
    sk = cls(int(d.get("k") or DEFAULT_K))
    levels = d.get("levels") or [[]]
    sk.levels = [[float(v) for v in b] for b in levels]
    sk.count = int(d.get("count") or 0)
    sk.vmin = d.get("min")
    sk.vmax = d.get("max")
    comps = d.get("compactions") or []
    sk._compactions = [int(c) for c in comps] or [0] * len(sk.levels)
    while len(sk._compactions) < len(sk.levels):
      sk._compactions.append(0)
    sk._parity = [0] * len(sk.levels)
    return sk


def merge_snapshots(snaps: Sequence[Optional[dict]],
                    k: int = DEFAULT_K) -> QuantileSketch:
  """Merge sketch snapshot dicts (per-executor ``"sketch"`` payloads,
  Nones skipped) into one cluster-true sketch — the read-plane half of
  delta shipping: executors ship full fixed-memory sketches, the driver
  keeps last-write per executor, and queries merge across them."""
  out = QuantileSketch(k)
  for s in snaps:
    if not s:
      continue
    data = s.get("data") if "data" in s else s
    if not data or not data.get("count"):
      continue
    out.merge(QuantileSketch.from_dict(data))
  return out
