"""Export plane: per-process JSONL logs, Prometheus text, Chrome traces.

The port's copy of ``tensorflowonspark_tpu/obs/export.py``, unchanged.

Three consumers, three formats:

- **JSONL event logs** (``TOS_OBS_DIR``): every obs-enabled process
  appends its spans (plus a meta header, its final clock offset and a
  final metrics snapshot) to ``obs-<label><id>-<pid>.jsonl``. Crash-safe
  by construction: each line is self-contained, a truncated tail loses
  only the last line.
- **Prometheus text exposition** (:func:`prometheus_text`): the registry
  snapshot (or the driver sink's per-executor totals) rendered in the
  standard ``# TYPE`` format for scrape endpoints / file-based collection.
- **Chrome trace JSON** (:func:`chrome_trace`): the merged per-node spans
  as a ``traceEvents`` array loadable in Perfetto / chrome://tracing,
  one process track per JSONL log, timestamps driver-anchored via each
  process's estimated clock offset (``obs.spans.ClockOffset``).

``tools/obs_report.py`` is the CLI over :func:`merge_jsonl` +
:func:`chrome_trace`.
"""

import glob
import json
import os
import threading
import time
from typing import Dict, List, Optional

#: directory for per-process JSONL event logs; unset disables the offline
#: log plane (env registry: TOS008)
ENV_OBS_DIR = "TOS_OBS_DIR"


def log_dir() -> Optional[str]:
  return os.environ.get(ENV_OBS_DIR) or None


class ProcessLog(object):
  """Append-only JSONL log for one process (no-op when no dir is set).

  Files are opened per append batch (open/write/close under ``with``):
  the log must survive SIGKILL mid-run with everything already appended,
  and a held-open fd in a long-lived executor is a leak class (TOS006).
  """

  def __init__(self, directory: Optional[str] = None, label: str = "proc",
               executor_id: int = 0, clock=None):
    self.directory = directory if directory is not None else log_dir()
    self.label = label
    self.executor_id = int(executor_id)
    self.clock = clock
    self.path = None
    if self.directory:
      self.path = os.path.join(
          self.directory,
          "obs-%s%d-%d.jsonl" % (label, self.executor_id, os.getpid()))
    self._lock = threading.Lock()
    self._meta_written = False

  def _append(self, records: List[dict]) -> None:
    if self.path is None or not records:
      return
    with self._lock:
      lines = []
      if not self._meta_written:
        self._meta_written = True
        lines.append(json.dumps({
            "kind": "meta", "label": self.label,
            "executor_id": self.executor_id, "pid": os.getpid(),
            "t_wall": time.time(), "t_mono": time.monotonic()}))
      lines.extend(json.dumps(r) for r in records)
      try:
        os.makedirs(self.directory, exist_ok=True)
        with open(self.path, "a") as f:
          f.write("\n".join(lines) + "\n")
      except OSError:
        # an unwritable obs dir must not take down the process being
        # observed; the merged report will simply miss this log
        self.path = None

  def append_spans(self, spans: List[dict]) -> None:
    self._append([dict(rec, kind="span") for rec in spans])

  def append_alerts(self, alerts: List[dict]) -> None:
    """Structured detector alerts (``obs.anomaly``), appended as they
    fire so a post-mortem (``obs_report --alerts``) survives a driver
    crash — each line is self-contained like every other record here."""
    self._append([dict(rec, kind="alert") for rec in alerts])

  def close(self, metrics_snapshot: Optional[dict] = None) -> None:
    """Stamp the final clock offset + metrics snapshot (merge anchors on
    the LAST clock line — the best estimate the process ever had)."""
    tail: List[dict] = []
    if self.clock is not None:
      tail.append(dict(self.clock.snapshot(), kind="clock"))
    if metrics_snapshot is not None:
      tail.append({"kind": "metrics", "data": metrics_snapshot})
    if not tail and not self._meta_written:
      return   # nothing was ever logged; leave no empty file behind
    self._append(tail)


# -- merge + chrome trace -----------------------------------------------------


def find_logs(directory: str) -> List[str]:
  return sorted(glob.glob(os.path.join(directory, "obs-*.jsonl")))


def merge_jsonl(paths: List[str]) -> List[dict]:
  """Parse per-process logs into proc dicts:
  ``{"path", "meta", "spans", "alerts", "metrics", "clock"}`` (malformed
  lines are skipped and counted in ``"skipped"``)."""
  procs = []
  for path in paths:
    proc = {"path": path, "meta": {}, "spans": [], "alerts": [],
            "metrics": {}, "clock": {}, "skipped": 0}
    try:
      with open(path) as f:
        lines = f.read().splitlines()
    except OSError as e:
      # unreadable log: surfaced in the report (never raised — a partial
      # merge beats no merge), counted so the gap is visible
      proc["error"] = str(e)
      procs.append(proc)
      continue
    for line in lines:
      if not line.strip():
        continue
      try:
        rec = json.loads(line)
        kind = rec.get("kind")
      except (ValueError, AttributeError):
        proc["skipped"] += 1
        continue
      if kind == "meta":
        proc["meta"] = rec
      elif kind == "span":
        proc["spans"].append(rec)
      elif kind == "alert":
        proc["alerts"].append(rec)
      elif kind == "clock":
        proc["clock"] = rec   # last one wins: the final (best) estimate
      elif kind == "metrics":
        proc["metrics"] = rec.get("data") or {}
      else:
        proc["skipped"] += 1
    procs.append(proc)
  return procs


def anchored_window(proc: dict) -> Optional[tuple]:
  """(first_start, last_end) of a proc's spans on the DRIVER timeline."""
  offset = float(proc.get("clock", {}).get("offset") or 0.0)
  spans = proc.get("spans") or []
  if not spans:
    return None
  starts = [s["t0"] + offset for s in spans]
  ends = [s["t0"] + s.get("dur", 0.0) + offset for s in spans]
  return min(starts), max(ends)


def _flow_id(trace: str) -> int:
  """Stable positive int id for a hex trace id (chrome flow ``id``).
  13 hex chars = 52 bits: trace viewers parse JSON numbers into float64,
  so ids must stay inside the 2**53 exact-integer range or two distinct
  traces can collapse onto one arrow chain after rounding."""
  try:
    return int(str(trace)[:13], 16) or 1
  except ValueError:
    return abs(hash(trace)) % (1 << 52) or 1


def _flow_events(spans_by_trace: Dict[str, List[dict]]) -> List[dict]:
  """Chrome flow events binding each trace's spans into one arrow chain.

  For every trace with >= 2 spans, the time-ordered chain gets a flow
  start (``ph: "s"``) on the first span, a step (``"t"``) on each
  middle one and a finish (``"f", bp: "e"``) on the last — all sharing
  ``id = _flow_id(trace)``, which is what renders the CROSS-PROCESS
  arrows (fleet dispatch → replica prefill → decode → stream, including
  a failover hop: both replicas' spans carry the same trace).
  """
  out = []
  for trace, spans in spans_by_trace.items():
    if len(spans) < 2:
      continue
    spans.sort(key=lambda e: e["ts"])
    fid = _flow_id(trace)
    for i, ev in enumerate(spans):
      ph = "s" if i == 0 else ("f" if i == len(spans) - 1 else "t")
      flow = {"ph": ph, "id": fid, "name": "req", "cat": "trace",
              "pid": ev["pid"], "tid": ev["tid"],
              # bind INSIDE the span's duration (chrome rejects flow
              # points outside their enclosing slice)
              "ts": ev["ts"] + min(1.0, ev.get("dur", 0.0) / 2.0)}
      if ph == "f":
        flow["bp"] = "e"
      out.append(flow)
  return out


def chrome_trace(procs: List[dict]) -> dict:
  """Perfetto/chrome://tracing JSON from merged proc logs.

  One trace "process" per log (pid = the real pid, disambiguated on
  collision), timestamps anchored with each proc's clock offset so every
  track shares the driver's monotonic timeline. Spans carrying a
  request ``trace`` id additionally get FLOW events (``ph: s/t/f``)
  chaining them across tracks/processes — the request waterfall's
  arrows (``obs_report --request`` renders the same chain as a table).
  """
  events = []
  used_pids = set()
  spans_by_trace: Dict[str, List[dict]] = {}
  for proc in procs:
    meta = proc.get("meta") or {}
    pid = int(meta.get("pid") or 0)
    while pid in used_pids:
      pid += 1000000   # same-pid logs (a respawn reusing a pid) split
    used_pids.add(pid)
    label = "%s%s" % (meta.get("label", "proc"),
                      meta.get("executor_id", ""))
    offset = float(proc.get("clock", {}).get("offset") or 0.0)
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": label}})
    tids: Dict[str, int] = {}
    for rec in proc.get("spans") or []:
      tname = rec.get("tid") or "main"
      tid = tids.get(tname)
      if tid is None:
        tid = tids[tname] = len(tids) + 1
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
      ts_us = (rec["t0"] + offset) * 1e6
      ev = {"name": rec.get("name", "?"), "pid": pid, "tid": tid,
            "ts": ts_us, "cat": rec.get("name", "?").split(".")[0]}
      if rec.get("ph") == "i":
        ev["ph"] = "i"
        ev["s"] = "t"
      else:
        ev["ph"] = "X"
        ev["dur"] = rec.get("dur", 0.0) * 1e6
      if rec.get("attrs"):
        ev["args"] = dict(rec["attrs"])
      trace = rec.get("trace")
      if trace is not None:
        # surfaced in args (clickable in Perfetto) AND collected for
        # the flow-arrow chain below; instants join args-only
        ev.setdefault("args", {})["trace"] = trace
        if ev["ph"] == "X":
          spans_by_trace.setdefault(str(trace), []).append(ev)
      events.append(ev)
    for rec in proc.get("alerts") or []:
      # detector alerts land as GLOBAL instants: on the trace they mark
      # the moment the driver called the run unhealthy, across all tracks
      events.append({"name": "alert:%s" % rec.get("alert", "?"),
                     "pid": pid, "tid": 0, "ph": "i", "s": "g",
                     "ts": (rec.get("t", 0.0) + offset) * 1e6,
                     "cat": "alert",
                     "args": {k: v for k, v in rec.items()
                              if k not in ("kind", "t")}})
  events.extend(_flow_events(spans_by_trace))
  return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- prometheus text ----------------------------------------------------------


def _prom_name(name: str) -> str:
  out = []
  for ch in name:
    out.append(ch if ch.isalnum() or ch == "_" else "_")
  base = "".join(out)
  return base if base.startswith("tos_") else "tos_" + base


def _prom_labels(labels: Optional[Dict[str, str]], extra: str = "") -> str:
  parts = ['%s="%s"' % (k, v) for k, v in sorted((labels or {}).items())]
  if extra:
    parts.append(extra)
  return "{%s}" % ",".join(parts) if parts else ""


def prometheus_text(snapshot: Dict[str, dict],
                    labels: Optional[Dict[str, str]] = None) -> str:
  """Render a registry snapshot in Prometheus text exposition format."""
  lines: List[str] = []
  for name in sorted(snapshot):
    m = snapshot[name]
    pname = _prom_name(name)
    kind = m.get("type")
    if kind in ("counter", "gauge"):
      lines.append("# TYPE %s %s" % (pname, kind))
      lines.append("%s%s %s" % (pname, _prom_labels(labels), m["value"]))
    elif kind == "histogram":
      lines.append("# TYPE %s histogram" % pname)
      cum = 0
      for bound, cnt in zip(m["bounds"], m["counts"]):
        cum += cnt
        lines.append("%s_bucket%s %d" % (
            pname, _prom_labels(labels, 'le="%g"' % bound), cum))
      cum += m["counts"][-1]
      lines.append("%s_bucket%s %d" % (
          pname, _prom_labels(labels, 'le="+Inf"'), cum))
      lines.append("%s_sum%s %s" % (pname, _prom_labels(labels), m["sum"]))
      lines.append("%s_count%s %d" % (pname, _prom_labels(labels),
                                      m["count"]))
    elif kind == "sketch":
      # quantile sketches (obs.quantiles) render as a Prometheus
      # SUMMARY: the canonical quantile set straight off the sketch
      from tensorflowonspark_tpu_torch.obs import quantiles as _q
      sk = _q.QuantileSketch.from_dict(m.get("data") or {})
      lines.append("# TYPE %s summary" % pname)
      for q in (0.5, 0.9, 0.99):
        v = sk.quantile(q)
        if v is not None:
          lines.append("%s%s %g" % (
              pname, _prom_labels(labels, 'quantile="%g"' % q), v))
      lines.append("%s_count%s %d" % (pname, _prom_labels(labels),
                                      sk.count))
  return "\n".join(lines) + ("\n" if lines else "")
