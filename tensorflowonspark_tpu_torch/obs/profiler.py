"""Profiling helpers: ``torch.profiler`` traces, ``StepTimer``, MFU.

Counterpart of ``tensorflowonspark_tpu/obs/profiler.py``. :func:`trace`
runs a region under ``torch.profiler`` (CPU and, where a card is there,
CUDA activities) and writes a Chrome trace that TensorBoard's profile
tab and Perfetto read; :func:`annotate` names a region on that timeline
(``torch.profiler.record_function``).

:class:`StepTimer` is the training loop's seam into the metrics
registry, as in the reference: when the obs plane is active
(``TOS_OBS=1``) each timed step past the warm-up also lands a
``train.step_ms`` histogram observation, a ``train.steps`` /
``train.items`` counter bump and a ``train.step`` span. It is a
wall-clock timer: the caller synchronises inside the timed region (read
the loss with ``float``, or ``torch.cuda.synchronize()``), or the card's
asynchronous launches make every step look instant.

MFU accounting (:func:`transformer_flops_per_token`, :func:`mfu`) is the
reference's; the peak table holds the card's: an H100 SXM's 989e12
dense bf16 FLOP/s. :func:`device_memory_stats` reads
``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info`` of the cards
this process has already initialised, and never initialises CUDA itself.

Known difference: the reference's ``start_server`` starts JAX's
on-demand capture server; PyTorch has none, so :func:`start_server`
raises ``NotImplementedError`` (capture with :func:`trace` instead).
"""

import contextlib
import logging
import os
import time
from typing import Optional

from tensorflowonspark_tpu_torch.obs import metrics as metrics_mod
from tensorflowonspark_tpu_torch.obs import spans as spans_mod

logger = logging.getLogger(__name__)


def start_server(port: int = 9999):
  """The reference's on-demand capture server: PyTorch has no
  counterpart, so this raises. Use :func:`trace` around the region."""
  raise NotImplementedError(
      "start_server(%d): PyTorch has no on-demand profiler capture server "
      "(the reference starts jax.profiler's); trace a region with "
      "obs.profiler.trace(log_dir) instead" % port)


@contextlib.contextmanager
def trace(log_dir: str):
  """Trace a region into ``log_dir`` as a Chrome trace (``*.pt.trace.json``,
  viewable in TensorBoard's profile tab or Perfetto).

  Usage::

      with profiler.trace("/tmp/tb"):
          state, loss = train_step(state, batch)
          float(loss)
  """
  import torch
  from torch.profiler import ProfilerActivity, profile, \
      tensorboard_trace_handler
  os.makedirs(log_dir, exist_ok=True)
  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available() and torch.cuda.is_initialized():
    activities.append(ProfilerActivity.CUDA)
  with profile(activities=activities,
               on_trace_ready=tensorboard_trace_handler(log_dir)):
    yield
  logger.info("profile trace written to %s", log_dir)


def annotate(name: str):
  """Named region annotation for traces (shows up on the timeline)."""
  import torch
  return torch.profiler.record_function(name)


# --- step timing / throughput ------------------------------------------------


class StepTimer(object):
  """Wall-clock step statistics with warmup exclusion.

  Usage::

      timer = StepTimer(warmup=2)
      for batch in data:
          with timer.step(items=batch_size):
              state, loss = train_step(state, batch)
              float(loss)                 # the caller synchronises
      print(timer.summary())   # {steps, mean_ms, p50_ms, p90_ms, items/s}

  When a metrics registry is active (``obs.metrics.active()``), every
  post-warmup step additionally feeds the registry (``train.steps``,
  ``train.items``, ``train.step_ms``) and records a ``train.step`` span.
  Don't also count steps through a ``TrainLoop`` (it owns
  ``train.steps`` too), or steps double-count.
  """

  def __init__(self, warmup: int = 2):
    self.warmup = warmup
    self._durations = []
    self._items = []
    self._seen = 0
    # cached once: the step context is the training hot path, and the
    # disabled case must stay a None check; metric handles are cached too
    self._reg = metrics_mod.active()
    self._rec = spans_mod.active()
    if self._reg is not None:
      self._m_steps = self._reg.counter("train.steps")
      self._m_items = self._reg.counter("train.items")
      self._m_step_ms = self._reg.histogram("train.step_ms")

  @contextlib.contextmanager
  def step(self, items: int = 0):
    t0 = time.perf_counter()
    mono0 = time.monotonic() if self._rec is not None else 0.0
    yield
    dt = time.perf_counter() - t0
    self._seen += 1
    if self._seen > self.warmup:
      self._durations.append(dt)
      self._items.append(items)
      if self._reg is not None:
        self._m_steps.inc()
        if items:
          self._m_items.inc(items)
        self._m_step_ms.observe(dt * 1e3)
      if self._rec is not None:
        self._rec.record_span("train.step", mono0, dt, items=items)

  def summary(self) -> dict:
    d = sorted(self._durations)
    if not d:
      return {"steps": 0}
    total = sum(self._durations)
    out = {
        "steps": len(d),
        "mean_ms": 1e3 * total / len(d),
        "p50_ms": 1e3 * d[len(d) // 2],
        "p90_ms": 1e3 * d[min(len(d) - 1, int(len(d) * 0.9))],
    }
    if any(self._items):
      out["items_per_sec"] = sum(self._items) / total
    return out


# --- MFU accounting ----------------------------------------------------------

#: dense bf16 peak FLOP/s per card (public spec sheet: H100 SXM5)
PEAK_BF16_FLOPS = {"h100": 989e12}


def resolve_chip_generation(hint: str = "") -> Optional[str]:
  """Map a card name (``torch.cuda.get_device_name``) to a
  ``PEAK_BF16_FLOPS`` key; an empty hint reads the current card's name
  when CUDA is already initialised. None when unknown."""
  text = (hint or "").lower()
  if not text:
    text = _current_card_name().lower()
  for g in sorted(PEAK_BF16_FLOPS, key=len, reverse=True):
    if g in text:
      return g
  return None


def _current_card_name() -> str:
  try:
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
      return torch.cuda.get_device_name()
  except Exception:  # noqa: BLE001 - a name lookup is best-effort
    pass
  return ""


def transformer_flops_per_token(n_params: int, num_layers: int,
                                d_model: int, seq_len: int) -> float:
  """Training FLOPs/token, PaLM-style accounting: ``6N`` for the fwd+bwd
  matmuls plus the attention term ``12·L·d_model·S``."""
  return 6.0 * n_params + 12.0 * num_layers * d_model * seq_len


def mfu(flops_per_item: float, items_per_sec: float,
        peak_flops: float) -> float:
  """Model FLOPs utilization against one card's peak."""
  return flops_per_item * items_per_sec / peak_flops


def device_memory_stats() -> dict:
  """Per-card memory stats (bytes) of the cards this process has
  initialised: ``{index: {"bytes_in_use", "peak_bytes_in_use",
  "bytes_limit"}}`` — the caching allocator's current and peak allocated
  bytes (``allocated_bytes.all.current`` / ``.peak``) and the card's
  total memory (``torch.cuda.mem_get_info``). ``{}`` when CUDA is not
  initialised: this never creates a context."""
  import sys
  torch = sys.modules.get("torch")
  if torch is None or not torch.cuda.is_initialized():
    return {}
  out = {}
  for i in range(torch.cuda.device_count()):
    stats = torch.cuda.memory_stats(i)
    if not stats.get("allocated_bytes.all.peak", 0):
      # nothing allocated on this card yet: no context to ask either
      continue
    out[str(i)] = {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
    }
  return out
