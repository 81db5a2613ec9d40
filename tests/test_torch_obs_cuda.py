"""The obs plane's device tier on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside a
fixture). The file imports only PyTorch and the port, so it runs on the
card's machine: ``python -m pytest tests/test_torch_obs_cuda.py -m cuda``.

- ``device_memory_stats`` reads the caching allocator's current and peak
  bytes and the card's size, and the memory sampler's gauges follow them;
- ``StepTimer`` with the caller's synchronise times real card work;
- ``trace`` records the card's kernels;
- a train step and a serving dispatch with the plane on launch exactly
  the kernels, and give exactly the bits, of the plane off.
"""

import os

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import ops, optim
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.obs import device as obs_device
from tensorflowonspark_tpu_torch.obs import metrics, profiler, spans
from tensorflowonspark_tpu_torch.parallel import sharding
from tensorflowonspark_tpu_torch.serving import ServingEngine, slots
from tensorflowonspark_tpu_torch.utils.params import init_params

CFG = dict(vocab_size=256, num_layers=2, num_heads=4, d_model=128,
           d_ff=256, max_seq_len=256)


@pytest.fixture()
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the device tier reads the card")
  yield torch.device("cuda")
  metrics.deactivate()
  spans.deactivate()
  obs_device.reset_trace_cache()
  obs_device.reset_cost_cache()


@pytest.mark.cuda
def test_memory_stats_and_sampler_follow_the_allocator(card):
  x = torch.empty(64 << 20, dtype=torch.uint8, device=card)
  stats = profiler.device_memory_stats()["0"]
  assert stats["bytes_in_use"] == torch.cuda.memory_allocated()
  assert stats["peak_bytes_in_use"] == torch.cuda.max_memory_allocated()
  assert stats["bytes_limit"] == torch.cuda.mem_get_info()[1] == \
      torch.cuda.get_device_properties(0).total_memory
  reg = metrics.MetricsRegistry()
  sample = obs_device.make_memory_sampler(reg)
  sample()
  snap = reg.snapshot()
  assert snap["device.bytes_in_use"]["value"] == torch.cuda.memory_allocated()
  assert snap["device.peak_bytes"]["value"] == \
      torch.cuda.max_memory_allocated()
  assert snap["device.bytes_in_use"]["value"] >= x.numel()


@pytest.mark.cuda
def test_step_timer_times_synchronised_card_work(card):
  reg = metrics.activate()
  a = torch.randn(2048, 2048, device=card)
  t = profiler.StepTimer(warmup=1)
  for _ in range(4):
    with t.step(items=1):
      (a @ a).sum().item()
  assert t.summary()["steps"] == 3 and t.summary()["mean_ms"] > 0
  assert reg.snapshot()["train.step_ms"]["count"] == 3


@pytest.mark.cuda
def test_trace_records_the_cards_kernels(card, tmp_path):
  a = torch.randn(512, 512, device=card)
  with profiler.trace(str(tmp_path)):
    with profiler.annotate("obs.cuda.region"):
      (a @ a).sum().item()
  text = "".join(open(os.path.join(d, f)).read()
                 for d, _, fs in os.walk(tmp_path) for f in fs)
  assert "obs.cuda.region" in text and '"cat": "kernel"' in text


def _train(card, obs):
  if obs:
    metrics.activate()
    spans.activate()
  cfg = tfm.TransformerConfig(**CFG)
  state = tfm.create_state(cfg, init_params(cfg, seed=3),
                           tx=optim.make_optimizer(1e-3), device=card)
  loop = sharding.make_train_loop(
      lambda m, t: tfm.causal_lm_loss(m(t), t), unroll=1)
  rng = np.random.default_rng(4)
  ops.reset_launches()
  losses = []
  for _ in range(3):
    state, got = loop(state, rng.integers(0, 256, (2, 128)).astype(np.int32))
    losses.append(got.cpu())
  launches = dict(ops.LAUNCHES)
  snap = metrics.active().snapshot() if obs else None
  metrics.deactivate()
  spans.deactivate()
  return torch.cat(losses), launches, snap


@pytest.mark.cuda
def test_train_seams_launch_nothing_and_change_no_bit(card):
  off, off_launches, _ = _train(card, obs=False)
  on, on_launches, snap = _train(card, obs=True)
  assert torch.equal(on, off)
  assert on_launches == off_launches and on_launches["layer_norm"] > 0
  assert snap["train.steps"]["value"] == 3
  assert snap["xla.compiles.train.step"]["value"] == 1


@pytest.mark.cuda
def test_serving_seams_launch_nothing_and_change_no_bit(card):
  cfg = tfm.TransformerConfig(**CFG)
  params = init_params(cfg, seed=5)
  rng = np.random.default_rng(6)
  prompts = [rng.integers(1, 256, n) for n in (17, 40, 100)]
  got = {}
  for obs in (False, True):
    if obs:
      metrics.activate()
      spans.activate()
    eng = ServingEngine(params, cfg, num_slots=2, horizon=4).start()
    ops.reset_launches()
    try:
      outs = eng.generate(prompts, max_new_tokens=6, timeout=300)
    finally:
      eng.stop()
    got[obs] = ([o.tolist() for o in outs], dict(ops.LAUNCHES),
                eng.stats["steps"])
    if obs:
      snap = metrics.active().snapshot()
      metrics.deactivate()
      spans.deactivate()
  assert got[True][0] == got[False][0]
  # the same kernels a forward, on or off: 12 flash per fresh prefill,
  # 2L+1 LayerNorms a chunk or decode step (dispatch counts may differ)
  chunks = sum(len(slots.chunk_plan(len(p))) for p in prompts)
  for _, launches, steps in got.values():
    assert launches["flash_attention_fwd"] == cfg.num_layers * len(prompts)
    assert launches["layer_norm"] == (2 * cfg.num_layers + 1) * (
        chunks + steps)
  assert snap["serve.completed"]["value"] == len(prompts)
  assert snap["serve.tokens"]["value"] == len(prompts) * 5
