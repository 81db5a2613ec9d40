"""The obs seams of the port's train step, fused loop, serving engine and
slot decoder, held against the JAX package's on the same inputs (CPU, no
executors).

- training: the same per-step batches and slab through both packages'
  ``make_train_loop`` with a live registry give the same ``train.steps``,
  ``train.unroll``, ``xla.compiles.train.step`` / ``.loop`` and
  ``train.slab`` spans; the port's cost gauges hold its stated analytic
  count (``sharding.step_cost``);
- serving: the same prompts through both packages' ``ServingEngine`` give
  the same ``serve.submitted`` / ``prefills`` / ``completed`` /
  ``tokens``, one ``serve.decode`` span and one ``serve.decode_ms``
  observation per dispatch, per-lane ``serve.decode.slot`` tokens that
  add up to ``serve.tokens``, one ``serve.prefill.chunk`` span per bucket
  chunk, full latency sketches, and outputs equal to an obs-off engine's;
- a crash mid-decode leaves ``serve.replay`` / ``serve.restart`` events;
- with the plane off no seam holds a handle.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu.obs import metrics as jax_metrics
from tensorflowonspark_tpu.obs import spans as jax_spans
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu.parallel import sharding as jax_sharding
from tensorflowonspark_tpu.serving import ServingEngine as JaxEngine
from tensorflowonspark_tpu_torch import optim
from tensorflowonspark_tpu_torch.data.readers import Slab
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.obs import device as port_device
from tensorflowonspark_tpu_torch.obs import metrics as port_metrics
from tensorflowonspark_tpu_torch.obs import profiler as port_profiler
from tensorflowonspark_tpu_torch.obs import spans as port_spans
from tensorflowonspark_tpu_torch.parallel import sharding
from tensorflowonspark_tpu_torch.serving import ServingEngine, slots
from tensorflowonspark_tpu_torch.utils.params import params_from_flax

CFG = dict(vocab_size=64, num_layers=1, num_heads=4, num_kv_heads=2,
           d_model=32, d_ff=64, max_seq_len=64)
OPT = dict(learning_rate=1e-2, clip_norm=1.0)
LENGTHS = (8, 16, 24)
BUDGET = 6
PAD = 0


@pytest.fixture(autouse=True)
def clean_active():
  yield
  for mod in (jax_metrics, jax_spans, port_metrics, port_spans):
    mod.deactivate()
  port_device.reset_trace_cache()
  port_device.reset_cost_cache()


@pytest.fixture(scope="module")
def pair():
  # the reference's plain attention and LayerNorm: the seams count the
  # same either way, and interpret-mode kernels would only cost time
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False,
                                   attention_impl="dense",
                                   layer_norm_impl="flax", **CFG)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, **CFG)
  state = jax_tfm.create_state(jax.random.PRNGKey(2), jcfg, seq_len=16,
                               tx=jax_optim.make_optimizer(**OPT))
  params = params_from_flax(jax.tree.map(np.asarray, state.params), tcfg)
  return jcfg, tcfg, state, params


def _obs_on(mods):
  metrics, spans = mods
  return metrics.activate(), spans.activate()


# -- training -------------------------------------------------------------------

def _batches():
  rng = np.random.default_rng(3)
  return [rng.integers(0, 64, size=(2, 16)).astype(np.int32)
          for _ in range(4)]


def _lm_loss(model, tokens):
  return tfm.causal_lm_loss(model(tokens), tokens)


TRAIN_KEYS = ("train.steps", "train.unroll", "xla.compiles.train.step",
              "xla.compiles.train.loop")


def test_train_loop_seams_match_the_reference(pair):
  jcfg, tcfg, jstate, params = pair
  b = _batches()
  mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(data=1),
                             devices=jax.devices()[:1])

  def jloss(p, tokens):
    return jax_tfm.causal_lm_loss(jstate.apply_fn({"params": p}, tokens),
                                  tokens)

  reg, rec = _obs_on((jax_metrics, jax_spans))
  jloop = jax_sharding.make_train_loop(jloss, mesh, donate_state=False,
                                       unroll=2)
  from tensorflowonspark_tpu.data.readers import Slab as JaxSlab
  jstate, _ = jloop(jstate, jnp.asarray(b[0]))
  jstate, _ = jloop(jstate, jnp.asarray(b[1]))
  jstate, _ = jloop(jstate, JaxSlab(jnp.asarray(np.stack(b[2:]))))
  want = {k: reg.snapshot()[k]["value"] for k in TRAIN_KEYS}
  want_spans = [(s["name"], s["attrs"]) for s in rec.drain(None)
                if s["name"] == "train.slab"]

  reg, rec = _obs_on((port_metrics, port_spans))
  state = tfm.create_state(tcfg, params, tx=optim.make_optimizer(**OPT),
                           device="cpu")
  loop = sharding.make_train_loop(_lm_loss, unroll=2)
  state, _ = loop(state, b[0])
  state, _ = loop(state, b[1])
  state, _ = loop(state, Slab(np.stack(b[2:])))
  snap = reg.snapshot()
  assert {k: snap[k]["value"] for k in TRAIN_KEYS} == want == {
      "train.steps": 4, "train.unroll": 2, "xla.compiles.train.step": 1,
      "xla.compiles.train.loop": 1}
  assert [(s["name"], s["attrs"]) for s in rec.drain(None)
          if s["name"] == "train.slab"] == want_spans
  # the cost gauges hold the stated analytic count
  n = sum(p.numel() for p in state.params.values())
  flops = port_profiler.transformer_flops_per_token(
      n, CFG["num_layers"], CFG["d_model"], 16) * 2 * 16
  assert snap["xla.cost.train.step.flops"]["value"] == flops
  assert snap["xla.cost.train.loop.flops"]["value"] == 2 * flops
  cost = sharding.step_cost(state, b[0])
  assert snap["xla.cost.train.step.bytes"]["value"] == cost["bytes"] > 0


def test_plane_off_train_seams_hold_nothing(pair):
  _, tcfg, _, params = pair
  loop = sharding.make_train_loop(_lm_loss, unroll=2)
  assert loop._obs is None
  state = tfm.create_state(tcfg, params, tx=optim.make_optimizer(**OPT),
                           device="cpu")
  loop(state, _batches()[0])
  assert port_metrics.active() is None and port_spans.active() is None


# -- serving --------------------------------------------------------------------

def _prompts():
  rng = np.random.default_rng(9)
  return [rng.integers(1, 64, size=n) for n in LENGTHS]


def _serve(engine):
  engine.start()
  try:
    outs = engine.generate(_prompts(), max_new_tokens=BUDGET, timeout=300)
  finally:
    engine.stop()
  return [np.asarray(o) for o in outs]


SERVE_KEYS = ("serve.submitted", "serve.prefills", "serve.completed",
              "serve.tokens", "serve.rejected", "serve.expired",
              "serve.cancelled", "serve.replays", "serve.engine_restarts",
              "serve.poisoned", "serve.prefix_hits", "serve.spec_accepted")


def test_engine_seams_match_the_reference(pair):
  jcfg, tcfg, jstate, params = pair
  jparams = jax.tree.map(np.asarray, jstate.params)
  jreg, _ = _obs_on((jax_metrics, jax_spans))
  jouts = _serve(JaxEngine(jparams, jcfg, num_slots=2, horizon=4,
                           pad_id=PAD))
  jsnap = jreg.snapshot()

  off = _serve(ServingEngine(params, tcfg, num_slots=2, horizon=4,
                             pad_id=PAD, device="cpu"))
  reg, rec = _obs_on((port_metrics, port_spans))
  eng = ServingEngine(params, tcfg, num_slots=2, horizon=4, pad_id=PAD,
                      device="cpu")
  outs = _serve(eng)
  snap = reg.snapshot()
  records = rec.drain(None)

  for a, b, c in zip(outs, off, jouts):
    np.testing.assert_array_equal(a, b)            # obs on = obs off
    np.testing.assert_array_equal(a, c)
  got = {k: snap[k]["value"] for k in SERVE_KEYS}
  assert got == {k: jsnap[k]["value"] for k in SERVE_KEYS}
  assert got["serve.completed"] == len(LENGTHS)
  # serve.tokens: the tokens decode dispatches emitted (prefill's first
  # token of each request excluded, as in the reference)
  assert got["serve.tokens"] == len(LENGTHS) * (BUDGET - 1)
  for name in ("serve.ttft_ms", "serve.tpot_ms", "serve.e2e_ms",
               "serve.queue_wait_ms"):
    assert snap[name]["count"] == jsnap[name]["count"] == len(LENGTHS)
  # one decode span and one histogram observation per dispatch
  decodes = [r for r in records if r["name"] == "serve.decode"]
  assert len(decodes) == snap["serve.decode_ms"]["count"] == \
      snap["serve.steps"]["value"] / 4 == eng.stats["steps"] / 4
  assert all(type(r["attrs"]["active"]) is int for r in decodes)
  lanes = [r for r in records if r["name"] == "serve.decode.slot"]
  assert sum(r["attrs"]["tokens"] for r in lanes) == got["serve.tokens"]
  chunks = [r for r in records if r["name"] == "serve.prefill.chunk"]
  assert len(chunks) == sum(len(slots.chunk_plan(n)) for n in LENGTHS)
  for name in ("serve.queue", "serve.prefill"):
    assert len([r for r in records if r["name"] == name]) == len(LENGTHS)
  traces = {r.get("trace") for r in records if r["name"] == "serve.prefill"}
  assert len(traces) == len(LENGTHS) and None not in traces
  # the recompile sentinel: one count per chunk length, one insert, one
  # horizon
  assert snap["xla.compiles.serve.prefill"]["value"] == len(
      {c for n in LENGTHS for c in slots.chunk_plan(n)})
  assert snap["xla.compiles.serve.insert"]["value"] == 1
  assert snap["xla.compiles.serve.step_many"]["value"] == 1
  assert snap["serve.kv_pages_free"]["value"] == 0


STACK_KEYS = ("serve.prefills", "serve.completed", "serve.tokens",
              "serve.prefix_hits", "serve.prefix_evictions",
              "serve.spec_accepted", "serve.spec_rejected",
              "serve.kv_pages_in_use", "serve.kv_pages_free",
              "xla.compiles.serve.insert_pages",
              "xla.compiles.serve.gather_pages",
              "xla.compiles.serve.reset_slots",
              "xla.compiles.serve.step_spec")


def test_decode_stack_seams_match_the_reference(pair):
  """A paged engine with the prefix cache and speculation: the prefix,
  spec and page metrics and the recompile sentinels of the paged slab
  operations equal the JAX engine's for the same requests."""
  jcfg, tcfg, jstate, params = pair
  jparams = jax.tree.map(np.asarray, jstate.params)
  rng = np.random.default_rng(12)
  prefix = rng.integers(1, 64, size=16)
  prompts = [np.concatenate([prefix, rng.integers(1, 64, size=n)])
             for n in (3, 6, 2, 5)]
  opts = dict(num_slots=2, horizon=4, pad_id=PAD, page_size=4,
              prefix_pages=6, spec_depth=2)
  snaps, outs = [], []
  for mods, make in (
      ((jax_metrics, jax_spans), lambda: JaxEngine(jparams, jcfg, **opts)),
      ((port_metrics, port_spans),
       lambda: ServingEngine(params, tcfg, device="cpu", **opts))):
    reg, _ = _obs_on(mods)
    eng = make().start()
    try:
      outs.append([np.asarray(o) for o in eng.generate(
          prompts, max_new_tokens=BUDGET, timeout=300)])
    finally:
      eng.stop()
    snap = reg.snapshot()
    snaps.append({k: snap[k]["value"] for k in STACK_KEYS})
    for mod in mods:
      mod.deactivate()
  for a, b in zip(*outs):
    np.testing.assert_array_equal(a, b)
  assert snaps[1] == snaps[0]
  assert snaps[1]["serve.prefix_hits"] >= len(prompts) - 1
  assert snaps[1]["serve.spec_accepted"] + \
      snaps[1]["serve.spec_rejected"] > 0
  assert snaps[1]["serve.kv_pages_in_use"] > 0


def test_stream_span_and_trace_detail_off(pair, monkeypatch):
  _, tcfg, _, params = pair
  monkeypatch.setenv("TOS_OBS_TRACE_DETAIL", "0")
  _, rec = _obs_on((port_metrics, port_spans))
  eng = ServingEngine(params, tcfg, num_slots=2, horizon=4, pad_id=PAD,
                      device="cpu").start()
  try:
    rid = eng.submit(_prompts()[1], max_new_tokens=BUDGET)
    toks = list(eng.stream(rid, timeout=120))
  finally:
    eng.stop()
  names = [r["name"] for r in rec.drain(None)]
  assert names.count("serve.stream") == 1 and len(toks) == BUDGET
  assert "serve.decode" in names and "serve.prefill" in names
  assert "serve.decode.slot" not in names
  assert "serve.prefill.chunk" not in names


def test_crash_replay_lands_on_the_timeline(pair):
  _, tcfg, _, params = pair
  reg, rec = _obs_on((port_metrics, port_spans))
  eng = ServingEngine(params, tcfg, num_slots=2, horizon=4, pad_id=PAD,
                      device="cpu", restart_backoff=0.0)
  real = eng.decoder.step_many
  calls = {"n": 0}

  def flaky(*a, **kw):
    calls["n"] += 1
    if calls["n"] == 2:
      raise RuntimeError("injected decode failure")
    return real(*a, **kw)

  eng.decoder.step_many = flaky
  _serve(eng)
  snap = reg.snapshot()
  names = [r["name"] for r in rec.drain(None)]
  assert snap["serve.engine_restarts"]["value"] == 1
  assert names.count("serve.restart") == 1
  assert names.count("serve.replay") == snap["serve.replays"]["value"] >= 1


def test_plane_off_engine_holds_no_handles(pair):
  _, tcfg, _, params = pair
  eng = ServingEngine(params, tcfg, num_slots=2, pad_id=PAD, device="cpu")
  assert eng._obs_m is None and eng._obs_q is None and eng._rec is None
  assert eng.decoder._obs is False


def test_kv_generate_counts_once_per_shape(pair):
  _, tcfg, _, params = pair
  reg = port_metrics.activate()
  model = tfm.Transformer(tcfg, params, device="cpu")
  for n in (5, 5, 7):
    tfm.greedy_generate_kv(model, np.arange(1, n + 1)[None], 3)
  assert reg.snapshot()["xla.compiles.transformer.kv_generate"]["value"] == 2
