"""The PyTorch port's ServingEngine on the CPU, held against both packages'
single-request ``greedy_generate_kv``, and against the JAX engine under the
same ``TOS_CHAOS_SERVE`` faults."""

import os
import time
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.serving import (DeadlineExceeded,
                                                 RequestCancelled,
                                                 ServingEngine,
                                                 ServingOverloaded, slots)
from tensorflowonspark_tpu_torch.utils.params import params_from_flax

PAD = 0
BUDGET = 8
LENGTHS = (1, 7, 16, 33, 40)
SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             d_model=32, d_ff=64, max_seq_len=64)


def _truncate(out, plen, eos_id):
  gen = out[plen:]
  stops = np.where(gen == eos_id)[0]
  stop = (int(stops[0]) + 1) if len(stops) else len(gen)
  return out[:plen + stop]


@pytest.fixture(scope="module")
def setup():
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False,
                                   attention_impl="flash",
                                   layer_norm_impl="fused", **SMALL)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, **SMALL)
  state = jax_tfm.create_state(jax.random.PRNGKey(1), jcfg, seq_len=16)
  jparams = jax.tree.map(np.asarray, state.params)
  params = params_from_flax(jparams, tcfg)
  model = tfm.Transformer(tcfg, params, device="cpu")
  rng = np.random.default_rng(5)
  prompts = [rng.integers(1, 64, size=n) for n in LENGTHS]
  # EOS = a token the second prompt really emits, so one request stops
  # early on it and the others run to their budget or stop on it too
  probe = tfm.greedy_generate_kv(model, prompts[1][None], BUDGET).numpy()[0]
  eos = int(probe[len(prompts[1]) + 2])
  assert eos != PAD
  jax_refs, port_refs = [], []
  for p in prompts:
    j = np.asarray(jax_tfm.greedy_generate_kv(
        jparams, jcfg, jnp.asarray(p, jnp.int32)[None], BUDGET,
        eos_id=eos, pad_id=PAD))[0]
    t = tfm.greedy_generate_kv(model, p[None], BUDGET, eos_id=eos,
                               pad_id=PAD).numpy()[0]
    jax_refs.append(_truncate(j, len(p), eos))
    port_refs.append(_truncate(t, len(p), eos))
  return tcfg, params, prompts, eos, jax_refs, port_refs


def _engine(setup, **kw):
  tcfg, params, _, eos = setup[:4]
  return ServingEngine(params, tcfg, num_slots=2, horizon=4, eos_id=eos,
                       pad_id=PAD, device="cpu", **kw)


def test_engine_outputs_equal_both_greedy_decodes(setup):
  _, _, prompts, eos, jax_refs, port_refs = setup
  eng = _engine(setup).start()
  try:
    outs = eng.generate(prompts, max_new_tokens=BUDGET, timeout=120)
  finally:
    eng.stop()
  assert any(len(o) < len(p) + BUDGET for o, p in zip(outs, prompts)), \
      "no request stopped on EOS"
  for out, jref, pref in zip(outs, jax_refs, port_refs):
    np.testing.assert_array_equal(out, jref)
    np.testing.assert_array_equal(out, pref)
  assert eng.stats["completed"] == len(prompts)
  assert eng.stats["replay_mismatches"] == 0


def test_crash_replays_in_flight_requests_bit_identically(setup):
  _, _, prompts, _, _, port_refs = setup
  eng = _engine(setup, restart_backoff=0.0)
  real = eng.decoder.step_many
  calls = {"n": 0}

  def flaky(*a, **kw):
    calls["n"] += 1
    if calls["n"] == 2:
      raise RuntimeError("injected decode failure")
    return real(*a, **kw)

  eng.decoder.step_many = flaky
  eng.start()
  try:
    outs = eng.generate(prompts, max_new_tokens=BUDGET, timeout=120)
  finally:
    eng.stop()
  for out, ref in zip(outs, port_refs):
    np.testing.assert_array_equal(out, ref)
  assert eng.stats["engine_restarts"] == 1
  assert eng.stats["replays"] >= 1
  assert eng.stats["replay_mismatches"] == 0


def test_cancel_frees_the_request(setup):
  _, _, prompts, _, _, port_refs = setup
  eng = _engine(setup, max_new_tokens=BUDGET).start()
  try:
    long_rid = eng.submit(prompts[4], max_new_tokens=20)
    assert eng.cancel(long_rid, timeout=60)
    with pytest.raises(RequestCancelled):
      eng.result(long_rid, timeout=5)
    rid = eng.submit(prompts[2])
    np.testing.assert_array_equal(eng.result(rid, timeout=60), port_refs[2])
  finally:
    eng.stop()
  assert eng.stats["cancelled"] == 1


def test_drain_finishes_accepted_work_then_refuses(setup):
  _, _, prompts, _, _, port_refs = setup
  eng = _engine(setup, max_new_tokens=BUDGET).start()
  rids = [eng.submit(p) for p in prompts[:3]]
  handles = [eng.request(r) for r in rids]
  assert eng.drain(timeout=120) is True
  assert not eng.alive
  for h, ref in zip(handles, port_refs[:3]):
    assert h.done.is_set() and h.error is None
    np.testing.assert_array_equal(h.output(), ref)
  with pytest.raises(ServingOverloaded) as ei:
    eng.submit(prompts[0])
  assert ei.value.draining


@pytest.mark.parametrize("kw", [dict(page_size=16),
                                dict(prefix_pages=4, page_size=16),
                                dict(spec_depth=2)],
                         ids=lambda kw: next(iter(kw)))
def test_unported_engine_options_raise(setup, kw):
  """The decode-speed options the port once refused: each engine builds
  and serves a request equal to both packages' greedy decodes (a prefix
  cache without paging is refused as the reference refuses it)."""
  _, _, prompts, _, jax_refs, port_refs = setup
  if "prefix_pages" in kw:
    with pytest.raises(ValueError, match="TOS_SERVE_PAGE_SIZE"):
      _engine(setup, prefix_pages=4)
  eng = _engine(setup, **kw).start()
  try:
    out = eng.result(eng.submit(prompts[2], max_new_tokens=BUDGET),
                     timeout=60)
  finally:
    eng.stop()
  np.testing.assert_array_equal(out, port_refs[2])
  np.testing.assert_array_equal(out, jax_refs[2])


def test_stream_yields_each_generated_token_once(setup):
  _, _, prompts, _, _, port_refs = setup
  eng = _engine(setup, max_new_tokens=BUDGET).start()
  try:
    rid = eng.submit(prompts[3])
    streamed = list(eng.stream(rid, timeout=60))
  finally:
    eng.stop()
  np.testing.assert_array_equal(streamed, port_refs[3][len(prompts[3]):])


def test_bounded_admission_rejects_with_structure(setup):
  _, _, prompts, _, _, _ = setup
  eng = _engine(setup, max_queue=1)            # not started: work queues
  eng.submit(prompts[0], max_new_tokens=2)
  with pytest.raises(ServingOverloaded) as ei:
    eng.submit(prompts[1], max_new_tokens=2)
  assert ei.value.queue_depth == 1 and not ei.value.draining
  assert ei.value.retry_after > 0
  assert eng.stats["rejected"] == 1
  eng.stop()


def test_step_equals_a_one_step_horizon(setup):
  tcfg, params, prompts, _, _, _ = setup
  model = tfm.Transformer(tcfg, params, device="cpu")
  dec = slots.SlotDecoder(model, 3)
  rows = [dec.prefill(p) for p in prompts[1:3]]
  slabs = [dec.init_slabs(), dec.init_slabs()]
  for slab in slabs:
    for i, (row, _) in enumerate(rows):
      dec.insert(slab, row, i)
  last = [rows[0][1], rows[1][1], PAD]
  active = [True, True, False]
  one = dec.step(slabs[0], last, active)
  many, still, _ = dec.step_many(slabs[1], last, active, [5, 5, 0], 1)
  np.testing.assert_array_equal(one.numpy(), many[0].numpy())
  assert one[2] == PAD and still.tolist() == [True, True, False]
  lengths = [len(prompts[1]) + 1, len(prompts[2]) + 1, 0]
  assert slabs[0].index.tolist() == lengths == slabs[1].index.tolist()


def test_deadlines_fail_requests_without_a_slot(setup):
  _, _, prompts, _, _, _ = setup
  eng = _engine(setup, max_new_tokens=BUDGET)
  with pytest.raises(DeadlineExceeded, match="dead on arrival"):
    eng.submit(prompts[0], ttl=0.0)
  rid = eng.submit(prompts[1], ttl=0.05)       # expires while queued
  time.sleep(0.1)
  eng.start()
  try:
    with pytest.raises(DeadlineExceeded):
      eng.result(rid, timeout=30)
  finally:
    eng.stop()
  assert eng.stats["expired"] == 2 and eng.stats["prefills"] == 0


# -- the TOS_CHAOS_SERVE recovery cases and the fleet surface, against the
# -- JAX engine (``tests/test_serving.py`` TestServingChaos)

REF_EOS = 7
TINY = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_seq_len=48)


@pytest.fixture(scope="module")
def pair():
  """Both packages' engines on the reference tests' tiny config and one
  seeded JAX state; the JAX engines of one slot count share one
  ``SlotDecoder`` (its jit caches; it holds no request state)."""
  from tensorflowonspark_tpu.serving import ServingEngine as JaxEngine
  from tensorflowonspark_tpu.serving import scheduler as jax_sched
  from tensorflowonspark_tpu.utils import chaos as jax_chaos
  from tensorflowonspark_tpu_torch.serving import scheduler as port_sched
  from tensorflowonspark_tpu_torch.utils import chaos as port_chaos
  jcfg = jax_tfm.TransformerConfig(remat=False, dtype=jnp.float32, **TINY)
  state = jax_tfm.create_state(jax.random.PRNGKey(0), jcfg, seq_len=16)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, **TINY)
  tparams = params_from_flax(jax.tree.map(np.asarray, state.params), tcfg)
  decoders = {}

  def jax_engine(**kw):
    eng = JaxEngine(state.params, jcfg, pad_id=PAD, **kw)
    eng.decoder = decoders.setdefault((eng.num_slots, eng.eos_id),
                                      eng.decoder)
    return eng

  def port_engine(**kw):
    return ServingEngine(tparams, tcfg, pad_id=PAD, device="cpu", **kw)

  return (types.SimpleNamespace(name="jax", engine=jax_engine,
                                sched=jax_sched, chaos=jax_chaos),
          types.SimpleNamespace(name="torch", engine=port_engine,
                                sched=port_sched, chaos=port_chaos))


def _prompts_of(seed, lengths):
  rng = np.random.RandomState(seed)
  return [rng.randint(1, 64, (n,)).astype(np.int32) for n in lengths]


def decode_crash_replays(ns):
  prompts = _prompts_of(21, (4, 7, 5, 9, 6, 8))
  with ns.engine(num_slots=2, eos_id=REF_EOS, horizon=4, poison_crashes=3,
                 restart_backoff=0.01) as eng:
    outs = eng.generate(prompts, max_new_tokens=8, timeout=120,
                        detailed=True)
    assert eng.alive
    log = list(eng.restart_log)
  assert eng.stats["replays"] >= 1
  assert len(log) == 1 and log[0]["duration_s"] >= 0.01
  replayed = [o for o in outs if o["timing"]["replays"]]
  assert replayed                  # the crash hit someone in flight
  for o in replayed:
    # the first token predates the recovery: replay did not reset it
    assert o["timing"]["first_token"] <= log[0]["t"]
  return {"outs": [o["tokens"].tolist() for o in outs],
          "stats": {k: eng.stats[k] for k in (
              "engine_restarts", "replay_mismatches", "poisoned",
              "completed")}}


def stream_deduplicated_across_crash(ns):
  p = np.asarray([3, 9, 4, 1], np.int32)
  with ns.engine(num_slots=1, eos_id=REF_EOS, horizon=1, poison_crashes=3,
                 restart_backoff=0.01) as eng:
    toks = list(eng.stream(eng.submit(p, max_new_tokens=10), timeout=120))
  return {"stream": [int(t) for t in toks],
          "stats": {k: eng.stats[k] for k in ("engine_restarts", "replays")}}


def prefill_poison_isolated(ns):
  good_a, poison, good_b = _prompts_of(31, (5, 13, 8))
  with ns.engine(num_slots=2, eos_id=REF_EOS, horizon=4, poison_crashes=2,
                 restart_backoff=0.01) as eng:
    rid_a = eng.submit(good_a, max_new_tokens=6)
    rid_p = eng.submit(poison, max_new_tokens=6)
    rid_b = eng.submit(good_b, max_new_tokens=6)
    out_a = eng.result(rid_a, timeout=120)
    out_b = eng.result(rid_b, timeout=120)
    with pytest.raises(ns.sched.PoisonedRequest,
                       match="consecutive engine crashes"):
      eng.result(rid_p, timeout=120)
    assert eng.alive                      # healed, not dead
  return {"outs": [out_a.tolist(), out_b.tolist()],
          "stats": {k: eng.stats[k] for k in (
              "engine_restarts", "poisoned", "replay_mismatches")}}


def stall_blows_deadline(ns):
  victim, healthy = _prompts_of(41, (6, 4))
  with ns.engine(num_slots=1, eos_id=None, horizon=2,
                 poll_interval=0.01) as eng:
    eng.generate([victim, healthy], max_new_tokens=2, timeout=120)  # warm
    os.environ[ns.chaos.ENV_SERVE] = "decode#1:stall:0.5"
    ns.chaos.reset()
    try:
      rid_v = eng.submit(victim, max_new_tokens=40, ttl=0.2)
      with pytest.raises(ns.sched.DeadlineExceeded):
        eng.result(rid_v, timeout=60)
    finally:
      del os.environ[ns.chaos.ENV_SERVE]
      ns.chaos.reset()
    out_h = eng.result(eng.submit(healthy, max_new_tokens=4), timeout=60)
  return {"out": out_h.tolist(), "expired": eng.stats["expired"]}


def terminal_death_fails_fast(ns):
  p = np.asarray([2, 3, 4], np.int32)
  eng = ns.engine(num_slots=1, eos_id=REF_EOS, horizon=4,
                  max_restarts=0).start()
  try:
    rid = eng.submit(p, max_new_tokens=8)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="request %d failed" % rid):
      eng.result(rid, timeout=600)
    assert time.monotonic() - t0 < 30.0   # not the 600 s timeout
    alive = eng.alive
    with pytest.raises(RuntimeError, match="serving loop died") as ei:
      eng.submit(p, max_new_tokens=2)
    assert isinstance(ei.value.__cause__, ns.chaos.InjectedFault)
  finally:
    eng.stop()
  return {"alive": alive, "cause": str(ei.value.__cause__)}


SERVE_CHAOS = {f.__name__: (f, spec) for f, spec in (
    (decode_crash_replays, "decode#2:raise"),
    (stream_deduplicated_across_crash, "decode#2:raise"),
    (prefill_poison_isolated, "prefill@13#1:raise,prefill@13#2:raise"),
    (stall_blows_deadline, None),
    (terminal_death_fails_fast, "decode#1:raise"))}


@pytest.mark.chaos
@pytest.mark.parametrize("case", sorted(SERVE_CHAOS))
def test_serve_chaos_recovery_equals_the_reference(pair, monkeypatch, case):
  """``tests/test_serving.py``'s TOS_CHAOS_SERVE recovery cases through
  both engines under the same spec: each package meets the reference
  test's invariants, and the port's outputs and recovery counts equal the
  JAX engine's."""
  fn, spec = SERVE_CHAOS[case]
  for name in list(os.environ):
    if name.startswith("TOS_CHAOS_"):
      monkeypatch.delenv(name)
  if spec is not None:
    monkeypatch.setenv("TOS_CHAOS_SERVE", spec)
  records = {}
  for ns in pair:
    for other in pair:
      other.chaos.reset()
    records[ns.name] = fn(ns)
  for ns in pair:
    ns.chaos.reset()
  assert records["torch"] == records["jax"]


def _load(eng):
  return [eng.queue_depth, eng.queued_tokens, eng.slots_in_use,
          eng.occupancy_now]


def test_fleet_surface_reads_as_the_reference(pair):
  """The load properties, ``poll``, ``stats_snapshot`` and ``kill`` read
  the same on both engines at the same states."""
  prompts = _prompts_of(7, (3, 6, 9))
  records = {}
  for ns in pair:
    rec = records[ns.name] = {}
    eng = ns.engine(num_slots=2, eos_id=REF_EOS, horizon=2)
    rec["fresh"] = _load(eng) + [eng.tokens_per_sec]
    rids = [eng.submit(p, max_new_tokens=5) for p in prompts]
    rec["queued"] = _load(eng)
    snap = eng.stats_snapshot()
    eng.start()
    try:
      handles = [eng.request(r) for r in rids]
      for h in handles:
        assert h.done.wait(timeout=120)
      rec["polled"] = [eng.poll(r).tolist() for r in rids]
      with pytest.raises(KeyError):
        eng.poll(rids[0])                  # poll popped the entry
      rec["delta"] = {k: snap.delta()[k] for k in ("submitted", "completed",
                                                    "prefills")}
      rec["idle"] = _load(eng)
      assert eng.tokens_per_sec > 0
      eng.kill(RuntimeError("boom"))       # the loop thread exits
      rec["killed"] = [eng.alive, eng._thread.is_alive(), _load(eng)]
      with pytest.raises(RuntimeError, match="serving loop died") as ei:
        eng.submit(prompts[0], max_new_tokens=2)
      rec["cause"] = str(ei.value.__cause__)
    finally:
      eng.stop()
    # a request the engine holds when it is killed fails with the cause
    eng = ns.engine(num_slots=2, eos_id=REF_EOS, horizon=2)
    held = eng.submit(prompts[1], max_new_tokens=5)
    assert eng.poll(held) is None
    eng.kill()
    with pytest.raises(RuntimeError, match="request %d failed" % held) as ei:
      eng.result(held, timeout=30)
    rec["held"] = [eng.alive, str(ei.value.__cause__)]
    eng.stop()
  assert records["torch"] == records["jax"]
  assert records["torch"]["queued"] == [3, sum(len(p) + 5 for p in prompts),
                                        0, 0.0]
