"""The port's decode-speed stack against the JAX package's, on the CPU.

The contract subset of ``tests/test_serving.py`` for the paged slab, the
shared-prefix cache and self-speculative decoding (``TestPagePool``,
``TestPrefixCacheTrie``, ``TestPagedSlab``, ``TestPrefixSharing``,
``TestSpeculativeDecode``, the int8 slot-reuse parity and the crash replay
of the paged stack), plus the ``kv_pages_exhausted`` detector fed by an
engine's page gauges. Each scenario is written once and runs through BOTH
packages on one seeded JAX state (``params_from_flax``), f32: it asserts
the reference test's invariants on each package and returns a record
(outputs, page counts, prefix hits, spec counters) that must be equal
across the two. Every engine output is also held against the port's
single-request ``greedy_generate_kv``.

The JAX engines of one decoder shape share one ``SlotDecoder`` (its jit
caches warm once; it holds no request state).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu.obs import anomaly as jax_anomaly
from tensorflowonspark_tpu.obs import metrics as jax_metrics
from tensorflowonspark_tpu.serving import ServingEngine as JaxEngine
from tensorflowonspark_tpu.serving import scheduler as jax_sched
from tensorflowonspark_tpu.utils import chaos as jax_chaos
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.obs import anomaly as port_anomaly
from tensorflowonspark_tpu_torch.obs import metrics as port_metrics
from tensorflowonspark_tpu_torch.serving import ServingEngine
from tensorflowonspark_tpu_torch.serving import scheduler as port_sched
from tensorflowonspark_tpu_torch.utils import chaos as port_chaos
from tensorflowonspark_tpu_torch.utils.params import params_from_flax

EOS = 7
PAD = 0
TINY = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_seq_len=48)


class _Package(object):
  """One package's engine factory and modules, behind one surface."""

  def __init__(self, name, engine, sched, chaos, anomaly, metrics):
    self.name, self._engine = name, engine
    self.sched, self.chaos = sched, chaos
    self.anomaly, self.metrics = anomaly, metrics

  def engine(self, int8=False, **kw):
    return self._engine(int8, **kw)


@pytest.fixture(scope="module")
def pair():
  jcfgs = {
      False: jax_tfm.TransformerConfig(remat=False, dtype=jnp.float32,
                                       **TINY),
      # a fresh prefill of an int8 cache attends the raw projections in
      # the flash kernel (the port's path): interpret mode here
      True: jax_tfm.TransformerConfig(remat=False, dtype=jnp.float32,
                                      attention_impl="flash",
                                      kv_cache_dtype="int8", **TINY)}
  tcfgs = {int8: tfm.TransformerConfig(
      dtype=torch.float32, kv_cache_dtype="int8" if int8 else "model",
      **TINY) for int8 in (False, True)}
  state = jax_tfm.create_state(jax.random.PRNGKey(0), jcfgs[False],
                               seq_len=16)
  tparams = params_from_flax(jax.tree.map(np.asarray, state.params),
                             tcfgs[False])
  models = {int8: tfm.Transformer(tcfgs[int8], tparams, device="cpu")
            for int8 in (False, True)}
  decoders = {}

  def jax_engine(int8, **kw):
    eng = JaxEngine(state.params, jcfgs[int8], pad_id=PAD, **kw)
    d = eng.decoder
    key = (int8, d.num_slots, d.eos_id, d.page_size, d.num_pages,
           d.spec_depth, d.spec_layers)
    eng.decoder = decoders.setdefault(key, d)
    return eng

  def port_engine(int8, **kw):
    return ServingEngine(tparams, tcfgs[int8], pad_id=PAD, device="cpu",
                         **kw)

  return models, (
      _Package("jax", jax_engine, jax_sched, jax_chaos, jax_anomaly,
               jax_metrics),
      _Package("torch", port_engine, port_sched, port_chaos, port_anomaly,
               port_metrics))


def _prompts(seed, lengths):
  rng = np.random.RandomState(seed)
  return [rng.randint(1, 64, (n,)).astype(np.int32) for n in lengths]


def _prefixed(seed, tails, prefix_len=12):
  rng = np.random.RandomState(seed)
  prefix = rng.randint(1, 64, (prefix_len,)).astype(np.int32)
  return [np.concatenate([prefix, rng.randint(1, 64, (n,)).astype(np.int32)])
          for n in tails]


def _serve(eng, prompts, budgets):
  rids = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
  return [eng.result(r, timeout=120).tolist() for r in rids]


def _stats(eng, *keys):
  return {k: eng.stats[k] for k in keys}


# -- TestPagePool / TestPrefixCacheTrie: one sequence of operations ----------

def page_pool_ops(ns):
  pool = ns.sched.PagePool(6)                  # 5 allocatable, page 0 trash
  rec = [pool.capacity, pool.free_pages]
  pages = pool.alloc(3)
  assert len(pages) == 3 and 0 not in pages
  rec += [pages, pool.in_use]
  pool.ref(pages[0])                           # a second reader
  rec += [pool.unref(pages[0]), pool.unref(pages[0])]
  with pytest.raises(ValueError, match="double free"):
    pool.unref(pages[0])
  rec.append(pool.alloc(10))                   # all-or-nothing: None
  for p in pages[1:]:
    pool.unref(p)
  rec.append(pool.free_pages)
  small = ns.sched.PagePool(3)
  rec.append(sorted(small.alloc(2)))
  with pytest.raises(ValueError):
    small.unref(0)
  with pytest.raises(ValueError, match="num_pages"):
    ns.sched.PagePool(1)
  return rec


def prefix_trie_ops(ns):
  c = ns.sched.PrefixCache(page_size=2, max_pages=8)
  rec = [c.lookup([1, 2, 3, 4, 5]), c.register([1, 2, 3, 4, 5], [10, 11]),
         c.pages_held, c.lookup([1, 2, 3, 4, 9, 9]), c.lookup([1, 2, 9, 9]),
         c.register([1, 2, 3, 4], [20, 21]), c.register([1, 2, 9, 9],
                                                         [10, 30]),
         c.pages_held]
  lru = ns.sched.PrefixCache(page_size=2, max_pages=2)
  lru.register([1, 2, 3, 4], [10, 11])
  lru.lookup([1, 2])                           # touch the interior node
  rec += [lru.evict(1), lru.over_budget, lru.pages_held,
          lru.lookup([1, 2, 3, 4]), lru.evict(5), lru.evict(1)]
  assert rec[8] == [11] and rec[-2] == [10] and rec[-1] == []
  return rec


# -- TestPagedSlab --------------------------------------------------------------

def paged_parity_and_page_release(ns):
  """Mixed-length traffic through page tables and the pool, and every
  page released once its request completes."""
  prompts = _prompts(13, (4, 7, 11, 16, 7, 4))
  budgets = [3, 8, 14, 8, 3, 8]
  with ns.engine(num_slots=3, eos_id=EOS, page_size=4) as eng:
    outs = _serve(eng, prompts, budgets)
    in_use = eng.kv_pages_in_use
  assert in_use == 0
  return {"outs": outs, "prompts": prompts, "budgets": budgets,
          "pages": eng.decoder.num_pages, "in_use": in_use}


def tight_pool_waits_then_serves(ns):
  """More slots than the pool can host at once: requests WAIT for pages
  (the length-16 request needs ceil((16 + 8) / 4) = 6 of 12)."""
  prompts = _prompts(17, (16, 11, 7, 4))
  with ns.engine(num_slots=4, eos_id=EOS, page_size=4, num_pages=13) as eng:
    outs = _serve(eng, prompts, [8] * 4)
  return {"outs": outs, "prompts": prompts, "budgets": [8] * 4,
          "completed": eng.stats["completed"]}


def knobs_and_refusals(ns):
  """A prompt no pool can page in is refused at submit; the env knobs
  apply and an explicit argument beats them; a prefix cache without
  paging is refused."""
  eng = ns.engine(num_slots=1, page_size=4, num_pages=4)
  with pytest.raises(ValueError, match="KV pages") as ei:
    eng.submit(np.arange(1, 20, dtype=np.int32), max_new_tokens=20)
  eng.stop()
  env = {"TOS_SERVE_PAGE_SIZE": "4", "TOS_SERVE_NUM_PAGES": "20",
         "TOS_SERVE_PREFIX_PAGES": "6", "TOS_SERVE_SPEC_DEPTH": "3",
         "TOS_SERVE_SPEC_LAYERS": "1"}
  os.environ.update(env)
  try:
    eng = ns.engine()
    eng2 = ns.engine(page_size=0, prefix_pages=0, spec_depth=0)
  finally:
    for k in env:
      del os.environ[k]
  with pytest.raises(ValueError, match="TOS_SERVE_PAGE_SIZE"):
    ns.engine(prefix_pages=4)
  return {"refusal": str(ei.value),
          "env": [eng.page_size, eng.decoder.paged, eng.decoder.num_pages,
                  eng.prefix_pages, eng.spec_depth, eng.decoder.spec_layers],
          "explicit": [eng2.decoder.paged, eng2.spec_depth]}


# -- TestPrefixSharing ----------------------------------------------------------

def shared_prefix_hits_release_and_drain(ns):
  """Requests sharing a prefix prefill it once (prefix hits), and after
  every request completes the only pages allocated are the cache's own;
  a second wave rides ``drain()`` and releases its pages exactly once."""
  prompts = _prefixed(23, (3, 5, 2, 6))
  eng = ns.engine(num_slots=2, eos_id=EOS, page_size=4,
                  prefix_pages=8).start()
  outs = _serve(eng, prompts, [8] * 4)
  hits = eng.stats["prefix_hits"]
  assert hits >= len(prompts) - 1
  held = eng._prefix.pages_held
  assert eng.kv_pages_in_use == held > 0
  drain_rids = [eng.submit(p, max_new_tokens=8) for p in prompts[:2]]
  assert eng.drain(timeout=120) is True
  drained = [eng.result(r, timeout=5).tolist() for r in drain_rids]
  assert not eng.alive
  return {"outs": outs + drained, "prompts": prompts + prompts[:2],
          "budgets": [8] * 6, "hits": hits, "held": held}


def eviction_under_budget_keeps_parity(ns):
  """A prefix budget too small for the traffic evicts LRU pages without
  corrupting a decode."""
  rng = np.random.RandomState(29)
  pre_a = rng.randint(1, 64, (12,)).astype(np.int32)
  pre_b = rng.randint(1, 64, (12,)).astype(np.int32)
  prompts = [np.concatenate([pre, rng.randint(1, 64, (3,)).astype(np.int32)])
             for pre in (pre_a, pre_b, pre_a, pre_b)]
  with ns.engine(num_slots=1, eos_id=EOS, page_size=4,
                 prefix_pages=3) as eng:
    outs = [eng.result(eng.submit(p, max_new_tokens=8),
                       timeout=120).tolist() for p in prompts]
    held = eng._prefix.pages_held
  assert eng.stats["prefix_evictions"] > 0 and held <= 3
  return {"outs": outs, "prompts": prompts, "budgets": [8] * 4,
          "held": held, **_stats(eng, "prefix_hits", "prefix_evictions")}


# -- TestSpeculativeDecode ------------------------------------------------------

def spec_parity_and_counters(ns):
  prompts = _prompts(37, (4, 7, 11, 16, 7))
  budgets = [3, 8, 14, 8, 3]
  with ns.engine(num_slots=3, eos_id=EOS, spec_depth=3) as eng:
    outs = _serve(eng, prompts, budgets)
  stats = _stats(eng, "spec_accepted", "spec_rejected", "steps")
  assert stats["spec_accepted"] + stats["spec_rejected"] > 0
  return {"outs": outs, "prompts": prompts, "budgets": budgets, **stats}


def full_stack_parity(ns):
  """Paged slab + prefix sharing + speculation composed."""
  prompts = _prefixed(41, (3, 5, 4, 6))
  with ns.engine(num_slots=3, eos_id=EOS, page_size=4, prefix_pages=8,
                 spec_depth=2) as eng:
    outs = _serve(eng, prompts, [8] * 4)
    in_use, held = eng.kv_pages_in_use, eng._prefix.pages_held
  assert in_use == held
  return {"outs": outs, "prompts": prompts, "budgets": [8] * 4,
          "in_use": in_use, **_stats(eng, "prefix_hits", "spec_accepted",
                                     "spec_rejected")}


def spec_overshoot_at_max_seq_len(ns):
  """prompt + budget flush against max_seq_len at depth 6: the verify
  window's overflow is dropped (contiguous) or sent to the trash page
  (paged), never clamped over live entries below the cursor."""
  prompt = _prompts(47, (34,))[0]
  budget = TINY["max_seq_len"] - len(prompt)   # 14
  outs = []
  for paged in ({}, dict(page_size=4)):
    with ns.engine(num_slots=1, eos_id=EOS, spec_depth=6, **paged) as eng:
      outs.append(eng.result(eng.submit(prompt, max_new_tokens=budget),
                             timeout=120).tolist())
  return {"outs": outs, "prompts": [prompt] * 2, "budgets": [budget] * 2}


def spec_depth_invariant(ns):
  """Spec depth changes the dispatch shape only: off and depth 2 emit the
  same streams."""
  prompts = _prompts(43, (4, 7, 11, 16))
  results = []
  for depth in (0, 2):
    with ns.engine(num_slots=2, eos_id=EOS, spec_depth=depth) as eng:
      results.append([o.tolist() for o in eng.generate(
          prompts, max_new_tokens=8, timeout=120)])
  assert results[0] == results[1]
  return {"outs": results[0], "prompts": prompts, "budgets": [8] * 4}


# -- the int8 cache under slot reuse -------------------------------------------

def int8_slot_reuse_parity(ns):
  """Request B decoded in the slot request A just vacated equals B
  decoded by a fresh engine: the insert overwrites A's quantized values
  AND scales."""
  a, b = _prompts(7, (9, 5))
  with ns.engine(int8=True, num_slots=1, eos_id=EOS) as eng:
    out_a = eng.result(eng.submit(a, max_new_tokens=6), timeout=120)
    out_b = eng.result(eng.submit(b, max_new_tokens=8), timeout=120)
  with ns.engine(int8=True, num_slots=1, eos_id=EOS) as eng:
    fresh_b = eng.result(eng.submit(b, max_new_tokens=8), timeout=120)
  np.testing.assert_array_equal(out_b, fresh_b)
  return {"outs": [out_a.tolist(), out_b.tolist()]}


# -- the crash replay of the paged stack ---------------------------------------

def decode_crash_replays_paged_stack(ns):
  """A decode crash over the paged slab + prefix cache + spec: the pool,
  the tables and the trie are rebuilt from nothing and every in-flight
  request replays; the rebuilt pool balances."""
  prompts = _prefixed(51, (3, 5, 4, 6, 2, 3))
  os.environ[ns.chaos.ENV_SERVE] = "decode#2:raise"
  ns.chaos.reset()
  try:
    with ns.engine(num_slots=2, eos_id=EOS, page_size=4, prefix_pages=6,
                   spec_depth=2, poison_crashes=3,
                   restart_backoff=0.01) as eng:
      outs = [o.tolist() for o in eng.generate(prompts, max_new_tokens=8,
                                               timeout=120)]
      assert eng.alive
      in_use, held = eng.kv_pages_in_use, eng._prefix.pages_held
  finally:
    del os.environ[ns.chaos.ENV_SERVE]
    ns.chaos.reset()
  stats = _stats(eng, "engine_restarts", "replays", "replay_mismatches")
  assert stats["engine_restarts"] == 1 and stats["replays"] >= 1
  assert stats["replay_mismatches"] == 0 and in_use == held
  return {"outs": outs, "prompts": prompts, "budgets": [8] * 6,
          "in_use": in_use, **stats}


# -- the page gauges drive the kv_pages_exhausted detector --------------------

def kv_pages_exhausted_fires(ns):
  """One request holds the whole pool and a second waits for pages: the
  engine's ``serve.kv_pages_free`` gauge pinned at 0 with a queued
  request, sampled at two decode dispatches, fires the detector. The
  engine loop is driven by hand, so the samples fall where they must."""
  reg = ns.metrics.activate()
  try:
    prompt_a, prompt_b = _prompts(61, (16, 16))
    # ceil((16 + 24) / 4) = 10 pages: the pool holds one such request
    eng = ns.engine(num_slots=2, page_size=4, num_pages=11, horizon=4)
    eng.submit(prompt_a, max_new_tokens=24)
    eng.submit(prompt_b, max_new_tokens=24)
    eng._ensure_slabs()
    eng._admit()
    frames = []
    for now in (0.0, 10.0):
      eng._decode_once()
      snap = reg.snapshot()
      frames.append((now, {k: snap[k]["value"] for k in (
          "serve.kv_pages_free", "serve.kv_pages_in_use",
          "serve.queue_depth")}))
    eng.stop()
  finally:
    ns.metrics.deactivate()

  class Sink(object):
    executors = {0: {}}
    data = {}

    def metrics(self, eid):
      return self.data

  sink = Sink()
  det = ns.anomaly.AnomalyDetector(
      sink, interval=0.5, window=10.0,
      registry=ns.metrics.MetricsRegistry(), recorder=None)
  fired = []
  for now, values in frames:
    sink.data = {k: {"type": "gauge", "value": float(v)}
                 for k, v in values.items()}
    fired.extend(det.poll(now=now))
  assert [a["alert"] for a in fired] == ["kv_pages_exhausted"]
  return {"frames": frames, "evidence": fired[0]["evidence"]}


SCENARIOS = {f.__name__: f for f in (
    page_pool_ops, prefix_trie_ops, paged_parity_and_page_release,
    tight_pool_waits_then_serves, knobs_and_refusals,
    shared_prefix_hits_release_and_drain, eviction_under_budget_keeps_parity,
    spec_parity_and_counters, full_stack_parity,
    spec_overshoot_at_max_seq_len, spec_depth_invariant,
    int8_slot_reuse_parity, decode_crash_replays_paged_stack,
    kv_pages_exhausted_fires)}


def _greedy(model, prompt, budget):
  """The single-request decode truncated at its stop: the parity oracle."""
  out = tfm.greedy_generate_kv(model, np.asarray(prompt)[None], budget,
                               eos_id=EOS, pad_id=PAD).numpy()[0]
  gen = out[len(prompt):]
  stops = np.where(gen == EOS)[0]
  stop = int(stops[0]) + 1 if len(stops) else budget
  return np.concatenate([prompt, gen[:stop]]).tolist()


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_decode_stack_equals_the_reference(pair, monkeypatch, case):
  """One ``tests/test_serving.py`` scenario through both packages: each
  meets the reference test's invariants, the records are equal, and every
  engine output equals the port's single-request greedy decode."""
  models, packages = pair
  for name in list(os.environ):
    if name.startswith("TOS_CHAOS_") or name.startswith("TOS_SERVE_"):
      monkeypatch.delenv(name)
  records = {}
  for ns in packages:
    ns.chaos.reset()
    records[ns.name] = SCENARIOS[case](ns)

  def plain(x):
    if isinstance(x, dict):
      return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
      return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
      return x.tolist()
    if isinstance(x, np.generic):
      return x.item()
    return x

  got, want = plain(records["torch"]), plain(records["jax"])
  assert got == want
  if "prompts" in got:
    for p, b, out in zip(got["prompts"], got["budgets"], got["outs"]):
      assert out == _greedy(models[False], p, b)
