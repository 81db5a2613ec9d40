"""The port's ServingFleet held against the JAX package's, case by case.

Each case of the contract subset of ``tests/test_fleet.py`` is one scenario,
written once and run through both packages' fleets on the same workload,
the same weights (``params_from_flax`` of one seeded JAX state) and the same
``TOS_CHAOS_FLEET`` spec. Inside each run the scenario asserts the reference
test's own invariants; it returns what is deterministic (outputs, stream
positions, replica states, the stats and events that do not depend on thread
timing), and the port's record must equal the JAX fleet's: outputs token for
token. The subset: routing (mixed-workload parity, load-aware dispatch,
generate/stream, the env knobs), admission (retry, admit deadline, TTL bound,
drain, cancel, dead on arrival), health (probe ejection with failover, all
replicas dead, the failover budget), rolling swaps (mid-flight, to a new
factory), chaos (a kill mid-decode, stream positions exactly once across a
hop with one trace, a stall spec, a malformed spec), exception pickling and
availability accounting.

The JAX engines of one slot count share one ``SlotDecoder``, so its jit
caches warm once for the module instead of once per engine: the decoder
holds no request state (the slab and the weights are passed in), so the
outputs are the same.
"""

import os
import pickle
import time
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu.obs import spans as jax_spans
from tensorflowonspark_tpu.serving import ServingEngine as JaxEngine
from tensorflowonspark_tpu.serving import fleet as jax_fleet
from tensorflowonspark_tpu.serving import scheduler as jax_sched
from tensorflowonspark_tpu.utils import chaos as jax_chaos
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.obs import spans as port_spans
from tensorflowonspark_tpu_torch.serving import ServingEngine as PortEngine
from tensorflowonspark_tpu_torch.serving import fleet as port_fleet
from tensorflowonspark_tpu_torch.serving import scheduler as port_sched
from tensorflowonspark_tpu_torch.utils import chaos as port_chaos
from tensorflowonspark_tpu_torch.utils.params import params_from_flax

pytestmark = pytest.mark.chaos

EOS = 7
PAD = 0
TINY = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_seq_len=48)


@pytest.fixture(scope="module")
def pkgs():
  jcfg = jax_tfm.TransformerConfig(remat=False, dtype=jnp.float32, **TINY)
  state = jax_tfm.create_state(jax.random.PRNGKey(0), jcfg, seq_len=16)
  jparams = jax.tree.map(np.asarray, state.params)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, **TINY)
  tparams = params_from_flax(jparams, tcfg)
  decoders = {}

  def jax_engine(**kw):
    eng = JaxEngine(state.params, jcfg, eos_id=EOS, pad_id=PAD, **kw)
    eng.decoder = decoders.setdefault(eng.num_slots, eng.decoder)
    return eng

  def port_engine(**kw):
    return PortEngine(tparams, tcfg, eos_id=EOS, pad_id=PAD, device="cpu",
                      **kw)

  def namespace(name, engine, fleet, sched, chaos, spans):
    def factory(**kw):
      kw.setdefault("num_slots", 2)
      kw.setdefault("horizon", 2)
      return lambda: engine(**kw)
    return types.SimpleNamespace(
        name=name, engine=engine, factory=factory, fleet=fleet,
        ServingFleet=fleet.ServingFleet, sched=sched, chaos=chaos,
        spans=spans)

  return (namespace("jax", jax_engine, jax_fleet, jax_sched, jax_chaos,
                    jax_spans),
          namespace("torch", port_engine, port_fleet, port_sched,
                    port_chaos, port_spans))


def _workload(seed, n=8, plens=(3, 5, 7), budgets=(4, 8)):
  rng = np.random.RandomState(seed)
  return [(rng.randint(1, 64, (int(rng.choice(plens)),)).astype(np.int32),
           int(rng.choice(budgets))) for _ in range(n)]


def _stats(fl, *keys):
  return {k: fl.stats[k] for k in keys}


def _ids(arrays):
  return [np.asarray(a).tolist() for a in arrays]


# -- routing --------------------------------------------------------------


def mixed_workload_parity(ns):
  with ns.ServingFleet(ns.factory(), num_replicas=2) as fl:
    work = _workload(3, n=10)
    budget = max(b for _, b in work)
    outs = fl.generate([p for p, _ in work], max_new_tokens=budget,
                       timeout=120, detailed=True)
    dispatches = [r.dispatches for r in fl._replicas.values()]
  for o in outs:
    t = o["timing"]
    assert t["trace_id"] == o["trace_id"]
    assert t["failovers"] == 0 and len(t["attempts"]) == 1
    assert t["ttft"] is not None and t["e2e"] >= t["ttft"]
  assert all(d > 0 for d in dispatches), dispatches
  return {"outs": _ids(o["tokens"] for o in outs),
          "stats": _stats(fl, "submitted", "dispatched", "completed",
                          "retries", "failovers", "shed")}


def dispatch_prefers_less_loaded(ns):
  with ns.ServingFleet(ns.factory(), num_replicas=2) as fl:
    busy = fl._dispatch_order()[0]
    for p, b in _workload(5, n=6, budgets=(16,)):
      busy.engine.submit(p, max_new_tokens=b)
    idle = [r for r in fl._replicas.values() if r is not busy][0]
    assert fl._dispatch_order()[0] is idle
    frid = fl.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=4)
    placed = fl.request(frid).cur_replica
    out = fl.result(frid, timeout=120)
  assert placed == idle.rid
  return {"busy": busy.rid, "placed": placed, "out": out.tolist()}


def generate_and_stream(ns):
  with ns.ServingFleet(ns.factory(), num_replicas=2) as fl:
    p = np.asarray([2, 9, 4], np.int32)
    frid = fl.submit(p, max_new_tokens=6)
    handle = fl.request(frid)
    toks = list(fl.stream(frid, timeout=120))
    # the consumer records the verdict itself, without racing the monitor
    assert handle.done.is_set() and handle.error is None
    assert handle.output.tolist() == p.tolist() + toks
    completed = fl.stats["completed"]
    outs = fl.generate([p, p[:2]], max_new_tokens=5, timeout=120)
  return {"stream": toks, "completed_after_stream": completed,
          "outs": _ids(outs)}


def env_knobs(ns):
  env = {ns.fleet.ENV_FLEET_REPLICAS: "3",
         ns.fleet.ENV_FLEET_MAX_FAILOVERS: "7",
         ns.fleet.ENV_FLEET_PROBE_FAILS: "5",
         ns.fleet.ENV_FLEET_ADMIT_TIMEOUT: "11.5",
         ns.fleet.ENV_FLEET_POLL: "0.02"}
  os.environ.update(env)
  try:
    fl = ns.ServingFleet(ns.factory())
  finally:
    for k in env:
      del os.environ[k]
  fl2 = ns.ServingFleet(ns.factory(), num_replicas=1, max_failovers=2)
  return {"env": [fl.num_replicas, fl.max_failovers, fl.probe_fails,
                  fl.admit_timeout, fl._poll],
          "args": [fl2.num_replicas, fl2.max_failovers]}


# -- admission ------------------------------------------------------------


def retry_then_admit(ns):
  fac = ns.factory(num_slots=1, max_queue=1)
  with ns.ServingFleet(fac, num_replicas=2, admit_timeout=60.0) as fl:
    work = _workload(11, n=8, budgets=(6,))
    frids = [fl.submit(p, max_new_tokens=b) for p, b in work]
    outs = [fl.result(fr, timeout=120) for fr in frids]
    refused = sum(r.engine.stats["rejected"] for r in fl._replicas.values())
  # at least one submit met a full fleet and waited out a retry_after (the
  # fleet's "retries" counts only the rounds after the first, and a fast
  # engine clears its backlog within one hint)
  assert refused >= 1
  return {"outs": _ids(outs), "stats": _stats(fl, "submitted", "completed",
                                              "shed", "rejected")}


def admit_deadline_bounds_retries(ns):
  fl = ns.ServingFleet(ns.factory(num_slots=1, max_queue=1), num_replicas=2,
                       admit_timeout=0.3)
  # engines never started: each queue takes one request, then rejects
  for rep in fl._replicas.values():
    rep.engine.submit(np.asarray([1, 2], np.int32), max_new_tokens=4)
  t0 = time.monotonic()
  with pytest.raises(ns.sched.ServingOverloaded) as ei:
    fl.submit(np.asarray([5, 6], np.int32), max_new_tokens=4)
  assert time.monotonic() - t0 < 5.0
  assert ei.value.retry_after is not None
  fl.stop()
  return {"stats": _stats(fl, "submitted", "rejected")}


def ttl_bounds_retries(ns):
  fl = ns.ServingFleet(ns.factory(num_slots=1, max_queue=1), num_replicas=1,
                       admit_timeout=60.0)
  fl._replicas[0].engine.submit(np.asarray([1, 2], np.int32),
                                max_new_tokens=4)
  t0 = time.monotonic()
  with pytest.raises((ns.sched.DeadlineExceeded,
                      ns.sched.ServingOverloaded)):
    fl.submit(np.asarray([3], np.int32), max_new_tokens=4, ttl=0.3)
  assert time.monotonic() - t0 < 5.0
  fl.stop()
  return {"stats": _stats(fl, "submitted", "dispatched")}


def drain_finishes_work(ns):
  fl = ns.ServingFleet(ns.factory(), num_replicas=2).start()
  work = _workload(13, n=6)
  frids = [fl.submit(p, max_new_tokens=b) for p, b in work]
  handles = [fl.request(fr) for fr in frids]
  assert fl.drain(timeout=120)
  assert all(h.error is None for h in handles)
  with pytest.raises(ns.sched.ServingOverloaded) as ei:
    fl.submit(np.asarray([1], np.int32), max_new_tokens=2)
  assert ei.value.draining
  assert ei.value.retry_after is not None and ei.value.retry_after > 0
  return {"outs": _ids(h.output for h in handles),
          "stats": _stats(fl, "submitted", "completed", "rejected")}


def cancel_inflight(ns):
  with ns.ServingFleet(ns.factory(), num_replicas=1) as fl:
    frid = fl.submit(np.asarray([4, 2, 5], np.int32), max_new_tokens=32)
    assert fl.cancel(frid, timeout=60)
    with pytest.raises(ns.sched.RequestCancelled):
      fl.result(frid, timeout=10)
  return {"stats": _stats(fl, "submitted", "completed", "shed")}


def dead_on_arrival(ns):
  with ns.ServingFleet(ns.factory(), num_replicas=1) as fl:
    with pytest.raises(ns.sched.DeadlineExceeded, match="dead on arrival"):
      fl.submit(np.asarray([1, 2], np.int32), max_new_tokens=4,
                deadline=time.monotonic() - 1.0)
  return {"stats": _stats(fl, "submitted", "rejected", "dispatched")}


# -- health ---------------------------------------------------------------


def probe_ejection_fails_over(ns):
  sick = {"rid": None}

  def probe(rep):
    return rep.rid != sick["rid"]

  with ns.ServingFleet(ns.factory(), num_replicas=2, probe_fails=2,
                       poll_interval=0.01, health_probe=probe) as fl:
    work = _workload(17, n=6, budgets=(32,))
    frids = [fl.submit(p, max_new_tokens=b) for p, b in work]
    victim = fl.request(frids[0]).cur_replica
    sick["rid"] = victim
    outs = [fl.result(fr, timeout=120) for fr in frids]
    states = fl.replica_states()
    events = {e["event"] for e in fl.events}
  assert fl.stats["failovers"] >= 1
  assert {"eject", "failover"} <= events
  return {"outs": _ids(outs), "victim": victim, "states": states,
          "stats": _stats(fl, "ejections", "shed", "completed")}


def all_replicas_dead(ns):
  fl = ns.ServingFleet(ns.factory(), num_replicas=1,
                       poll_interval=0.02).start()
  frid = fl.submit(np.asarray([3, 1], np.int32), max_new_tokens=32)
  fl._kill_replica(fl._replicas[0], RuntimeError("boom"))
  with pytest.raises(RuntimeError):
    fl.result(frid, timeout=30)
  alive = fl.alive
  # the ejection released the dead engine's slab
  released = fl._replicas[0].engine._slabs is None
  with pytest.raises(RuntimeError):
    fl.submit(np.asarray([1], np.int32), max_new_tokens=2)
  fl.stop()
  return {"alive": alive, "released": released,
          "states": fl.replica_states(),
          "stats": _stats(fl, "ejections", "rejected")}


def failover_budget(ns):
  fl = ns.ServingFleet(ns.factory(), num_replicas=1, max_failovers=0,
                       poll_interval=0.02).start()
  frid = fl.submit(np.asarray([2, 2, 2], np.int32), max_new_tokens=32)
  fl._kill_replica(fl._replicas[0], RuntimeError("boom"))
  with pytest.raises(RuntimeError, match="failed"):
    fl.result(frid, timeout=30)
  fl.stop()
  return {"stats": _stats(fl, "shed", "failovers", "ejections")}


# -- rolling swaps ----------------------------------------------------------


def swap_mid_flight(ns):
  with ns.ServingFleet(ns.factory(), num_replicas=2) as fl:
    work = _workload(23, n=8, budgets=(8, 16))
    frids = [fl.submit(p, max_new_tokens=b) for p, b in work]
    rep = fl.rolling_swap(timeout=120.0)
    outs = [fl.result(fr, timeout=120) for fr in frids]
    assert all(r["drained"] for r in rep["replicas"])
    gens = [r.generation for r in fl._replicas.values()]
    p = np.asarray([9, 9, 1], np.int32)
    after = fl.result(fl.submit(p, max_new_tokens=4), timeout=120)
  return {"outs": _ids(outs), "after": after.tolist(),
          "swapped": rep["swapped"], "generations": gens,
          "stats": _stats(fl, "swaps", "shed")}


def swap_to_new_factory(ns):
  built = []

  def new_factory():
    eng = ns.engine(num_slots=2, horizon=2)
    built.append(eng)
    return eng

  with ns.ServingFleet(ns.factory(), num_replicas=2) as fl:
    fl.rolling_swap(timeout=60.0, engine_factory=new_factory)
    assert [r.engine for r in fl._replicas.values()] == built
    assert fl._factory is new_factory
    out = fl.result(fl.submit(np.asarray([5, 1], np.int32),
                              max_new_tokens=4), timeout=120)
  return {"built": len(built), "out": out.tolist()}


# -- chaos ----------------------------------------------------------------


def kill_mid_decode(ns):
  with ns.ServingFleet(ns.factory(), num_replicas=3,
                       poll_interval=0.02) as fl:
    work = _workload(31, n=9, budgets=(8, 16))
    frids = [fl.submit(p, max_new_tokens=b) for p, b in work]
    swap = fl.rolling_swap(timeout=120.0)   # mid-flight, after the kill
    outs = [fl.result(fr, timeout=120) for fr in frids]
    states = fl.replica_states()
    events = list(fl.events)
  assert fl.stats["failovers"] >= 1 and fl.stats["replays"] >= 1
  kinds = {e["event"] for e in events}
  assert {"eject", "failover", "swap_done"} <= kinds
  eject = next(e for e in events if e["event"] == "eject")
  assert "InjectedFault" in eject["cause"]
  return {"outs": _ids(outs), "states": states, "swapped": swap["swapped"],
          "ejected": eject["replica"],
          "stats": _stats(fl, "ejections", "shed", "replay_mismatches",
                          "completed")}


def stream_exactly_once_across_hop(ns):
  rec = ns.spans.activate()
  try:
    with ns.ServingFleet(ns.factory(num_slots=1), num_replicas=2,
                         poll_interval=0.02) as fl:
      p = np.asarray([5, 3, 8, 2], np.int32)
      frid = fl.submit(p, max_new_tokens=24)
      trace = fl.request(frid).trace_id
      got, kicked = [], False
      for tok in fl.stream(frid, timeout=120):
        got.append(tok)
        if not kicked and len(got) == 2:
          kicked = True
          # occupy replica 1, then force a round that reaches replica 0
          # again: its 2nd dispatch consult kills it mid-stream
          fl.submit(np.asarray([1, 1], np.int32), max_new_tokens=4)
          fl.submit(np.asarray([2, 2], np.int32), max_new_tokens=4)
      states = fl.replica_states()
  finally:
    ns.spans.deactivate()
  assert fl.stats["failovers"] >= 1
  recs = [r for r in rec.drain() if r.get("trace") == trace]
  names = {r["name"] for r in recs}
  dispatches = [r for r in recs if r["name"] == "fleet.dispatch"]
  assert {"serve.queue", "serve.prefill", "serve.decode.slot",
          "fleet.stream"} <= names, names
  stream_span = next(r for r in recs if r["name"] == "fleet.stream")
  assert stream_span["attrs"]["failovers"] >= 1
  return {"stream": got, "states": states,
          "hop": sorted(d["attrs"]["replica"] for d in dispatches),
          "prefills": sum(1 for r in recs if r["name"] == "serve.prefill"),
          "stream_tokens": stream_span["attrs"]["tokens"],
          "stats": _stats(fl, "replay_mismatches", "shed")}


def stall_delays_dispatch_only(ns):
  with ns.ServingFleet(ns.factory(), num_replicas=1) as fl:
    t0 = time.monotonic()
    frid = fl.submit(np.asarray([6, 4], np.int32), max_new_tokens=4)
    assert time.monotonic() - t0 >= 0.2
    out = fl.result(frid, timeout=120)
  return {"out": out.tolist(), "stats": _stats(fl, "ejections", "shed")}


def malformed_spec(ns):
  with pytest.raises(ValueError, match="fleet spec") as ei:
    ns.chaos.check_config()
  return {"error": str(ei.value)}


# -- exceptions and availability ------------------------------------------


def exception_pickling(ns):
  e = pickle.loads(pickle.dumps(ns.sched.ServingOverloaded(
      "queue full", queue_depth=7, queued_tokens=123, retry_after=1.5,
      draining=True)))
  assert type(e) is ns.sched.ServingOverloaded
  got = [str(e), e.queue_depth, e.queued_tokens, e.retry_after, e.draining]
  for cls in ("DeadlineExceeded", "RequestCancelled", "PoisonedRequest"):
    e2 = pickle.loads(pickle.dumps(getattr(ns.sched, cls)("why")))
    assert type(e2) is getattr(ns.sched, cls)
    got.append(str(e2))
  return {"fields": got}


def dead_fleet_counts_submitted_and_rejected(ns):
  fl = ns.ServingFleet(ns.factory(), num_replicas=1).start()
  fl.stop()
  with pytest.raises(RuntimeError):
    fl.submit(np.asarray([1, 2], np.int32), max_new_tokens=4)
  return {"stats": _stats(fl, "submitted", "rejected")}


def malformed_prompt_counts_neither(ns):
  with ns.ServingFleet(ns.factory(), num_replicas=1) as fl:
    with pytest.raises(ValueError, match="at least one token"):
      fl.submit(np.asarray([], np.int32), max_new_tokens=4)
  return {"stats": _stats(fl, "submitted", "rejected")}


def served_request_counts_submitted_only(ns):
  with ns.ServingFleet(ns.factory(), num_replicas=1) as fl:
    out = fl.result(fl.submit(np.asarray([4, 9], np.int32),
                              max_new_tokens=4), timeout=120)
  return {"out": out.tolist(), "stats": _stats(fl, "submitted", "rejected",
                                               "completed")}


CASES = {f.__name__: f for f in (
    mixed_workload_parity, dispatch_prefers_less_loaded, generate_and_stream,
    env_knobs, retry_then_admit, admit_deadline_bounds_retries,
    ttl_bounds_retries, drain_finishes_work, cancel_inflight,
    dead_on_arrival, probe_ejection_fails_over, all_replicas_dead,
    failover_budget, swap_mid_flight, swap_to_new_factory, kill_mid_decode,
    stream_exactly_once_across_hop, stall_delays_dispatch_only,
    malformed_spec, exception_pickling,
    dead_fleet_counts_submitted_and_rejected,
    malformed_prompt_counts_neither, served_request_counts_submitted_only)}

#: the TOS_CHAOS_FLEET spec each chaos case runs under
CHAOS = {"kill_mid_decode": "dispatch@1#2:kill",
         # replica 0's 2nd dispatch consult: the streamed request is its 1st
         "stream_exactly_once_across_hop": "dispatch@0#2:kill",
         "stall_delays_dispatch_only": "dispatch#1:stall:0.2",
         "malformed_spec": "dispatch@1#2:raise"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_fleet_matches_the_reference(pkgs, monkeypatch, case):
  for name in list(os.environ):
    if name.startswith(("TOS_CHAOS_", "TOS_FLEET_")):
      monkeypatch.delenv(name)
  if case in CHAOS:
    monkeypatch.setenv("TOS_CHAOS_FLEET", CHAOS[case])
  records = {}
  for ns in pkgs:
    jax_chaos.reset()
    port_chaos.reset()
    records[ns.name] = CASES[case](ns)
  jax_chaos.reset()
  port_chaos.reset()
  assert records["torch"] == records["jax"]


def test_launch_counts_survive_concurrent_replicas():
  """Two replicas launch from a loop thread each: the kernel launch
  counter must lose no increment under contention (more threads than
  cores, a switch interval short enough to split a read-modify-write)."""
  import sys
  import threading
  from tensorflowonspark_tpu_torch import ops
  threads, each = 2 * (os.cpu_count() or 2), 2000
  old = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    ops.reset_launches()
    workers = [threading.Thread(
        target=lambda: [ops.count_launch("layer_norm") for _ in range(each)])
               for _ in range(threads)]
    for w in workers:
      w.start()
    for w in workers:
      w.join(timeout=60)
    assert not any(w.is_alive() for w in workers)
    assert ops.LAUNCHES["layer_norm"] == threads * each
  finally:
    sys.setswitchinterval(old)
    ops.reset_launches()
