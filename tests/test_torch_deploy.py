"""The port's model registry and deploy controller held against the JAX
package's, case by case.

Each case of the contract subset of ``tests/test_deploy.py`` is one
scenario, written once and run through both packages on the same weights
(three seeded JAX states, carried across with ``params_from_flax``) and
the same ``TOS_CHAOS_DEPLOY`` spec. Inside each run the scenario asserts
the reference test's own invariants, with its package's own
``greedy_generate_kv`` as the parity oracle; it returns what is
deterministic (outputs, versions, quarantine records, verdicts, counters
and refcounts), and the port's record must equal the JAX one's, outputs
token for token in f32. The subset: the registry (round trip, a torn
publish resolving to the previous version, corruption at rest, watch,
quarantine, gc with refs and quarantine, publish on checkpoint), the
predict fn's content-keyed engine cache, fleet scale-up, the happy path,
a poisoned candidate, a kill mid-promote with resume, a kill mid-canary
and a malformed spec.

Registry versions do not cross between the packages: each manifest holds
its own package's ``params_fingerprint``, and the two prints never agree
(``tests/test_torch_checkpoint.py``). So each package publishes the same
weights into a registry of its own.

The JAX engines of one slot count share one ``SlotDecoder`` (its jit
caches warm once; the decoder holds no request state, so the outputs are
the same), which keeps the JAX side cheap.
"""

import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu.serving import deploy as jax_deploy
from tensorflowonspark_tpu.serving import fleet as jax_fleet
from tensorflowonspark_tpu.serving import registry as jax_registry
from tensorflowonspark_tpu.serving.engine import ServingEngine as JaxEngine
from tensorflowonspark_tpu.utils import chaos as jax_chaos
from tensorflowonspark_tpu.utils import checkpoint as jax_ckpt
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.serving import deploy as port_deploy
from tensorflowonspark_tpu_torch.serving import fleet as port_fleet
from tensorflowonspark_tpu_torch.serving import registry as port_registry
from tensorflowonspark_tpu_torch.serving.engine import (
    ServingEngine as PortEngine)
from tensorflowonspark_tpu_torch.utils import chaos as port_chaos
from tensorflowonspark_tpu_torch.utils import checkpoint as port_ckpt
from tensorflowonspark_tpu_torch.utils.params import params_from_flax

pytestmark = pytest.mark.chaos

EOS = 7
PAD = 0
TINY = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_seq_len=48)


@pytest.fixture(scope="module")
def pkgs():
  jcfg = jax_tfm.TransformerConfig(remat=False, dtype=jnp.float32, **TINY)
  jstates = [jax_tfm.create_state(jax.random.PRNGKey(s), jcfg,
                                  seq_len=16).params for s in (0, 1, 2)]
  tcfg = tfm.TransformerConfig(remat=False, dtype=torch.float32, **TINY)
  tstates = [params_from_flax(jax.tree.map(np.asarray, p), tcfg)
             for p in jstates]
  decoders = {}

  def jax_engine(params, **kw):
    eng = JaxEngine(params, jcfg, eos_id=EOS, pad_id=PAD, **kw)
    eng.decoder = decoders.setdefault(eng.num_slots, eng.decoder)
    return eng

  def port_engine(params, **kw):
    return PortEngine(params, tcfg, eos_id=EOS, pad_id=PAD, device="cpu",
                      **kw)

  def jax_reference(params, prompt, budget):
    out = np.asarray(jax_tfm.greedy_generate_kv(
        params, jcfg, jnp.asarray(prompt)[None], int(budget), eos_id=EOS,
        pad_id=PAD))[0]
    return _truncate(out, prompt, budget)

  models = {}

  def port_reference(params, prompt, budget):
    key = id(params)
    if key not in models:
      models[key] = (params, tfm.Transformer(tcfg, params=params,
                                             device="cpu"))
    out = tfm.greedy_generate_kv(
        models[key][1], torch.as_tensor(np.asarray(prompt))[None],
        int(budget), eos_id=EOS, pad_id=PAD).numpy()[0]
    return _truncate(out, prompt, budget)

  def namespace(name, engine, reference, states, cfg, deploy, fleet,
                registry, chaos, ckpt, predict_fn):
    return types.SimpleNamespace(
        name=name, engine=engine, reference=reference, states=states,
        cfg=cfg, deploy=deploy, fleet=fleet, registry=registry,
        ModelRegistry=registry.ModelRegistry, chaos=chaos, ckpt=ckpt,
        predict_fn=predict_fn)

  def jax_predict_fn():
    return jax_tfm.make_serving_predict_fn(jcfg, 4, eos_id=EOS, pad_id=PAD,
                                           num_slots=2)

  def port_predict_fn():
    return tfm.make_serving_predict_fn(tcfg, 4, eos_id=EOS, pad_id=PAD,
                                       num_slots=2, device="cpu")

  return (namespace("jax", jax_engine, jax_reference, jstates, jcfg,
                    jax_deploy, jax_fleet, jax_registry, jax_chaos, jax_ckpt,
                    jax_predict_fn),
          namespace("torch", port_engine, port_reference, tstates, tcfg,
                    port_deploy, port_fleet, port_registry, port_chaos,
                    port_ckpt, port_predict_fn))


def _truncate(out, prompt, budget):
  """prompt + generated, cut after the first EOS."""
  gen = np.asarray(out)[len(prompt):]
  stops = np.where(gen == EOS)[0]
  stop = (int(stops[0]) + 1) if len(stops) else int(budget)
  return np.concatenate([np.asarray(prompt), gen[:stop]]).astype(np.int64)


def _workload(seed, n=6, plens=(3, 5, 7), budgets=(4, 6)):
  rng = np.random.RandomState(seed)
  return [(rng.randint(1, 64, (int(rng.choice(plens)),)).astype(np.int32),
           int(rng.choice(budgets))) for _ in range(n)]


def _tree(scale=1.0):
  """A tiny nested-dict params stand-in for the registry-only cases."""
  return {"dense": {"w": np.arange(6, dtype=np.float32) * scale,
                    "b": np.zeros(2, np.float32)},
          "emb": np.ones((3, 2), np.float32) * scale}


def _factory(ns, params):
  return lambda: ns.engine(params, num_slots=2, horizon=2)


def _controller(ns, fleet, reg, probe, **kw):
  kw.setdefault("traffic_slice", 0.5)
  kw.setdefault("bake_seconds", 0.2)
  kw.setdefault("spot_checks", 2)
  kw.setdefault("swap_timeout", 120.0)
  return ns.deploy.DeploymentController(
      fleet, reg, lambda params, manifest: _factory(ns, params),
      ns.reference, probe, **kw)


def _fleet_for(ns, reg, version, replicas=2):
  params, _ = reg.get(version)
  fl = ns.fleet.ServingFleet(_factory(ns, params),
                             num_replicas=replicas).start()
  for rid in fl.replica_states():
    fl.set_replica_version(rid, version)
  return fl


def _ids(a):
  return np.asarray(a).tolist()


# -- the registry ----------------------------------------------------------


def publish_get_roundtrip(ns, tmp):
  reg = ns.ModelRegistry(tmp)
  v1 = reg.publish(_tree(1.0), step=10, lineage={"run": "a"})
  v2 = reg.publish(_tree(2.0), step=20)
  params, manifest = reg.get(v2)
  np.testing.assert_array_equal(params["dense"]["w"],
                                _tree(2.0)["dense"]["w"])
  with pytest.raises(TypeError):
    reg.publish([np.zeros(2)], step=1)
  with pytest.raises(ValueError, match="'/'"):
    reg.publish({"a/b": np.zeros(2)}, step=1)
  return {"versions": [v1, v2], "listed": reg.versions(),
          "latest": reg.latest(), "step": manifest["step"],
          "fingerprint_matches": manifest["fingerprint"]
          == ns.ckpt.params_fingerprint(_tree(2.0)),
          "lineage": reg.manifest(v1)["lineage"],
          "keys": sorted(manifest),
          "files": sorted(os.listdir(reg._dir(v2))),
          "leaves": {k: _ids(v) for k, v in params["dense"].items()}}


def torn_publish_resolves_to_previous(ns, tmp):
  reg = ns.ModelRegistry(tmp)
  v1 = reg.publish(_tree(1.0), step=10)
  v2 = reg.publish(_tree(2.0), step=20)
  vdir = reg._dir(v2)
  for name in os.listdir(vdir):
    with open(os.path.join(vdir, name), "r+b") as f:
      f.truncate(0)
  assert reg.latest() == v1 and reg.versions() == [v1]
  with pytest.raises(FileNotFoundError, match="no commit marker"):
    reg.get(v2)
  fresh = ns.ModelRegistry(tmp)
  return {"latest": fresh.latest(), "next": fresh.publish(_tree(3.0),
                                                          step=30)}


def corruption_at_rest_detected(ns, tmp):
  reg = ns.ModelRegistry(tmp)
  v = reg.publish(_tree(1.0), step=1)
  ppath = os.path.join(reg._dir(v), ns.registry._PARAMS)
  flat = {"dense/w": np.arange(6, dtype=np.float32) * 9.0,
          "dense/b": np.zeros(2, np.float32),
          "emb": np.ones((3, 2), np.float32)}
  with open(ppath, "wb") as f:
    np.savez(f, **flat)
  with pytest.raises(ValueError, match="corrupt at rest"):
    reg.get(v)
  params, _ = reg.get(v, verify=False)
  return {"w1": float(params["dense"]["w"][1])}


def watch_sees_new_version(ns, tmp):
  reg = ns.ModelRegistry(tmp)
  v1 = reg.publish(_tree(1.0), step=1)
  before = reg.watch(0.05, last_seen=v1, poll=0.01)
  v2 = reg.publish(_tree(2.0), step=2)
  return {"before": before, "after": reg.watch(5.0, last_seen=v1, poll=0.01),
          "any": reg.watch(5.0, last_seen=None, poll=0.01), "v2": v2}


def quarantine_hides_and_records(ns, tmp):
  reg = ns.ModelRegistry(tmp)
  v1 = reg.publish(_tree(1.0), step=1)
  v2 = reg.publish(_tree(2.0), step=2)
  reg.quarantine(v2, {"reason": "parity: 2/2 diverged", "ok": False})
  rec = reg.quarantine_record(v2)
  return {"latest": reg.latest(), "versions": reg.versions(),
          "all": reg.versions(include_quarantined=True),
          "quarantined": [reg.is_quarantined(v) for v in (v1, v2)],
          "record": {k: rec[k] for k in ("version", "verdict")},
          "record_keys": sorted(rec),
          "watch": reg.watch(0.05, last_seen=v1, poll=0.01)}


def gc_respects_refs_quarantine_and_newest(ns, tmp):
  reg = ns.ModelRegistry(tmp, keep=1)
  vs = [reg.publish(_tree(float(i)), step=i) for i in range(1, 5)]
  reg.acquire(vs[1])
  reg.quarantine(vs[2])
  first = reg.gc()
  kept = [os.path.isdir(reg._dir(v)) for v in vs]
  reg.release(vs[1])
  second = reg.gc()
  return {"first": first, "kept": kept, "second": second,
          "quarantined_kept": os.path.isdir(reg._dir(vs[2])),
          "latest": reg.latest()}


def publish_on_checkpoint_rides_save_cadence(ns, tmp):
  mgr = ns.ckpt.CheckpointManager(os.path.join(tmp, "ckpt"),
                                  save_interval_steps=1)
  reg = ns.ModelRegistry(os.path.join(tmp, "reg"))
  reg.publish_on_checkpoint(mgr, get_params=lambda s: s,
                            lineage={"run": "trainer0"})
  state = _tree(4.0)
  assert mgr.save(3, state, is_chief=True, manifest={"note": "x"})
  mgr.wait()
  v = reg.latest()
  params, manifest = reg.get(v)
  np.testing.assert_array_equal(params["dense"]["w"], state["dense"]["w"])
  lin = manifest["lineage"]
  return {"version": v, "step": manifest["step"], "run": lin["run"],
          "checkpoint_manifest": lin["checkpoint_manifest"],
          "ckpt_dir": "ckpt" in lin["checkpoint_dir"]}


# -- the predict fn's engine cache and fleet scale-up ---------------------


def republished_params_not_served_stale(ns, tmp):
  """The predict fn's engine cache keys on the params' content: a
  republished same-shape set served through the same predict fn gives
  that set's outputs, never the cached engine's."""
  del tmp
  fn = ns.predict_fn()
  prompts = [np.asarray([1, 2, 3], np.int32), np.asarray([4, 5], np.int32)]
  col = np.empty(2, object)
  col[:] = prompts
  out1 = np.asarray(fn(ns.states[0], {"x": col})["tokens"])
  out2 = np.asarray(fn(ns.states[1], {"x": col})["tokens"])
  for i, p in enumerate(prompts):
    r1 = ns.reference(ns.states[0], p, 4)
    r2 = ns.reference(ns.states[1], p, 4)
    np.testing.assert_array_equal(out1[i, :len(r1)], r1)
    np.testing.assert_array_equal(out2[i, :len(r2)], r2)
  out2b = np.asarray(fn(ns.states[1], {"x": col})["tokens"])
  np.testing.assert_array_equal(out2, out2b)
  return {"out1": _ids(out1), "out2": _ids(out2)}


def on_saturated_adds_replica_up_to_cap(ns, tmp):
  del tmp
  with ns.fleet.ServingFleet(_factory(ns, ns.states[0]), num_replicas=1,
                             max_replicas=2) as fl:
    steps = [fl.num_replicas, fl.on_saturated(), fl.num_replicas,
             fl.stats["scale_ups"], fl.on_saturated(), fl.num_replicas]
    work = _workload(5, n=6)
    budget = max(b for _, b in work)
    outs = fl.generate([p for p, _ in work], max_new_tokens=budget,
                       timeout=120)
    for (p, _), o in zip(work, outs):
      np.testing.assert_array_equal(o, ns.reference(ns.states[0], p, budget))
    events = sorted({e["event"] for e in fl.events})
  return {"steps": steps, "outs": [_ids(o) for o in outs], "events": events}


def hook_off_by_default_and_cap_validated(ns, tmp):
  del tmp
  with ns.fleet.ServingFleet(_factory(ns, ns.states[0]),
                             num_replicas=1) as fl:
    got = [fl.max_replicas, fl.on_saturated(), fl.num_replicas]
  with pytest.raises(ValueError):
    ns.fleet.ServingFleet(_factory(ns, ns.states[0]), num_replicas=3,
                          max_replicas=2)
  return got


# -- the controller ---------------------------------------------------------


def _verdict(v):
  return {"ok": v["ok"], "promoted": v.get("promoted"),
          "parity": v["parity"], "reason": v["reason"],
          "canary_sampled": v["canary_samples"] >= 1,
          "rollback_bit_identical": v.get("rollback_bit_identical")}


def happy_path_promotes_fleet_wide(ns, tmp):
  reg = ns.ModelRegistry(tmp)
  v1 = reg.publish(ns.states[0], step=100)
  v2 = reg.publish(ns.states[1], step=200)
  work = _workload(7, n=6)
  fl = _fleet_for(ns, reg, v1)
  snap = fl.stats_snapshot()
  try:
    ctl = _controller(ns, fl, reg, work[:2], baseline_version=v1)
    verdict = ctl.deploy(v2, bake_traffic=work)
    assert verdict["ok"] and verdict.get("promoted")
    frid = fl.submit(work[0][0], max_new_tokens=work[0][1])
    freq = fl.request(frid)
    out = fl.result(frid, timeout=120)
    np.testing.assert_array_equal(
        out, ns.reference(ns.states[1], work[0][0], work[0][1]))
    st = ctl.status()
    return {"verdict": _verdict(verdict),
            "served": sorted(set(fl.served_versions().values())),
            "current": ctl.current_version, "state": ctl.state,
            "stats": dict(ctl.stats), "out": _ids(out),
            "stamp": freq.timing()["model_version"],
            "shed": snap.delta().get("shed", 0),
            "refs": [reg.refcount(v1), reg.refcount(v2)],
            "status": {k: st[k] for k in ("state", "state_code", "version",
                                          "candidate", "served_versions",
                                          "stats")}}
  finally:
    fl.stop()


def poisoned_candidate_caught_quarantined_rolled_back(ns, tmp):
  reg = ns.ModelRegistry(tmp)
  v1 = reg.publish(ns.states[0], step=100)
  v2 = reg.publish(ns.states[1], step=200)
  work = _workload(11, n=6)
  fl = _fleet_for(ns, reg, v1)
  snap = fl.stats_snapshot()
  os.environ[ns.chaos.ENV_DEPLOY] = "canary:poison"
  try:
    ctl = _controller(ns, fl, reg, work[:2], baseline_version=v1)
    verdict = ctl.deploy(v2, bake_traffic=work)
    assert not verdict["ok"] and verdict["parity"]["mismatches"] > 0
    assert verdict["rollback_bit_identical"] is True
    rec = reg.quarantine_record(v2)
    return {"verdict": _verdict(verdict),
            "quarantined": reg.is_quarantined(v2), "latest": reg.latest(),
            "served": sorted(set(fl.served_versions().values())),
            "current": ctl.current_version, "state": ctl.state,
            "stats": dict(ctl.stats), "shed": snap.delta().get("shed", 0),
            "record_reason": rec["verdict"]["reason"],
            "record_ok": rec["verdict"]["ok"]}
  finally:
    del os.environ[ns.chaos.ENV_DEPLOY]
    fl.stop()


def kill_mid_promote_resume_converges(ns, tmp):
  reg = ns.ModelRegistry(tmp)
  v1 = reg.publish(ns.states[0], step=100)
  v2 = reg.publish(ns.states[1], step=200)
  work = _workload(13, n=6)
  fl = _fleet_for(ns, reg, v1)
  snap = fl.stats_snapshot()
  os.environ[ns.chaos.ENV_DEPLOY] = "promote:kill"
  try:
    ctl = _controller(ns, fl, reg, work[:2], baseline_version=v1)
    with pytest.raises(ns.deploy.ControllerKilled):
      ctl.deploy(v2, bake_traffic=work)
    mixed = fl.served_versions()
    outs = []
    for p, b in work:
      frid = fl.submit(p, max_new_tokens=b)
      freq = fl.request(frid)
      out = fl.result(frid, timeout=120)
      ver = freq.timing()["model_version"]
      np.testing.assert_array_equal(
          out, ns.reference(ns.states[ver - 1], p, b))
      outs.append(_ids(out))
    del os.environ[ns.chaos.ENV_DEPLOY]
    ns.chaos.reset()
    rep = ctl.resume(timeout=120.0)
    out = fl.result(fl.submit(work[0][0], max_new_tokens=work[0][1]),
                    timeout=120)
    np.testing.assert_array_equal(
        out, ns.reference(ns.states[1], work[0][0], work[0][1]))
    return {"mixed": {str(k): v for k, v in sorted(mixed.items())},
            "outs": outs, "resume": rep,
            "served": sorted(set(fl.served_versions().values())),
            "current": ctl.current_version, "after": _ids(out),
            "shed": snap.delta().get("shed", 0),
            "refs": [reg.refcount(v1), reg.refcount(v2)],
            "stats": dict(ctl.stats)}
  finally:
    os.environ.pop(ns.chaos.ENV_DEPLOY, None)
    fl.stop()


def kill_mid_canary_resume_keeps_baseline(ns, tmp):
  reg = ns.ModelRegistry(tmp)
  v1 = reg.publish(ns.states[0], step=100)
  v2 = reg.publish(ns.states[1], step=200)
  work = _workload(17, n=4)
  fl = _fleet_for(ns, reg, v1)
  os.environ[ns.chaos.ENV_DEPLOY] = "canary:kill"
  try:
    ctl = _controller(ns, fl, reg, work[:2], baseline_version=v1)
    with pytest.raises(ns.deploy.ControllerKilled):
      ctl.deploy(v2)
    before = sorted(set(fl.served_versions().values()))
    del os.environ[ns.chaos.ENV_DEPLOY]
    ns.chaos.reset()
    rep = ctl.resume(timeout=120.0)
    return {"before": before, "resume": rep,
            "served": sorted(set(fl.served_versions().values())),
            "state": ctl.state, "candidate": ctl.candidate_version,
            "refs": [reg.refcount(v1), reg.refcount(v2)]}
  finally:
    os.environ.pop(ns.chaos.ENV_DEPLOY, None)
    fl.stop()


def malformed_deploy_spec_rejected_at_startup(ns, tmp):
  del tmp
  os.environ[ns.chaos.ENV_DEPLOY] = "promote@kill"
  try:
    with pytest.raises(ValueError, match="malformed deploy spec") as e:
      ns.chaos.check_config()
    ns.chaos.reset()
    os.environ[ns.chaos.ENV_DEPLOY] = "canary:poison,promote:stall:0.1"
    ns.chaos.check_config()
    return str(e.value)
  finally:
    del os.environ[ns.chaos.ENV_DEPLOY]


CASES = {f.__name__: f for f in (
    publish_get_roundtrip, torn_publish_resolves_to_previous,
    corruption_at_rest_detected, watch_sees_new_version,
    quarantine_hides_and_records, gc_respects_refs_quarantine_and_newest,
    publish_on_checkpoint_rides_save_cadence,
    republished_params_not_served_stale, on_saturated_adds_replica_up_to_cap,
    hook_off_by_default_and_cap_validated, happy_path_promotes_fleet_wide,
    poisoned_candidate_caught_quarantined_rolled_back,
    kill_mid_promote_resume_converges, kill_mid_canary_resume_keeps_baseline,
    malformed_deploy_spec_rejected_at_startup)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_deploy_matches_the_reference(pkgs, monkeypatch, tmp_path, case):
  for name in list(os.environ):
    if name.startswith(("TOS_CHAOS_", "TOS_DEPLOY_", "TOS_REGISTRY_",
                        "TOS_FLEET_")):
      monkeypatch.delenv(name)
  records = {}
  for ns in pkgs:
    jax_chaos.reset()
    port_chaos.reset()
    root = tmp_path / ns.name
    root.mkdir()
    records[ns.name] = CASES[case](ns, str(root))
  jax_chaos.reset()
  port_chaos.reset()
  assert records["torch"] == records["jax"]


def test_poison_flips_every_leaf_and_keeps_its_dtype():
  """``_poison`` on the port's flat params: ``-(a) - 1`` per leaf, numpy
  and torch alike, dtype kept, as the reference's tree map does."""
  params = {"a": np.arange(4, dtype=np.float32),
            "b": torch.arange(3, dtype=torch.bfloat16),
            "n": {"c": np.ones(2, np.float16)}}
  out = port_deploy._poison(params)
  np.testing.assert_array_equal(out["a"], -np.arange(4, dtype=np.float32) - 1)
  assert out["b"].dtype == torch.bfloat16
  assert torch.equal(out["b"], -torch.arange(3, dtype=torch.bfloat16) - 1)
  assert out["n"]["c"].dtype == np.float16
  ref = jax_deploy._poison({"a": params["a"], "n": params["n"]})
  np.testing.assert_array_equal(np.asarray(ref["a"]), out["a"])
  np.testing.assert_array_equal(np.asarray(ref["n"]["c"]), out["n"]["c"])


def test_bf16_tensors_publish_as_exact_float32(tmp_path):
  """A bf16 tensor leaf (numpy has no bfloat16) is stored as float32,
  which is exact, and the stored set verifies on read."""
  reg = port_registry.ModelRegistry(str(tmp_path))
  w = torch.randn(5, 3).to(torch.bfloat16)
  v = reg.publish({"w": w, "s": torch.ones(3)}, step=1)
  params, manifest = reg.get(v)
  assert params["w"].dtype == np.float32
  assert torch.equal(torch.from_numpy(params["w"]).to(torch.bfloat16), w)
  assert manifest["fingerprint"] == port_ckpt.params_fingerprint(
      {"w": w.float(), "s": torch.ones(3)})
