"""The port's fault injection and its acceptance paths, held against the
JAX package.

- ``check_config`` accepts and refuses the same specs as the reference's
  for every knob the port injects (kill, stall, rendezvous drop and delay,
  serve, fleet, deploy, host), with the same messages; an unknown
  ``TOS_CHAOS_*`` name raises ``ValueError``; ``GROUP`` raises
  ``NotImplementedError`` naming ROADMAP item 10;
- the same call sequences through both modules' ``serve_fault``,
  ``fleet_fault``, ``deploy_fault``, ``host_fault``, ``stall_point`` and
  ``message_fault`` give the same verdicts (raises, kills, poisons,
  partitions, seconds slept, drops and delays);
- ``kill_point`` in a subprocess dies by SIGKILL at the nth call, and not
  again once the sentinel exists;
- the fault sites on the port's runtime: dropped beats read as a dead node
  by the rendezvous server, then live again once the budget is spent
  (``tests/test_chaos.py:202``); a stalled feeder delays the feed without
  losing a row (``:581``);
- the acceptance path of ``tests/test_chaos.py:319-387`` on the port: 2
  LocalEngine executors, executor 0 SIGKILLed at step 2 by the kill site,
  relaunched by the supervisor, resumed from its checkpoint through
  ``ctx.checkpoint_manager``, both reaching the last step.
"""

import multiprocessing as mp
import os
import signal
import time

import pytest

from tensorflowonspark_tpu.utils import chaos as ref_chaos
from tensorflowonspark_tpu_torch import cluster as port_cluster
from tensorflowonspark_tpu_torch.cluster import InputMode
from tensorflowonspark_tpu_torch.control import rendezvous
from tensorflowonspark_tpu_torch.engine import LocalEngine
from tensorflowonspark_tpu_torch.utils import chaos

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _fresh_chaos(monkeypatch):
  for name in list(os.environ):
    if name.startswith("TOS_CHAOS_"):
      monkeypatch.delenv(name)
  chaos.reset()
  ref_chaos.reset()
  yield
  chaos.reset()
  ref_chaos.reset()


def _verdict(module):
  try:
    module.check_config()
    return "ok"
  except ValueError:
    return "ValueError"
  finally:
    module.reset()


KILL_SPECS = ["train-step@0#3", "p", "p@1", "p#2", "a@0#1, b@1#2", "p@x",
              "p#", "p#two", "p@1#2#3", "@@", "p@-1#0", " , p@2 ,", "p@1.5"]


@pytest.mark.parametrize("spec", KILL_SPECS)
def test_kill_specs_accepted_and_refused_as_the_reference(monkeypatch, spec):
  monkeypatch.setenv(chaos.ENV_KILL, spec)
  assert _verdict(chaos) == _verdict(ref_chaos)


def test_unknown_knob_raises_as_the_reference(monkeypatch):
  monkeypatch.setenv("TOS_CHAOS_KIL", "p#1")
  with pytest.raises(ValueError, match="unknown chaos env var"):
    chaos.check_config()
  chaos.reset()
  # the kill hook's first consult sees it too
  with pytest.raises(ValueError, match="TOS_CHAOS_KIL"):
    chaos.kill_point("p")
  assert chaos._KNOWN_ENV == ref_chaos._KNOWN_ENV


#: the knobs whose sites the port does not have yet, and the item of each
UNPORTED_ITEMS = {"TOS_CHAOS_GROUP": "10"}


def _inject(module, name):
  """Drive the fault site ``name`` arms a few times; its verdicts."""
  if name == "TOS_CHAOS_STALL":
    return [module.stall_point("feeder", index=1) for _ in range(2)]
  if name in ("TOS_CHAOS_RV_DROP", "TOS_CHAOS_RV_DELAY"):
    return [module.message_fault("BEAT") for _ in range(4)]
  if name == "TOS_CHAOS_FLEET":
    return [module.fleet_fault("dispatch", index=1) for _ in range(3)]
  if name == "TOS_CHAOS_DEPLOY":
    return [module.deploy_fault("promote", index=r) for r in (0, 1, 1)]
  if name == "TOS_CHAOS_HOST":
    return [module.host_fault("sync", index=1) for _ in range(31)]
  out = []
  for _ in range(3):
    try:
      module.serve_fault("decode")
      out.append(None)
    except module.InjectedFault:
      out.append("raised")
  return out


@pytest.mark.parametrize("name,value", [
    ("TOS_CHAOS_STALL", "feeder@1:3"), ("TOS_CHAOS_RV_DROP", "BEAT:3"),
    ("TOS_CHAOS_RV_DELAY", "BEAT:0.1"), ("TOS_CHAOS_SERVE", "decode#2:raise"),
    ("TOS_CHAOS_FLEET", "dispatch@1#2:kill"),
    ("TOS_CHAOS_GROUP", "kill@0#1"), ("TOS_CHAOS_DEPLOY", "promote#1:kill"),
    ("TOS_CHAOS_HOST", "sync@1#30:kill")])
def test_armed_fault_sites_not_ported_raise_naming_item_8(monkeypatch, name,
                                                          value):
  """Each knob the reference injects: the port injects it the same way
  (DEPLOY and HOST since their sites were ported), or (GROUP) refuses it
  at every consult, naming the ROADMAP item that ports its site."""
  monkeypatch.setenv(name, value)
  monkeypatch.setattr(time, "sleep", lambda s: None)
  ref_chaos.check_config()              # a fault the reference would inject
  calls = (chaos.check_config, chaos.enabled, lambda: chaos.kill_point("p", 0))
  item = UNPORTED_ITEMS.get(name)
  if item is None:
    for call in calls:
      chaos.reset()
      call()
    chaos.reset()
    assert chaos.enabled()
    assert _inject(chaos, name) == _inject(ref_chaos, name)
    return
  for call in calls:
    chaos.reset()
    with pytest.raises(NotImplementedError,
                       match=r"%s .*item %s\b" % (name, item)):
      call()


#: (knob, spec, call sequence): each call is (hook, point, index)
GRAMMAR = [
    ("TOS_CHAOS_SERVE", "decode#2:raise", [("serve", "decode", None)] * 4),
    ("TOS_CHAOS_SERVE", "prefill@13#1:raise,prefill@13#2:raise",
     [("serve", "prefill", 5), ("serve", "prefill", 13),
      ("serve", "prefill", 8), ("serve", "prefill", 13),
      ("serve", "prefill", 13)]),
    ("TOS_CHAOS_SERVE", "prefill#3:raise",
     [("serve", "prefill", 5), ("serve", "prefill", 13),
      ("serve", "prefill", 5), ("serve", "decode", None)]),
    ("TOS_CHAOS_SERVE", "decode#1:stall:0.5,decode#3:raise",
     [("serve", "decode", None)] * 3 + [("serve", "prefill", 2)]),
    ("TOS_CHAOS_FLEET", "dispatch@1#3:kill",
     [("fleet", "dispatch", r) for r in (0, 1, 1, 0, 1, 1)]),
    ("TOS_CHAOS_FLEET", "dispatch#2:kill,dispatch@0#2:stall:0.2",
     [("fleet", "dispatch", r) for r in (1, 0, 0, 0)]),
    ("TOS_CHAOS_DEPLOY", "promote#1:kill",
     [("deploy", "canary", 3), ("deploy", "verify", 3),
      ("deploy", "promote", 1), ("deploy", "promote", 2)]),
    ("TOS_CHAOS_DEPLOY", "canary:poison,promote@2#1:kill,verify#1:stall:0.3",
     [("deploy", "canary", 4), ("deploy", "verify", 4),
      ("deploy", "promote", 1), ("deploy", "promote", 2),
      ("deploy", "canary", 5), ("deploy", "rollback", 5)]),
    ("TOS_CHAOS_HOST", "decode@1#3:kill",
     [("host", p, h) for p, h in (("sync", 1), ("decode", 0), ("decode", 1),
                                  ("decode", 1), ("sync", 1), ("decode", 1),
                                  ("decode", 1))]),
    ("TOS_CHAOS_HOST", "sync@0#2:partition:1.5,sync#3:stall:0.2",
     [("host", "sync", h) for h in (0, 1, 0, 1, 0)]),
    ("TOS_CHAOS_STALL", "feeder@1:3,feeder:0.5",
     [("stall", "feeder", r) for r in (0, 1, 1, 2, 0)]),
    ("TOS_CHAOS_STALL", "feeder@2:1.5", [("stall", "feeder", r)
                                         for r in (1, 2, 2)]),
    ("TOS_CHAOS_RV_DROP", "BEAT:2,RESV:1",
     [("message", v, None) for v in ("BEAT", "RESV", "BEAT", "QUERY", "BEAT",
                                     "RESV")]),
    ("TOS_CHAOS_RV_DELAY", "BEAT:0.25:2,QUERY:1.5",
     [("message", v, None) for v in ("BEAT", "QUERY", "BEAT", "BEAT",
                                     "QUERY")]),
]


def _run_calls(module, calls, slept):
  out = []
  for hook, point, index in calls:
    del slept[:]
    if hook == "serve":
      try:
        module.serve_fault(point, index=index)
        verdict = None
      except module.InjectedFault as e:
        verdict = str(e)
    elif hook == "fleet":
      verdict = module.fleet_fault(point, index)
    elif hook == "deploy":
      verdict = module.deploy_fault(point, index)
    elif hook == "host":
      verdict = module.host_fault(point, index)
    elif hook == "stall":
      verdict = module.stall_point(point, index=index)
    else:
      verdict = module.message_fault(point)
    out.append((verdict, list(slept)))
  return out


@pytest.mark.parametrize("name,spec,calls", GRAMMAR,
                         ids=["%s-%d" % (g[0][11:].lower(), i)
                              for i, g in enumerate(GRAMMAR)])
def test_fault_verdicts_equal_the_reference(monkeypatch, name, spec, calls):
  """The same call sequence through both modules: the same raises, kill
  verdicts, seconds slept, drops and delays, call by call."""
  slept = []
  monkeypatch.setattr(time, "sleep", slept.append)
  monkeypatch.setenv(name, spec)
  got = _run_calls(chaos, calls, slept)
  want = _run_calls(ref_chaos, calls, slept)
  assert got == want
  assert any(v != (None, []) and v != (0.0, []) and v != ((False, 0.0), [])
             for v in want), "the spec injected nothing"


MALFORMED = [
    ("TOS_CHAOS_STALL", "feeder@1"), ("TOS_CHAOS_STALL", "feeder:x"),
    ("TOS_CHAOS_STALL", "feeder@a:1"), ("TOS_CHAOS_RV_DROP", "BEAT;3"),
    ("TOS_CHAOS_RV_DROP", ":3"), ("TOS_CHAOS_RV_DROP", "BEAT:1:2"),
    ("TOS_CHAOS_RV_DELAY", "BEAT"), ("TOS_CHAOS_RV_DELAY", "BEAT:0.1:x"),
    ("TOS_CHAOS_RV_DELAY", "BEAT:1:2:3"), ("TOS_CHAOS_SERVE", "decode#2"),
    ("TOS_CHAOS_SERVE", "decode#2:kill"),
    ("TOS_CHAOS_SERVE", "decode:stall"),
    ("TOS_CHAOS_SERVE", "decode:raise:1"), ("TOS_CHAOS_SERVE", ":raise"),
    ("TOS_CHAOS_FLEET", "dispatch@1#2:raise"),
    ("TOS_CHAOS_FLEET", "dispatch:kill:3"),
    ("TOS_CHAOS_FLEET", "dispatch@x:kill"),
    ("TOS_CHAOS_FLEET", "dispatch:stall:slow"),
    ("TOS_CHAOS_DEPLOY", "canary#1:raise"),
    ("TOS_CHAOS_DEPLOY", "promote:poison:2"),
    ("TOS_CHAOS_DEPLOY", "verify:stall"),
    ("TOS_CHAOS_DEPLOY", ":kill"),
    ("TOS_CHAOS_HOST", "sync@1:partition"),
    ("TOS_CHAOS_HOST", "decode@1#3:poison"),
    ("TOS_CHAOS_HOST", "sync:kill:1"),
    ("TOS_CHAOS_HOST", "sync@x:stall:1")]


@pytest.mark.parametrize("name,spec", MALFORMED,
                         ids=["%s-%d" % (m[0][11:].lower(), i)
                              for i, m in enumerate(MALFORMED)])
def test_malformed_specs_refused_as_the_reference(monkeypatch, name, spec):
  monkeypatch.setenv(name, spec)
  with pytest.raises(ValueError) as want:
    ref_chaos.check_config()
  with pytest.raises(ValueError) as got:
    chaos.check_config()
  assert str(got.value) == str(want.value)


def test_disarmed_kill_point_is_a_noop(tmp_path, monkeypatch):
  monkeypatch.chdir(tmp_path)
  assert not chaos.enabled()
  chaos.kill_point("anything", index=3)
  monkeypatch.setenv(chaos.ENV_KILL, "p@1#1")
  assert chaos.enabled()
  for _ in range(3):
    chaos.kill_point("p", index=0)      # wrong index: no kill
    chaos.kill_point("q", index=1)      # wrong point: no kill
  assert os.listdir(str(tmp_path)) == []
  assert chaos._sentinel_path("p", 1) == os.path.join(
      str(tmp_path), ".tos_chaos_fired_p_1")


def _kill_victim(spec, cwd):
  """Child entry point (module level: spawn pickles it by name)."""
  os.chdir(cwd)
  os.environ[chaos.ENV_KILL] = spec
  for _ in range(5):
    chaos.kill_point("p", index=1)
  os._exit(7)   # only reached if the kill never fired


def test_kill_point_sigkills_on_nth_invocation_once(tmp_path):
  ctx = mp.get_context("spawn")
  for want in (-signal.SIGKILL, 7):
    p = ctx.Process(target=_kill_victim, args=("p@1#3", str(tmp_path)))
    p.start()
    p.join(timeout=60)
    assert p.exitcode == want
  with open(str(tmp_path / ".tos_chaos_fired_p_1")) as f:
    assert f.read().startswith("fired at count 3 ")


# -- the fault sites on the port's runtime -------------------------------------


def test_dropped_beats_mark_dead_then_recover(monkeypatch):
  """Chaos-dropped BEATs drive the node dead on the server; once the drop
  budget is spent, the next beat revives it (``tests/test_chaos.py:202``
  on the port's rendezvous)."""
  s = rendezvous.Server(1, heartbeat_interval=0.1)
  addr = s.start()
  sender = None
  try:
    c = rendezvous.Client(addr)
    c.register({"executor_id": 0, "host": "h", "port": 1})
    sender = rendezvous.HeartbeatSender(addr, 0, interval=0.05).start()
    assert s.liveness.state(0) == "live"   # first beat confirmed the node
    monkeypatch.setenv(chaos.ENV_RV_DROP, "BEAT:200")
    deadline = time.monotonic() + 3
    while s.liveness.state(0) != "dead" and time.monotonic() < deadline:
      time.sleep(0.01)
    assert s.liveness.state(0) == "dead", "dropped beats never marked dead"
    dropped = c._request({"type": "BEAT", "executor_id": 0})
    assert dropped == {"type": "DROPPED", "dropped": True, "done": False}
    monkeypatch.delenv(chaos.ENV_RV_DROP)
    deadline = time.monotonic() + 3
    while s.liveness.state(0) != "live" and time.monotonic() < deadline:
      time.sleep(0.01)
    assert s.liveness.state(0) == "live", "beats resumed but state stuck"
    c.close()
  finally:
    if sender is not None:
      sender.stop()
    s.stop()


def _summing_main_fn(args, ctx):
  """Sum every fed row into the executor's working dir (module level: the
  port pickles a main fn by name)."""
  feed = ctx.get_data_feed(train_mode=True)
  total = 0
  while not feed.should_stop():
    for x in feed.next_batch(16):
      total += x
  with open("stall_total.txt", "w") as f:
    f.write(str(total))


def test_feeder_stall_injection():
  """The feeder's stall point is wired: an armed stall delays the feed
  without breaking delivery (``tests/test_chaos.py:581`` on the port)."""
  engine = LocalEngine(num_executors=2,
                       env={chaos.ENV_STALL: "feeder:0.3"})
  try:
    c = port_cluster.run(engine, _summing_main_fn,
                         input_mode=InputMode.SPARK, reservation_timeout=60,
                         feed_transport="queue")
    t0 = time.monotonic()
    c.train([[1] * 10, [2] * 10], num_epochs=1, feed_timeout=60)
    assert time.monotonic() - t0 >= 0.3, "stall point never fired"
    c.shutdown(timeout=300)
    grand = 0
    for slot in range(2):
      path = os.path.join(engine.executor_workdir(slot), "stall_total.txt")
      if os.path.exists(path):
        with open(path) as f:
          grand += int(f.read())
    assert grand == 30
  finally:
    engine.stop()


# -- the acceptance path ---------------------------------------------------------


def _resuming_main_fn(args, ctx):
  """Checkpointed training loop with a kill site at each step."""
  import numpy as np
  from tensorflowonspark_tpu_torch.utils import chaos as _chaos

  mgr = ctx.checkpoint_manager(
      os.path.join(args["ckpt_root"], str(ctx.executor_id)),
      save_interval_steps=1, max_to_keep=2)
  state = {"value": np.zeros(())}
  state, start_step = mgr.restore_or(state)
  for step in range(start_step, args["num_steps"]):
    state = {"value": state["value"] + 1.0}
    ctx.report_progress(step)
    mgr.save(step, state, force=True)
    mgr.wait()             # durable before the kill site: resume is exact
    _chaos.kill_point("train-step", index=ctx.executor_id)
  mgr.close()
  with open("train_done.txt", "w") as f:
    f.write("%d:%d:%d" % (ctx.restart_count, start_step,
                          int(state["value"])))


def test_sigkill_mid_training_recovers_and_resumes(tmp_path):
  """A worker SIGKILLed mid-training is detected dead, relaunched on its
  executor, resumes from its latest checkpoint and reaches the same final
  step as the worker that was not killed."""
  num_steps = 4
  hb = 0.25
  engine = LocalEngine(num_executors=2,
                       env={chaos.ENV_KILL: "train-step@0#2"})
  try:
    t0 = time.monotonic()
    c = port_cluster.run(
        engine, _resuming_main_fn,
        tf_args={"ckpt_root": str(tmp_path), "num_steps": num_steps},
        input_mode=InputMode.FILES, reservation_timeout=60,
        heartbeat_interval=hb, max_restarts=2,
        restart_backoff=0.2, restart_backoff_cap=1.0)
    c.shutdown(timeout=300)     # must not raise: the failure was recovered
    elapsed = time.monotonic() - t0

    results = {}
    for slot in range(2):
      path = os.path.join(engine.executor_workdir(slot), "train_done.txt")
      assert os.path.exists(path), "worker on slot %d never finished" % slot
      with open(path) as f:
        results[slot] = tuple(map(int, f.read().split(":")))
    # executor 0 was killed after step 1 and resumed at step 2
    assert results == {0: (1, 2, num_steps), 1: (0, 0, num_steps)}, results

    sup = c.supervisor
    assert sup is not None and sup.restarts == {0: 1}, sup.restarts
    kinds = [e["kind"] for e in sup.events if e["executor_id"] == 0]
    assert kinds[:3] == ["detected-dead", "relaunched", "recovered"], kinds
    ev = {e["kind"]: e["t"] for e in sup.events if e["executor_id"] == 0}
    assert ev["relaunched"] - ev["detected-dead"] <= 1.0 * 1.5 + 0.5
    assert elapsed < 120, "recovery path took pathologically long"
  finally:
    engine.stop()
