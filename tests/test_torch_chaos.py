"""The port's kill site and its acceptance path, held against the JAX package.

- ``check_config`` accepts and refuses the same kill specs as the
  reference's; an unknown ``TOS_CHAOS_*`` name raises ``ValueError``; an
  armed fault knob the port does not have yet raises
  ``NotImplementedError`` naming ROADMAP item 8;
- ``kill_point`` in a subprocess dies by SIGKILL at the nth call, and not
  again once the sentinel exists;
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


@pytest.mark.parametrize("name,value", [
    ("TOS_CHAOS_STALL", "feeder@1:3"), ("TOS_CHAOS_RV_DROP", "BEAT:3"),
    ("TOS_CHAOS_RV_DELAY", "BEAT:0.1"), ("TOS_CHAOS_SERVE", "decode#2:raise"),
    ("TOS_CHAOS_FLEET", "dispatch@1#2:kill"),
    ("TOS_CHAOS_GROUP", "kill@0#1"), ("TOS_CHAOS_DEPLOY", "promote#1:kill"),
    ("TOS_CHAOS_HOST", "sync@1#30:kill")])
def test_armed_fault_sites_not_ported_raise_naming_item_8(monkeypatch, name,
                                                          value):
  monkeypatch.setenv(name, value)
  ref_chaos.check_config()              # a fault the reference would inject
  for call in (chaos.check_config, chaos.enabled,
               lambda: chaos.kill_point("p", 0)):
    chaos.reset()
    with pytest.raises(NotImplementedError, match="item 8"):
      call()


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
