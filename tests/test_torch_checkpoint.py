"""The port's checkpoint manager, fingerprint and export, held against the
JAX package on the CPU.

- the reference's and the port's ``CheckpointManager`` driven through the
  same ``save`` calls (per step, and at slab boundaries of several
  unrolls) make the same decisions, keep the same steps and write the
  same commit markers, byte for byte; ``restore_or`` resumes at the same
  step, also past a step whose marker is gone;
- the contract subset of ``tests/test_readers_checkpoint.py``'s
  ``TestCheckpointManager`` and ``tests/test_train_loop.py``'s cadence
  tests, on the port;
- a 2-layer narrow ``TrainState`` saved at step k and restored into a
  fresh state takes the next step exactly as the uninterrupted run does
  (AdamW, Lion, SGD, and AdamW with gradient accumulation);
- ``params_fingerprint``; ``export_model`` / ``import_model`` on the
  chief and off it; a save in a 2-rank gloo process group.
"""

import json
import multiprocessing as mp
import os
import socket

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.utils import checkpoint as ref_ckpt
from tensorflowonspark_tpu_torch import optim
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.parallel import sharding
from tensorflowonspark_tpu_torch.utils import checkpoint, compat
from tensorflowonspark_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                          params_fingerprint)


def _markers(directory):
  """{marker name: its bytes} of a checkpoint directory."""
  out = {}
  for name in sorted(os.listdir(directory)):
    if name.startswith(".commit-") and name.endswith(".json"):
      with open(os.path.join(directory, name), "rb") as f:
        out[name] = f.read()
  return out


# -- the same save calls through both managers ---------------------------------

CADENCES = [(1, 1), (2, 1), (3, 1), (5, 2), (5, 8), (3, 4), (4, 4)]


@pytest.mark.parametrize("interval,unroll", CADENCES)
def test_same_decisions_steps_and_markers_as_the_reference(tmp_path, interval,
                                                           unroll):
  rng = np.random.default_rng(interval * 10 + unroll)
  steps = list(range(unroll - 1, 8 * unroll, unroll))
  mgrs = {"ref": ref_ckpt.CheckpointManager(str(tmp_path / "ref"),
                                            save_interval_steps=interval,
                                            max_to_keep=3),
          "port": CheckpointManager(str(tmp_path / "port"),
                                    save_interval_steps=interval,
                                    max_to_keep=3)}
  saved = {k: [] for k in mgrs}
  for i, step in enumerate(steps):
    w = rng.standard_normal(4).astype("float32")
    manifest = {"slab": i} if i % 2 else None
    for k, m in mgrs.items():
      saved[k].append(bool(m.save(step, {"w": w}, manifest=manifest)))
  for m in mgrs.values():
    m.wait()
  assert saved["port"] == saved["ref"], saved
  assert mgrs["port"].all_steps() == mgrs["ref"].all_steps()
  assert mgrs["port"].latest_step() == mgrs["ref"].latest_step()
  assert _markers(tmp_path / "port") == _markers(tmp_path / "ref")
  last = mgrs["ref"].latest_step()
  assert mgrs["port"].manifest() == mgrs["ref"].manifest()

  # a fresh manager of each resumes at the same step with the same weights
  def resume(k):
    cls = CheckpointManager if k == "port" else ref_ckpt.CheckpointManager
    got, nxt = cls(str(tmp_path / k), save_interval_steps=interval) \
        .restore_or({"w": np.zeros(4, "float32")})
    return np.asarray(got["w"]), nxt

  (pw, pn), (rw, rn) = resume("port"), resume("ref")
  assert pn == rn == last + 1
  np.testing.assert_array_equal(pw, rw)
  # the newest step loses its marker in both: both fall back to the one
  # before it
  for k in mgrs:
    os.remove(os.path.join(str(tmp_path / k), ".commit-%d.json" % last))
  (pw, pn), (rw, rn) = resume("port"), resume("ref")
  assert pn == rn == mgrs["ref"].all_steps()[-2] + 1
  np.testing.assert_array_equal(pw, rw)


def test_non_chief_and_non_advancing_steps_decide_as_the_reference(tmp_path):
  ref = ref_ckpt.CheckpointManager(str(tmp_path / "ref"),
                                   save_interval_steps=2)
  port = CheckpointManager(str(tmp_path / "port"), save_interval_steps=2)
  calls = [(0, True, False), (1, True, False), (1, True, True),
           (2, False, False), (2, True, False), (2, True, False),
           (0, True, False), (7, True, False), (8, True, False),
           (9, True, True)]
  state = {"w": np.ones(2, "float32")}
  got = [(bool(port.save(s, state, is_chief=c, force=f)),
          bool(ref.save(s, state, is_chief=c, force=f)))
         for s, c, f in calls]
  ref.wait()
  assert [p for p, _ in got] == [r for _, r in got], got
  assert port.all_steps() == ref.all_steps()
  assert _markers(tmp_path / "port") == _markers(tmp_path / "ref")


# -- the contract subset on the port -------------------------------------------


def test_save_restore_resume(tmp_path):
  state = {"w": torch.arange(4.0), "step_scale": torch.tensor(1.0)}
  mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=2,
                          max_to_keep=2)
  for step in range(6):
    state = {"w": state["w"] + 1, "step_scale": state["step_scale"]}
    mgr.save(step, state, is_chief=True)
  mgr.wait()
  assert mgr.latest_step() == 4
  assert mgr.all_steps() == [2, 4]
  assert mgr.last_save["bytes"] == sum(
      os.path.getsize(os.path.join(str(tmp_path / "ckpt" / "4"), n))
      for n in os.listdir(str(tmp_path / "ckpt" / "4")))
  assert set(mgr.last_save) == {"bytes", "host_s", "write_s", "commit_s"}
  fresh = {"w": torch.zeros(4), "step_scale": torch.tensor(0.0)}
  w = fresh["w"]
  restored, next_step = CheckpointManager(
      str(tmp_path / "ckpt"), save_interval_steps=2).restore_or(fresh)
  assert next_step == 5
  assert restored["w"] is w, "restore must write into the template's tensor"
  np.testing.assert_array_equal(restored["w"].numpy(), np.arange(4.0) + 5)


def test_reader_manager_sees_other_writers_saves(tmp_path):
  reader = CheckpointManager(str(tmp_path / "c"), save_interval_steps=1)
  assert reader.latest_step() is None
  writer = CheckpointManager(str(tmp_path / "c"), save_interval_steps=1)
  writer.save(3, {"w": np.arange(4.0)}, is_chief=True)
  assert reader.latest_step(refresh=True) == 3
  got = reader.restore({"w": np.zeros(4)}, step=3)
  np.testing.assert_array_equal(got["w"], np.arange(4.0))


def test_non_chief_never_writes(tmp_path):
  mgr = CheckpointManager(str(tmp_path / "c2"), save_interval_steps=1)
  assert not mgr.save(0, {"w": torch.zeros(2)}, is_chief=False)
  assert mgr.latest_step() is None


def test_restore_or_fresh_start(tmp_path):
  mgr = CheckpointManager(str(tmp_path / "c3"))
  state, step = mgr.restore_or({"w": torch.ones(2)})
  assert step == 0
  np.testing.assert_array_equal(state["w"].numpy(), [1, 1])


def _truncate_files(directory):
  for root, _, names in os.walk(directory):
    for name in names:
      p = os.path.join(root, name)
      if os.path.getsize(p):
        with open(p, "r+b") as f:
          f.truncate(os.path.getsize(p) // 2)


def test_torn_save_without_marker_restores_previous_step(tmp_path):
  mgr = CheckpointManager(str(tmp_path / "torn"), save_interval_steps=1,
                          max_to_keep=3)
  for step in (1, 2):
    assert mgr.save(step, {"w": torch.full((4,), float(step))})
  os.remove(str(tmp_path / "torn" / ".commit-2.json"))
  _truncate_files(str(tmp_path / "torn" / "2"))
  restored, next_step = CheckpointManager(
      str(tmp_path / "torn"), save_interval_steps=1).restore_or(
          {"w": torch.zeros(4)})
  assert next_step == 2, "the unmarked (torn) step must be rejected"
  np.testing.assert_array_equal(restored["w"].numpy(), np.ones(4))


def test_marker_free_directory_keeps_the_load_failure_fallback(tmp_path):
  mgr = CheckpointManager(str(tmp_path / "old"), save_interval_steps=1)
  for step in (3, 4):
    assert mgr.save(step, {"w": torch.arange(4.0) + step})
  for name in os.listdir(str(tmp_path / "old")):
    if name.startswith(".commit-"):
      os.remove(str(tmp_path / "old" / name))
  fresh = CheckpointManager(str(tmp_path / "old"), save_interval_steps=1)
  restored, next_step = fresh.restore_or({"w": torch.zeros(4)})
  assert next_step == 5                   # the newest step, no marker needed
  _truncate_files(str(tmp_path / "old" / "4"))
  restored, next_step = fresh.restore_or({"w": torch.zeros(4)})
  assert next_step == 4                   # past the unreadable step
  np.testing.assert_array_equal(restored["w"].numpy(), np.arange(4.0) + 3)


def test_restore_or_raises_when_every_step_fails(tmp_path):
  mgr = CheckpointManager(str(tmp_path / "c"), save_interval_steps=1)
  for step in (0, 1):
    assert mgr.save(step, {"w": torch.zeros(4)})
  template = {"w": torch.zeros(5)}
  with pytest.raises(ValueError, match="shape"):
    mgr.restore_or(template)
  assert template["w"].shape == (5,)
  with pytest.raises(ValueError, match="keys"):
    mgr.restore_or({"v": torch.zeros(4)})


def test_manifest_rides_the_commit_marker(tmp_path):
  mgr = CheckpointManager(str(tmp_path / "mf"), save_interval_steps=1)
  assert mgr.save(5, {"w": torch.zeros(2)},
                  manifest={"num_groups": 2, "groups": [0, 1]})
  reader = CheckpointManager(str(tmp_path / "mf"), save_interval_steps=1)
  assert reader.manifest() == {"num_groups": 2, "groups": [0, 1]}
  _, next_step, manifest = reader.restore_or({"w": torch.zeros(2)},
                                             with_manifest=True)
  assert next_step == 6 and manifest["num_groups"] == 2
  with open(str(tmp_path / "mf" / ".commit-5.json")) as f:
    assert json.load(f) == {"step": 5, "manifest": {"num_groups": 2,
                                                    "groups": [0, 1]}}


def test_data_state_rides_the_step_and_publish_hook_is_best_effort(tmp_path):
  published = []

  def hook(step, state, manifest):
    published.append(step)
    raise RuntimeError("registry down")

  mgr = CheckpointManager(str(tmp_path / "d"), save_interval_steps=1,
                          publish_hook=hook)
  assert mgr.save(0, {"w": torch.ones(2)}, data_state={"position": 7})
  assert mgr.save(1, {"w": torch.ones(2)})
  assert published == [0, 1]
  assert mgr.restore({"w": torch.zeros(2)}, step=0, with_data=True)[1] == \
      {"position": 7}
  assert mgr.restore({"w": torch.zeros(2)}, with_data=True)[1] is None


def test_cadence_at_slab_boundaries(tmp_path):
  """``tests/test_train_loop.py``'s cadence cases on the port: the save
  fires at the first slab boundary at or past each interval crossing."""
  state = {"w": np.ones((2,), "float32")}
  mgr = CheckpointManager(str(tmp_path / "a"), save_interval_steps=5)
  assert [s for s in range(8, 41, 8) if mgr.save(s, state)] == \
      [8, 16, 24, 32, 40]
  mgr = CheckpointManager(str(tmp_path / "b"), save_interval_steps=5)
  assert [s for s in range(2, 21, 2) if mgr.save(s, state)] == \
      [2, 6, 10, 16, 20]


def test_numpy_and_python_leaves_round_trip(tmp_path):
  Pair = optim.AdamState
  tree = {"a": np.arange(6, dtype="int64").reshape(2, 3),
          "s": np.float32(3.5), "n": 4, "f": 0.25, "none": None,
          "t": (torch.tensor([1.0, 2.0], dtype=torch.bfloat16), "x"),
          "l": [torch.ones(1)], "adam": Pair(optim._Count(), [torch.ones(2)],
                                            [torch.zeros(2)])}
  tree["adam"].count.count = 9
  checkpoint.save_tree(str(tmp_path / "t"), tree)
  blank = {"a": np.zeros((2, 3), "int64"), "s": np.float32(0), "n": 0,
           "f": 0.0, "none": None,
           "t": (torch.zeros(2, dtype=torch.bfloat16), ""),
           "l": [torch.zeros(1)], "adam": Pair(optim._Count(), [torch.zeros(2)],
                                              [torch.ones(2)])}
  got = checkpoint.load_tree(str(tmp_path / "t"), blank)
  np.testing.assert_array_equal(got["a"], tree["a"])
  assert got["s"] == np.float32(3.5) and isinstance(got["s"], np.float32)
  assert (got["n"], got["f"], got["none"]) == (4, 0.25, None)
  assert got["t"][1] == "x" and got["t"][0].dtype == torch.bfloat16
  assert torch.equal(got["t"][0], tree["t"][0])
  assert got["adam"].count is blank["adam"].count and \
      got["adam"].count.count == 9
  assert torch.equal(got["adam"].nu[0], torch.zeros(2))
  plain = checkpoint.load_tree(str(tmp_path / "t"))
  assert plain["adam"]["count"] == {"count": 9}
  assert plain["n"] == 4 and isinstance(plain["t"], tuple)


# -- the fingerprint -------------------------------------------------------------


def test_params_fingerprint_sees_every_leaf():
  rng = np.random.default_rng(0)
  base = {"a": rng.standard_normal((3, 4)).astype("float32"),
          "b": rng.standard_normal(5).astype("float32")}
  as_torch = {k: torch.from_numpy(v.copy()) for k, v in base.items()}
  as_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in base.items()}
  fp = params_fingerprint(as_torch)
  assert fp == params_fingerprint({k: torch.from_numpy(v.copy())
                                   for k, v in base.items()})
  assert fp == params_fingerprint(as_params)
  assert fp == params_fingerprint(base)
  for name in base:
    changed = dict(as_torch)
    changed[name] = changed[name].clone()
    changed[name].view(-1)[2] += 1e-6
    assert params_fingerprint(changed) != fp, name
  assert params_fingerprint({"a": as_torch["b"], "b": as_torch["a"]}) != fp
  assert params_fingerprint({"a": as_torch["a"],
                             "c": as_torch["b"]}) != fp
  assert params_fingerprint({k: v.double() for k, v in as_torch.items()}) \
      != fp


# -- a TrainState saved and resumed ----------------------------------------------

SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
             max_seq_len=32, dtype=torch.float32)
OPTIMIZERS = [dict(optimizer="adamw"), dict(optimizer="lion"),
              dict(optimizer="sgd"), dict(optimizer="adamw",
                                          grad_accum_steps=2),
              dict(optimizer="adafactor")]
# Adafactor factors a kernel only past a second-largest dim of 127: at
# d_model 128 the MLP's kernels are factored, the attention's are not
WIDE = dict(d_model=128, d_ff=256)


def _state(opt):
  tx = optim.make_optimizer(learning_rate=1e-2, clip_norm=1.0,
                            warmup_steps=2, decay_steps=10,
                            schedule="cosine", **opt)
  wide = WIDE if opt["optimizer"] == "adafactor" else {}
  return tfm.create_state(tfm.TransformerConfig(**dict(SMALL, **wide)), 0,
                          tx=tx, device="cpu")


def _batches(n):
  rng = np.random.default_rng(3)
  return [rng.integers(0, SMALL["vocab_size"], (2, 16)).astype("int32")
          for _ in range(n)]


@pytest.mark.parametrize("opt", OPTIMIZERS,
                         ids=["adamw", "lion", "sgd", "adamw-accum2",
                              "adafactor"])
def test_train_state_resumes_to_the_bit(tmp_path, opt):
  step = sharding.make_train_step(
      lambda m, t: tfm.causal_lm_loss(m(t), t))
  batches = _batches(6)
  k = 3
  straight = _state(opt)
  losses = []
  for i, b in enumerate(batches):
    straight, loss = step(straight, b)
    losses.append(float(loss))
    if i == k - 1:
      mgr = CheckpointManager(str(tmp_path / "ck"), save_interval_steps=1)
      assert mgr.save(i, straight)

  fresh = _state(opt)
  held = dict(fresh.params)
  resumed, start = CheckpointManager(str(tmp_path / "ck")).restore_or(fresh)
  assert resumed is fresh and start == k
  assert resumed.step == k
  assert all(resumed.params[n] is p for n, p in held.items()), \
      "restore must keep the model's parameters"
  got = []
  for b in batches[start:]:
    resumed, loss = step(resumed, b)
    got.append(float(loss))
  assert got == losses[k:]
  for name, p in straight.params.items():
    assert torch.equal(resumed.params[name], p), name
  assert params_fingerprint(resumed.params) == \
      params_fingerprint(straight.params)


def test_train_state_refuses_another_config(tmp_path):
  state = _state(OPTIMIZERS[0])
  mgr = CheckpointManager(str(tmp_path / "ck"), save_interval_steps=1)
  assert mgr.save(0, state)
  other = tfm.create_state(tfm.TransformerConfig(**dict(SMALL, d_ff=128)), 0,
                           tx=optim.make_optimizer(), device="cpu")
  before = params_fingerprint(other.params)
  with pytest.raises(ValueError, match="shape"):
    mgr.restore_or(other)
  assert params_fingerprint(other.params) == before, \
      "a refused restore must leave the template as it was"


# -- export ------------------------------------------------------------------------


def test_export_on_the_chief_and_off_it(tmp_path):
  state = _state(OPTIMIZERS[0])
  target = compat.export_model(state.params, str(tmp_path / "exp"),
                               is_chief=True)
  assert target == str(tmp_path / "exp")
  assert sorted(os.listdir(os.path.join(target, "model"))) == \
      ["state.json", "state.pt"]
  plain = compat.import_model(target)
  assert set(plain) == set(state.params)
  assert params_fingerprint(plain) == params_fingerprint(state.params)
  fresh = _state(OPTIMIZERS[0])
  with torch.no_grad():
    for p in fresh.params.values():
      p.zero_()
  compat.import_model(target, fresh.params)
  assert params_fingerprint(fresh.params) == params_fingerprint(state.params)
  # a second export replaces the first
  compat.export_model({"w": torch.ones(2)}, target, is_chief=True)
  assert set(compat.import_model(target)) == {"w"}

  other = compat.export_model(state.params, str(tmp_path / "exp2"),
                              is_chief=False)
  try:
    assert other != str(tmp_path / "exp2")
    assert not os.path.exists(str(tmp_path / "exp2"))
    assert os.path.isdir(os.path.join(other, "model"))
  finally:
    import shutil
    shutil.rmtree(other)


def test_gpu_availability_and_auto_shard_shims(monkeypatch, tmp_path):
  monkeypatch.setenv("PATH", str(tmp_path))
  assert compat.is_gpu_available() is False
  compat.disable_auto_shard(object())


# -- a process group ---------------------------------------------------------------


def _group_saver(rank, port, directory, out):
  import torch.distributed as dist
  dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                          rank=rank, world_size=2)
  try:
    mgr = CheckpointManager(directory, save_interval_steps=2)
    saved = [bool(mgr.save(s, {"w": torch.full((2,), float(rank))},
                           is_chief=False)) for s in range(5)]
    steps = mgr.all_steps()      # after the barrier: rank 0's writes landed
    with open(out % rank, "w") as f:
      json.dump({"saved": saved, "steps": steps}, f)
  finally:
    dist.destroy_process_group()


def _group_failing_saver(rank, port, directory, out):
  """Rank 0's write of step 1 fails once; step 1 is saved again after."""
  import torch.distributed as dist
  dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                          rank=rank, world_size=2)
  try:
    mgr = CheckpointManager(directory, save_interval_steps=1)
    real, failed = checkpoint.save_tree, []

    def disk_full(path, tree):
      if os.path.basename(path).startswith(".1.tmp-") and not failed:
        failed.append(path)
        raise OSError("No space left on device")
      return real(path, tree)

    checkpoint.save_tree = disk_full
    outcomes = []
    for s in (0, 1, 1, 2):
      try:
        outcomes.append(bool(mgr.save(s, {"w": torch.full((2,), float(s))})))
      except (OSError, RuntimeError) as e:
        outcomes.append(type(e).__name__)
    with open(out % rank, "w") as f:
      json.dump({"outcomes": outcomes, "steps": mgr.all_steps()}, f)
  finally:
    dist.destroy_process_group()


def _run_two_ranks(target, tmp_path):
  """``target(rank, port, directory, out)`` in 2 spawned gloo ranks; each
  rank's JSON record."""
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
  ctx = mp.get_context("spawn")
  out = str(tmp_path / "rank%d.json")
  procs = [ctx.Process(target=target,
                       args=(r, port, str(tmp_path / "ck"), out))
           for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(timeout=120)
  assert [p.exitcode for p in procs] == [0, 0]
  got = []
  for r in range(2):
    with open(out % r) as f:
      got.append(json.load(f))
  return got


def test_process_group_save_failure_raises_on_every_rank(tmp_path):
  """A write that fails on rank 0 raises on both ranks, none blocks, and
  the step is not taken as saved: saving it again writes it."""
  got = _run_two_ranks(_group_failing_saver, tmp_path)
  assert got[0] == {"outcomes": [True, "OSError", True, True],
                    "steps": [0, 1, 2]}, got[0]
  assert got[1] == {"outcomes": [True, "RuntimeError", True, True],
                    "steps": [0, 1, 2]}, got[1]


def test_process_group_save_rank0_writes_after_a_barrier(tmp_path):
  for r, got in enumerate(_run_two_ranks(_group_saver, tmp_path)):
    # every rank decides alike (is_chief is ignored in a group) and sees
    # rank 0's steps when save returns
    assert got == {"saved": [True, False, True, False, True],
                   "steps": [0, 2, 4]}, (r, got)
  restored = CheckpointManager(str(tmp_path / "ck")).restore(
      {"w": torch.zeros(2)})
  np.testing.assert_array_equal(restored["w"].numpy(), [0.0, 0.0])
