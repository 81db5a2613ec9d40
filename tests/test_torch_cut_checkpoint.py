"""Checkpoints, restores and exports of train states cut over fsdp,
tensor and expert, in gloo processes against the JAX package on the 8
virtual CPU devices.

Two groups of ranks, spawned once for the module (2 ranks and 4 ranks,
side by side, from the jax-free helper ``torch_cut_ckpt_ranks``), run
four cases: ``train_gpt --fsdp 2`` (AdamW), ``--tp 2 --fused`` (the
fused QKV weight stored per rank in ``[q_r | k_r | v_r]`` order, and its
moments), ``--fsdp 2 --tp 2 --optimizer adafactor`` at widths Adafactor
factors (row and column statistics over cut dimensions) and a MoE
Transformer cut over ``data`` x ``expert`` (SGD with momentum). Each
trains 2 steps on its mesh A, saves (every rank calls, rank 0 writes the
whole state), exports and publishes; restores onto A, onto another mesh
B and, in this process, onto one process; restores a checkpoint written
by one process onto A; and takes step 3 each time. The JAX package runs
the uninterrupted 3 steps on mesh A meanwhile (``make_train_step``, as
``tests/test_torch_spmd.py`` and ``tests/test_torch_expert_parallel.py``
run it): every restored run's losses and gathered weights are held to
it within 1e-5, and a restore onto A to the port's own uninterrupted run
to the bit.
"""

import json
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import optim
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.parallel import sharding
from tensorflowonspark_tpu_torch.serving.registry import ModelRegistry
from tensorflowonspark_tpu_torch.train_state import TrainState
from tensorflowonspark_tpu_torch.utils import checkpoint, compat
from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port

import torch_cut_ckpt_ranks as R

TRAIN_TOL = 1e-5       # f32 losses and weights after 3 steps
CASES = [(n, name) for n in (2, 4) for name in R.CASES[n]]
IDS = [c[1] for c in CASES]
WHERE = ("onto_a", "one_process", "onto_b", "from_one")


def _jax_reference(name):
  """The JAX package's uninterrupted 3 steps on mesh A: (losses, weights
  as the port names them)."""
  a_flags, _, model_flags = R.CASES[2 if name in R.CASES[2] else 4][name]
  if model_flags is None:
    import test_torch_expert_parallel as ep_test
    got = ep_test._jax_model(ep_test._jmesh(**a_flags),
                             moe_capacity_factor=R.MOE_CFG[
                                 "moe_capacity_factor"])
    return got["losses"], got["weights"]
  import test_torch_spmd as spmd_test
  assert spmd_test.GPT == R.GPT
  return spmd_test._jax_train(a_flags + model_flags)


def _one_process(root, name, model_flags):
  """In this process: the ranks' checkpoint restored onto one process and
  its step 3; and one process's own uninterrupted 2 steps' state."""
  run = R.Run(name, None, model_flags)
  fresh = run.state(1)
  fresh, nxt = R._manager(R.ckpt_dir(root, name, "ranks")).restore_or(fresh)
  rec = {"next": nxt, "step": fresh.step, "loss": run.step(fresh)}
  return rec, sharding.gather_state_params(fresh)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
  """{n: [(arrays, record) of each rank]}, "jax": references, "one":
  the one-process restores, "root": where the ranks wrote."""
  root = str(tmp_path_factory.mktemp("cut_ckpt"))
  ctx = mp.get_context("spawn")
  procs = []
  for n in (2, 4):
    port = get_free_port()
    procs += [ctx.Process(target=R.rank_main, args=(r, n, port, root))
              for r in range(n)]
  for p in procs:
    p.start()
  # the JAX package's side, while the ranks run
  want = {name: _jax_reference(name) for _, name in CASES}
  for p in procs:
    p.join(timeout=300)
  assert [p.exitcode for p in procs] == [0] * len(procs)
  got = {"jax": want, "root": root, "one": {}}
  for n in (2, 4):
    got[n] = []
    for r in range(n):
      out = os.path.join(root, "w%d_rank%d" % (n, r))
      with open(out + ".json") as f:
        got[n].append((dict(np.load(out + ".npz")), json.load(f)))
  for n, name in CASES:
    got["one"][name] = _one_process(root, name, R.CASES[n][name][2])
  return got


def _weights(arrays, name, tag):
  prefix = "%s/%s/" % (name, tag)
  return {k[len(prefix):]: v for k, v in arrays.items()
          if k.startswith(prefix)}


@pytest.mark.parametrize("where", WHERE)
@pytest.mark.parametrize("n,name", CASES, ids=IDS)
def test_restored_step_matches_jax_uninterrupted(groups, n, name, where):
  """A save after step 2 on mesh A restored onto A, onto one process,
  onto another mesh (and one process's save restored onto A) gives step
  3's loss and weights of the JAX package's uninterrupted 3 steps on A,
  within 1e-5."""
  want_losses, want = groups["jax"][name]
  zero = groups[n][0][1]
  for rank, (arrays, rec) in enumerate(groups[n]):
    if where == "one_process":
      if rank:
        break
      one, weights = groups["one"][name]
      nxt, step, loss = one["next"], one["step"], one["loss"]
    else:
      rec = rec[name]
      weights = _weights(arrays, name, where)
      nxt, step, loss = (rec[where + k] for k in ("_next", "_step",
                                                   "_loss"))
      # the template lies on a mesh that cuts it
      assert rec[where + "_cut"], (name, where)
    assert (nxt, step) == (R.STEPS_SAVED, R.STEPS_SAVED), (nxt, step)
    first = zero["one_process"][name] if where == "from_one" \
        else zero[name]["losses"]
    np.testing.assert_allclose(first + [loss], want_losses, rtol=TRAIN_TOL,
                               err_msg="%s %s rank %d" % (name, where, rank))
    assert sorted(weights) == sorted(want)
    for k, v in want.items():
      np.testing.assert_allclose(weights[k], v, rtol=TRAIN_TOL,
                                 atol=TRAIN_TOL,
                                 err_msg="%s %s rank %d %s"
                                 % (name, where, rank, k))


@pytest.mark.parametrize("n,name", CASES, ids=IDS)
def test_restore_onto_the_same_mesh_continues_to_the_bit(groups, n, name):
  for arrays, rec in groups[n]:
    rec = rec[name]
    assert rec["onto_a_loss"] == rec["uninterrupted"], rec
    a = _weights(arrays, name, "onto_a")
    b = _weights(arrays, name, "uninterrupted")
    assert sorted(a) == sorted(b)
    for k in a:
      np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("n,name", CASES, ids=IDS)
def test_each_rank_keeps_its_blocks_across_save_and_restore(groups, n, name):
  """The port's counterpart of ``test_readers_checkpoint.py``'s
  ``test_sharded_state_roundtrip_preserves_layout``: on the same mesh
  each rank's blocks of every tensor (weights and optimizer state) are
  the same before the save and after the restore, bit for bit; the save
  changes no block; an import of the export into a cut template gives
  the same blocks."""
  for _, rec in groups[n]:
    rec = rec[name]
    assert rec["cut"] and rec["saved"], rec
    assert rec["save_changed"] == [] and rec["onto_a_differ"] == [], rec
    assert rec["import_differ"] == [] and rec["import_step"] == 2, rec
  assert groups[n][0][1][name]["last_save"]["bytes"] > 0


def _tree(path):
  with open(os.path.join(path, str(R.STEPS_SAVED - 1), "state.json")) as f:
    return json.load(f)


def _tensors(path):
  return torch.load(os.path.join(path, str(R.STEPS_SAVED - 1), "state.pt"),
                    weights_only=True)


@pytest.mark.parametrize("n,name", CASES, ids=IDS)
def test_ranks_write_the_tree_of_one_process(groups, n, name):
  """A checkpoint written by ranks and one written by one process at the
  same config: the same ``state.json`` tree and tensor shapes, so either
  restores into the other."""
  ranks = R.ckpt_dir(groups["root"], name, "ranks")
  one = R.ckpt_dir(groups["root"], name, "one")
  assert _tree(ranks) == _tree(one)
  a, b = _tensors(ranks), _tensors(one)
  assert sorted(a) == sorted(b)
  assert {k: tuple(v.shape) for k, v in a.items()} == \
      {k: tuple(v.shape) for k, v in b.items()}


def _leaf_paths(node):
  if "items" not in node:
    return {node["key"]: node["path"]} if "key" in node else {}
  out = {}
  for _, child in node["items"]:
    out.update(_leaf_paths(child))
  return out


@pytest.mark.parametrize("n,name", CASES, ids=IDS)
def test_checkpoint_holds_every_tensor_whole(groups, n, name):
  """Every tensor the ranks wrote, the fused QKV weight's moments (in the
  heads order of one process) and Adafactor's row and column statistics
  over cut dimensions included, equals one process's after the same 2
  steps within 1e-5 of its largest entry: a block of rank 0, or heads in
  a rank's order, would differ by the whole tensor's scale."""
  ranks = R.ckpt_dir(groups["root"], name, "ranks")
  one = R.ckpt_dir(groups["root"], name, "one")
  paths = _leaf_paths(_tree(ranks)["tree"])
  a, b = _tensors(ranks), _tensors(one)
  checked = set()
  for key, path in paths.items():
    want = b[key].float().numpy()
    np.testing.assert_allclose(
        a[key].float().numpy(), want, rtol=TRAIN_TOL,
        atol=TRAIN_TOL * max(float(np.abs(want).max()), 1e-30), err_msg=path)
    checked.add(path)
  if name == "tp2_fused":
    names = [p.split("/")[2] for p in paths.values()
             if p.startswith("/params/")]
    qkv = names.index("layers.0.attn.qkv")
    moments = [p for p in checked if p.endswith(("/mu/%d" % qkv,
                                                 "/nu/%d" % qkv))]
    assert len(moments) == 2, sorted(checked)
  if name == "fsdp2_tp2_adafactor":
    rows = [p for p in checked if "/v_row/" in p]
    assert rows and any(b[k].numel() > 1 for k, p in paths.items()
                        if p in rows)


@pytest.mark.parametrize("n,name", CASES, ids=IDS)
def test_export_import_and_publish_of_a_cut_state_are_whole(groups, n, name):
  """``export_model`` and ``publish_on_checkpoint`` of a cut state write
  the whole weights, equal to ``gather_state_params``; ``import_model``
  reads them, and a one-card state restores the published ones."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  root = groups["root"]
  want = _weights(groups[n][0][0], name, "saved")
  exported = compat.import_model(R.ckpt_dir(root, name, "export"))
  reg = ModelRegistry(R.ckpt_dir(root, name, "registry"))
  published, _ = reg.get(reg.latest())
  for got in (exported["params"], published):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
      np.testing.assert_array_equal(np.asarray(got[k], "float32"), v,
                                    err_msg=k)
  model_flags = R.CASES[n][name][2]
  state = R.Run(name, None, model_flags).state(published)
  for k, v in sharding.gather_state_params(state).items():
    np.testing.assert_array_equal(v, want[k], err_msg=k)
  assert isinstance(state.model, tfm.Transformer)


class _Group(object):

  def __init__(self, n, rank=0):
    self.n, self.r = n, rank

  def size(self):
    return self.n

  def rank(self):
    return self.r


def _stand_in(**degrees):
  return mesh_lib.build_mesh(mesh_lib.MeshSpec(**dict({"data": 1},
                                                      **degrees)),
                             group=_Group(int(np.prod(list(
                                 degrees.values())))))


def _cut_module(tx, **degrees):
  from torch import nn
  model = nn.Module()
  model.w = nn.Parameter(torch.zeros(64, 128))
  mesh = _stand_in(**degrees)
  sh = sharding.StateSharding(mesh, {"w": ("fsdp", "tensor")},
                              {"w": (128, 256)})
  with optim.param_layout(sh):
    state = TrainState.create(model, tx)
  state.sharding = sh
  return state


def test_factored_statistics_lie_as_their_parameter_less_the_reduced_dim():
  """Adafactor's statistics of a ``[128, 256]`` weight cut ``fsdp`` x
  ``tensor`` are cut blocks too: the row statistic (the mean over the
  largest dimension, 1) keeps dim 0's ``fsdp`` cut, the column statistic
  dim 1's ``tensor`` cut; the unused slot is whole."""
  state = _cut_module(optim.adafactor(1e-2), fsdp=2, tensor=2)
  got = sharding.state_shardings(state, state.sharding)
  fs = state.opt_state[0]
  assert tuple(fs.v_row[0].shape) == (64,) and tuple(fs.v_col[0].shape) == \
      (128,)
  assert got[("opt_state", 0, "v_row", 0)] == sharding.collectives.P("fsdp")
  assert got[("opt_state", 0, "v_col", 0)] == sharding.collectives.P(
      "tensor")
  assert got[("opt_state", 0, "v", 0)] == sharding.collectives.P(None)
  layout = sharding.state_layout(state)
  assert layout[("opt_state", 0, "v_row", 0)].shape == (128,)
  assert layout[("opt_state", 0, "v_col", 0)].shape == (256,)
  # a whole template of the same state: the whole shapes
  whole = sharding.whole_like(state)
  assert tuple(whole.opt_state[0].v_row[0].shape) == (128,)
  assert tuple(whole.params["w"].shape) == (128, 256)


def test_an_optimizer_tensor_of_no_derivable_layout_raises_by_name(tmp_path):
  """An optimizer tensor that mirrors no parameter and is no factored
  statistic has no layout the port can derive: the layout, a save and
  an export of the cut state raise naming its path, before any gather,
  instead of writing a guess."""
  odd = optim.GradientTransformation(
      lambda params: [torch.zeros(3) for _ in params],
      lambda updates, state, params=None: (updates, state))
  state = _cut_module(optim.chain(optim.scale(1.0), odd), fsdp=2)
  match = "cannot derive .* opt_state/1/0"
  with pytest.raises(ValueError, match=match):
    sharding.state_layout(state)
  mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"))
  with pytest.raises(ValueError, match=match):
    mgr.save(0, state, force=True)
  with pytest.raises(ValueError, match=match):
    compat.export_model(state, str(tmp_path / "ex"), True)
  assert mgr.all_steps() == [] and not (tmp_path / "ex" / "model").exists()
