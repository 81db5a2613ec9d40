"""What each gloo rank runs for ``tests/test_torch_cut_checkpoint.py``:
checkpoints, restores and exports of train states cut over fsdp, tensor
and expert.

A helper, not a test file: it imports PyTorch and the port only, so a
spawned rank starts without loading JAX. :func:`rank_main` runs every
case of a group of ``world`` ranks and writes what the rank saw to
``<root>/w<world>_rank<rank>.npz`` (arrays) and ``.json`` (a record);
the checkpoints, exports and registries it writes stay under
``<root>/<case>/`` for the test process to read.

A case trains 2 steps on its mesh A and saves (every rank calls
``save``; rank 0 writes the whole state), exports and publishes, then
takes step 3 uninterrupted; a fresh state from other weights restores
the checkpoint onto A itself and onto another mesh B and takes step 3
there; and a checkpoint that rank 0 wrote as one process before the
group formed restores onto A.
"""

import dataclasses
import json
import os

import numpy as np
import torch

GPT = ["--device", "cpu", "--layers", "2", "--d_model", "32", "--heads",
       "4", "--seq_len", "32", "--vocab", "64", "--batch", "4", "--steps",
       "3"]
WIDE = ["--d_model", "128", "--vocab", "256"]     # Adafactor factors these
MOE_CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64,
               d_ff=128, max_seq_len=16, remat=False, moe_experts=4,
               moe_top_k=2, moe_every=2, moe_capacity_factor=4.0)
MOE_LR = 0.1
#: by group size: case -> (mesh A's flags, mesh B's flags, model flags);
#: a MoE case's flags are its mesh degrees
CASES = {
    2: {"fsdp2": (["--fsdp", "2"], ["--tp", "2"], []),
        "tp2_fused": (["--tp", "2"], ["--fsdp", "2"], ["--fused"])},
    4: {"fsdp2_tp2_adafactor": (["--fsdp", "2", "--tp", "2"], ["--tp", "2"],
                                ["--optimizer", "adafactor"] + WIDE),
        "moe_dp2_ep2": ({"data": 2, "expert": 2}, {"data": 1, "expert": 4},
                        None)},
}
STEPS_SAVED = 2


def ckpt_dir(root, name, what):
  return os.path.join(root, name, what)


class Run(object):
  """One case on one mesh (None: one process): its mesh, config, a
  fresh state from ``seed``'s weights, its step and its block of the
  global batch, on ``device``."""

  def __init__(self, name, mesh_flags, model_flags, device="cpu"):
    from tensorflowonspark_tpu_torch import optim
    from tensorflowonspark_tpu_torch.examples import train_gpt
    from tensorflowonspark_tpu_torch.models import transformer as tfm
    from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
    from tensorflowonspark_tpu_torch.parallel import sharding
    self.name, self.device = name, device
    if model_flags is None:                                  # MoE
      self.cfg = tfm.TransformerConfig(dtype=torch.float32, **MOE_CFG)
      self.mesh = None if mesh_flags is None else mesh_lib.build_mesh(
          mesh_lib.MeshSpec(**mesh_flags))
      self.make_tx = lambda: optim.make_optimizer(
          learning_rate=MOE_LR, clip_norm=1.0, optimizer="sgd")
      self.loss_fn = lambda m, t: tfm.causal_lm_loss(m(t), t, mesh=m.mesh)
      self.tokens = np.tile(np.arange(16) % 8, (8, 1)).astype("int32")
      self.extra = ()
    else:
      args = train_gpt.parse_args(GPT + model_flags + (mesh_flags or [])
                                  + ["--device", device])
      self.cfg = dataclasses.replace(train_gpt.make_config(args),
                                     dtype=torch.float32)
      self.mesh = train_gpt.make_mesh(args)
      self.make_tx = lambda: optim.make_optimizer(
          learning_rate=args.lr, clip_norm=1.0, optimizer=args.optimizer,
          grad_accum_steps=args.grad_accum)
      self.loss_fn = train_gpt.make_loss_fn(args)
      self.tokens = np.asarray(next(train_gpt.batch_stream(args)), "int32")
      self.extra = train_gpt.SEQUENCE_AXES if self.mesh is not None else ()
    self.batch = self.tokens if self.mesh is None else \
        sharding.shard_batch(self.tokens, self.mesh, self.extra)

  def state(self, seed):
    from tensorflowonspark_tpu_torch.models import transformer as tfm
    if self.mesh is None:
      return tfm.create_state(self.cfg, seed, tx=self.make_tx(),
                              device=self.device)
    return tfm.create_sharded_state(self.cfg, seed, self.mesh,
                                    tx=self.make_tx(), device=self.device)[0]

  def step(self, state):
    """One step of ``state``: the global batch's loss."""
    from tensorflowonspark_tpu_torch.parallel import sharding
    fn = sharding.make_train_step(self.loss_fn, self.mesh, state.sharding,
                                  batch_extra_axes=self.extra)
    return float(fn(state, self.batch)[1])


def _manager(path):
  from tensorflowonspark_tpu_torch.utils.checkpoint import CheckpointManager
  return CheckpointManager(path, save_interval_steps=1)


def one_process_save(root, name, case):
  """One process (no group yet): 2 steps on the whole batch, saved."""
  run = Run(name, None, case[2])
  state = run.state(0)
  losses = [run.step(state) for _ in range(STEPS_SAVED)]
  assert _manager(ckpt_dir(root, name, "one")).save(STEPS_SAVED - 1, state)
  return losses


def _blocks(state):
  from tensorflowonspark_tpu_torch.parallel import sharding
  return {"/".join(str(k) for k in path): t.detach().clone()
          for path, t in sharding._state_tensors(state)}


def _differ(state, before):
  return sorted(k for k, t in _blocks(state).items()
                if not torch.equal(t, before[k]))


def _restore_and_step(run, path, rec, tag):
  """A fresh state from seed 1 on ``run``'s mesh restores the checkpoint
  at ``path`` and takes step 3; its loss and gathered weights."""
  from tensorflowonspark_tpu_torch.parallel import sharding
  fresh = run.state(1)
  fresh, rec[tag + "_next"] = _manager(path).restore_or(fresh)
  rec[tag + "_step"] = fresh.step
  rec[tag + "_cut"] = bool(fresh.sharding is not None
                           and fresh.sharding.sharded)
  blocks = _blocks(fresh)
  rec[tag + "_loss"] = run.step(fresh)
  return blocks, sharding.gather_state_params(fresh)


def run_case(rank, root, name, case):
  """Mesh A's 2 steps, save / export / publish, the uninterrupted step
  3, and the restores onto A, onto B and from one process onto A."""
  from tensorflowonspark_tpu_torch.parallel import sharding
  from tensorflowonspark_tpu_torch.serving.registry import ModelRegistry
  from tensorflowonspark_tpu_torch.utils import compat
  a_flags, b_flags, model_flags = case
  run = Run(name, a_flags, model_flags)
  state = run.state(0)
  rec, arrays = {"cut": bool(state.sharding.sharded)}, {}
  rec["losses"] = [run.step(state) for _ in range(STEPS_SAVED)]
  before = _blocks(state)
  mgr = _manager(ckpt_dir(root, name, "ranks"))
  ModelRegistry(ckpt_dir(root, name, "registry")).publish_on_checkpoint(mgr)
  rec["saved"] = mgr.save(STEPS_SAVED - 1, state)
  rec["last_save"] = mgr.last_save
  compat.export_model(state, ckpt_dir(root, name, "export"), rank == 0)
  rec["save_changed"] = _differ(state, before)
  for k, v in sharding.gather_state_params(state).items():
    arrays["saved/" + k] = v
  # the blocks of an import into a cut template are the saved ones
  fresh = run.state(1)
  compat.import_model(ckpt_dir(root, name, "export"), fresh)
  rec["import_differ"] = _differ(fresh, before)
  rec["import_step"] = fresh.step
  del fresh
  rec["uninterrupted"] = run.step(state)
  for k, v in sharding.gather_state_params(state).items():
    arrays["uninterrupted/" + k] = v
  blocks, weights = _restore_and_step(run, ckpt_dir(root, name, "ranks"),
                                      rec, "onto_a")
  rec["onto_a_differ"] = sorted(k for k, t in blocks.items()
                                if not torch.equal(t, before[k]))
  arrays.update({"onto_a/" + k: v for k, v in weights.items()})
  other = Run(name, b_flags, model_flags)
  _, weights = _restore_and_step(other, ckpt_dir(root, name, "ranks"), rec,
                                 "onto_b")
  arrays.update({"onto_b/" + k: v for k, v in weights.items()})
  _, weights = _restore_and_step(run, ckpt_dir(root, name, "one"), rec,
                                 "from_one")
  arrays.update({"from_one/" + k: v for k, v in weights.items()})
  return rec, arrays


def rank_main(rank, world, port, root):
  import tempfile
  import torch.distributed as dist
  torch.set_num_threads(1)
  tempfile.tempdir = root          # a non-chief export's throwaway copy
  rec, arrays = {}, {}
  if rank == 0:
    rec["one_process"] = {name: one_process_save(root, name, case)
                          for name, case in CASES[world].items()}
  dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                          rank=rank, world_size=world)
  try:
    for name, case in CASES[world].items():
      rec[name], got = run_case(rank, root, name, case)
      arrays.update({"%s/%s" % (name, k): v for k, v in got.items()})
  finally:
    dist.destroy_process_group()
  out = os.path.join(root, "w%d_rank%d" % (world, rank))
  np.savez(out + ".npz", **arrays)
  with open(out + ".json", "w") as f:
    json.dump(rec, f)
