"""A checkpoint of a state cut over tensor, written by ranks on the card
and restored in one process on it.

Marked ``cuda``: the test skips without a CUDA card (decided inside a
fixture). The file imports only PyTorch and the port, so it runs on the
card's machine: ``python -m pytest tests/test_torch_cut_checkpoint_cuda.py
-m cuda``.

Two gloo ranks sharing the card train ``train_gpt --tp 2 --fused`` (f32,
2 layers) 2 steps, save (every rank calls; rank 0 writes the whole
state) and take step 3; this process restores the checkpoint into a
one-card state and takes step 3 on the whole batch: the same loss and
weights within 1e-5.
"""

import json
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.parallel import sharding
from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port

import torch_cut_ckpt_ranks as R

NAME, FLAGS = "tp2_fused", (["--tp", "2"], ["--fused"])


@pytest.fixture(scope="module")
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernels run on it")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


def _rank(rank, port, root):
  import torch.distributed as dist
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.cuda.set_device(0)
  dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                          rank=rank, world_size=2)
  try:
    run = R.Run(NAME, FLAGS[0], FLAGS[1], device="cuda")
    state = run.state(0)
    rec = {"losses": [run.step(state) for _ in range(R.STEPS_SAVED)],
           "cut": bool(state.sharding.sharded)}
    mgr = R._manager(os.path.join(root, "ranks"))
    rec["saved"] = mgr.save(R.STEPS_SAVED - 1, state)
    rec["step3"] = run.step(state)
    weights = sharding.gather_state_params(state)
  finally:
    dist.destroy_process_group()
  if rank == 0:
    np.savez(os.path.join(root, "weights.npz"), **weights)
    with open(os.path.join(root, "rank0.json"), "w") as f:
      json.dump(rec, f)


@pytest.mark.cuda
def test_tp2_checkpoint_restores_in_one_process_on_the_card(card, tmp_path):
  root = str(tmp_path)
  port = get_free_port()
  ctx = mp.get_context("spawn")
  procs = [ctx.Process(target=_rank, args=(r, port, root)) for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(timeout=300)
  assert [p.exitcode for p in procs] == [0, 0]
  with open(os.path.join(root, "rank0.json")) as f:
    rec = json.load(f)
  assert rec["cut"] and rec["saved"], rec
  run = R.Run(NAME, None, FLAGS[1], device="cuda")
  state, nxt = R._manager(os.path.join(root, "ranks")).restore_or(
      run.state(1))
  assert nxt == R.STEPS_SAVED and state.step == R.STEPS_SAVED
  assert next(state.model.parameters()).is_cuda
  loss = run.step(state)
  np.testing.assert_allclose(loss, rec["step3"], rtol=1e-5)
  want = np.load(os.path.join(root, "weights.npz"))
  for k, v in sharding.gather_state_params(state).items():
    np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-5, err_msg=k)
