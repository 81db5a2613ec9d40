"""Elastic multi-group training on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside a
fixture). The file imports only PyTorch and the port, so it runs on the
card's machine: ``python -m pytest tests/test_torch_groups_cuda.py -m cuda``.

- two groups of a small Transformer as threads sharing the card, synced
  every 2 steps: after each round both hold the same bits, and each
  group's launches are its steps' exactly;
- a group killed by ``TOS_CHAOS_GROUP`` mid-training: the survivor
  completes with denominator 1, and ``readmit`` catches the group up;
- the group threads leave the calling thread's CUDA device as it was.
"""

import pytest
import torch

from tensorflowonspark_tpu_torch import ops, optim
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.parallel import groups as G
from tensorflowonspark_tpu_torch.utils import chaos

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=512, num_layers=2, num_heads=2, d_model=128,
             d_ff=256, max_seq_len=64)
B, S = 4, 64


@pytest.fixture(scope="module")
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernels run on it")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


def _build(device):
  cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **SMALL)
  state = tfm.create_state(cfg, 0, device=device,
                           tx=optim.make_optimizer(learning_rate=3e-3))
  return state, lambda model, t: tfm.causal_lm_loss(model(t), t)


def _batch(gid, step):
  g = torch.Generator().manual_seed(1000 * gid + step % 2)
  return torch.randint(0, SMALL["vocab_size"], (B, S), generator=g,
                       dtype=torch.int32).numpy()


def test_two_groups_sync_bit_identical_with_exact_launches(card):
  gs = G.GroupSet(_build, _batch, num_groups=2, sync_every=2,
                  sync_timeout=30.0)
  try:
    assert all(g.device.type == "cuda" for g in gs.groups.values())
    ops.reset_launches()
    gs.run(6)
    assert gs.wait(timeout=120)
    assert [g.exit_reason for g in gs.groups.values()] == ["completed"] * 2
    assert gs.plane.status()["rounds_completed"] == 3
    p0 = G.pack_tree(gs.groups[0].state.params)
    p1 = G.pack_tree(gs.groups[1].state.params)
    assert all(a["data"] == b["data"] for a, b in zip(p0, p1))
    # remat: a layer's flash forward twice a step, LayerNorm 4 + ln_f
    want = {"flash_attention_fwd": 4, "flash_attention_bwd": 2,
            "layer_norm": 9, "layer_norm_bwd": 5}
    for name, n in want.items():
      assert ops.LAUNCHES[name] == 2 * 6 * n, (name, ops.LAUNCHES[name])
    for g in gs.groups.values():
      assert g.losses[-1] < g.losses[0]
  finally:
    gs.close()


def test_killed_group_shrinks_the_round_then_readmits(card, monkeypatch):
  monkeypatch.setenv(chaos.ENV_GROUP, "kill@1#2")
  chaos.reset()
  gs = G.GroupSet(_build, _batch, num_groups=2, sync_every=2,
                  sync_timeout=1.0, miss_limit=2)
  try:
    gs.run(10)
    assert gs.wait(timeout=120)
    assert gs.groups[1].exit_reason == "chaos-kill"
    assert gs.groups[0].exit_reason == "completed"
    dens = [e["denominator"] for e in gs.events
            if e["event"] == "sync" and e["group"] == 0]
    assert dens[0] == 2 and dens[-1] == 1 and 1 in gs.plane.lost
    monkeypatch.delenv(chaos.ENV_GROUP)
    chaos.reset()
    g = gs.readmit(1)
    assert g.steps == 10 and gs.wait(timeout=60)
    assert gs.groups[1].exit_reason == "completed"
  finally:
    gs.close()
    chaos.reset()


def test_group_threads_leave_the_callers_device_as_it_was(card):
  before = torch.cuda.current_device()
  gs = G.GroupSet(_build, _batch, num_groups=torch.cuda.device_count() + 1,
                  sync_every=0)
  try:
    gs.run(1)
    assert gs.wait(timeout=120)
    assert torch.cuda.current_device() == before
    want = [torch.device("cuda", gid % torch.cuda.device_count())
            for gid in gs.groups]
    assert [g.device for g in gs.groups.values()] == want
  finally:
    gs.close()
