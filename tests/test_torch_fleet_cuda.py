"""The serving fleet on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside a
fixture). The file imports only PyTorch and the port, so it runs on the
card's machine: ``python -m pytest tests/test_torch_fleet_cuda.py -m cuda``.

- two replicas of a small bf16 model, both on the card, give every request
  the bare engine's output to the bit, and both take requests;
- a ``TOS_CHAOS_FLEET`` kill ejects replica 1 mid-decode: its requests fail
  over to replica 0 and replay, outputs still to the bit, nothing shed.
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.serving import ServingEngine, ServingFleet
from tensorflowonspark_tpu_torch.serving import fleet as fleet_mod
from tensorflowonspark_tpu_torch.utils import chaos
from tensorflowonspark_tpu_torch.utils.params import init_params

CFG = dict(vocab_size=256, num_layers=2, num_heads=4, d_model=128,
           d_ff=256, max_seq_len=256)
NEW = 16


@pytest.fixture(scope="module")
def served():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the replicas serve on it")
  cfg = tfm.TransformerConfig(**CFG)
  params = init_params(cfg, seed=3)
  rng = np.random.default_rng(4)
  prompts = [rng.integers(1, cfg.vocab_size, size=int(n))
             for n in rng.integers(5, 200, size=12)]

  def factory():
    return ServingEngine(params, cfg, num_slots=4, horizon=4,
                         max_new_tokens=NEW)

  with factory() as eng:
    bare = eng.generate(prompts, timeout=300)
  return factory, prompts, [o.tolist() for o in bare]


@pytest.fixture()
def no_chaos(monkeypatch):
  monkeypatch.delenv(chaos.ENV_FLEET, raising=False)
  chaos.reset()
  yield monkeypatch
  chaos.reset()


@pytest.mark.cuda
def test_two_replicas_on_the_card_equal_the_bare_engine(served, no_chaos):
  factory, prompts, bare = served
  with ServingFleet(factory, num_replicas=2) as fl:
    outs = fl.generate(prompts, timeout=300)
    dispatches = [r.dispatches for r in fl._replicas.values()]
  assert [o.tolist() for o in outs] == bare
  assert all(d > 0 for d in dispatches), dispatches
  assert fl.stats["completed"] == len(prompts) and fl.stats["shed"] == 0


@pytest.mark.cuda
def test_a_killed_replica_fails_over_to_the_bit(served, no_chaos):
  factory, prompts, bare = served
  no_chaos.setenv(chaos.ENV_FLEET, "dispatch@1#2:kill")
  with ServingFleet(factory, num_replicas=2, poll_interval=0.02) as fl:
    outs = fl.generate(prompts, timeout=300)
    states = fl.replica_states()
  assert [o.tolist() for o in outs] == bare
  assert states[1] == fleet_mod.EJECTED
  assert fl.stats["failovers"] >= 1 and fl.stats["shed"] == 0
  assert fl.stats["replay_mismatches"] == 0
