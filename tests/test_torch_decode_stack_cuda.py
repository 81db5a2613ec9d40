"""The decode-speed stack on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside a
fixture). The file imports only PyTorch and the port, so it runs on the
card's machine: ``python -m pytest tests/test_torch_decode_stack_cuda.py
-m cuda``.

- a speculative verify window overshooting ``max_seq_len`` (prompt +
  budget flush against it, depth 6) drops its overflow on the card too,
  contiguous and paged: f32 outputs equal ``greedy_generate_kv``;
- a decode crash over the paged slab + prefix cache + speculation replays
  every in-flight request: outputs equal the fault-free run's to the bit,
  the pool rebuilt with the slab;
- ``speculative_generate_kv`` in f32 equals ``greedy_generate_kv``, for a
  self-draft and a 1-layer draft.
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.serving import ServingEngine
from tensorflowonspark_tpu_torch.utils import chaos
from tensorflowonspark_tpu_torch.utils.params import init_params

CFG = dict(vocab_size=256, num_layers=2, num_heads=4, d_model=128,
           d_ff=256, max_seq_len=96, dtype=torch.float32)


@pytest.fixture(scope="module")
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the engines serve on it")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cfg = tfm.TransformerConfig(**CFG)
  params = init_params(cfg, seed=5)
  return cfg, params, tfm.Transformer(cfg, params)


@pytest.fixture()
def no_chaos(monkeypatch):
  monkeypatch.delenv(chaos.ENV_SERVE, raising=False)
  chaos.reset()
  yield monkeypatch
  chaos.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [{}, dict(page_size=16)],
                         ids=["contiguous", "paged"])
def test_spec_overshoot_keeps_parity_on_the_card(card, no_chaos, paged):
  cfg, params, model = card
  prompt = np.random.default_rng(6).integers(1, 256, size=81)
  budget = cfg.max_seq_len - len(prompt)        # 15 < depth 6 x 3 rounds
  ref = tfm.greedy_generate_kv(model, prompt[None], budget).cpu().numpy()[0]
  with ServingEngine(params, cfg, num_slots=2, spec_depth=6, spec_layers=1,
                     **paged) as eng:
    out = eng.result(eng.submit(prompt, max_new_tokens=budget), timeout=300)
  np.testing.assert_array_equal(out, ref)


@pytest.mark.cuda
def test_paged_stack_crash_replays_bit_identically(card, no_chaos):
  cfg, params, _ = card
  rng = np.random.default_rng(7)
  prefix = rng.integers(1, 256, size=40)
  prompts = [np.concatenate([prefix, rng.integers(1, 256, size=int(n))])
             for n in (3, 9, 5, 12, 2, 7)]
  opts = dict(num_slots=2, horizon=4, page_size=16, prefix_pages=8,
              spec_depth=3, spec_layers=1, poison_crashes=3,
              restart_backoff=0.01)
  with ServingEngine(params, cfg, **opts) as eng:
    clean = [o.tolist() for o in eng.generate(prompts, max_new_tokens=16,
                                              timeout=300)]
  no_chaos.setenv(chaos.ENV_SERVE, "decode#3:raise")
  chaos.reset()
  with ServingEngine(params, cfg, **opts) as eng:
    outs = [o.tolist() for o in eng.generate(prompts, max_new_tokens=16,
                                             timeout=300)]
    stats = dict(eng.stats)
    assert eng.kv_pages_in_use == eng._prefix.pages_held
  assert outs == clean
  assert stats["engine_restarts"] == 1 and stats["replays"] >= 1
  assert stats["replay_mismatches"] == 0


@pytest.mark.cuda
def test_speculative_generate_equals_greedy_on_the_card(card):
  cfg, params, model = card
  dcfg = tfm.TransformerConfig(**dict(CFG, num_layers=1))
  draft = tfm.Transformer(dcfg, init_params(dcfg, seed=9))
  prompt = np.random.default_rng(8).integers(1, 256, size=(2, 24))
  ref = tfm.greedy_generate_kv(model, prompt, 20)
  for d, k in ((model, 4), (draft, 3)):
    got = tfm.speculative_generate_kv(d, model, prompt, 20, draft_k=k)
    assert torch.equal(got, ref)
