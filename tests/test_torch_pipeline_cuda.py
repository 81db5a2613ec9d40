"""The port's serving predict fn on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside a
fixture, never at import). JAX-free, so it runs on a machine that has
only PyTorch: ``python -m pytest tests/test_torch_pipeline_cuda.py -m
cuda``.
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.utils.params import init_params

CFG = dict(vocab_size=512, num_layers=2, num_heads=4, d_model=128, d_ff=256,
           max_seq_len=256)


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernels run only there")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_predict_fn_repeats_itself_bitwise_on_the_card(card, dtype):
  cfg = tfm.TransformerConfig(dtype=dtype, **CFG)
  params = init_params(cfg, seed=0)
  fn = tfm.make_serving_predict_fn(cfg, 16, num_slots=4)
  rng = np.random.default_rng(0)
  rect = {"input": rng.integers(1, 512, (8, 128)).astype(np.int32)}
  rows = np.empty(6, object)
  rows[:] = [rng.integers(1, 512, n).tolist() for n in (17, 60, 5, 128, 33,
                                                        90)]
  for batch in (rect, {"input": rows}):
    first = fn(params, batch)["tokens"]
    again = fn(params, batch)["tokens"]
    assert first.dtype == np.int32
    np.testing.assert_array_equal(first, again)


def _replay(model, prompts, out, k, temp):
  """Replay the drawn tokens through the same decode path (which gives
  the same logits, bit for bit) and check each lies in its step's top
  ``k``; returns, per row, whether any step's k-th largest was tied."""
  plen, steps = prompts.shape[1], out.shape[1] - prompts.shape[1]
  tied = torch.zeros(out.shape[0], dtype=torch.bool, device=out.device)
  with torch.inference_mode():
    cache = model.init_cache(out.shape[0])
    logits = model(torch.as_tensor(prompts, device=out.device), cache)[:, -1]
    for i in range(steps):
      tok = out[:, plen + i]
      scaled = logits.float() / temp
      kth = torch.topk(scaled, k, dim=-1).values[:, -1:]
      assert bool((scaled.gather(1, tok[:, None]) >= kth).all()), i
      tied |= (scaled >= kth).sum(-1) > k
      logits = model(tok[:, None], cache)[:, -1]
  return tied


@pytest.mark.cuda
def test_sampled_tokens_lie_in_their_steps_top_k_on_the_card(card):
  """Top-40 at T 0.8 on bf16 logits; top-1 equals greedy in every row
  whose steps met no tied maximum (bf16 logits tie; a tie is kept, as
  the reference keeps it, and drawn from)."""
  cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **CFG)
  model = tfm.Transformer(cfg, init_params(cfg, seed=1))
  prompts = np.random.default_rng(1).integers(1, 512, (8, 128))
  temp, steps = 0.8, 24
  gen = torch.Generator(device=card).manual_seed(5)
  out = tfm.greedy_generate_kv(model, prompts, steps, temperature=temp,
                               top_k=40, generator=gen)
  _replay(model, prompts, out, 40, temp)
  greedy = tfm.greedy_generate_kv(model, prompts, steps)
  top1 = tfm.greedy_generate_kv(model, prompts, steps, temperature=temp,
                                top_k=1, generator=gen)
  tied = _replay(model, prompts, top1, 1, temp)
  assert torch.equal(greedy[~tied], top1[~tied])
