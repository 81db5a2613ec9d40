"""Adafactor and remat ``"dots"`` on the card against the CPU, in f32.

Marked ``cuda``: each test skips without a CUDA card (decided inside a
fixture, never at import). JAX-free, so it runs on a machine that has
only PyTorch: ``python -m pytest tests/test_torch_train_options_cuda.py
-m cuda``.
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import optim
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.parallel import sharding
from tensorflowonspark_tpu_torch.utils.params import init_params

# d_model 128: the MLP kernels and the embedding are factored
CFG = dict(vocab_size=512, num_layers=2, num_heads=4, d_model=128, d_ff=512,
           max_seq_len=256, dtype=torch.float32)
SHAPES = {"up": (768, 3072), "q": (768, 12, 64), "out": (12, 64, 768),
          "scale": (768,)}


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernels run only there")
  matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  yield torch.device("cuda")
  torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


@pytest.mark.cuda
def test_adafactor_updates_on_the_card_equal_the_cpus(card):
  rng = np.random.default_rng(0)
  params = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}
  got = {}
  for dev in ("cpu", card):
    tx = optim.make_optimizer(learning_rate=1e-2, optimizer="adafactor",
                              clip_norm=1.0, weight_decay=0.1)
    p = {n: torch.tensor(v, device=dev) for n, v in params.items()}
    state = tx.init(p)
    grads = np.random.default_rng(1)
    for i in range(3):
      g = {n: torch.tensor((grads.standard_normal(s) * (0.5 + i))
                           .astype(np.float32), device=dev)
           for n, s in SHAPES.items()}
      upd, state = tx.update(g, state, p)
      optim.apply_updates(p, upd)
    got[str(dev)] = {n: t.cpu().numpy() for n, t in p.items()}
  for n in SHAPES:
    np.testing.assert_allclose(got["cuda"][n], got["cpu"][n], rtol=1e-5,
                               atol=1e-6, err_msg=n)


@pytest.mark.cuda
def test_dots_adafactor_train_steps_on_the_card_equal_the_cpus(card):
  """Two steps of a model under remat "dots" with Adafactor: the card's
  kernels (LayerNorm, flash forward and backward) against the CPU's plain
  versions."""
  cfg = tfm.TransformerConfig(remat_policy="dots", **CFG)
  params = init_params(cfg, seed=2)
  batches = [np.random.default_rng(i).integers(0, 512, (2, 256))
             .astype(np.int32) for i in range(2)]
  step = sharding.make_train_step(lambda m, t: tfm.causal_lm_loss(m(t), t))
  runs = {}
  for dev in ("cpu", card):
    state = tfm.create_state(cfg, params, device=dev,
                             tx=optim.make_optimizer(learning_rate=1e-2,
                                                     optimizer="adafactor"))
    losses = []
    for b in batches:
      state, loss = step(state, b)
      losses.append(float(loss))
    runs[str(dev)] = (losses, {n: p.detach().cpu().numpy()
                               for n, p in state.params.items()})
  np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
  for n, want in runs["cpu"][1].items():
    got = runs["cuda"][1][n]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * float(np.abs(want).max()),
                               err_msg=n)
