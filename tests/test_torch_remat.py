"""Remat ``"dots"`` in the PyTorch port against the JAX package's.

The reference saves the outputs of each block's products with no batch
dims (``dots_with_no_batch_dims_saveable``) and recomputes the rest. The
port does the same with a selective-checkpoint policy. Loss and gradients
are held to the reference under ``"dots"`` and to the port without remat;
a dispatch-mode count shows which products the backward no longer runs.
"""

import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.utils.params import (init_params,
                                                      params_from_flax)

GRAD_CFG = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64,
                d_ff=128, max_seq_len=128)
SEQ = 128
CONFIGS = {"plain": {}, "gqa": dict(num_kv_heads=2),
           "all_fused": dict(fuse_qkv=True, ln_matmul_impl="fused",
                             act_matmul_impl="fused")}
# the weight products of a block that "dots" saves and "none" recomputes:
# q, k, v, out and up unfused (the recompute stops before down, whose
# output the backward never reads); all-fused runs qkv, up and down as
# LN->matmul / GELU->matmul kernels (no dots in the reference either),
# leaving out alone
SAVED_PER_LAYER = {"plain": 5, "gqa": 5, "all_fused": 1}


def _tcfg(name, **kw):
  return tfm.TransformerConfig(dtype=torch.float32,
                               **dict(GRAD_CFG, **CONFIGS[name], **kw))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def dots_reference(request):
  """(config name, flax params, tokens, JAX loss and flat gradients under
  remat "dots")."""
  name = request.param
  jcfg = jax_tfm.TransformerConfig(
      dtype=jnp.float32, remat=True, remat_policy="dots",
      attention_impl="flash", layer_norm_impl="fused",
      **dict(GRAD_CFG, **CONFIGS[name]))
  state = jax_tfm.create_state(jax.random.PRNGKey(5), jcfg, seq_len=16)
  params = jax.tree.map(np.asarray, state.params)
  tokens = np.random.default_rng(7).integers(0, GRAD_CFG["vocab_size"],
                                             size=(2, SEQ))
  model = jax_tfm.Transformer(jcfg)
  jt = jnp.asarray(tokens, jnp.int32)

  def loss_fn(p):
    return jax_tfm.causal_lm_loss(model.apply({"params": p}, jt), jt)

  loss, grads = jax.value_and_grad(loss_fn)(params)
  return (name, params, tokens, float(loss),
          params_from_flax(jax.tree.map(np.asarray, grads), _tcfg(name)))


def _port_loss_and_grads(tcfg, params, tokens):
  model = tfm.Transformer(tcfg, params_from_flax(params, tcfg), device="cpu",
                          trainable=True)
  t = torch.from_numpy(tokens)
  loss = tfm.causal_lm_loss(model(t), t)
  names, weights = zip(*model.named_parameters())
  grads = torch.autograd.grad(loss, weights)
  return float(loss.detach()), dict(zip(names, (g.numpy() for g in grads)))


def test_dots_loss_and_every_gradient_match_jax_dots(dots_reference):
  """The port under "dots" against the reference under "dots", at the
  reference's own remat bounds (``tests/test_models.py``: rtol 1e-6 on
  the loss, 1e-5 on the grads)."""
  name, params, tokens, want_loss, want_grads = dots_reference
  loss, grads = _port_loss_and_grads(
      _tcfg(name, remat=True, remat_policy="dots"), params, tokens)
  np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
  assert sorted(grads) == sorted(want_grads)
  for n, g in grads.items():
    np.testing.assert_allclose(g, want_grads[n], atol=1e-5, rtol=1e-5,
                               err_msg=n)


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_policy_numerics_invariant(dots_reference, policy):
  """Remat trades memory for compute, never numerics: the port under each
  policy against the port without remat, at the reference's own bounds
  (``tests/test_models.py``: rtol 1e-6 on the loss, 1e-5 on the grads)."""
  name, params, tokens, _, _ = dots_reference
  l0, g0 = _port_loss_and_grads(_tcfg(name, remat=False), params, tokens)
  l1, g1 = _port_loss_and_grads(
      _tcfg(name, remat=True, remat_policy=policy), params, tokens)
  np.testing.assert_allclose(l1, l0, rtol=1e-6)
  for n in g0:
    np.testing.assert_allclose(g1[n], g0[n], atol=1e-5, rtol=1e-5,
                               err_msg=n)


class _CountProducts(TorchDispatchMode):
  """Counts the matrix products dispatched while active."""

  OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)

  def __init__(self):
    super().__init__()
    self.count = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    if func in self.OPS:
      self.count += 1
    return func(*args, **(kwargs or {}))


def _backward_products(tcfg, tokens):
  model = tfm.Transformer(tcfg, init_params(tcfg, seed=3), device="cpu",
                          trainable=True)
  t = torch.from_numpy(tokens)
  loss = tfm.causal_lm_loss(model(t), t)
  with _CountProducts() as counter:
    loss.backward()
  return counter.count


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dots_backward_skips_the_saved_products(name):
  """The backward under "dots" runs the saved weight products no more:
  ``SAVED_PER_LAYER x layers`` fewer products than under "none"; the
  attention's batched products are recomputed under both."""
  tokens = np.random.default_rng(8).integers(0, GRAD_CFG["vocab_size"],
                                             (2, 32))
  none = _backward_products(_tcfg(name, remat=True, remat_policy="none"),
                            tokens)
  dots = _backward_products(_tcfg(name, remat=True, remat_policy="dots"),
                            tokens)
  off = _backward_products(_tcfg(name, remat=False), tokens)
  layers = GRAD_CFG["num_layers"]
  assert none - dots == SAVED_PER_LAYER[name] * layers
  assert dots > off      # what "dots" does not save is recomputed


def _count_kernel_forwards(monkeypatch):
  """Calls of each op's forward (on the card, where its kernel
  launches)."""
  counts = {}
  for mod in ("layer_norm", "flash_attention", "ln_matmul", "act_matmul"):
    module = sys.modules["tensorflowonspark_tpu_torch.ops." + mod]
    inner = module._forward

    def counted(*args, _inner=inner, _name=mod):
      counts[_name] = counts.get(_name, 0) + 1
      return _inner(*args)
    monkeypatch.setattr(module, "_forward", counted)
  return counts


@pytest.mark.parametrize("name", ["plain", "all_fused"])
def test_dots_recomputes_every_kernel_forward(monkeypatch, name):
  """Kernels are no dots: under "dots" each one's forward re-runs in the
  backward exactly as under "none"."""
  tokens = torch.from_numpy(
      np.random.default_rng(9).integers(0, GRAD_CFG["vocab_size"], (2, 32)))
  seen = {}
  for policy in ("none", "dots"):
    tcfg = _tcfg(name, remat=True, remat_policy=policy)
    model = tfm.Transformer(tcfg, init_params(tcfg, seed=1), device="cpu",
                            trainable=True)
    counts = _count_kernel_forwards(monkeypatch)
    tfm.causal_lm_loss(model(tokens), tokens).backward()
    seen[policy] = dict(counts)
    monkeypatch.undo()
  layers = GRAD_CFG["num_layers"]
  assert seen["dots"] == seen["none"]
  assert seen["dots"]["flash_attention"] == 2 * layers
