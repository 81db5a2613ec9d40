"""The port at head dims other than 64 and 128, against the JAX package, on
the CPU.

The flash kernels take every head_dim ``d`` with ``8 <= d <= 128`` and ``d
% 8 == 0``, padding it inside the kernel to a 64- or 128-column tile. Here
the port's plain versions (which its wrappers take for CPU tensors) are held
against the JAX kernels in interpret mode at d 32 (``train_gpt``'s defaults,
``serve_gpt``) and 96: the forward, the fused backward and the split
backward, MHA and grouped, causal and windowed, and a ragged Sq != Sk block;
then the Transformer at ``train_gpt``'s default widths (d_model 256, 8 heads)
on loss and every gradient. Inputs are made with numpy from a seed; the
kernels themselves run only on the card (``tests/test_torch_kernels.py``).
"""

import dataclasses
import importlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.examples import train_gpt
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.utils.params import params_from_flax

# the packages re-export the function ``flash_attention`` over the module
jfa = importlib.import_module("tensorflowonspark_tpu.ops.flash_attention")
tfa = importlib.import_module("tensorflowonspark_tpu_torch.ops.flash_attention")

# (H, Hk, Sq, Sk, q_base, kv_base, window, lse cotangent): MHA and grouped,
# causal and windowed, and a ragged block of 48 queries at position 16
# against 64 keys
CASES = {
    "mha": (4, 4, 64, 64, 0, 0, None, False),
    "gqa_hk2": (4, 2, 64, 64, 0, 0, None, True),
    "window_24": (4, 2, 64, 64, 0, 0, 24, False),
    "ragged_sq_sk": (4, 2, 48, 64, 16, 0, None, True),
}
HEAD_DIMS = (32, 96)


def _inputs(case, d):
  h, hk, sq, sk, q_base, kv_base, window, with_lse = CASES[case]
  rng = np.random.default_rng(d)
  q = rng.standard_normal((2, sq, h, d)).astype(np.float32)
  k = rng.standard_normal((2, sk, hk, d)).astype(np.float32)
  v = rng.standard_normal((2, sk, hk, d)).astype(np.float32)
  g = rng.standard_normal((2, sq, h, d)).astype(np.float32)
  gl = rng.standard_normal((2, h, sq)).astype(np.float32) if with_lse else None
  return (q, k, v, g, gl), (q_base, kv_base, window)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax_at_head_dim(case, d):
  (q, k, v, _, _), (q_base, kv_base, window) = _inputs(case, d)
  jo, jl = jfa._fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         q_base, kv_base, causal=True, blk_q=16, blk_k=16,
                         interpret=True, window=window)
  to, tl = ops.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), q_base, kv_base, True,
                                   window)
  assert to.shape == q.shape
  np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=2e-5)
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bwd", ["fused", "split"])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax_at_head_dim(case, d, bwd):
  (q, k, v, g, gl), (q_base, kv_base, window) = _inputs(case, d)
  jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
  out, lse = jfa._fwd_impl(jq, jk, jv, q_base, kv_base, causal=True,
                           blk_q=16, blk_k=16, interpret=True, window=window)
  if gl is not None:
    gl = np.where(np.asarray(lse) <= -1e29, 0.0, gl).astype(np.float32)
  want = jfa._bwd_impl(jq, jk, jv, out, lse, jg,
                       None if gl is None else jnp.asarray(gl), q_base,
                       kv_base, causal=True, blk_q=16, blk_k=16,
                       interpret=True, bwd=bwd, window=window)
  ops.reset_launches()
  got = ops.flash_attention_bwd(
      torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
      torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)),
      torch.from_numpy(g), None if gl is None else torch.from_numpy(gl),
      q_base, kv_base, True, window, bwd=bwd)
  assert not any(ops.LAUNCHES.values())        # CPU tensors: plain versions
  for name, t, j in zip("qkv", got, want):
    assert t.shape == j.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4,
                               err_msg="d" + name)


@pytest.mark.parametrize("d", [8, 32, 64, 96, 128])
def test_kernel_check_takes_head_dims_up_to_128(d):
  tfa.check_head_dim("flash_attention kernel", d)


@pytest.mark.parametrize("d", [136, 100, 4, 256])
def test_kernel_check_refuses_other_head_dims_by_name(d):
  with pytest.raises(ValueError, match=re.escape(
      "flash_attention kernel takes head_dim d with 8 <= d <= 128 and d % 8 "
      "== 0, got " + str(d))):
    tfa.check_head_dim("flash_attention kernel", d)


def test_transformer_at_train_gpt_default_widths_matches_jax():
  # train_gpt's default model flags (d_model 256, 8 heads: head_dim 32, d_ff
  # 4 x d_model, vocab 1024), cut to 2 layers and 64 tokens
  args = train_gpt.parse_args(["--layers", "2", "--seq_len", "64",
                               "--device", "cpu"])
  tcfg = train_gpt.make_config(args)
  assert tcfg.head_dim == 32
  tcfg = dataclasses.replace(tcfg, dtype=torch.float32, remat=False)
  jcfg = jax_tfm.TransformerConfig(
      vocab_size=args.vocab, num_layers=args.layers, num_heads=args.heads,
      d_model=args.d_model, d_ff=args.d_model * 4, max_seq_len=args.seq_len,
      dtype=jnp.float32, remat=False, attention_impl="flash",
      layer_norm_impl="fused")
  state = jax_tfm.create_state(jax.random.PRNGKey(3), jcfg, seq_len=16)
  params = jax.tree.map(np.asarray, state.params)
  tokens = np.random.default_rng(4).integers(0, args.vocab, size=(2, 64))
  model = jax_tfm.Transformer(jcfg)

  def loss_fn(p):
    return jax_tfm.causal_lm_loss(model.apply({"params": p},
                                              jnp.asarray(tokens, jnp.int32)),
                                  jnp.asarray(tokens, jnp.int32))
  want_loss, want = jax.value_and_grad(loss_fn)(params)
  want = params_from_flax(jax.tree.map(np.asarray, want), tcfg)
  port = tfm.Transformer(tcfg, params_from_flax(params, tcfg), device="cpu",
                         trainable=True)
  tt = torch.from_numpy(tokens)
  loss = tfm.causal_lm_loss(port(tt), tt)
  names, weights = zip(*port.named_parameters())
  grads = torch.autograd.grad(loss, weights)
  np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                             rtol=1e-4)
  assert sorted(names) == sorted(want)
  for name, g in zip(names, grads):
    np.testing.assert_allclose(g.numpy(), want[name], atol=1e-4, rtol=1e-4,
                               err_msg=name)
