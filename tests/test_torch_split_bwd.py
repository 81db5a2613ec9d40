"""The port's split flash-attention backward against the JAX package's, on
the CPU.

The JAX ``_bwd_impl(..., bwd="split")`` runs its Pallas kernels
(``_attn_bwd_dq_kernel``, ``_attn_bwd_dkv_kernel``,
``_attn_bwd_dkv_gqa_kernel``) in interpret mode; the port runs the plain
versions of its split kernels (``flash_attention_bwd_dq_reference``,
``flash_attention_bwd_dkv_reference``), which its wrappers take for CPU
tensors. Inputs are made with numpy from a seed and handed to both. The
kernels themselves run only on the card: ``tests/test_torch_kernels.py``.
"""

import importlib
import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.utils.params import params_from_flax

# the packages re-export the function ``flash_attention`` over the module
jfa = importlib.import_module("tensorflowonspark_tpu.ops.flash_attention")
tfa = importlib.import_module("tensorflowonspark_tpu_torch.ops.flash_attention")

# (H, Hk, q_base, kv_base, window, lse cotangent)
SPLIT_CASES = {
    "mha": (4, 4, 0, 0, None, False),
    "gqa_hk2": (4, 2, 0, 0, None, False),
    "window_24": (4, 2, 0, 0, 24, False),
    "bases_lse_cotangent": (4, 2, 40, 8, None, True),
    "empty_rows": (4, 2, 0, 32, None, True),
}


def _split_inputs(case, dtype):
  h, hk, q_base, kv_base, window, with_lse = SPLIT_CASES[case]
  rng = np.random.default_rng(11)
  b, s, d = 2, 64, 16
  q = rng.standard_normal((b, s, h, d)).astype(np.float32)
  k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
  v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
  g = rng.standard_normal((b, s, h, d)).astype(np.float32)
  jdt = getattr(jnp, dtype)
  jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
  out, lse = jfa._fwd_impl(jq, jk, jv, q_base, kv_base, causal=True, blk_q=16,
                           blk_k=16, interpret=True, window=window)
  gl = None
  if with_lse:
    gl = rng.standard_normal((b, h, s)).astype(np.float32)
    gl = np.where(np.asarray(lse) <= -1e29, 0.0, gl).astype(np.float32)
  return (jq, jk, jv, out, lse, jg, gl), (q_base, kv_base, window)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_plain_versions_match_jax_split_bwd(case, dtype, tol):
  (jq, jk, jv, out, lse, jg, gl), (q_base, kv_base, window) = \
      _split_inputs(case, dtype)
  want = jfa._bwd_impl(jq, jk, jv, out, lse, jg,
                       None if gl is None else jnp.asarray(gl), q_base,
                       kv_base, causal=True, blk_q=16, blk_k=32,
                       interpret=True, bwd="split", window=window)
  tdt = getattr(torch, dtype)
  tq, tk, tv, tout, tg = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                          for a in (jq, jk, jv, out, jg))
  tlse = torch.from_numpy(np.array(lse))
  tgl = None if gl is None else torch.from_numpy(gl)
  ops.reset_launches()
  got = ops.flash_attention_bwd(tq, tk, tv, tout, tlse, tg, tgl, q_base,
                                kv_base, True, window, bwd="split")
  assert not any(ops.LAUNCHES.values())        # CPU tensors: plain versions
  # the two plain versions called on their own give the same bits
  delta = tfa._plain_delta(tout, tg, tgl)
  dq = ops.flash_attention_bwd_dq_reference(tq, tk, tv, tg, tlse, delta,
                                            q_base, kv_base, True, window)
  dk, dv = ops.flash_attention_bwd_dkv_reference(tq, tk, tv, tg, tlse, delta,
                                                 q_base, kv_base, True,
                                                 window)
  for name, t, j, alone in zip("qkv", got, want, (dq, dk, dv)):
    assert t.dtype == tdt and t.shape == j.shape
    assert torch.equal(t, alone), "d" + name
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol, err_msg="d" + name)
  if case == "empty_rows":
    # queries before the first key get dq 0 in both packages
    dead = slice(0, kv_base - q_base)
    assert (got[0][:, dead] == 0).all()
    assert (np.asarray(want[0], np.float32)[:, dead] == 0).all()


PLAN_GRID = list(itertools.product(
    (512, 1024, 4096, 8192, 10240, 10241, 16384),
    (512, 1024, 4096, 10240, 10241, 16384, 32768), (64, 128), (2, 4)))


def test_plan_rule_equals_the_reference_rule():
  assert tfa.GQA_FUSED_VMEM_BUDGET == jfa.GQA_FUSED_VMEM_BUDGET
  for s_q, s_kv, d, isz in PLAN_GRID:
    fits = jfa._gqa_fused_fits(s_q, s_kv, d, isz)
    assert tfa._gqa_fused_fits(s_q, s_kv, d, isz) == fits
    for bwd, grp in itertools.product(("fused", "split"), (1, 2, 3, 12)):
      # _bwd_impl:588-590: only fused with grp > 1 can switch
      want = "split" if bwd == "split" or (grp > 1 and not fits) else "fused"
      assert tfa.bwd_plan(bwd, grp, s_q, s_kv, d, isz) == want


@pytest.mark.parametrize("shape,plan", [((1024, 1024, 64, 2), "fused"),
                                        ((8192, 8192, 128, 2), "split"),
                                        ((16384, 16384, 64, 2), "split"),
                                        ((10240, 10240, 64, 2), "fused")])
def test_named_shapes_take_the_reference_plan(shape, plan):
  assert tfa.bwd_plan("fused", 3, *shape) == plan
  assert tfa.bwd_plan("fused", 1, *shape) == "fused"      # MHA never switches
  assert tfa.bwd_plan("split", 1, *shape) == "split"


def test_long_grouped_kv_backward_runs_the_split_plan(monkeypatch):
  calls = []
  real_dq = tfa.flash_attention_bwd_dq

  def spy(*args, **kw):
    calls.append(args[0].shape)
    return real_dq(*args, **kw)

  monkeypatch.setattr(tfa, "flash_attention_bwd_dq", spy)
  # a budget that a 64-token grouped backward exceeds stands in for S 16384
  monkeypatch.setattr(tfa, "GQA_FUSED_VMEM_BUDGET", 1024)
  rng = np.random.default_rng(3)
  q = torch.from_numpy(rng.standard_normal((1, 64, 4, 16)).astype(np.float32))
  kv = torch.from_numpy(rng.standard_normal((1, 64, 2, 16)).astype(np.float32))
  q.requires_grad_()
  ops.flash_attention(q, kv, kv, bwd="fused").sum().backward()
  assert calls == [q.shape]
  ops.flash_attention(q, q, q, bwd="fused").sum().backward()   # MHA: fused
  assert len(calls) == 1


GRAD_CFG = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64,
                d_ff=128, max_seq_len=128)


@pytest.mark.parametrize("kv_heads", [0, 2], ids=["mha", "gqa"])
def test_split_plan_model_gradients_match_jax(monkeypatch, kv_heads):
  # both packages read the plan from the environment when they trace
  monkeypatch.setenv("TFOS_TPU_FLASH_BWD", "split")
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False,
                                   attention_impl="flash",
                                   layer_norm_impl="fused",
                                   num_kv_heads=kv_heads, **GRAD_CFG)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, remat=False,
                               num_kv_heads=kv_heads, **GRAD_CFG)
  state = jax_tfm.create_state(jax.random.PRNGKey(4), jcfg, seq_len=16)
  params = jax.tree.map(np.asarray, state.params)
  tokens = np.random.default_rng(5).integers(0, 96, size=(2, 128))
  model = jax_tfm.Transformer(jcfg)

  def jloss(p):
    return jax_tfm.causal_lm_loss(
        model.apply({"params": p}, jnp.asarray(tokens, jnp.int32)),
        jnp.asarray(tokens, jnp.int32))

  want_loss, want = jax.value_and_grad(jloss)(params)
  want = params_from_flax(jax.tree.map(np.asarray, want), tcfg)
  tmodel = tfm.Transformer(tcfg, params_from_flax(params, tcfg), device="cpu",
                           trainable=True)
  calls = []
  real = tfa.flash_attention_bwd_dkv

  def spy(*args, **kw):
    calls.append(1)
    return real(*args, **kw)

  monkeypatch.setattr(tfa, "flash_attention_bwd_dkv", spy)
  tt = torch.from_numpy(tokens)
  loss = tfm.causal_lm_loss(tmodel(tt), tt)
  names, weights = zip(*tmodel.named_parameters())
  grads = torch.autograd.grad(loss, weights)
  assert len(calls) == GRAD_CFG["num_layers"]      # the split plan ran
  np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                             rtol=1e-4)
  for name, g in zip(names, grads):
    np.testing.assert_allclose(g.numpy(), want[name], atol=1e-4, rtol=1e-4,
                               err_msg=name)
