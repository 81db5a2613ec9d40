"""The PyTorch port's fused LN->matmul and GELU->matmul against the JAX
package's, on the CPU.

The JAX side runs the Pallas kernels ``ln_matmul`` / ``gelu_matmul`` in
interpret mode (the model with ``attention_impl="flash"`` and
``layer_norm_impl="fused"`` too); the port runs on the CPU, where its ops
take their plain versions. Inputs and tokens are made with numpy from a
seed; weights go across with ``params_from_flax``. The hand-written
kernels themselves run only on the card: ``tests/test_torch_kernels.py``.
"""

import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu.ops.act_matmul import gelu_matmul as jax_gelu_mm
from tensorflowonspark_tpu.ops.ln_matmul import ln_matmul as jax_ln_mm
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu.parallel import sharding as jax_sharding
from tensorflowonspark_tpu_torch import ops, optim
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.parallel import sharding
from tensorflowonspark_tpu_torch.serving import ServingEngine
from tensorflowonspark_tpu_torch.utils.params import (init_params,
                                                      params_from_flax,
                                                      params_to_flax)

ALL_FUSED = dict(fuse_qkv=True, ln_matmul_impl="fused",
                 act_matmul_impl="fused")
FUSED_CONFIGS = {
    "all_fused": dict(ALL_FUSED),
    "all_fused_gqa": dict(ALL_FUSED, num_kv_heads=2),
    "ln_only": dict(ln_matmul_impl="fused"),
    "act_only": dict(act_matmul_impl="fused"),
}
GRAD_CFG = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64,
                d_ff=128, max_seq_len=128)
SEQ = 128

# (rows, K, N): a block of whole rows, and 33 ragged rows into the grouped
# fused-QKV width N = (H + 2 Hk) * head_dim = 1280
SHAPES = {"rows64": (64, 64, 192), "ragged33_n1280": (33, 64, 1280)}


def _tol(dtype):
  # f32: the JAX package's own f32 tolerance for its kernels (forward) and
  # 1e-4 for gradients (sums over rows in another order); bf16: one or two
  # bf16 ulps of outputs of magnitude ~1-8
  return (1e-5, 1e-4) if dtype == "float32" else (3e-2, 3e-2)


def _compare(got, want, tol, what):
  np.testing.assert_allclose(got.detach().float().numpy(),
                             np.asarray(want, np.float32), atol=tol,
                             rtol=tol, err_msg=what)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_matmul_matches_jax_kernel(dtype, shape):
  rows, h, n = SHAPES[shape]
  rng = np.random.default_rng(11)
  x = rng.standard_normal((rows, h)).astype(np.float32) * 2.0 + 0.5
  w = (rng.random(h) + 0.5).astype(np.float32)
  W = (rng.standard_normal((h, n)) / np.sqrt(h)).astype(np.float32)
  g = rng.standard_normal((rows, n)).astype(np.float32)
  jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
  want, vjp = jax.vjp(lambda a, b, c: jax_ln_mm(a, b, c, interpret=True),
                      jnp.asarray(x, jdt), jnp.asarray(w),
                      jnp.asarray(W, jdt))
  wdx, wdw, wdW = vjp(jnp.asarray(g, jdt))
  tx = torch.from_numpy(x).to(tdt).requires_grad_()
  tw = torch.from_numpy(w).requires_grad_()
  tW = torch.from_numpy(W).to(tdt).requires_grad_()
  out = ops.ln_matmul(tx, tw, tW)
  out.backward(torch.from_numpy(g).to(tdt))
  ftol, gtol = _tol(dtype)
  assert out.dtype == tdt and out.shape == (rows, n)
  _compare(out, want, ftol, "out")
  assert tx.grad.dtype == tdt and tw.grad.dtype == torch.float32
  for name, t, j in (("dx", tx, wdx), ("dw_ln", tw, wdw), ("dW", tW, wdW)):
    _compare(t.grad, j, gtol, name)
  # the plain version is the forward the CPU ran
  assert torch.equal(ops.ln_matmul_reference(tx.detach(), tw.detach(),
                                             tW.detach()), out.detach())


# (rows, H, N, mean of x): the widths where the card's wgmma body meets its
# tile edges (128 rows x 256 columns x 64-deep K steps): K 776 = 12 x 64 + 8
# with N 200 under one column tile, K 256 (train_gpt's d_model) into the
# grouped fused-QKV width N 1280 over 33 ragged rows, and rows whose mean is
# large against their spread (x = 100 + N(0, 1)), where the normalisation
# must subtract the mean before it scales
EDGE_SHAPES = {"k776_n200": (100, 776, 200, 0.5),
               "k256_n1280_rows33": (33, 256, 1280, 0.5),
               "large_mean": (64, 768, 256, 100.0)}


@pytest.mark.parametrize("shape", sorted(EDGE_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_matmul_reference_matches_jax_at_tile_edges(dtype, shape):
  rows, h, n, mean = EDGE_SHAPES[shape]
  rng = np.random.default_rng(13)
  spread = 1.0 if mean > 1 else 2.0
  x = rng.standard_normal((rows, h)).astype(np.float32) * spread + mean
  w = (rng.random(h) + 0.5).astype(np.float32)
  W = (rng.standard_normal((h, n)) / np.sqrt(h)).astype(np.float32)
  jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
  want = jax_ln_mm(jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(W, jdt),
                   interpret=True)
  got = ops.ln_matmul_reference(torch.from_numpy(x).to(tdt),
                                torch.from_numpy(w),
                                torch.from_numpy(W).to(tdt))
  assert got.dtype == tdt and got.shape == (rows, n)
  # f32: the row statistics of the two packages sum in another order, and
  # their rounding scales with the magnitude of x, so the f32 tolerance does
  # too (bf16 rounding of the output is the larger term there)
  tol = _tol(dtype)[0] * (max(1.0, mean) if dtype == "float32" else 1.0)
  _compare(got, want, tol, "out")
  assert np.isfinite(got.float().numpy()).all()


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matmul_matches_jax_kernel(dtype, shape):
  rows, f, n = SHAPES[shape]
  rng = np.random.default_rng(12)
  x = rng.standard_normal((rows, f)).astype(np.float32) * 2.0
  W = (rng.standard_normal((f, n)) / np.sqrt(f)).astype(np.float32)
  g = rng.standard_normal((rows, n)).astype(np.float32)
  jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
  want, vjp = jax.vjp(lambda a, c: jax_gelu_mm(a, c, interpret=True),
                      jnp.asarray(x, jdt), jnp.asarray(W, jdt))
  wdx, wdW = vjp(jnp.asarray(g, jdt))
  tx = torch.from_numpy(x).to(tdt).requires_grad_()
  tW = torch.from_numpy(W).to(tdt).requires_grad_()
  out = ops.gelu_matmul(tx, tW)
  out.backward(torch.from_numpy(g).to(tdt))
  ftol, gtol = _tol(dtype)
  assert out.dtype == tdt and out.shape == (rows, n)
  _compare(out, want, ftol, "out")
  _compare(tx.grad, wdx, gtol, "dx")
  _compare(tW.grad, wdW, gtol, "dW")


def test_fused_wrappers_refuse_bad_inputs():
  x = torch.randn(4, 16)
  with pytest.raises(ValueError, match="w_ln"):
    ops.ln_matmul(x, torch.ones(8), torch.randn(16, 8))
  with pytest.raises(ValueError, match=r"W \[H, N\]"):
    ops.ln_matmul(x, torch.ones(16), torch.randn(8, 8))
  with pytest.raises(ValueError, match=r"W \[F, N\]"):
    ops.gelu_matmul(x, torch.randn(8, 8))
  with pytest.raises(ValueError, match="CUDA or all on the CPU"):
    ops.on_card(x, torch.empty(0, device="meta"))
  # the backwards return each gradient in its input's dtype
  xb = x.bfloat16()
  dx, dw, dW = ops.ln_matmul_bwd(xb, torch.ones(16), torch.randn(16, 8)
                                 .bfloat16(), torch.randn(4, 8))
  assert (dx.dtype, dw.dtype, dW.dtype) == (torch.bfloat16, torch.float32,
                                            torch.bfloat16)
  dx, dW = ops.gelu_matmul_bwd(xb, torch.randn(16, 8), torch.randn(4, 8))
  assert (dx.dtype, dW.dtype) == (torch.bfloat16, torch.float32)


# -- the model -----------------------------------------------------------------


def _configs(remat=False, **kw):
  kw = dict(GRAD_CFG, **kw)
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False,
                                   attention_impl="flash",
                                   layer_norm_impl="fused", **kw)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, remat=remat, **kw)
  return jcfg, tcfg


@pytest.fixture(scope="module", params=sorted(FUSED_CONFIGS))
def fused_reference(request):
  """(config name, flax params, tokens, JAX loss, flat JAX gradients)."""
  kw = FUSED_CONFIGS[request.param]
  jcfg, tcfg = _configs(**kw)
  state = jax_tfm.create_state(jax.random.PRNGKey(4), jcfg, seq_len=16)
  params = jax.tree.map(np.asarray, state.params)
  tokens = np.random.default_rng(6).integers(0, GRAD_CFG["vocab_size"],
                                             size=(2, SEQ))
  model = jax_tfm.Transformer(jcfg)
  jt = jnp.asarray(tokens, jnp.int32)

  def loss_fn(p):
    return jax_tfm.causal_lm_loss(model.apply({"params": p}, jt), jt)

  loss, grads = jax.value_and_grad(loss_fn)(params)
  return (request.param, params, tokens, float(loss),
          params_from_flax(jax.tree.map(np.asarray, grads), tcfg))


@pytest.mark.parametrize("remat", [False, True])
def test_fused_configs_loss_and_every_gradient_match_jax(fused_reference,
                                                         remat):
  name, params, tokens, want_loss, want_grads = fused_reference
  _, tcfg = _configs(remat=remat, **FUSED_CONFIGS[name])
  model = tfm.Transformer(tcfg, params_from_flax(params, tcfg), device="cpu",
                          trainable=True)
  t = torch.from_numpy(tokens)
  loss = tfm.causal_lm_loss(model(t), t)
  names, weights = zip(*model.named_parameters())
  grads = torch.autograd.grad(loss, weights)
  np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-4)
  assert sorted(names) == sorted(want_grads)
  for n, g in zip(names, grads):
    np.testing.assert_allclose(g.numpy(), want_grads[n], atol=1e-4,
                               rtol=1e-4, err_msg=n)


def test_fused_param_tree_is_the_unfused_tree():
  # the reference keeps one param tree across the fusion settings: a JAX
  # all-fused tree loads into the port's all-fused and unfused models
  jcfg, tcfg = _configs(**ALL_FUSED)
  _, plain = _configs(fuse_qkv=True)
  tree = jax.tree.map(np.asarray, jax_tfm.create_state(
      jax.random.PRNGKey(0), jcfg, seq_len=16).params)
  ref = jax.tree.map(np.asarray, jax_tfm.create_state(
      jax.random.PRNGKey(0), _configs(fuse_qkv=True)[0], seq_len=16).params)
  assert jax.tree_util.tree_structure(tree) == \
      jax.tree_util.tree_structure(ref)
  flat = params_from_flax(tree, tcfg)
  assert sorted(flat) == sorted(params_from_flax(tree, plain))
  fused = tfm.Transformer(tcfg, flat, device="cpu")
  unfused = tfm.Transformer(plain, flat, device="cpu")
  assert [n for n, _ in fused.named_parameters()] == \
      [n for n, _ in unfused.named_parameters()]
  back = params_to_flax(fused.numpy_params(), tcfg)
  for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                              jax.tree_util.tree_leaves_with_path(tree)):
    assert pa == pb and np.array_equal(a, b)
  # and the two forwards agree (f32: rounding order only)
  tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 96, (2, 48)))
  with torch.no_grad():
    np.testing.assert_allclose(fused(tokens).numpy(),
                               unfused(tokens).numpy(), atol=1e-5, rtol=1e-5)


def test_ln_fused_attention_requires_fuse_qkv():
  _, tcfg = _configs(ln_matmul_impl="fused")
  model = tfm.Transformer(tcfg, init_params(tcfg, seed=0), device="cpu")
  attn = model.layers[0].attn
  x = torch.randn(1, 8, tcfg.d_model)
  rope = tfm._rope_tables(torch.arange(8)[None], tcfg.head_dim)
  with pytest.raises(ValueError, match="requires fuse_qkv"):
    attn(x, rope, ln_scale=model.layers[0].ln1.scale)


def _count_fused_forwards(monkeypatch):
  """Count calls of each fused op's forward (on the CPU the plain version
  runs there; on the card it is where the kernel launches)."""
  counts = {"ln_matmul": 0, "gelu_matmul": 0}
  for name, mod in (("ln_matmul", "ln_matmul"),
                    ("gelu_matmul", "act_matmul")):
    module = sys.modules["tensorflowonspark_tpu_torch.ops." + mod]
    inner = module._forward

    def counted(*args, _inner=inner, _name=name):
      counts[_name] += 1
      return _inner(*args)
    monkeypatch.setattr(module, "_forward", counted)
  return counts


@pytest.mark.parametrize("remat", [False, True])
def test_each_fused_forward_runs_once_per_layer_and_again_under_remat(
    monkeypatch, remat):
  _, tcfg = _configs(remat=remat, **ALL_FUSED)
  model = tfm.Transformer(tcfg, init_params(tcfg, seed=1), device="cpu",
                          trainable=True)
  counts = _count_fused_forwards(monkeypatch)
  tokens = torch.from_numpy(np.random.default_rng(9).integers(0, 96, (2, 32)))
  tfm.causal_lm_loss(model(tokens), tokens).backward()
  per = 2 if remat else 1      # the backward re-runs each block's forward
  layers = tcfg.num_layers
  assert counts == {"ln_matmul": 2 * layers * per,
                    "gelu_matmul": layers * per}


def test_all_fused_serving_equals_unfused(monkeypatch):
  # the decode path never fuses (as the reference's decode=True): the
  # all-fused config serves exactly the tokens of the unfused one
  small = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
               d_model=32, d_ff=64, max_seq_len=64, dtype=torch.float32)
  fused = tfm.TransformerConfig(**small, **ALL_FUSED)
  plain = tfm.TransformerConfig(**small, fuse_qkv=True)
  params = init_params(plain, seed=2)
  rng = np.random.default_rng(10)
  prompts = [rng.integers(1, 64, size=n) for n in (3, 16, 33)]
  counts = _count_fused_forwards(monkeypatch)
  outs = {}
  for name, cfg in (("fused", fused), ("plain", plain)):
    eng = ServingEngine(params, cfg, num_slots=2, horizon=4,
                        device="cpu").start()
    try:
      outs[name] = eng.generate(prompts, max_new_tokens=6, timeout=120)
    finally:
      eng.stop()
  assert counts == {"ln_matmul": 0, "gelu_matmul": 0}
  for a, b in zip(outs["fused"], outs["plain"]):
    np.testing.assert_array_equal(a, b)
  model = tfm.Transformer(fused, params, device="cpu")
  ref = tfm.greedy_generate_kv(model, prompts[1][None], 6).numpy()[0]
  np.testing.assert_array_equal(outs["fused"][1], ref)


STEP_CFG = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                d_model=32, d_ff=64, max_seq_len=32, **ALL_FUSED)
OPT = dict(learning_rate=3e-3, clip_norm=1.0, warmup_steps=1,
           schedule="cosine", decay_steps=4)


def test_all_fused_train_steps_match_jax_make_train_step():
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False,
                                   attention_impl="flash",
                                   layer_norm_impl="fused", **STEP_CFG)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, **STEP_CFG)
  jstate = jax_tfm.create_state(jax.random.PRNGKey(5), jcfg, seq_len=32,
                                tx=jax_optim.make_optimizer(**OPT))
  params = params_from_flax(jax.tree.map(np.asarray, jstate.params), tcfg)
  mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(data=1),
                             devices=jax.devices()[:1])

  def jloss(p, tokens):
    return jax_tfm.causal_lm_loss(jstate.apply_fn({"params": p}, tokens),
                                  tokens)

  def tloss(model, tokens):
    return tfm.causal_lm_loss(model(tokens), tokens)

  jstep = jax_sharding.make_train_step(jloss, mesh, donate_state=False)
  tstate = tfm.create_state(tcfg, params, tx=optim.make_optimizer(**OPT),
                            device="cpu")
  tstep = sharding.make_train_step(tloss)
  rng = np.random.default_rng(7)
  for _ in range(3):
    tokens = rng.integers(0, 64, size=(4, 32)).astype(np.int32)
    jstate, jl = jstep(jstate, jnp.asarray(tokens))
    tstate, tl = tstep(tstate, tokens)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
  got = params_to_flax(tstate.model.numpy_params(), tcfg)
  for (path, a), (_, b) in zip(
      jax.tree_util.tree_leaves_with_path(got),
      jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                       jstate.params))):
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=str(path))
