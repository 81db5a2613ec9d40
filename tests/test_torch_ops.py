"""The PyTorch port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX kernels
run in interpret mode. Inputs are made with numpy from a seed and handed
to both. The hand-written kernels themselves run only on the card: see
``tests/test_torch_kernels.py``.
"""

import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import jax

from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu.ops import flash_attention as jax_flash
from tensorflowonspark_tpu.ops import flash_attention_block as jax_flash_block
from tensorflowonspark_tpu.ops import layer_norm as jax_layer_norm
from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.models import transformer as tfm


def _ln_inputs(seed):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((64, 256)).astype(np.float32) * 2.0 + 0.5
  w = (rng.random(256) + 0.5).astype(np.float32)
  return x, w


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_layer_norm_matches_jax_kernel(dtype, tol):
  # same tolerances as the JAX package's own LayerNorm tests
  x, w = _ln_inputs(0)
  jx = jnp.asarray(x, getattr(jnp, dtype))
  want = jax_layer_norm(jx, jnp.asarray(w), interpret=True)
  tx = torch.from_numpy(x).to(getattr(torch, dtype))
  got = ops.layer_norm(tx, torch.from_numpy(w))
  assert got.dtype == tx.dtype
  np.testing.assert_allclose(got.float().numpy(),
                             np.asarray(want, np.float32), atol=tol, rtol=tol)


# (H, Hk, q_base, kv_base, causal, window)
FLASH_CASES = {
    "mha_causal": (4, 4, 0, 0, True, None),
    "gqa_causal": (4, 2, 0, 0, True, None),
    "window_24": (4, 2, 0, 0, True, 24),
    "non_causal": (4, 4, 0, 0, False, None),
    "kv_ahead": (4, 2, 0, 32, True, None),   # queries before every key
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_reference_matches_jax_kernel(case):
  h, hk, q_base, kv_base, causal, window = FLASH_CASES[case]
  rng = np.random.default_rng(1)
  b, s, d = 2, 64, 16
  q = rng.standard_normal((b, s, h, d)).astype(np.float32)
  k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
  v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
  jo, jl = jax_flash_block(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           q_base, kv_base, causal=causal, interpret=True,
                           blk_q=16, blk_k=16, window=window)
  to, tl = ops.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), q_base, kv_base,
                                   causal=causal, window=window)
  assert to.shape == (b, s, h, d) and tl.shape == (b, h, s)
  assert tl.dtype == torch.float32
  np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5,
                             rtol=2e-5)
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                             rtol=2e-5)
  if case == "kv_ahead":
    # queries before the first key see nothing: lse -1e30, out 0 in both
    dead = slice(0, kv_base - q_base)
    assert (tl[:, :, dead] == -1e30).all()
    assert (np.asarray(jl)[:, :, dead] == -1e30).all()
    assert (to[:, dead] == 0).all()
    assert (np.asarray(jo)[:, dead] == 0).all()


def test_rotary_matches_jax():
  rng = np.random.default_rng(2)
  x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
  pos = rng.integers(0, 2048, size=(2, 12))
  want = jax_tfm._rotary(jnp.asarray(x), jnp.asarray(pos, jnp.int32))
  got = tfm._rotary(torch.from_numpy(x), torch.from_numpy(pos))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                             rtol=1e-5)


def test_cpu_calls_run_plain_versions_and_count_nothing():
  ops.reset_launches()
  x = torch.randn(8, 64, requires_grad=True)
  ops.layer_norm(x, torch.ones(64)).sum().backward()
  q = torch.randn(1, 16, 2, 64, requires_grad=True)
  ops.flash_attention(q, q, q).sum().backward()
  out, lse = ops.flash_attention_fwd(q, q[:, :, :1], q[:, :, :1], 3, 0)
  (out.sum() + lse.sum()).backward()
  w = torch.randn(64, 32, requires_grad=True)
  h = ops.ln_matmul(x, torch.ones(64, requires_grad=True), w)
  ops.gelu_matmul(h, torch.randn(32, 16)).sum().backward()
  ops.flash_attention(q, q[:, :, :1], q[:, :, :1],
                      bwd="split").sum().backward()
  assert ops.LAUNCHES == {"layer_norm": 0, "layer_norm_bwd": 0,
                          "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                          "flash_attention_bwd_gqa": 0,
                          "flash_attention_bwd_dq": 0,
                          "flash_attention_bwd_dkv": 0,
                          "flash_attention_bwd_dkv_gqa": 0, "ln_matmul": 0,
                          "gelu_matmul": 0}


def test_wrappers_refuse_gradients_and_bad_inputs(monkeypatch):
  q = torch.randn(1, 8, 4, 16, requires_grad=True)
  # the split backward plan, asked for or from the environment, gives the
  # fused plan's gradient
  want = torch.autograd.grad(ops.flash_attention(q, q, q).sum(), q)[0]
  got = torch.autograd.grad(ops.flash_attention(q, q, q, bwd="split").sum(),
                            q)[0]
  torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
  monkeypatch.setenv("TFOS_TPU_FLASH_BWD", "split")
  got = torch.autograd.grad(ops.flash_attention(q, q, q).sum(), q)[0]
  torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
  with torch.no_grad():
    ops.flash_attention(q, q, q)
  with pytest.raises(ValueError, match="bwd"):
    ops.flash_attention(q, q, q, bwd="fast")
  monkeypatch.setenv("TFOS_TPU_FLASH_BWD", "bogus")
  with pytest.raises(ValueError, match="TFOS_TPU_FLASH_BWD"):
    ops.flash_attention(q, q, q)
  monkeypatch.delenv("TFOS_TPU_FLASH_BWD")
  with pytest.raises(ValueError, match="g shaped like x"):
    ops.layer_norm_bwd(torch.randn(4, 32), torch.ones(32),
                       torch.randn(4, 16))
  q = torch.randn(1, 8, 4, 16)
  with pytest.raises(ValueError, match="must divide"):
    ops.flash_attention(q, q[:, :, :3], q[:, :, :3])
  with pytest.raises(ValueError, match="causal"):
    ops.flash_attention(q, q, q, causal=False, window=4)
  with pytest.raises(ValueError, match="weight"):
    ops.layer_norm(torch.randn(4, 32), torch.ones(16))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_layer_norm_bwd_matches_jax_vjp(dtype, tol):
  x, w = _ln_inputs(3)
  g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
  jdt = getattr(jnp, dtype)
  _, vjp = jax.vjp(lambda a, b: jax_layer_norm(a, b, interpret=True),
                   jnp.asarray(x, jdt), jnp.asarray(w))
  jdx, jdw = vjp(jnp.asarray(g, jdt))
  tdt = getattr(torch, dtype)
  tx = torch.from_numpy(x).to(tdt).requires_grad_()
  tw = torch.from_numpy(w).requires_grad_()
  ops.layer_norm(tx, tw).backward(torch.from_numpy(g).to(tdt))
  assert tx.grad.dtype == tdt and tw.grad.dtype == torch.float32
  np.testing.assert_allclose(tx.grad.float().numpy(),
                             np.asarray(jdx, np.float32), atol=tol, rtol=tol)
  np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=tol,
                             rtol=tol)
  # the plain backward called directly gives the autograd result
  dx, dw = ops.layer_norm_bwd(tx.detach(), tw.detach(),
                              torch.from_numpy(g).to(tdt))
  assert torch.equal(dx, tx.grad) and torch.equal(dw, tw.grad)


# (H, Hk, q_base, kv_base, window, lse cotangent)
FLASH_BWD_CASES = {
    "mha": (4, 4, 0, 0, None, False),
    "gqa_g2": (4, 2, 0, 0, None, False),
    "gqa_g4": (4, 1, 0, 0, None, False),
    "window_24": (4, 2, 0, 0, 24, False),
    "bases_lse_cotangent": (4, 2, 40, 8, None, True),
    "empty_rows": (4, 2, 0, 32, None, True),
}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("case", sorted(FLASH_BWD_CASES))
def test_flash_bwd_matches_jax_grad(case, dtype, tol):
  h, hk, q_base, kv_base, window, with_lse = FLASH_BWD_CASES[case]
  rng = np.random.default_rng(5)
  b, s, d = 2, 64, 16
  q = rng.standard_normal((b, s, h, d)).astype(np.float32)
  k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
  v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
  go = rng.standard_normal((b, s, h, d)).astype(np.float32)
  gl = rng.standard_normal((b, h, s)).astype(np.float32) * with_lse
  blocks = dict(interpret=True, blk_q=16, blk_k=16, blk_bwd_q=16,
                blk_bwd_k=32, bwd="fused", window=window)

  def jloss(q, k, v):
    if with_lse:
      o, l = jax_flash_block(q, k, v, q_base, kv_base, **blocks)
      l = jnp.where(l <= -1e29, 0.0, l)
      return jnp.sum(o.astype(jnp.float32) * go) + jnp.sum(l * gl)
    o = jax_flash(q, k, v, **blocks)
    return jnp.sum(o.astype(jnp.float32) * go)

  jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
  want = jax.grad(jloss, argnums=(0, 1, 2))(
      *(jnp.asarray(a, jdt) for a in (q, k, v)))
  tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                for a in (q, k, v))
  if with_lse:
    o, l = ops.flash_attention_fwd(tq, tk, tv, q_base, kv_base,
                                   window=window)
    l = torch.where(l <= -1e29, 0.0, l)
    loss = (o.float() * torch.from_numpy(go)).sum() + \
        (l * torch.from_numpy(gl)).sum()
  else:
    o = ops.flash_attention(tq, tk, tv, window=window)
    loss = (o.float() * torch.from_numpy(go)).sum()
  loss.backward()
  for name, t, j in zip("qkv", (tq, tk, tv), want):
    assert t.grad.dtype == tdt
    np.testing.assert_allclose(t.grad.float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol,
                               err_msg="d" + name)
  if case == "empty_rows":
    # queries before the first key get no gradient in either package
    dead = slice(0, kv_base - q_base)
    assert (tq.grad[:, dead] == 0).all()
    assert (np.asarray(want[0])[:, dead] == 0).all()


def test_tma_operands_copy_unaligned_bf16_bases():
  # the bf16 kernels read tiles by TMA, which needs 16-byte aligned bases:
  # the wrappers copy a bf16 view at another offset and pass the rest as it
  # is; the f32 kernels do not use TMA
  fa = sys.modules["tensorflowonspark_tpu_torch.ops.flash_attention"]
  n = 2 * 64 * 4 * 64
  buf = torch.arange(n + 8).to(torch.bfloat16)
  assert buf.data_ptr() % 16 == 0
  aligned = buf[8:].view(2, 64, 4, 64)
  assert fa._tma_operand(aligned) is aligned
  odd = buf[1:n + 1].view(2, 64, 4, 64)
  got = fa._tma_operand(odd)
  assert got.data_ptr() % 16 == 0 and got.is_contiguous()
  assert torch.equal(got, odd)
  f32 = torch.zeros(n + 1)[1:].view(2, 64, 4, 64)
  assert fa._tma_operand(f32) is f32
  strided = buf[:n].view(2, 4, 64, 64).transpose(1, 2)
  got = fa._tma_operand(strided)
  assert got.is_contiguous() and torch.equal(got, strided)


@pytest.mark.parametrize("h", [8193, 12288, 16384])
def test_layer_norm_kernel_check_takes_rows_past_8192(h):
  # rows wider than 8192 take the block-per-row kernels on the card
  ln = sys.modules["tensorflowonspark_tpu_torch.ops.layer_norm"]
  ln._check_kernel_inputs(torch.zeros(2, h), torch.ones(h))
  with pytest.raises(TypeError, match="weight must be f32"):
    ln._check_kernel_inputs(torch.zeros(2, h), torch.ones(h).double())


@pytest.mark.parametrize("k,n", [(771, 203), (20, 12), (776, 200)])
def test_fused_product_kernel_check_takes_any_k_and_n(k, n):
  # K and N off a multiple of 8 are read element by element on the card
  lm = sys.modules["tensorflowonspark_tpu_torch.ops.ln_matmul"]
  for dtype in (torch.bfloat16, torch.float32):
    x, W = torch.zeros(3, k, dtype=dtype), torch.zeros(k, n, dtype=dtype)
    lm.check_kernel_inputs("ln_matmul", x, W, torch.ones(k))
    lm.check_kernel_inputs("gelu_matmul", x, W)
  with pytest.raises(TypeError, match="both bf16 or both f32"):
    lm.check_kernel_inputs("gelu_matmul", torch.zeros(3, k),
                           torch.zeros(k, n, dtype=torch.bfloat16))
