"""The PyTorch port's hand-written kernels against their plain versions,
on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside a
fixture, never at import). JAX-free, so it runs on a machine that has
only PyTorch: ``python -m pytest tests/test_torch_kernels.py -m cuda``.
"""

import sys

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.data import readers
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.serving import ServingEngine
from tensorflowonspark_tpu_torch.utils.params import init_params

# (H, Hk, q_base, kv_base, causal, window)
FLASH_CASES = {
    "mha_causal": (4, 4, 0, 0, True, None),
    "gqa_causal": (4, 2, 0, 0, True, None),
    "window_24": (4, 2, 0, 0, True, 24),
    "non_causal": (4, 4, 0, 0, False, None),
    "kv_ahead": (4, 2, 0, 32, True, None),
    "q_offset": (4, 2, 100, 0, True, None),
}


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernels run only there")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_layer_norm_kernel_matches_plain_on_card(card, dtype, tol):
  x = torch.randn(512, 768, device=card).to(dtype)
  w = torch.rand(768, device=card) + 0.5
  ops.reset_launches()
  got = ops.layer_norm(x, w)
  assert ops.LAUNCHES["layer_norm"] == 1
  want = ops.layer_norm_reference(x, w)
  torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain_on_card(card, case):
  h, hk, q_base, kv_base, causal, window = FLASH_CASES[case]
  g = torch.Generator(device=card).manual_seed(0)
  q = torch.randn(2, 200, h, 64, device=card, generator=g)
  k = torch.randn(2, 200, hk, 64, device=card, generator=g)
  v = torch.randn(2, 200, hk, 64, device=card, generator=g)
  ops.reset_launches()
  out, lse = ops.flash_attention_fwd(q, k, v, q_base, kv_base, causal, window)
  assert ops.LAUNCHES["flash_attention_fwd"] == 1
  ro, rl = ops.flash_attention_reference(q, k, v, q_base, kv_base, causal,
                                         window)
  torch.testing.assert_close(out, ro, atol=2e-5, rtol=2e-5)
  torch.testing.assert_close(lse, rl, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_engine_on_card_equals_greedy_decode(card):
  # f32 with TF32 off: the engine's batched matmuls and the single-row
  # decode then agree to float rounding, so greedy tokens match
  torch.backends.cuda.matmul.allow_tf32 = False
  cfg = tfm.TransformerConfig(vocab_size=256, num_layers=2, num_heads=2,
                              d_model=128, d_ff=256, max_seq_len=256,
                              dtype=torch.float32)
  params = init_params(cfg, seed=0)
  rng = np.random.default_rng(0)
  prompts = [rng.integers(1, 256, size=n) for n in (1, 17, 64, 130)]
  ops.reset_launches()
  eng = ServingEngine(params, cfg, num_slots=2, horizon=4).start()
  try:
    outs = eng.generate(prompts, max_new_tokens=8, timeout=300)
  finally:
    eng.stop()
  assert ops.LAUNCHES["flash_attention_fwd"] == 2 * len(prompts) - 2
  assert ops.LAUNCHES["layer_norm"] > 0
  for p, out in zip(prompts, outs):
    ref = tfm.greedy_generate_kv(eng.model, p[None], 8).cpu().numpy()[0]
    np.testing.assert_array_equal(out, ref)


# (rows, h, dtype, tol): one row, three rows (fewer than a block's teams),
# the training batch 16384 and 16387 rows (not a multiple of the 8 rows a
# block holds at h 768), f32 (two warps a row), h 770 (unvectorised, eight
# warps a row), h 2000 (two warps, four packs a lane), h 8192 (eight warps a
# row), f32 at h 1024, and h 12288 (the block-per-row kernel)
LN_BWD_CASES = [(512, 768, torch.float32, 1e-4),
                (512, 768, torch.bfloat16, 3e-2),
                (1, 768, torch.bfloat16, 3e-2), (3, 768, torch.bfloat16, 3e-2),
                (16384, 768, torch.bfloat16, 3e-2),
                (16387, 768, torch.bfloat16, 3e-2),
                (33, 770, torch.bfloat16, 3e-2),
                (17, 2000, torch.bfloat16, 3e-2),
                (40, 8192, torch.bfloat16, 3e-2),
                (4100, 1024, torch.float32, 1e-4),
                (64, 12288, torch.bfloat16, 3e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h,dtype,tol", LN_BWD_CASES)
def test_layer_norm_bwd_kernel_matches_plain_on_card(card, rows, h, dtype,
                                                     tol):
  g = torch.Generator(device=card).manual_seed(1)
  x = (torch.randn(rows, h, device=card, generator=g) * 2 + 0.5).to(dtype)
  w = torch.rand(h, device=card, generator=g) + 0.5
  gy = torch.randn(rows, h, device=card, generator=g).to(dtype)
  ops.reset_launches()
  dx, dw = ops.layer_norm_bwd(x, w, gy)
  assert ops.LAUNCHES["layer_norm_bwd"] == 1
  rdx, rdw = ops.layer_norm_bwd_reference(x, w, gy)
  torch.testing.assert_close(dx.float(), rdx.float(), atol=tol, rtol=tol)
  # dw sums ``rows`` terms in another order
  torch.testing.assert_close(dw, rdw, atol=1e-3 * rows ** 0.5, rtol=1e-4)
  # no atomics: a second run gives the same bits
  dx2, dw2 = ops.layer_norm_bwd(x, w, gy)
  assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


def _flash_grads(q, k, v, q_base, kv_base, causal, window, go, gl):
  q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
  out, lse = ops.flash_attention_fwd(q, k, v, q_base, kv_base, causal, window)
  loss = (out.float() * go).sum() + (torch.where(lse <= -1e29, 0.0, lse)
                                     * gl).sum()
  loss.backward()
  return q.grad, k.grad, v.grad


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_plain_on_card(card, case, dtype):
  h, hk, q_base, kv_base, causal, window = FLASH_CASES[case]
  g = torch.Generator(device=card).manual_seed(2)
  mk = lambda *s: torch.randn(*s, device=card, generator=g)  # noqa: E731
  q, k, v = mk(2, 200, h, 64), mk(2, 200, hk, 64), mk(2, 200, hk, 64)
  go, gl = mk(2, 200, h, 64), mk(2, h, 200)
  q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
  ops.reset_launches()
  got = _flash_grads(q, k, v, q_base, kv_base, causal, window, go, gl)
  name = "flash_attention_bwd" if h == hk else "flash_attention_bwd_gqa"
  assert ops.LAUNCHES[name] == 1
  out, lse = ops.flash_attention_reference(q, k, v, q_base, kv_base, causal,
                                           window)
  gl_eff = torch.where(lse <= -1e29, 0.0, gl)
  want = ops.flash_attention_bwd_reference(q, k, v, out, lse,
                                           go.to(dtype), gl_eff, q_base,
                                           kv_base, causal, window)
  tol = 2e-4 if dtype == torch.float32 else 3e-2
  for a, b in zip(got, want):
    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
  again = _flash_grads(q, k, v, q_base, kv_base, causal, window, go, gl)
  assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_flash_bwd_kernel_head_dim_128_on_card(card):
  g = torch.Generator(device=card).manual_seed(3)
  q = torch.randn(1, 130, 4, 128, device=card, generator=g)
  k = torch.randn(1, 130, 2, 128, device=card, generator=g)
  v = torch.randn(1, 130, 2, 128, device=card, generator=g)
  go = torch.randn(1, 130, 4, 128, device=card, generator=g)
  gl = torch.zeros(1, 4, 130, device=card)
  got = _flash_grads(q, k, v, 0, 0, True, None, go, gl)
  out, lse = ops.flash_attention_reference(q, k, v)
  want = ops.flash_attention_bwd_reference(q, k, v, out, lse, go)
  for a, b in zip(got, want):
    torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


# (rows, K, N, dtype, tol): the fused-QKV width 2304, ragged rows into the
# grouped width 1280, ragged rows/K/N against the 128 x 128 x 32 tiles, and
# K and N that are not multiples of 8 (rows off a 16-byte boundary: element
# loads and stores)
FUSED_CASES = [(512, 768, 2304, torch.bfloat16, 2e-2),
               (33, 768, 1280, torch.bfloat16, 2e-2),
               (100, 776, 200, torch.bfloat16, 2e-2),
               (100, 771, 203, torch.bfloat16, 2e-2),
               (40, 64, 13, torch.bfloat16, 2e-2),
               (512, 768, 2304, torch.float32, 1e-5),
               (33, 776, 200, torch.float32, 1e-5),
               (33, 301, 131, torch.float32, 1e-5)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n,dtype,tol", FUSED_CASES)
@pytest.mark.parametrize("op", ["ln_matmul", "gelu_matmul"])
def test_fused_matmul_kernels_match_plain_on_card(card, op, rows, k, n, dtype,
                                                  tol):
  # bf16: outputs may round one ulp apart (the f32 sums run in another
  # order); f32: summation order only, relative to the output's scale
  g = torch.Generator(device=card).manual_seed(4)
  x = (torch.randn(rows, k, device=card, generator=g) * 2 + 0.5).to(dtype)
  W = (torch.randn(k, n, device=card, generator=g) / k ** 0.5).to(dtype)
  ops.reset_launches()
  if op == "ln_matmul":
    w = torch.rand(k, device=card, generator=g) + 0.5
    got, want = ops.ln_matmul(x, w, W), ops.ln_matmul_reference(x, w, W)
  else:
    got, want = ops.gelu_matmul(x, W), ops.gelu_matmul_reference(x, W)
  assert ops.LAUNCHES[op] == 1 and got.dtype == dtype
  scale = want.float().abs().max().item()
  torch.testing.assert_close(got.float(), want.float(), atol=tol * scale,
                             rtol=tol)


@pytest.mark.cuda
def test_fused_kernels_refuse_what_they_do_not_take(card):
  # K and N of any width run (K 20, N 12: rows off a 16-byte boundary) and
  # match the plain versions; mixed or unsupported dtypes are refused
  x = torch.randn(4, 20, device=card)
  W = torch.randn(20, 12, device=card)
  w = torch.rand(20, device=card) + 0.5
  torch.testing.assert_close(ops.gelu_matmul(x, W),
                             ops.gelu_matmul_reference(x, W), atol=1e-5,
                             rtol=1e-5)
  torch.testing.assert_close(ops.ln_matmul(x, w, W),
                             ops.ln_matmul_reference(x, w, W), atol=1e-5,
                             rtol=1e-5)
  with pytest.raises(TypeError, match="both bf16 or both f32"):
    ops.gelu_matmul(x[:, :16], torch.randn(16, 8, device=card).bfloat16())
  with pytest.raises(TypeError, match="w_ln must be f32"):
    ops.ln_matmul(x[:, :16], torch.ones(16, device=card).double(),
                  torch.randn(16, 8, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("h,dtype,tol", [(12288, torch.bfloat16, 2e-2),
                                         (16384, torch.float32, 1e-4),
                                         (8200, torch.bfloat16, 2e-2),
                                         (9001, torch.float32, 1e-4)])
def test_layer_norm_wide_rows_match_plain_on_card(card, h, dtype, tol):
  # rows wider than 8192 take the block-per-row kernels, forward and
  # backward (H 9001: no 16-byte vectors)
  g = torch.Generator(device=card).manual_seed(10)
  x = (torch.randn(40, h, device=card, generator=g) * 2 + 0.5).to(dtype)
  w = torch.rand(h, device=card, generator=g) + 0.5
  gy = torch.randn(40, h, device=card, generator=g).to(dtype)
  ops.reset_launches()
  y = ops.layer_norm(x, w)
  dx, dw = ops.layer_norm_bwd(x, w, gy)
  assert ops.LAUNCHES["layer_norm"] == 1 and ops.LAUNCHES["layer_norm_bwd"] == 1
  torch.testing.assert_close(y.float(), ops.layer_norm_reference(x, w).float(),
                             atol=tol, rtol=tol)
  rdx, rdw = ops.layer_norm_bwd_reference(x, w, gy)
  torch.testing.assert_close(dx.float(), rdx.float(), atol=tol, rtol=tol)
  torch.testing.assert_close(dw, rdw, atol=1e-3 * 40 ** 0.5, rtol=1e-4)
  dx2, dw2 = ops.layer_norm_bwd(x, w, gy)
  assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.cuda
def test_all_fused_gradients_on_card_equal_cpu(card):
  torch.backends.cuda.matmul.allow_tf32 = False
  cfg = tfm.TransformerConfig(vocab_size=256, num_layers=2, num_heads=2,
                              d_model=128, d_ff=256, max_seq_len=256,
                              dtype=torch.float32, fuse_qkv=True,
                              ln_matmul_impl="fused", act_matmul_impl="fused")
  params = init_params(cfg, seed=0)
  tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 64)))
  out = {}
  ops.reset_launches()
  for where in ("cuda", "cpu"):
    model = tfm.Transformer(cfg, params, device=where, trainable=True)
    loss = tfm.causal_lm_loss(model(tokens), tokens.to(model.device))
    names, weights = zip(*model.named_parameters())
    out[where] = (loss.item(), [g.cpu() for g in
                                torch.autograd.grad(loss, weights)])
  # forward + remat recompute: two per fused product per layer
  assert ops.LAUNCHES["ln_matmul"] == 8 and ops.LAUNCHES["gelu_matmul"] == 4
  assert ops.LAUNCHES["layer_norm"] == 1
  assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
  for name, a, b in zip(names, out["cuda"][1], out["cpu"][1]):
    assert (a - b).abs().max() <= 1e-3 * b.abs().max(), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_bwd_kernels_match_plain_and_fused_on_card(card, case, dtype):
  h, hk, q_base, kv_base, causal, window = FLASH_CASES[case]
  g = torch.Generator(device=card).manual_seed(5)
  mk = lambda *s: torch.randn(*s, device=card, generator=g)  # noqa: E731
  q, k, v = mk(2, 200, h, 64), mk(2, 200, hk, 64), mk(2, 200, hk, 64)
  go, gl = mk(2, 200, h, 64).to(dtype), mk(2, h, 200)
  q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
  out, lse = ops.flash_attention_fwd(q, k, v, q_base, kv_base, causal, window)
  gl = torch.where(lse <= -1e29, 0.0, gl)
  args = (q, k, v, out, lse, go, gl, q_base, kv_base, causal, window)
  ops.reset_launches()
  got = ops.flash_attention_bwd(*args, bwd="split")
  dkv = "flash_attention_bwd_dkv" if h == hk else "flash_attention_bwd_dkv_gqa"
  assert {n: c for n, c in ops.LAUNCHES.items() if c} == {
      "flash_attention_bwd_dq": 1, dkv: 1}
  want = ops.flash_attention_bwd_reference(*args)
  fused = ops.flash_attention_bwd(*args, bwd="fused")
  tol = 2e-4 if dtype == torch.float32 else 3e-2
  for a, b, c in zip(got, want, fused):
    assert a.dtype == dtype
    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(a.float(), c.float(), atol=tol, rtol=tol)
  # no atomics: a second run gives the same bits
  again = ops.flash_attention_bwd(*args, bwd="split")
  assert all(torch.equal(a, b) for a, b in zip(got, again))
  if case == "kv_ahead":
    assert (got[0][:, :kv_base - q_base] == 0).all()


@pytest.mark.cuda
def test_split_bwd_kernels_head_dim_128_and_autograd_on_card(card):
  g = torch.Generator(device=card).manual_seed(6)
  q = torch.randn(1, 130, 4, 128, device=card, generator=g)
  k = torch.randn(1, 130, 2, 128, device=card, generator=g)
  v = torch.randn(1, 130, 2, 128, device=card, generator=g)
  go = torch.randn(1, 130, 4, 128, device=card, generator=g)
  qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
  (ops.flash_attention(qs, ks, vs, bwd="split") * go).sum().backward()
  out, lse = ops.flash_attention_reference(q, k, v)
  want = ops.flash_attention_bwd_reference(q, k, v, out, lse, go)
  for a, b in zip((qs.grad, ks.grad, vs.grad), want):
    torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_device_prefetch_on_card_waits_for_its_copies(card):
  side = torch.cuda.Stream(card)
  with torch.cuda.stream(side):
    # a long kernel ahead of the copies on the side stream: a batch used
    # before its copy's event would read memory not yet written
    torch.cuda._sleep(200_000_000)
  rng = np.random.default_rng(0)
  batches = [rng.integers(0, 1000, (64, 1024)).astype(np.int32)
             for _ in range(4)]
  for b in batches:
    b.setflags(write=False)
  got = []
  for t in readers.device_prefetch(iter(batches), size=2, stream=side):
    assert t.is_cuda and t.dtype == torch.int32
    got.append((t.long().sum(), t.clone()))     # queued on the consumer stream
  torch.cuda.synchronize()
  for (total, t), b in zip(got, batches):
    assert int(total) == int(b.astype(np.int64).sum())
    assert np.array_equal(t.cpu().numpy(), b)


# The bf16 kernels on the tensor cores (wgmma + TMA): (B, Sq, Sk, H, Hk, D,
# q_base, kv_base, window, causal). Prefill chunks of 16 and 32 rows, a
# ragged q tile (100 rows), keys not a multiple of the 64-key tile, keys
# ahead of every query (empty rows), a window, an offset chunk, grouped K/V,
# head_dim 128, and the unmasked branch (every key tile, keys past Sk only)
WGMMA_FWD_CASES = {
    "s16": (1, 16, 16, 12, 12, 64, 0, 0, None, True),
    "s32": (1, 32, 32, 12, 12, 64, 0, 0, None, True),
    "s100": (2, 100, 100, 4, 4, 64, 0, 0, None, True),
    "sk_ragged": (2, 150, 150, 4, 2, 64, 0, 0, None, True),
    "kv_ahead": (1, 128, 128, 12, 12, 64, 0, 64, None, True),
    "window128": (1, 512, 512, 12, 12, 64, 0, 0, 128, True),
    "q_offset": (1, 256, 512, 12, 12, 64, 256, 0, None, True),
    "gqa_hk4": (1, 512, 512, 12, 4, 64, 0, 0, None, True),
    "d128": (1, 256, 256, 6, 6, 128, 0, 0, None, True),
    "d128_ragged_window": (2, 130, 130, 4, 2, 128, 0, 0, 40, True),
    "non_causal": (2, 256, 256, 4, 4, 64, 0, 0, None, False),
    "non_causal_ragged": (2, 100, 150, 4, 2, 64, 0, 0, None, False),
    "d128_non_causal": (1, 256, 256, 6, 6, 128, 0, 0, None, False),
    "d128_non_causal_ragged": (2, 130, 150, 4, 2, 128, 0, 0, None, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_FWD_CASES))
def test_flash_bf16_tensor_core_forward_matches_plain_on_card(card, case):
  b, sq, sk, h, hk, d, q_base, kv_base, window, causal = WGMMA_FWD_CASES[case]
  g = torch.Generator(device=card).manual_seed(7)
  mk = lambda *s: torch.randn(*s, device=card,  # noqa: E731
                              generator=g).to(torch.bfloat16)
  q, k, v = mk(b, sq, h, d), mk(b, sk, hk, d), mk(b, sk, hk, d)
  ops.reset_launches()
  out, lse = ops.flash_attention_fwd(q, k, v, q_base, kv_base, causal,
                                     window)
  assert ops.LAUNCHES["flash_attention_fwd"] == 1
  ro, rl = ops.flash_attention_reference(q, k, v, q_base, kv_base, causal,
                                         window)
  # out rounds to bf16 (P also rounds to bf16 before P V); lse is f32 from
  # exact bf16 products
  torch.testing.assert_close(out.float(), ro.float(), atol=2e-2, rtol=2e-2)
  torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-4)
  if case == "kv_ahead":
    dead = kv_base - q_base
    assert (lse[:, :, :dead] == -1e30).all() and (out[:, :dead] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mha_causal", "gqa_causal", "window_24",
                                  "non_causal", "kv_ahead", "q_offset"])
@pytest.mark.parametrize("d", [64, 128])
def test_dkv_bf16_tensor_core_kernel_matches_plain_and_fused_on_card(
    card, case, d):
  h, hk, q_base, kv_base, causal, window = FLASH_CASES[case]
  fa = sys.modules["tensorflowonspark_tpu_torch.ops.flash_attention"]
  g = torch.Generator(device=card).manual_seed(8)
  mk = lambda *s: torch.randn(*s, device=card,  # noqa: E731
                              generator=g).to(torch.bfloat16)
  q, k, v, go = mk(2, 200, h, d), mk(2, 200, hk, d), mk(2, 200, hk, d), \
      mk(2, 200, h, d)
  out, lse = ops.flash_attention_fwd(q, k, v, q_base, kv_base, causal, window)
  gl = torch.where(lse <= -1e29, 0.0,
                   torch.randn(2, h, 200, device=card, generator=g))
  delta = fa._bwd_delta(out, go, gl)
  ops.reset_launches()
  dk, dv = ops.flash_attention_bwd_dkv(q, k, v, go, lse, delta, q_base,
                                       kv_base, causal, window)
  name = "flash_attention_bwd_dkv" if h == hk else "flash_attention_bwd_dkv_gqa"
  assert ops.LAUNCHES[name] == 1
  again = ops.flash_attention_bwd_dkv(q, k, v, go, lse, delta, q_base,
                                      kv_base, causal, window)
  assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])
  pk, pv = ops.flash_attention_bwd_dkv_reference(q, k, v, go, lse, delta,
                                                 q_base, kv_base, causal,
                                                 window)
  _, fk, fv = fa._fused_bwd(q, k, v, out, lse, go, gl, q_base, kv_base,
                            causal, window)
  # bf16: outputs round to bf16, and P and dS round to bf16 before their
  # products: 1e-2 of each gradient's largest magnitude
  for got, want in ((dk, pk), (dv, pv), (dk, fk), (dv, fv)):
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max()
    assert err <= 1e-2 * want.float().abs().max(), (case, d, float(err))


@pytest.mark.cuda
def test_tensor_core_kernels_take_unaligned_bases_on_card(card):
  # a contiguous bf16 view 2 bytes off a 16-byte boundary is copied for TMA:
  # the same bits as the aligned tensor
  g = torch.Generator(device=card).manual_seed(9)
  n = 2 * 64 * 4 * 64
  buf = torch.randn(n + 1, device=card, generator=g).to(torch.bfloat16)
  odd = buf[1:].view(2, 64, 4, 64)
  assert odd.data_ptr() % 16
  al = odd.clone()
  q = torch.randn(2, 64, 4, 64, device=card, generator=g).to(torch.bfloat16)
  for got, want in zip(ops.flash_attention_fwd(odd, q, q),
                       ops.flash_attention_fwd(al, q, q)):
    assert torch.equal(got, want)
  _, lse = ops.flash_attention_fwd(q, al, q)
  delta = torch.randn(2, 4, 64, device=card, generator=g)
  for got, want in zip(ops.flash_attention_bwd_dkv(q, odd, q, q, lse, delta),
                       ops.flash_attention_bwd_dkv(q, al, q, q, lse, delta)):
    assert torch.equal(got, want)
  assert torch.equal(ops.flash_attention_bwd_dq(odd, q, q, q, lse, delta),
                     ops.flash_attention_bwd_dq(al, q, q, q, lse, delta))
  assert torch.equal(ops.flash_attention_bwd_dq(q, q, odd, q, lse, delta),
                     ops.flash_attention_bwd_dq(q, q, al, q, lse, delta))
  # the GELU->matmul wgmma body reads x and W by TMA too
  x_odd, x_al = odd.view(256, 128), al.view(256, 128)
  W = (torch.randn(128, 64, device=card, generator=g) / 128 ** 0.5).to(
      torch.bfloat16)
  assert torch.equal(ops.gelu_matmul(x_odd, W), ops.gelu_matmul(x_al, W))


# The bf16 fused backward on the tensor cores: (B, Sq, Sk, H, Hk, q_base,
# kv_base, causal, window, lse cotangent). MHA and grouped, causal, windowed
# and non-causal, ragged Sq != Sk (keys not a multiple of the key tile), bases
# with keys ahead of every query, and g_lse present and absent.
FUSED_BWD_CASES = {
    "mha_causal": (2, 200, 200, 4, 4, 0, 0, True, None, False),
    "gqa_causal_lse": (2, 200, 200, 4, 2, 0, 0, True, None, True),
    "window_24": (2, 200, 200, 4, 2, 0, 0, True, 24, False),
    "non_causal": (2, 130, 150, 4, 4, 0, 0, False, None, True),
    "ragged_offset": (1, 100, 250, 6, 3, 150, 0, True, None, True),
    "kv_ahead": (2, 160, 160, 4, 2, 0, 32, True, None, True),
}


# The bf16 split dQ on the tensor cores takes 128-row q tiles of two
# warpgroups and streams 64-key K/V tiles through a 4-stage ring: the fused
# cases, plus sequences long enough for the ring to wrap, with an offset
# query block over more keys and a window.
DQ_CASES = dict(
    FUSED_BWD_CASES,
    ring_offset_lse=(1, 700, 900, 4, 2, 200, 0, True, None, True),
    ring_window=(1, 1000, 1000, 4, 4, 0, 0, True, 300, False),
    ring_non_causal=(2, 300, 600, 4, 2, 0, 0, False, None, False))


def _bwd_inputs(card, case, d, seed, cases=FUSED_BWD_CASES):
  b, sq, sk, h, hk, q_base, kv_base, causal, window, with_lse = cases[case]
  g = torch.Generator(device=card).manual_seed(seed)
  mk = lambda *s: torch.randn(*s, device=card,  # noqa: E731
                              generator=g).to(torch.bfloat16)
  q, k, v, go = mk(b, sq, h, d), mk(b, sk, hk, d), mk(b, sk, hk, d), \
      mk(b, sq, h, d)
  out, lse = ops.flash_attention_fwd(q, k, v, q_base, kv_base, causal, window)
  gl = None
  if with_lse:
    gl = torch.where(lse <= -1e29, 0.0,
                     torch.randn(b, h, sq, device=card, generator=g))
  return (q, k, v, out, lse, go, gl, q_base, kv_base, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FUSED_BWD_CASES))
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_fused_bwd_bf16_tensor_core_kernel_matches_plain_and_split_on_card(
    card, case, d):
  args = _bwd_inputs(card, case, d, 11)
  h, hk = args[0].shape[2], args[1].shape[2]
  ops.reset_launches()
  got = ops.flash_attention_bwd(*args, bwd="fused")
  name = "flash_attention_bwd" if h == hk else "flash_attention_bwd_gqa"
  assert {n: c for n, c in ops.LAUNCHES.items() if c} == {name: 1}
  again = ops.flash_attention_bwd(*args, bwd="fused")
  assert all(torch.equal(a, b) for a, b in zip(got, again))
  want = ops.flash_attention_bwd_reference(*args)
  split = ops.flash_attention_bwd(*args, bwd="split")
  # bf16: outputs round to bf16, and P and dS round to bf16 before their
  # products: 1e-2 of each gradient's largest magnitude
  for t, a, w, s in zip("qkv", got, want, split):
    assert a.dtype == torch.bfloat16 and a.shape == w.shape
    for ref in (w, s):
      err = (a.float() - ref.float()).abs().max()
      assert err <= 1e-2 * ref.float().abs().max(), (case, d, t, float(err))
  if case == "kv_ahead":
    assert (got[0][:, :args[8] - args[7]] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["gqa_causal_lse", "window_24",
                                  "non_causal", "ragged_offset"])
def test_head_dims_forward_dq_dkv_match_plain_on_card(card, case, d, dtype):
  # the forward, split dQ and split dK/dV (and the f32 fused body) at head
  # dims padded inside the kernels: 32 in a 64-wide tile, 96 in a 128-wide
  b, sq, sk, h, hk, q_base, kv_base, causal, window, _ = FUSED_BWD_CASES[case]
  fa = sys.modules["tensorflowonspark_tpu_torch.ops.flash_attention"]
  g = torch.Generator(device=card).manual_seed(12)
  mk = lambda *s: torch.randn(*s, device=card,  # noqa: E731
                              generator=g).to(dtype)
  q, k, v, go = mk(b, sq, h, d), mk(b, sk, hk, d), mk(b, sk, hk, d), \
      mk(b, sq, h, d)
  out, lse = ops.flash_attention_fwd(q, k, v, q_base, kv_base, causal, window)
  ro, rl = ops.flash_attention_reference(q, k, v, q_base, kv_base, causal,
                                         window)
  f32 = dtype == torch.float32
  otol, ltol = (2e-5, 2e-5) if f32 else (2e-2, 1e-4)
  torch.testing.assert_close(out.float(), ro.float(), atol=otol, rtol=otol)
  torch.testing.assert_close(lse, rl, atol=ltol, rtol=ltol)
  delta = fa._bwd_delta(out, go, None)
  rel = 1e-4 if f32 else 1e-2
  dq = ops.flash_attention_bwd_dq(q, k, v, go, lse, delta, q_base, kv_base,
                                  causal, window)
  dk, dv = ops.flash_attention_bwd_dkv(q, k, v, go, lse, delta, q_base,
                                       kv_base, causal, window)
  pq = ops.flash_attention_bwd_dq_reference(q, k, v, go, lse, delta, q_base,
                                            kv_base, causal, window)
  pk, pv = ops.flash_attention_bwd_dkv_reference(q, k, v, go, lse, delta,
                                                 q_base, kv_base, causal,
                                                 window)
  fused = fa._fused_bwd(q, k, v, out, lse, go, None, q_base, kv_base, causal,
                        window)
  for a, w in ((dq, pq), (dk, pk), (dv, pv), (fused[0], pq), (fused[1], pk),
               (fused[2], pv)):
    assert a.dtype == dtype and a.shape == w.shape
    err = (a.float() - w.float()).abs().max()
    assert err <= rel * w.float().abs().max(), (case, d, float(err))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DQ_CASES))
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_dq_bf16_tensor_core_kernel_matches_plain_on_card(card, case, d):
  # flash_bwd_dq_kernel_wgmma: causal, windowed and non-causal, grouped K/V,
  # ragged Sq != Sk, keys ahead of every query, an lse cotangent folded
  # into Delta, at head dims padded to 64 and to 128
  fa = sys.modules["tensorflowonspark_tpu_torch.ops.flash_attention"]
  q, k, v, out, lse, go, gl, q_base, kv_base, causal, window = _bwd_inputs(
      card, case, d, 13, DQ_CASES)
  delta = fa._bwd_delta(out, go, gl)
  args = (q, k, v, go, lse, delta, q_base, kv_base, causal, window)
  ops.reset_launches()
  dq = ops.flash_attention_bwd_dq(*args)
  assert {n: c for n, c in ops.LAUNCHES.items() if c} == {
      "flash_attention_bwd_dq": 1}
  # one CTA owns each dQ tile: no atomics, the same bits every run
  assert torch.equal(dq, ops.flash_attention_bwd_dq(*args))
  want = ops.flash_attention_bwd_dq_reference(*args)
  # dQ rounds to bf16, and dS rounds to bf16 before dS K: 1e-2 of the
  # largest |dQ|, as the other bf16 gradients
  assert dq.dtype == torch.bfloat16 and dq.shape == want.shape
  err = (dq.float() - want.float()).abs().max()
  assert err <= 1e-2 * want.float().abs().max(), (case, d, float(err))
  if case == "kv_ahead":
    assert (dq[:, :kv_base - q_base] == 0).all()


# (rows, f, n, body): GELU->matmul in bf16 at the training shape (the MLP
# down-projection), ragged row counts, n not a multiple of the 256-column
# tile, f not a multiple of the 64-deep K step, train_gpt's widths; and
# widths that are not multiples of 8, which keep the WMMA body
GELU_BODY_CASES = [(16384, 3072, 768, "wgmma"), (1000, 3072, 768, "wgmma"),
                   (33, 768, 1280, "wgmma"), (100, 776, 200, "wgmma"),
                   (4096, 1024, 256, "wgmma"), (129, 264, 136, "wgmma"),
                   (100, 771, 200, "wmma"), (100, 776, 203, "wmma")]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,f,n,body", GELU_BODY_CASES)
def test_gelu_matmul_bf16_bodies_match_plain_on_card(card, rows, f, n, body):
  am = sys.modules["tensorflowonspark_tpu_torch.ops.act_matmul"]
  assert am.kernel_body(f, n, torch.bfloat16) == body
  g = torch.Generator(device=card).manual_seed(14)
  x = (torch.randn(rows, f, device=card, generator=g) * 2 + 0.5).to(
      torch.bfloat16)
  W = (torch.randn(f, n, device=card, generator=g) / f ** 0.5).to(
      torch.bfloat16)
  ops.reset_launches()
  got = ops.gelu_matmul(x, W)
  assert ops.LAUNCHES["gelu_matmul"] == 1 and got.dtype == torch.bfloat16
  want = ops.gelu_matmul_reference(x, W)
  # outputs may round one ulp apart (the f32 sums run in another order):
  # 2e-2 of the output's scale, as check_fused_matmul holds them
  err = (got.float() - want.float()).abs().max()
  assert err <= 2e-2 * want.float().abs().max(), (rows, f, n, float(err))
  assert torch.equal(got, ops.gelu_matmul(x, W))


# (rows, h, n, body): LN->matmul in bf16 at the training shapes (fused QKV,
# its grouped width, the MLP up-projection), ragged row counts, n not a
# multiple of the 256-column tile, h not a multiple of the 64-deep K step,
# train_gpt's widths; and widths that are not multiples of 8, which keep the
# WMMA body
LN_BODY_CASES = [(16384, 768, 2304, "wgmma"), (16384, 768, 1280, "wgmma"),
                 (16384, 768, 3072, "wgmma"), (33, 768, 1280, "wgmma"),
                 (100, 776, 200, "wgmma"), (4096, 256, 1024, "wgmma"),
                 (129, 264, 136, "wgmma"), (100, 771, 200, "wmma"),
                 (100, 776, 203, "wmma")]


def _ln_matmul_on_card(card, rows, h, n, mean, spread, seed):
  g = torch.Generator(device=card).manual_seed(seed)
  x = (torch.randn(rows, h, device=card, generator=g) * spread + mean).to(
      torch.bfloat16)
  w = torch.rand(h, device=card, generator=g) + 0.5
  W = (torch.randn(h, n, device=card, generator=g) / h ** 0.5).to(
      torch.bfloat16)
  ops.reset_launches()
  got = ops.ln_matmul(x, w, W)
  assert ops.LAUNCHES["ln_matmul"] == 1 and got.dtype == torch.bfloat16
  want = ops.ln_matmul_reference(x, w, W)
  # outputs may round one ulp apart (the f32 sums run in another order):
  # 2e-2 of the output's scale, as check_fused_matmul holds them
  err = (got.float() - want.float()).abs().max()
  assert err <= 2e-2 * want.float().abs().max(), (rows, h, n, float(err))
  assert torch.equal(got, ops.ln_matmul(x, w, W))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h,n,body", LN_BODY_CASES)
def test_ln_matmul_bf16_bodies_match_plain_on_card(card, rows, h, n, body):
  lm = sys.modules["tensorflowonspark_tpu_torch.ops.ln_matmul"]
  assert lm.kernel_body(h, n, torch.bfloat16) == body
  _ln_matmul_on_card(card, rows, h, n, 0.5, 2.0, 15)


@pytest.mark.cuda
def test_ln_matmul_keeps_rows_with_a_large_mean_on_card(card):
  # x = 100 + N(0, 1): the normalisation must subtract the mean before it
  # scales, as the reference does, or the rows lose their digits
  _ln_matmul_on_card(card, 512, 768, 2304, 100.0, 1.0, 16)
