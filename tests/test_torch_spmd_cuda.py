"""The mesh axes' kernel cases on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside a
fixture). The file imports only PyTorch and the port, so it runs on the
card's machine: ``python -m pytest tests/test_torch_spmd_cuda.py -m cuda``.

- the flash kernels at a ring step's block cases (a block wholly in the
  past, the diagonal, wholly in the future) with an lse cotangent on
  every row, grouped (Hk 4: forward, fused grouped backward, split dQ and
  grouped dK/dV) and MHA (the fused backward and dK/dV): each held
  against its plain version; the future block gives out 0, lse -1e30
  and zero, finite gradients;
- ``flash_attention_block`` and ``merge_partials`` differentiated through
  a 2-block merge on the card against the plain versions on the CPU;
- LN->matmul and GELU->matmul at ``--tp 2``'s local widths against their
  plain versions, twice and bitwise equal;
- ring attention in 2 gloo processes sharing the card (CUDA tensors
  staged through pinned host memory) against one process, forward and
  gradients, bf16.
"""

import multiprocessing as mp

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port

S, H, D = 2048, 12, 64
BLOCKS = {"past": (S, 0), "diagonal": (S, S), "future": (0, S)}


@pytest.fixture(scope="module")
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernels run on it")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


def _rel(got, want):
  return (got.float() - want.float()).abs().max().item() / max(
      want.float().abs().max().item(), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("hk", [4, H])
@pytest.mark.parametrize("where", sorted(BLOCKS))
def test_ring_block_kernels_match_plain(card, where, hk):
  import sys
  fa = sys.modules["tensorflowonspark_tpu_torch.ops.flash_attention"]
  q_base, kv_base = BLOCKS[where]
  g = torch.Generator(device=card).manual_seed(7)
  mk = lambda *shape: torch.randn(*shape, device=card,  # noqa: E731
                                  generator=g).to(torch.bfloat16)
  q, k, v, go = mk(1, S, H, D), mk(1, S, hk, D), mk(1, S, hk, D), \
      mk(1, S, H, D)
  gl = torch.randn(1, H, S, device=card, generator=g)
  out, lse = fa._forward(q, k, v, q_base, kv_base, True, None)
  ro, rl = ops.flash_attention_reference(q, k, v, q_base, kv_base)
  assert torch.allclose(out.float(), ro.float(), atol=2e-2, rtol=2e-2)
  assert torch.allclose(lse, rl, atol=1e-4, rtol=1e-4)
  want = ops.flash_attention_bwd_reference(q, k, v, out, lse, go, gl, q_base,
                                           kv_base)
  delta = fa._bwd_delta(out, go, gl)
  plans = {"fused": fa._fused_bwd(q, k, v, out, lse, go, gl, q_base,
                                  kv_base, True, None),
           "split": (ops.flash_attention_bwd_dq(q, k, v, go, lse, delta,
                                                q_base, kv_base),)
           + ops.flash_attention_bwd_dkv(q, k, v, go, lse, delta, q_base,
                                         kv_base)}
  for plan, got in plans.items():
    for t, a, r in zip("qkv", got, want):
      assert torch.isfinite(a).all(), (plan, t)
      if where == "future":
        assert not a.any(), (plan, t)
      else:
        assert _rel(a, r) <= 1e-2, (plan, t, _rel(a, r))
  if where == "future":
    assert (out == 0).all() and (lse == -1e30).all()


@pytest.mark.cuda
def test_block_merge_gradients_match_plain(card):
  """Two blocks (the past and the diagonal) merged: the loss's gradients
  through ``flash_attention_block`` (the kernels) and ``merge_partials``
  on the card equal the same on the CPU (the plain versions), f32."""
  g = torch.Generator().manual_seed(8)
  q, k0, v0, k1, v1, w = (torch.randn(1, 256, H, D, generator=g)
                          if i in (0, 5) else
                          torch.randn(1, 256, 4, D, generator=g)
                          for i in range(6))

  def run(device):
    leaves = [t.to(device).requires_grad_() for t in (q, k0, v0, k1, v1)]
    tq, tk0, tv0, tk1, tv1 = leaves
    o0, l0 = ops.flash_attention_block(tq, tk0, tv0, 256, 0)
    o1, l1 = ops.flash_attention_block(tq, tk1, tv1, 256, 256)
    o, _ = ops.merge_partials(o0, l0, o1, l1)
    (o * w.to(device)).sum().backward()
    return [o.detach().cpu()] + [t.grad.cpu() for t in leaves]

  for got, want in zip(run(card), run("cpu")):
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4), _rel(got, want)


TP_CASES = (("ln_matmul", 4096, 768, 1152), ("ln_matmul", 4096, 768, 1536),
            ("gelu_matmul", 4096, 1536, 768))


@pytest.mark.cuda
@pytest.mark.parametrize("op,rows,k,n", TP_CASES)
def test_tp_local_widths_match_plain(card, op, rows, k, n):
  g = torch.Generator(device=card).manual_seed(9)
  x = (torch.randn(rows, k, device=card, generator=g) * 2 + 0.5).to(
      torch.bfloat16)
  W = (torch.randn(k, n, device=card, generator=g) / k ** 0.5).to(
      torch.bfloat16)
  if op == "ln_matmul":
    w = torch.rand(k, device=card, generator=g) + 0.5
    got, again = ops.ln_matmul(x, w, W), ops.ln_matmul(x, w, W)
    want = ops.ln_matmul_reference(x, w, W)
  else:
    got, again = ops.gelu_matmul(x, W), ops.gelu_matmul(x, W)
    want = ops.gelu_matmul_reference(x, W)
  assert torch.equal(got, again)
  assert _rel(got, want) <= 2e-2


def _ring_rank(rank, port, inputs, out):
  import torch.distributed as dist
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  from tensorflowonspark_tpu_torch.parallel import ring_attention as ra
  torch.cuda.set_device(0)
  dist.init_process_group("gloo", init_method="tcp://localhost:%d" % port,
                          rank=rank, world_size=2)
  try:
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=1, sequence=2))
    half = inputs[0].shape[1] // 2
    mine = [t[:, rank * half:(rank + 1) * half].cuda().requires_grad_()
            for t in inputs[:3]]
    o = ra.ring_attention(*mine, mesh, use_flash=True)
    (o.float() * inputs[3][:, rank * half:(rank + 1) * half].cuda()).sum() \
        .backward()
    torch.save([o.detach().cpu()] + [t.grad.cpu() for t in mine],
               out % rank)
  finally:
    dist.destroy_process_group()


@pytest.mark.cuda
def test_ring_on_the_card_matches_one_process(card, tmp_path):
  g = torch.Generator().manual_seed(10)
  q, w = (torch.randn(1, 1024, H, D, generator=g) for _ in range(2))
  k, v = (torch.randn(1, 1024, 4, D, generator=g) for _ in range(2))
  inputs = [t.to(torch.bfloat16) for t in (q, k, v)] + [w]
  out = str(tmp_path / "rank%d.pt")
  ctx = mp.get_context("spawn")
  port = get_free_port()
  procs = [ctx.Process(target=_ring_rank, args=(r, port, inputs, out))
           for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(timeout=300)
  assert [p.exitcode for p in procs] == [0, 0]
  leaves = [t.cuda().requires_grad_() for t in inputs[:3]]
  o = ops.flash_attention(*leaves)
  (o.float() * w.cuda()).sum().backward()
  want = [o.detach().cpu()] + [t.grad.cpu() for t in leaves]
  got = [torch.cat(parts, dim=1) for parts in zip(*(
      torch.load(out % r) for r in range(2)))]
  # each query row's output is its block's merged in f32 and cast once;
  # dK/dV sum the two ranks' shares in another order than one kernel
  for a, b in zip(got, want):
    assert _rel(a, b) <= 2e-2, _rel(a, b)
  assert np.isfinite(got[0].float().numpy()).all()
