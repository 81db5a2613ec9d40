"""The pipeline and expert axes' paths on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside a
fixture). The file imports only PyTorch and the port, so it runs on the
card's machine: ``python -m pytest tests/test_torch_pp_ep_cuda.py -m cuda``.

- a MoE Transformer's loss and every gradient (f32; dense blocks and a
  MoE block, its ln2 the LayerNorm kernel) on the card against the same
  weights' plain run on the CPU, with the kernels' launches;
- its greedy KV decode on the card: exact launches, and each token the
  argmax of the non-cached forward (near-ties aside);
- ``make_pipeline_train_step`` in 2 gloo processes sharing the card
  (activations and cotangents staged through pinned host memory) against
  one process's loss and gradients, bf16.
"""

import multiprocessing as mp

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port
from tensorflowonspark_tpu_torch.utils.params import init_params

MOE = dict(vocab_size=512, num_layers=2, num_heads=4, d_model=256,
           d_ff=1024, max_seq_len=160, remat=False, moe_experts=4,
           moe_top_k=2, moe_every=2)
PP = dict(vocab_size=512, num_layers=4, num_heads=4, d_model=256, d_ff=1024,
          max_seq_len=128)


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
def test_moe_model_loss_and_gradients_match_the_cpu(card):
  cfg = tfm.TransformerConfig(dtype=torch.float32, **MOE)
  params = init_params(cfg, 3)
  tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 512,
                                                             (4, 128)))
  out = {}
  for device in ("cpu", card):
    model = tfm.Transformer(cfg, params, device=device, trainable=True)
    before = dict(ops.LAUNCHES)
    loss = tfm.causal_lm_loss(model(tokens.to(device)), tokens.to(device))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    out[str(device)] = (loss.detach().cpu(), [g.cpu() for g in grads],
                        {k: ops.LAUNCHES[k] - before[k] for k in before})
  loss_cpu, g_cpu, none = out["cpu"]
  loss_card, g_card, launches = out[str(card)]
  assert not any(none.values())
  # 2 blocks: ln1 and ln2 each (the MoE block's ln2 too), then ln_f
  assert launches == dict({k: 0 for k in launches}, flash_attention_fwd=2,
                          flash_attention_bwd=2, layer_norm=5,
                          layer_norm_bwd=5)
  assert _rel(loss_card, loss_cpu) <= 1e-5
  for a, b in zip(g_card, g_cpu):
    assert _rel(a, b) <= 1e-4, _rel(a, b)


@pytest.mark.cuda
def test_moe_decode_on_the_card_is_the_forwards_argmax(card):
  cfg = tfm.TransformerConfig(dtype=torch.float32, **MOE)
  model = tfm.Transformer(cfg, init_params(cfg, 4), device=card)
  prompts = np.random.default_rng(1).integers(1, 512, (4, 128))
  before = dict(ops.LAUNCHES)
  out = tfm.greedy_generate_kv(model, prompts, 16)
  launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
  assert launches == dict({k: 0 for k in launches}, flash_attention_fwd=2,
                          layer_norm=5 * 16)
  with torch.inference_mode():
    logits = model(out[:, :-1])[:, 127:]
  pred, got = logits.argmax(-1), out[:, 128:]
  for b, t in zip(*torch.nonzero(pred != got, as_tuple=True)):
    top2 = torch.topk(logits[b, t], 2).values
    assert float(top2[0] - top2[1]) < 1e-4, (int(b), int(t))


def _pp_rank(rank, port, tokens, out):
  import torch.distributed as dist
  from tensorflowonspark_tpu_torch.parallel import collectives
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  torch.cuda.set_device(0)
  dist.init_process_group("gloo", init_method="tcp://localhost:%d" % port,
                          rank=rank, world_size=2)
  try:
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=1, pipeline=2))
    cfg = tfm.TransformerConfig(**PP)
    state = tfm.create_state(cfg, 0)
    step = tfm.make_pipeline_train_step(cfg, mesh, 4)
    collectives.reset_counts()
    loss, grads = step(state.params, tokens)
    torch.save([loss.cpu(), {k: v.cpu() for k, v in grads.items()},
                dict(collectives.COUNTS)], out % rank)
  finally:
    dist.destroy_process_group()


@pytest.mark.cuda
def test_pipeline_on_the_card_matches_one_process(card, tmp_path):
  tokens = torch.as_tensor(np.random.default_rng(2).integers(0, 512,
                                                             (8, 128)))
  out = str(tmp_path / "rank%d.pt")
  ctx = mp.get_context("spawn")
  port = get_free_port()
  procs = [ctx.Process(target=_pp_rank, args=(r, port, tokens, out))
           for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(timeout=300)
  assert [p.exitcode for p in procs] == [0, 0]
  cfg = tfm.TransformerConfig(**PP)
  state = tfm.create_state(cfg, 0)
  t = tokens.to(card)
  loss = tfm.causal_lm_loss(state.model(t), t)
  want = dict(zip(state.params, torch.autograd.grad(
      loss, list(state.params.values()))))
  got = [torch.load(out % r) for r in range(2)]
  for g_loss, grads, counts in got:
    # bf16 activations through 4 microbatches against one batch
    assert abs(float(g_loss) - float(loss)) <= 2e-3 * abs(float(loss))
    assert counts["ring_permute"] == 2 * (4 + 2 * 2 - 1)
    for k, w in want.items():
      assert _rel(grads[k], w.cpu()) <= 3e-2, (k, _rel(grads[k], w.cpu()))
  assert float(got[0][0]) == float(got[1][0])
