"""Decoding over a ``tensor=2`` serving mesh on the card.

Marked ``cuda``: the test skips without a CUDA card (decided inside a
fixture). The file imports only PyTorch and the port, so it runs on the
card's machine: ``python -m pytest tests/test_torch_serving_mesh_cuda.py
-m cuda``.

Two gloo ranks sharing the card decode the reference's decode-test
config (vocab 128, 2 layers, 4 heads, 2 KV heads, d 64, f32: each rank 2
query heads over 1 KV head) with the kernels: the prefill's flash forward
at the rank's heads and the LayerNorm forward, counted on each rank. The
tokens and the prefill's whole logits are held against the plain
versions' decode in one process on the CPU: logits within 1e-4, tokens
equal.
"""

import json
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port

import torch_serving_mesh_ranks as R

LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernels run on it")
  return torch.device("cuda")


def _decode_and_logits(model, tokens):
  """(greedy tokens, the prefill's whole logits) of ``model``; on a mesh
  every rank returns the whole batch."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  out = tfm.greedy_generate_kv(model, tokens, R.STEPS).cpu().numpy()
  with torch.inference_mode():
    logits = model.whole_logits(model(torch.as_tensor(tokens).long().to(
        model.device), model.init_cache(tokens.shape[0])))
  return out, logits.float().cpu().numpy()


def _rank(rank, port, root):
  import torch.distributed as dist
  from tensorflowonspark_tpu_torch import ops
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  from tensorflowonspark_tpu_torch.utils.params import init_params
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.cuda.set_device(0)
  dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                          rank=rank, world_size=2)
  try:
    cfg = R.config(R.CFG)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=1, tensor=2))
    model = tfm.Transformer(cfg, init_params(cfg, 0), mesh=mesh)
    before = dict(ops.LAUNCHES)
    tokens = tfm.greedy_generate_kv(model, R.prompt(), R.STEPS)
    launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
    _, logits = _decode_and_logits(model, R.prompt())
  finally:
    dist.destroy_process_group()
  np.savez(os.path.join(root, "rank%d.npz" % rank),
           tokens=tokens.cpu().numpy(), logits=logits)
  with open(os.path.join(root, "rank%d.json" % rank), "w") as f:
    json.dump({"launches": launches, "cuda": tokens.is_cuda}, f)


@pytest.mark.cuda
def test_tensor_2_decode_on_the_card_matches_the_plain_versions(card,
                                                                tmp_path):
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.utils.params import init_params
  root = str(tmp_path)
  port = get_free_port()
  ctx = mp.get_context("spawn")
  procs = [ctx.Process(target=_rank, args=(r, port, root)) for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(timeout=300)
  assert [p.exitcode for p in procs] == [0, 0]
  cfg = R.config(R.CFG)
  want, want_logits = _decode_and_logits(
      tfm.Transformer(cfg, init_params(cfg, 0), device="cpu"), R.prompt())
  layers = cfg.num_layers
  for r in range(2):
    got = np.load(os.path.join(root, "rank%d.npz" % r))
    with open(os.path.join(root, "rank%d.json" % r)) as f:
      rec = json.load(f)
    assert rec["cuda"], rec
    # one flash prefill a layer, 2L + 1 LayerNorm forwards a forward
    assert rec["launches"]["flash_attention_fwd"] == layers, rec
    assert rec["launches"]["layer_norm"] == (2 * layers + 1) * R.STEPS, rec
    np.testing.assert_allclose(got["logits"], want_logits, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_array_equal(got["tokens"], want)
