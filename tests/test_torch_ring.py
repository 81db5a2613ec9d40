"""The port's ring attention in 4 gloo processes against the JAX package's
ring on 4 of the 8 virtual CPU devices, and its ring-step ops against the
JAX package's.

- ``ring_attention``: the cases of ``tests/test_parallel.py``'s
  ``TestRingAttention`` and ``TestRingWindow`` (dense and flash blocks,
  causal and not, grouped K/V, a tensor axis that cannot divide the KV
  heads, sliding windows that straddle the blocks, gradients). ONE
  module-scoped spawn of 4 ranks runs every case; each rank writes its
  output block (and its q/k/v gradient blocks), and each test holds them
  against the same block of the JAX ring's global output (and
  ``jax.grad`` of the same loss) on a mesh of the same shape: 2e-5 in
  f32. The port's flash path runs the kernels' plain versions on the
  CPU; the JAX ring runs its Pallas kernels in interpret mode, as
  ``tests/test_parallel.py`` runs them.
- the grouped ring moves the unexpanded K/V: the permuted bytes counted
  by ``collectives.COUNTS`` are those of the grouped blocks.
- ``ops.flash_attention_block`` at a ring step's bases (a block wholly in
  the past, the diagonal, wholly in the future) with an lse cotangent,
  forward and both backward plans, and ``ops.merge_partials``, against
  the JAX package's in interpret mode.
"""

import importlib
import json
import multiprocessing as mp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu.parallel import ring_attention as jax_ra
from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port

# the package re-exports the function under the module's name
jax_fa = importlib.import_module("tensorflowonspark_tpu.ops.flash_attention")

TOL = 2e-5
RANKS = 4


def _case(spec, b, s, h, hk, d, seed, causal=True, flash=False, window=None,
          grads=False):
  return dict(spec=spec, shape=(b, s, h, hk, d), seed=seed, causal=causal,
              flash=flash, window=window, grads=grads)


DS = dict(data=2, sequence=2)
S4 = dict(data=1, sequence=4)
CASES = {
    # TestRingAttention
    "dense_causal": _case(DS, 2, 32, 4, 4, 16, 0),
    "dense_full": _case(DS, 2, 32, 4, 4, 16, 0, causal=False),
    "flash_causal": _case(DS, 2, 32, 2, 2, 16, 1, flash=True),
    "flash_full": _case(DS, 2, 32, 2, 2, 16, 1, causal=False, flash=True),
    "gqa_dense": _case(S4, 2, 32, 4, 2, 16, 5),
    "gqa_flash": _case(S4, 2, 32, 4, 2, 16, 5, flash=True),
    "gqa_dense_grads": _case(S4, 1, 32, 4, 2, 8, 6, grads=True),
    "gqa_indivisible_tensor": _case(dict(data=1, sequence=2, tensor=2),
                                    1, 16, 4, 1, 8, 8, grads=True),
    "gqa_flash_grads": _case(S4, 1, 32, 4, 2, 8, 9, flash=True, grads=True),
    "flash_grads": _case(S4, 1, 32, 2, 2, 8, 2, flash=True, grads=True),
    # TestRingWindow
    "window3_dense": _case(S4, 2, 32, 2, 2, 16, 2, window=3),
    "window8_dense": _case(S4, 2, 32, 2, 2, 16, 2, window=8),
    "window20_dense": _case(S4, 2, 32, 2, 2, 16, 2, window=20),
    "window3_flash": _case(S4, 2, 32, 2, 2, 16, 2, flash=True, window=3),
    "window8_flash": _case(S4, 2, 32, 2, 2, 16, 2, flash=True, window=8),
    "window20_flash": _case(S4, 2, 32, 2, 2, 16, 2, flash=True, window=20),
    "window_flash_grads": _case(S4, 1, 32, 2, 2, 8, 3, flash=True, window=12,
                                grads=True),
}


def _inputs(case):
  """Global q, k, v and the loss weights w, f32, from the case's seed."""
  b, s, h, hk, d = case["shape"]
  rng = np.random.RandomState(case["seed"])
  q = rng.randn(b, s, h, d).astype(np.float32)
  k = rng.randn(b, s, hk, d).astype(np.float32)
  v = rng.randn(b, s, hk, d).astype(np.float32)
  w = rng.randn(b, s, h, d).astype(np.float32)
  return q, k, v, w


def _degrees(case):
  spec = case["spec"]
  return spec.get("data", 1), spec.get("sequence", 1), spec.get("tensor", 1)


def _coords(case, rank):
  """(data, sequence, tensor) coordinates of ``rank``: row-major."""
  _, sq, t = _degrees(case)
  return rank // (sq * t), (rank // t) % sq, rank % t


def _block(x, case, rank, heads=True):
  """Rank ``rank``'s block of a global ``[B, S, H, D]`` array: its rows
  over data, its positions over sequence and, with ``heads``, its heads
  over tensor."""
  dd, sq, t = _degrees(case)
  cd, cs, ct = _coords(case, rank)
  b, s, h = x.shape[:3]
  x = x[cd * b // dd:(cd + 1) * b // dd, cs * s // sq:(cs + 1) * s // sq]
  if heads and t > 1:
    x = x[:, :, ct * h // t:(ct + 1) * h // t]
  return x


def _rank_main(rank, port, out):
  import torch.distributed as dist
  from tensorflowonspark_tpu_torch.parallel import collectives
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  from tensorflowonspark_tpu_torch.parallel import ring_attention as ra
  torch.set_num_threads(1)
  dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                          rank=rank, world_size=RANKS)
  try:
    arrays, meta = {}, {}
    for name, case in CASES.items():
      mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**case["spec"]))
      q, k, v, w = _inputs(case)
      t = _degrees(case)[2]
      whole = k.shape[2] % t != 0
      ql = torch.from_numpy(np.ascontiguousarray(_block(q, case, rank)))
      kl, vl = (torch.from_numpy(np.ascontiguousarray(
          _block(x, case, rank, heads=not whole))) for x in (k, v))
      for x in (ql, kl, vl):
        x.requires_grad_(case["grads"])
      collectives.reset_counts()
      got = ra.ring_attention(ql, kl, vl, mesh, causal=case["causal"],
                              use_flash=case["flash"], window=case["window"],
                              kv_whole=whole)
      meta[name] = dict(collectives.COUNTS)
      arrays[name + "/out"] = got.detach().numpy()
      if case["grads"]:
        wl = torch.from_numpy(np.ascontiguousarray(_block(w, case, rank)))
        (got * wl).sum().backward()
        for tag, x in (("dq", ql), ("dk", kl), ("dv", vl)):
          arrays["%s/%s" % (name, tag)] = x.grad.numpy()
    np.savez(out % rank, **arrays)
    with open((out % rank) + ".json", "w") as f:
      json.dump(meta, f)
  finally:
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
  out = str(tmp_path_factory.mktemp("ring") / "rank%d.npz")
  ctx = mp.get_context("spawn")
  port = get_free_port()
  procs = [ctx.Process(target=_rank_main, args=(r, port, out))
           for r in range(RANKS)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(timeout=240)
  assert [p.exitcode for p in procs] == [0] * RANKS
  got = []
  for r in range(RANKS):
    with open((out % r) + ".json") as f:
      got.append((dict(np.load(out % r)), json.load(f)))
  return got


def _jax_ring(case):
  """The JAX ring's global output (and q/k/v gradients of ``sum(w *
  out)``) on a mesh of the case's shape."""
  dd, sq, t = _degrees(case)
  mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(data=dd, sequence=sq,
                                               tensor=t),
                             devices=jax.devices()[:dd * sq * t])
  q, k, v, w = (jnp.asarray(x) for x in _inputs(case))
  kw = dict(causal=case["causal"], window=case["window"])
  if case["flash"]:
    kw.update(use_flash=True, blk_q=8, blk_k=8, interpret=True)

  def ring(q, k, v):
    return jax_ra.ring_attention(q, k, v, mesh, **kw)

  out = np.asarray(jax.jit(ring)(q, k, v))
  if not case["grads"]:
    return out, None
  grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(w * ring(q, k, v)),
                           argnums=(0, 1, 2)))(q, k, v)
  return out, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_the_jax_ring(ranks, name):
  case = CASES[name]
  want, grads = _jax_ring(case)
  whole = case["shape"][3] % _degrees(case)[2] != 0
  for rank, (arrays, _) in enumerate(ranks):
    np.testing.assert_allclose(arrays[name + "/out"],
                               _block(want, case, rank), rtol=TOL, atol=TOL,
                               err_msg="%s rank %d out" % (name, rank))
    if grads is None:
      continue
    for tag, g in zip(("dq", "dk", "dv"), grads):
      np.testing.assert_allclose(
          arrays["%s/%s" % (name, tag)],
          _block(g, case, rank, heads=tag == "dq" or not whole),
          rtol=TOL, atol=TOL, err_msg="%s rank %d %s" % (name, rank, tag))


def test_ring_matches_full_attention(ranks):
  """The JAX package's ``full_attention`` and the port's agree, and the
  port's ring output blocks put together are the full attention."""
  from tensorflowonspark_tpu_torch.parallel import ring_attention as ra
  case = CASES["gqa_dense"]
  q, k, v, _ = _inputs(case)
  h = q.shape[2]
  ke, ve = (np.repeat(x, h // x.shape[2], axis=2) for x in (k, v))
  want = np.asarray(jax_ra.full_attention(jnp.asarray(q), jnp.asarray(ke),
                                          jnp.asarray(ve)))
  got = ra.full_attention(*(torch.from_numpy(x) for x in (q, ke, ve)))
  np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
  whole = np.concatenate([ranks[r][0]["gqa_dense/out"]
                          for r in range(RANKS)], axis=1)
  np.testing.assert_allclose(whole, want, rtol=TOL, atol=TOL)


def test_grouped_ring_moves_unexpanded_blocks(ranks):
  """Every ring step sends the stacked GROUPED key and value blocks
  (``[2, B, S_local, Hk, D]`` f32): 3 sends a rank over 4 ranks, none in
  expanded heads; the backward sends the gradients back as many times."""
  b, s, _, hk, d = CASES["gqa_dense"]["shape"]
  send = 2 * b * (s // 4) * hk * d * 4
  for _, meta in ranks:
    got = meta["gqa_dense"]
    assert got["ring_permute"] == 3, got
    assert got["ring_permute_bytes"] == 3 * send, got


# -- the ring step's ops, one process ------------------------------------------

BLOCK_B, BLOCK_S, BLOCK_H, BLOCK_HK, BLOCK_D = 1, 16, 4, 2, 8
# a ring step at sequence 2: rank 1 against rank 0's keys (past), its own
# (diagonal), and rank 0 against rank 1's (future: every row masked)
BASES = {"past": (16, 0), "diagonal": (16, 16), "future": (0, 16)}


@pytest.mark.parametrize("bwd", ["fused", "split"])
@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("where", sorted(BASES))
def test_flash_attention_block_matches_jax(where, window, bwd):
  q_base, kv_base = BASES[where]
  rng = np.random.RandomState(11)
  q = rng.randn(BLOCK_B, BLOCK_S, BLOCK_H, BLOCK_D).astype(np.float32)
  k = rng.randn(BLOCK_B, BLOCK_S, BLOCK_HK, BLOCK_D).astype(np.float32)
  v = rng.randn(BLOCK_B, BLOCK_S, BLOCK_HK, BLOCK_D).astype(np.float32)
  g = rng.randn(BLOCK_B, BLOCK_S, BLOCK_H, BLOCK_D).astype(np.float32)
  g_lse = rng.randn(BLOCK_B, BLOCK_H, BLOCK_S).astype(np.float32)

  def jblock(q, k, v):
    return jax_fa.flash_attention_block(q, k, v, q_base, kv_base,
                                        causal=True, blk_q=8, blk_k=8,
                                        interpret=True, bwd=bwd,
                                        blk_bwd_q=8, blk_bwd_k=8,
                                        window=window)

  (j_out, j_lse), vjp = jax.vjp(jblock, *(jnp.asarray(x) for x in (q, k, v)))
  j_grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
  tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
  out, lse = ops.flash_attention_block(tq, tk, tv, q_base, kv_base,
                                       causal=True, bwd=bwd, window=window)
  torch.autograd.backward((out, lse), (torch.from_numpy(g),
                                       torch.from_numpy(g_lse)))
  np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                             rtol=TOL, atol=TOL)
  np.testing.assert_allclose(lse.detach().numpy(), np.asarray(j_lse),
                             rtol=TOL, atol=TOL)
  for got, want, tag in zip((tq, tk, tv), j_grads, "qkv"):
    assert torch.isfinite(got.grad).all(), tag
    np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL, err_msg="d" + tag)
  if where == "future":
    assert not out.detach().any() and bool((lse == -1e30).all())
    for x in (tq, tk, tv):
      assert not x.grad.any()


def test_merge_partials_matches_jax():
  rng = np.random.RandomState(12)
  shape = (2, 16, 4, 8)
  o_a, o_b = (rng.randn(*shape).astype(np.float32) for _ in range(2))
  lse_a, lse_b = (rng.randn(2, 4, 16).astype(np.float32) for _ in range(2))
  # rows one side never saw a key, and a row neither did
  lse_a[0, 1, :5] = -1e30
  lse_b[1, 2, 3:9] = -1e30
  lse_a[1, 3, 7] = lse_b[1, 3, 7] = -1e30
  want_o, want_lse = jax_fa.merge_partials(*(jnp.asarray(x) for x in (
      o_a, lse_a, o_b, lse_b)))
  got_o, got_lse = ops.merge_partials(*(torch.from_numpy(x) for x in (
      o_a, lse_a, o_b, lse_b)))
  np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=TOL,
                             atol=TOL)
  np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                             rtol=TOL, atol=TOL)
  assert not got_o[1, 7, 3].any()
