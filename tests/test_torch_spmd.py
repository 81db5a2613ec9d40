"""The port's mesh axes (fsdp, sequence, tensor) in gloo processes against
the JAX package on the 8 virtual CPU devices.

Two groups of ranks, spawned once for the module and run side by side
(2 ranks and 4 ranks), run every case and write what each rank saw; the
tests hold it against the JAX package on a mesh of the same shape:

- the collectives of ``tests/test_parallel.py``'s ``TestCollectives``
  through ``shard_map_fn`` (a psum and a ring permute, the hierarchical
  all-reduce over ``data`` x ``fsdp``, ``sync_gradients``,
  ``broadcast_from``, ``global_norm`` and ``clip_by_global_norm``), plus
  ``all_to_all``, ``ring_permute`` by other shifts, several axes at once
  and the mesh's coordinates and groups; f32, 1e-6;
- ``train_gpt --fsdp 2``, ``--sp 2``, ``--tp 2`` (with the blocked loss
  and z-loss), and on 4 ranks ``--sp 2 --tp 2``, ``--fsdp 2 --tp 2
  --optimizer adafactor`` at widths Adafactor factors (its row and column
  statistics over cut dimensions) and ``--fsdp 2 --tp 2 --fused
  --kv_heads 2 --optimizer sgd``: 3 steps of the port's pieces of ``train_gpt``
  (its config made f32) against the JAX package's ``make_train_step`` on
  the same mesh from the same weights and batches: losses and the
  gathered weights within 1e-5; ``train_gpt.run`` gives the same losses;
  FSDP ranks hold half the weights;
- ``TestShardedTrainStep``'s cases but MoE: KV heads the tensor axis
  cannot divide (tensor 4), a dp-free sp x tp mesh training down on a
  cyclic corpus, moments mirroring THEIR parameter, LN->matmul fused and
  unfused giving the same loss and gradients on sp x tp, the ring's flash
  path in the model against the JAX dense trajectory (2e-4, as the
  reference holds its own), parameter specs by the logical rules; and
  ``TestRingGQATransformer``: the ring's grouped logits against the JAX
  model's dense logits.

The port runs its kernels' plain versions on the CPU; the JAX model runs
as ``tests/test_parallel.py`` runs it ("auto": dense attention and flax
LayerNorm on the CPU).
"""

import dataclasses
import itertools
import json
import multiprocessing as mp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu.parallel import collectives as jax_coll
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu.parallel import sharding as jax_sharding
from tensorflowonspark_tpu_torch.examples import train_gpt
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.parallel import collectives
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.parallel import sharding
from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port
from tensorflowonspark_tpu_torch.utils.params import (init_params,
                                                      params_from_flax,
                                                      params_to_flax)

P = jax.sharding.PartitionSpec
RTOL = 1e-6            # collectives: a sum of a few terms, in any order
TRAIN_TOL = 1e-5       # f32 losses and weights after 3 steps
TRAJ_TOL = 2e-4        # the ring's flash path against the dense one
GPT = ["--device", "cpu", "--layers", "2", "--d_model", "32", "--heads",
       "4", "--seq_len", "32", "--vocab", "64", "--batch", "4", "--steps",
       "3"]
WIDE = ["--d_model", "128", "--vocab", "256"]     # Adafactor factors these
TRAIN = {
    2: {"fsdp2": ["--fsdp", "2"], "sp2": ["--sp", "2"],
        "tp2_blocked_z": ["--tp", "2", "--blocked_loss", "--z_loss", "1e-4"]},
    4: {"sp2_tp2": ["--sp", "2", "--tp", "2"],
        "fsdp2_tp2_adafactor": ["--fsdp", "2", "--tp", "2", "--optimizer",
                                "adafactor"] + WIDE,
        # SGD: its update is linear in the gradient, which this case holds
        # (AdamW's per-element normalization turns f32 rounding in a
        # near-zero gradient into a visible step)
        "fsdp2_tp2_fused_gqa_sgd": ["--fsdp", "2", "--tp", "2", "--fused",
                                    "--kv_heads", "2", "--optimizer", "sgd"]},
}
SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
             max_seq_len=32)
CYCLIC = np.tile(np.arange(32) % 16, (4, 1)).astype("int32")


def _argv(flags):
  return GPT + flags


def _f32(cfg):
  return dataclasses.replace(cfg, dtype=torch.float32)


def _mesh_of(args):
  return dict(data=1 if args.dp == -1 else args.dp, fsdp=args.fsdp,
              sequence=args.sp, tensor=args.tp)


# -- what each rank runs -------------------------------------------------------


def _collectives(rank, n):
  """Every collective case of an ``n``-rank group: name -> this rank's
  result (global values from ``shard_map_fn``, or a local block)."""
  C, M = collectives, mesh_lib
  out = {}
  mesh = M.build_mesh(M.MeshSpec(data=n))

  def body(x):
    total = C.all_reduce(x.sum(), mesh, "data")
    return total * torch.ones_like(x), C.ring_permute(x, mesh, "data", 1)

  x = torch.arange(4.0 * n)
  out["psum"], out["ring1"] = C.shard_map_fn(
      body, mesh, C.P("data"), (C.P("data"), C.P("data")))(x)
  out["ring_back"] = C.shard_map_fn(
      lambda v: C.ring_permute(v, mesh, "data", -1), mesh, C.P("data"),
      C.P("data"))(x)
  out["ring_two"] = C.shard_map_fn(
      lambda v: C.ring_permute(v, mesh, "data", 2), mesh, C.P("data"),
      C.P("data"))(x)
  sq = torch.arange(8.0 * n * n).reshape(2 * n, 4 * n)
  out["a2a"] = C.shard_map_fn(
      lambda v: C.all_to_all(v, mesh, "data", 1, 0), mesh, C.P("data"),
      C.P("data"))(sq)
  grads = {"w": torch.arange(float(n)), "b": torch.ones((n, 2))}
  sync = C.shard_map_fn(lambda g: C.sync_gradients(g, mesh, True, "data"),
                        mesh, ({"w": C.P("data"), "b": C.P("data")},),
                        {"w": C.P("data"), "b": C.P("data")})(grads)
  out["sync"] = torch.cat([sync["w"].reshape(-1), sync["b"].reshape(-1)])
  out["bcast"] = C.shard_map_fn(lambda v: C.broadcast_from(v, mesh, "data",
                                                           n - 1),
                                mesh, C.P("data"), C.P("data"))(
                                    torch.arange(float(n)))
  tree = {"a": torch.arange(float(n)), "b": -torch.arange(2.0 * n).reshape(
      n, 2)}
  spec = {"a": C.P("data"), "b": C.P("data")}
  out["norm"] = C.shard_map_fn(
      lambda t: C.global_norm(t, mesh, ("data",)).reshape(1), mesh, (spec,),
      C.P())(tree)
  clipped, norm = C.shard_map_fn(
      lambda t: C.clip_by_global_norm(t, 1.0, mesh, "data"), mesh,
      ({"g": C.P("data")},), ({"g": C.P("data")}, C.P()))(
          {"g": torch.full((n,), 3.0)})
  out["clipped"], out["clip_norm"] = clipped["g"], norm.reshape(1)
  if n == 4:
    two = M.build_mesh(M.MeshSpec(data=2, fsdp=2))
    x = torch.arange(256.0).reshape(32, 8)
    spec = C.P(("data", "fsdp"))
    out["hier"] = C.shard_map_fn(
        lambda v: C.hierarchical_all_reduce(v, two, "fsdp", "data"), two,
        spec, spec)(x)
    out["hier_mean"] = C.shard_map_fn(
        lambda v: C.hierarchical_all_reduce(v, two, "fsdp", "data",
                                            mean=True), two, spec, spec)(x)
    # several axes at once, and the groups of a 2 x 2 mesh
    ds = M.build_mesh(M.MeshSpec(data=2, sequence=2))
    local = torch.full((3,), float(rank + 1))
    out["sync_two_axes"] = C.sync_gradients([local], ds, mean=True,
                                            axis_name=("data", "sequence"))[0]
    out["norm_two_axes"] = C.global_norm([local], ds, ("data", "sequence"))
    out["sum_sequence"] = C.all_reduce(local, ds, "sequence")
    out["coords"] = torch.tensor([ds.coord("data"), ds.coord("sequence"),
                                  M.axis_index(ds, "sequence")])
    out["ranks_sequence"] = torch.tensor(ds.ranks("sequence"))
    out["bcast_data"] = C.broadcast_from(local, ds, "data", 1)
  return {k: v.float().numpy() for k, v in out.items()}


def _train(flags):
  """``train_gpt``'s pieces at ``flags`` (its config made f32): 3 steps
  over the mesh; the losses, the gathered weights, the weights' local
  element count and the losses of ``train_gpt.run`` itself."""
  args = train_gpt.parse_args(_argv(flags))
  mesh = train_gpt.make_mesh(args)
  cfg = train_gpt.make_config(args)
  state = train_gpt.make_state(args, cfg, mesh)
  step = sharding.make_train_step(train_gpt.make_loss_fn(args), mesh,
                                  state.sharding,
                                  batch_extra_axes=train_gpt.SEQUENCE_AXES)
  losses = []
  for batch in itertools.islice(train_gpt.batch_stream(args), args.steps):
    state, loss = step(state, sharding.shard_batch(
        batch, mesh, train_gpt.SEQUENCE_AXES))
    losses.append(float(loss))
  weights = sharding.gather_state_params(state)
  local = sum(p.numel() for p in state.params.values())
  return {"losses": losses, "run": train_gpt.run(args), "local": local,
          "total": sum(w.size for w in weights.values()),
          "opt_local": sum(t.numel() for t in collectives.tensors_of(
              state.opt_state))}, weights


def _small_state(mesh, **kw):
  cfg = tfm.TransformerConfig(dtype=torch.float32, remat=False,
                              **dict(SMALL, **kw))
  from tensorflowonspark_tpu_torch import optim
  return cfg, tfm.create_sharded_state(
      cfg, init_params(cfg, 0), mesh, device="cpu",
      tx=optim.adamw(1e-2, weight_decay=0.01))[0]


def _lm_loss(model, tokens):
  return tfm.causal_lm_loss(model(tokens), tokens, mesh=model.mesh)


def _steps(state, mesh, tokens, n):
  step = sharding.make_train_step(_lm_loss, mesh,
                                  batch_extra_axes=("sequence",))
  losses = []
  for _ in range(n):
    state, loss = step(state, sharding.shard_batch(tokens, mesh,
                                                   ("sequence",)))
    losses.append(float(loss))
  return state, losses


def _model_cases(rank):
  """The 4-rank cases of ``TestShardedTrainStep`` and
  ``TestRingGQATransformer``."""
  M = mesh_lib
  rec, arrays = {}, {}
  # KV heads the tensor axis cannot divide (kv_heads 2 on tensor 4)
  mesh = M.build_mesh(M.MeshSpec(tensor=4))
  cfg, state = _small_state(mesh, num_heads=8, num_kv_heads=2)
  specs = state.sharding.specs
  rec["indivisible_specs"] = {n: list(specs["layers.0.attn." + n])
                              for n in ("q", "k", "v", "out")}
  state, rec["indivisible_losses"] = _steps(state, mesh, CYCLIC, 1)
  # sp x tp trains down on a cyclic corpus; some weight is cut
  mesh = M.build_mesh(M.MeshSpec(sequence=2, tensor=2))
  cfg, state = _small_state(mesh, use_ring_attention=True)
  rec["cut"] = [n for n, p in state.params.items()
                if tuple(p.shape) != state.sharding.global_shape(n)]
  state, rec["cyclic_losses"] = _steps(state, mesh, CYCLIC, 8)
  # LN->matmul fused and unfused: one loss and gradient on one weight set
  cfg, state = _small_state(mesh, use_ring_attention=True, fuse_qkv=True)
  fcfg = dataclasses.replace(cfg, ln_matmul_impl="fused",
                             act_matmul_impl="fused")
  fused = tfm.Transformer(fcfg, sharding.gather_state_params(state),
                          device="cpu", trainable=True, mesh=mesh)
  tokens = torch.as_tensor(sharding.shard_batch(CYCLIC, mesh, ("sequence",)))
  for tag, model in (("unfused", state.model), ("fused", fused)):
    loss = _lm_loss(model, tokens)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    rec[tag + "_loss"] = float(loss)
    arrays[tag + "_grads"] = torch.cat([g.reshape(-1) for g in grads]).numpy()
  # the blocked loss against the plain one over sequence x tensor, z-loss
  # on, chunks that do not divide a rank's positions
  losses = {
      "plain": lambda m, t: tfm.causal_lm_loss(m(t), t, 1e-4, mesh=mesh),
      "blocked": lambda m, t: tfm.causal_lm_loss_blocked(
          m(t, return_hidden=True), tfm.tied_embedding_table(m), t, chunk=5,
          z_loss=1e-4, mesh=mesh)}
  for tag, fn in losses.items():
    loss = fn(state.model, tokens)
    grads = torch.autograd.grad(loss, list(state.model.parameters()))
    rec[tag + "_z_loss"] = float(loss)
    arrays[tag + "_z_grads"] = torch.cat([g.reshape(-1)
                                          for g in grads]).numpy()
  # the ring's flash path in the model (data 2 x sequence 2), 4 steps
  mesh = M.build_mesh(M.MeshSpec(data=2, sequence=2))
  cfg, state = _small_state(mesh, use_ring_attention=True)
  _, rec["ring_losses"] = _steps(state, mesh, CYCLIC, 4)
  # the ring's grouped logits (sequence 4, kv_heads 2), this rank's block
  mesh = M.build_mesh(M.MeshSpec(sequence=4))
  cfg, state = _small_state(mesh, num_kv_heads=2, use_ring_attention=True)
  tokens = np.random.RandomState(0).randint(0, 64, (2, 32)).astype("int32")
  with torch.no_grad():
    arrays["ring_gqa_logits"] = state.model(torch.as_tensor(
        sharding.shard_batch(tokens, mesh, ("sequence",)))).numpy()
  return rec, arrays


def _cut_module_checkpoint(rank, root):
  """A one-weight state cut over fsdp 2 (rank r holds rows [4r, 4r + 4)
  of an [8, 8] weight), one AdamW step taken: each rank calls save,
  restore_or into a fresh state of zeros, and export."""
  import os
  from torch import nn
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.train_state import TrainState
  from tensorflowonspark_tpu_torch.utils import checkpoint, compat

  def state_of(value):
    model = nn.Module()
    model.w = nn.Parameter(torch.full((4, 8), value))
    state = TrainState.create(model, optim.adamw(1e-3))
    state.sharding = sharding.StateSharding(
        mesh_lib.build_mesh(mesh_lib.MeshSpec(data=1, fsdp=2)),
        {"w": ("fsdp", None)}, {"w": (8, 8)})
    return state

  state = state_of(float(rank + 1))
  state.apply_gradients({"w": torch.full((4, 8), float(rank + 1))})
  ck, ex = os.path.join(root, "cut_ck"), os.path.join(root, "cut_ex")
  rec = {"saved": checkpoint.CheckpointManager(ck).save(0, state,
                                                        force=True)}
  fresh, rec["next"] = checkpoint.CheckpointManager(ck).restore_or(
      state_of(0.0))
  before, after = (sharding._state_tensors(s) for s in (state, fresh))
  rec["restored_equal"] = [torch.equal(a, b) for (_, a), (_, b)
                           in zip(before, after)]
  # the chief writes the export, the other rank a throwaway copy
  rec["exported_to"] = compat.export_model(state, ex, rank == 0) == ex
  rec["root"] = root
  return rec


def _cut_serving_params():
  """``serving_params`` of the model of ``test_param_shardings_follow_rules``
  cut over ``fsdp=2``: for each weight, whether it equals the uncut
  model's to the bit."""
  cfg = tfm.TransformerConfig(vocab_size=64, num_layers=1, num_heads=4,
                              d_model=64, d_ff=128, dtype=torch.float32)
  cut = tfm.Transformer(cfg, init_params(cfg, 0), device="cpu",
                        mesh=mesh_lib.build_mesh(mesh_lib.MeshSpec(
                            data=1, fsdp=2))).serving_params()
  whole = tfm.Transformer(cfg, init_params(cfg, 0),
                          device="cpu").serving_params()
  return {n: bool(torch.equal(cut[n], whole[n])) for n in whole}


def _rank_main(rank, n, port, out):
  import torch.distributed as dist
  torch.set_num_threads(1)
  dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                          rank=rank, world_size=n)
  make = train_gpt.make_config
  train_gpt.make_config = lambda args: _f32(make(args))
  try:
    arrays = {"coll/" + k: v for k, v in _collectives(rank, n).items()}
    rec = {}
    for name, flags in TRAIN[n].items():
      rec[name], weights = _train(flags)
      arrays.update({"%s/%s" % (name, k): v for k, v in weights.items()})
    if n == 2:
      # the fused loop over a sequence-cut slab: train_gpt --unroll 3
      rec["sp2_unroll"] = train_gpt.run(train_gpt.parse_args(_argv(
          TRAIN[2]["sp2"] + ["--unroll", "3"])))
      import os
      rec["cut_ckpt"] = _cut_module_checkpoint(rank, os.path.dirname(out))
      rec["serving_params"] = _cut_serving_params()
    if n == 4:
      rec["model"], more = _model_cases(rank)
      arrays.update({"model/" + k: v for k, v in more.items()})
    np.savez(out % (n, rank), **arrays)
    with open((out % (n, rank)) + ".json", "w") as f:
      json.dump(rec, f)
  finally:
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
  """{2: records of each of 2 ranks, 4: of each of 4}: both groups run
  side by side."""
  out = str(tmp_path_factory.mktemp("spmd") / "g%d_rank%d.npz")
  ctx = mp.get_context("spawn")
  procs = []
  for n in (2, 4):
    port = get_free_port()
    procs += [ctx.Process(target=_rank_main, args=(r, n, port, out))
              for r in range(n)]
  for p in procs:
    p.start()
  # the JAX package's side of every test, while the ranks run
  want = _jax_references()
  for p in procs:
    p.join(timeout=300)
  assert [p.exitcode for p in procs] == [0] * len(procs)
  got = {"jax": want}
  for n in (2, 4):
    got[n] = []
    for r in range(n):
      with open((out % (n, r)) + ".json") as f:
        got[n].append((dict(np.load(out % (n, r))), json.load(f)))
  return got


# -- the collectives -----------------------------------------------------------


def _jax_shard_map(fn, n, in_specs, out_specs, *args, **mesh_kw):
  mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(**(mesh_kw or {"data": n})),
                             devices=jax.devices()[:n])
  return jax.jit(jax_coll.shard_map_fn(fn, mesh, in_specs, out_specs))(*args)


def _jax_collectives(n):
  C = jax_coll
  want = {}
  x = jnp.arange(4.0 * n)

  def body(v):
    return C.all_reduce(jnp.sum(v), "data") * jnp.ones_like(v), \
        C.ring_permute(v, "data", 1)

  want["psum"], want["ring1"] = _jax_shard_map(body, n, P("data"),
                                               (P("data"), P("data")), x)
  want["ring_back"] = _jax_shard_map(lambda v: C.ring_permute(v, "data", -1),
                                     n, P("data"), P("data"), x)
  want["ring_two"] = _jax_shard_map(lambda v: C.ring_permute(v, "data", 2),
                                    n, P("data"), P("data"), x)
  sq = jnp.arange(8.0 * n * n).reshape(2 * n, 4 * n)
  want["a2a"] = _jax_shard_map(lambda v: C.all_to_all(v, "data", 1, 0), n,
                               P("data"), P("data"), sq)
  spec = {"w": P("data"), "b": P("data")}
  sync = _jax_shard_map(lambda g: C.sync_gradients(g, "data"), n, (spec,),
                        spec, {"w": jnp.arange(float(n)),
                               "b": jnp.ones((n, 2))})
  want["sync"] = jnp.concatenate([sync["w"].reshape(-1),
                                  sync["b"].reshape(-1)])
  want["bcast"] = _jax_shard_map(lambda v: C.broadcast_from(v, "data", n - 1),
                                 n, P("data"), P("data"),
                                 jnp.arange(float(n)))
  tree = {"a": jnp.arange(float(n)), "b": -jnp.arange(2.0 * n).reshape(n, 2)}
  want["norm"] = _jax_shard_map(
      lambda t: C.global_norm(t, "data") * jnp.ones(1), n,
      ({"a": P("data"), "b": P("data")},), P(), tree)
  clipped, norm = _jax_shard_map(
      lambda t: (lambda c: (c[0], c[1] * jnp.ones(1)))(
          C.clip_by_global_norm(t, 1.0, "data")), n,
      ({"g": P("data")},), ({"g": P("data")}, P()),
      {"g": jnp.full((n,), 3.0)})
  want["clipped"], want["clip_norm"] = clipped["g"], norm
  if n == 4:
    x = jnp.arange(256.0).reshape(32, 8)
    spec = P(("data", "fsdp"))
    want["hier"] = _jax_shard_map(
        lambda v: C.hierarchical_all_reduce(v, "fsdp", "data"), 4, spec,
        spec, x, data=2, fsdp=2)
    want["hier_mean"] = _jax_shard_map(
        lambda v: C.hierarchical_all_reduce(v, "fsdp", "data", mean=True), 4,
        spec, spec, x, data=2, fsdp=2)
  return {k: np.asarray(v) for k, v in want.items()}




COLLECTIVES = ["psum", "ring1", "ring_back", "ring_two", "a2a", "sync",
               "bcast", "norm", "clipped", "clip_norm"]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_matches_shard_map(groups, n, name):
  want = groups["jax"]["collectives"][n][name]
  for rank, (arrays, _) in enumerate(groups[n]):
    np.testing.assert_allclose(arrays["coll/" + name].reshape(want.shape),
                               want, rtol=RTOL, atol=1e-6,
                               err_msg="%s, rank %d of %d" % (name, rank, n))


@pytest.mark.parametrize("name", ["hier", "hier_mean"])
def test_hierarchical_all_reduce_matches_jax(groups, name):
  want = groups["jax"]["collectives"][4][name]
  for arrays, _ in groups[4]:
    np.testing.assert_allclose(arrays["coll/" + name], want, rtol=RTOL)
  # and equals the flat sum over both tiers (the mean: over 4 ranks)
  flat = np.tile(np.arange(256.0).reshape(32, 8).reshape(4, 8, 8).sum(0),
                 (4, 1))
  np.testing.assert_allclose(want, flat / (4 if name == "hier_mean" else 1),
                             rtol=RTOL)


def test_groups_and_coordinates_of_a_two_by_two_mesh(groups):
  for rank, (arrays, _) in enumerate(groups[4]):
    d, s = rank // 2, rank % 2
    assert arrays["coll/coords"].tolist() == [d, s, s]
    assert arrays["coll/ranks_sequence"].tolist() == [2 * d, 2 * d + 1]
    pair = [2 * d + 1, 2 * d + 2]                    # rank + 1 of each
    np.testing.assert_allclose(arrays["coll/sum_sequence"], [sum(pair)] * 3)
    np.testing.assert_allclose(arrays["coll/sync_two_axes"], [2.5] * 3)
    np.testing.assert_allclose(arrays["coll/norm_two_axes"],
                               np.sqrt(3 * (1 + 4 + 9 + 16)), rtol=RTOL)
    np.testing.assert_allclose(arrays["coll/bcast_data"], [2 + s + 1] * 3)


# -- train_gpt over the mesh axes against the JAX package ----------------------


def _jax_train(flags):
  """3 steps of the JAX package's ``make_train_step`` at ``train_gpt``'s
  flags: its config (f32), mesh, optimizer recipe and synthetic batch, from
  the port's seed-0 weights; (losses, weights as the port names them)."""
  from tensorflowonspark_tpu.parallel import mesh as M
  args = train_gpt.parse_args(_argv(flags))
  tcfg = _f32(train_gpt.make_config(args))
  # remat off on the JAX side: the same function, compiled faster
  jcfg = jax_tfm.TransformerConfig(
      vocab_size=args.vocab, num_layers=args.layers, num_heads=args.heads,
      d_model=args.d_model, d_ff=args.d_model * 4, max_seq_len=args.seq_len,
      num_kv_heads=args.kv_heads, use_ring_attention=args.sp > 1,
      fuse_qkv=args.fused, dtype=jnp.float32, remat=False)
  degrees = _mesh_of(args)
  mesh = M.build_mesh(M.MeshSpec(**degrees), devices=jax.devices()[
      :int(np.prod(list(degrees.values())))])
  tx = jax_optim.make_optimizer(learning_rate=args.lr, clip_norm=1.0,
                                optimizer=args.optimizer)
  state, shard = jax_tfm.create_sharded_state(
      jax.random.PRNGKey(0), jcfg, mesh, seq_len=args.seq_len, tx=tx)
  flax = jax.tree.map(jnp.asarray, params_to_flax(init_params(tcfg, 0), tcfg))
  state = jax.jit(lambda p: state.replace(params=p, opt_state=tx.init(p)),
                  out_shardings=shard)(flax)

  def loss_fn(params, tokens):
    if args.blocked_loss:
      hidden = state.apply_fn({"params": params}, tokens, return_hidden=True)
      return jax_tfm.causal_lm_loss_blocked(
          hidden, jax_tfm.tied_embedding_table(params), tokens,
          z_loss=args.z_loss)
    return jax_tfm.causal_lm_loss(state.apply_fn({"params": params}, tokens),
                                  tokens, z_loss=args.z_loss)

  step = jax_sharding.make_train_step(loss_fn, mesh, shard,
                                      batch_extra_axes=(M.AXIS_SEQUENCE,))
  base = np.random.RandomState(0).randint(0, args.vocab,
                                          (args.batch, args.seq_len))
  losses = []
  for _ in range(args.steps):
    state, loss = step(state, jax_sharding.shard_batch(
        jnp.asarray(base, jnp.int32), mesh, extra_axes=(M.AXIS_SEQUENCE,)))
    losses.append(float(loss))
  return losses, params_from_flax(jax.tree.map(np.asarray, state.params),
                                  tcfg)


CASES = [(n, name) for n in (2, 4) for name in TRAIN[n]]


@pytest.mark.parametrize("n,name", CASES, ids=[c[1] for c in CASES])
def test_train_gpt_matches_jax_make_train_step(groups, n, name):
  want_losses, want = groups["jax"]["train"][name]
  for rank, (arrays, rec) in enumerate(groups[n]):
    got = rec[name]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=TRAIN_TOL,
                               err_msg="%s rank %d" % (name, rank))
    # train_gpt.run is the same pieces: the same losses, to the bit
    assert got["run"] == got["losses"], (got["run"], got["losses"])
    for k, v in want.items():
      np.testing.assert_allclose(arrays["%s/%s" % (name, k)], v,
                                 rtol=TRAIN_TOL, atol=TRAIN_TOL,
                                 err_msg="%s rank %d %s" % (name, rank, k))


@pytest.mark.parametrize("n,name", [(2, "fsdp2"), (4, "fsdp2_tp2_adafactor")])
def test_fsdp_ranks_hold_their_share_of_the_weights(groups, n, name):
  """Every weight but the LayerNorm scales is cut over fsdp (and over
  tensor where its rule says so): under --fsdp 2 each rank holds half of
  them, and its AdamW moments mirror its blocks; under --fsdp 2 --tp 2 a
  quarter of the weights the tensor axis cuts too."""
  for _, rec in groups[n]:
    got = rec[name]
    args = train_gpt.parse_args(_argv(TRAIN[n][name]))
    scales = (2 * args.layers + 1) * args.d_model
    if n == 2:
      assert got["local"] == (got["total"] - scales) // 2 + scales, got
      assert got["opt_local"] == 2 * got["local"], got
    else:
      # every other weight is cut over tensor too: heads, mlp, vocab
      assert got["local"] == (got["total"] - scales) // 4 + scales, got


# -- TestShardedTrainStep / TestRingGQATransformer -----------------------------


def _jax_small(mesh_kw, tokens, steps, **kw):
  """The JAX package's steps from the port's seed-0 weights on a mesh of
  ``mesh_kw`` (AdamW 1e-2, as ``_small_state``); its losses."""
  import optax
  from tensorflowonspark_tpu.parallel import mesh as M
  cfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False,
                                  **dict(SMALL, **kw))
  tcfg = tfm.TransformerConfig(dtype=torch.float32, remat=False,
                               **dict(SMALL, **{k: v for k, v in kw.items()
                                                if k != "attention_impl"}))
  n = int(np.prod(list(mesh_kw.values())))
  mesh = M.build_mesh(M.MeshSpec(**dict({"data": 1}, **mesh_kw)),
                      devices=jax.devices()[:n])
  tx = optax.adamw(1e-2, weight_decay=0.01)
  state, shard = jax_tfm.create_sharded_state(jax.random.PRNGKey(0), cfg,
                                              mesh, seq_len=32, tx=tx)
  flax = jax.tree.map(jnp.asarray, params_to_flax(init_params(tcfg, 0), tcfg))
  state = jax.jit(lambda p: state.replace(params=p, opt_state=tx.init(p)),
                  out_shardings=shard)(flax)
  step = jax_sharding.make_train_step(
      lambda p, t: jax_tfm.causal_lm_loss(state.apply_fn({"params": p}, t),
                                          t), mesh, shard,
      batch_extra_axes=(M.AXIS_SEQUENCE,))
  losses = []
  for _ in range(steps):
    state, loss = step(state, jax_sharding.shard_batch(
        jnp.asarray(tokens), mesh, extra_axes=(M.AXIS_SEQUENCE,)))
    losses.append(float(loss))
  return losses


def _model(groups):
  return [(arrays, rec["model"]) for arrays, rec in groups[4]]


def test_gqa_kv_heads_replicate_when_indivisible(groups):
  want = groups["jax"]["indivisible"]
  for _, rec in _model(groups):
    specs = rec["indivisible_specs"]
    assert specs["q"] == [None, "tensor", None], specs
    assert specs["k"] == specs["v"] == [None, None, None], specs
    assert specs["out"] == ["tensor", None, None], specs
    np.testing.assert_allclose(rec["indivisible_losses"], want,
                               rtol=TRAIN_TOL)


def test_transformer_trains_sharded(groups):
  """sp x tp on the cyclic corpus: the loss falls to under 0.7 of its
  start in 8 steps; weights are actually cut."""
  for _, rec in _model(groups):
    losses = rec["cyclic_losses"]
    assert losses[-1] < losses[0] * 0.7, losses
    assert "layers.0.mlp.up" in rec["cut"] and \
        "embed.embedding" in rec["cut"], rec["cut"]


def test_ln_matmul_fused_matches_unfused_sharded(groups):
  for arrays, rec in _model(groups):
    np.testing.assert_allclose(rec["fused_loss"], rec["unfused_loss"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(arrays["model/fused_grads"],
                               arrays["model/unfused_grads"], rtol=2e-4,
                               atol=2e-4)


def test_blocked_loss_matches_the_plain_one_over_sequence_and_tensor(groups):
  for arrays, rec in _model(groups):
    np.testing.assert_allclose(rec["blocked_z_loss"], rec["plain_z_loss"],
                               rtol=TRAIN_TOL)
    np.testing.assert_allclose(arrays["model/blocked_z_grads"],
                               arrays["model/plain_z_grads"], rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)


def test_train_gpt_unroll_over_a_sequence_mesh_equals_per_step(groups):
  """``--unroll 3`` over ``--sp 2`` runs the same step body on a slab cut
  by ``shard_slab(..., ("sequence",))``: the per-step path's losses, to
  the bit."""
  for _, rec in groups[2]:
    assert rec["sp2_unroll"] == rec["sp2"]["run"], (rec["sp2_unroll"],
                                                    rec["sp2"]["run"])


def test_ring_flash_in_model_matches_dense(groups):
  want = groups["jax"]["ring_dense"]
  for _, rec in _model(groups):
    np.testing.assert_allclose(rec["ring_losses"], want, rtol=TRAJ_TOL,
                               atol=TRAJ_TOL)


def _jax_dense_logits():
  cfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False,
                                  num_kv_heads=2, **SMALL)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, num_kv_heads=2, **SMALL)
  tokens = np.random.RandomState(0).randint(0, 64, (2, 32)).astype("int32")
  return np.asarray(jax_tfm.Transformer(cfg, None).apply(
      {"params": params_to_flax(init_params(tcfg, 0), tcfg)},
      jnp.asarray(tokens)))


def _jax_references() -> dict:
  """Everything the tests hold the ranks against, from the JAX package."""
  return {
      "collectives": {n: _jax_collectives(n) for n in (2, 4)},
      "train": {name: _jax_train(flags) for n in (2, 4)
                for name, flags in TRAIN[n].items()},
      "indivisible": _jax_small({"tensor": 4}, CYCLIC, 1, num_heads=8,
                                num_kv_heads=2),
      "ring_dense": _jax_small({"data": 2, "sequence": 2}, CYCLIC, 4,
                               use_ring_attention=True,
                               attention_impl="dense"),
      "ring_gqa_logits": _jax_dense_logits()}


def test_ring_gqa_logits_match_dense(groups):
  want = groups["jax"]["ring_gqa_logits"]
  for rank, (arrays, _) in enumerate(_model(groups)):
    np.testing.assert_allclose(arrays["model/ring_gqa_logits"],
                               want[:, rank * 8:(rank + 1) * 8], rtol=1e-4,
                               atol=1e-4)


class _Group(object):

  def __init__(self, n, rank=0):
    self.n, self.r = n, rank

  def size(self):
    return self.n

  def rank(self):
    return self.r


def _stand_in(rank=0, **degrees):
  return mesh_lib.build_mesh(mesh_lib.MeshSpec(**dict({"data": 1}, **degrees)),
                             group=_Group(int(np.prod(list(
                                 degrees.values()))), rank))


def test_param_shardings_follow_rules(groups):
  """The port's specs follow LOGICAL_RULES as the reference's do: mlp
  over tensor, embed over fsdp, heads over tensor where divisible. A cut
  model's ``serving_params``, once refused by name, are the whole
  weights: on each rank of the 2-rank group, the model cut over
  ``fsdp=2`` gives the uncut model's to the bit."""
  cfg = tfm.TransformerConfig(vocab_size=64, num_layers=1, num_heads=4,
                              d_model=64, d_ff=128, dtype=torch.float32)
  model = tfm.Transformer(cfg, init_params(cfg, 0), device="cpu",
                          mesh=_stand_in(rank=3, tensor=4))
  specs = model.param_specs()
  assert specs["layers.0.mlp.up"][-1] == "tensor"
  assert specs["layers.0.attn.q"] == (None, "tensor", None)
  assert specs["embed.embedding"] == ("tensor", None)
  # rank 3 holds the last quarter of the up projection's columns
  up = init_params(cfg, 0)["layers.0.mlp.up"]
  np.testing.assert_array_equal(
      model.layers[0].mlp.up.detach().numpy(), up[:, 96:].astype(
          model.layers[0].mlp.up.detach().numpy().dtype))
  fsdp = tfm.Transformer(cfg, init_params(cfg, 0), device="cpu",
                         mesh=_stand_in(fsdp=2))
  assert fsdp.param_specs()["layers.0.mlp.down"] == (None, "fsdp")
  assert fsdp.param_specs()["layers.0.ln1.scale"] == (None,)
  # a cut model's serving bundle is the whole weights
  for _, rec in groups[2]:
    assert rec["serving_params"] and all(rec["serving_params"].values()), \
        rec["serving_params"]


def test_state_shardings_distinguish_same_shape_params():
  """Moments mirror THEIR parameter's layout: two weights of one shape
  with different specs keep their own."""
  from torch import nn
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.train_state import TrainState
  mesh = _stand_in(data=2, tensor=2)
  model = nn.Module()
  model.a = nn.Parameter(torch.zeros(4, 8))
  model.b = nn.Parameter(torch.zeros(4, 8))
  state = TrainState.create(model, optim.adamw(1e-3))
  sh = sharding.StateSharding(mesh, {"a": ("tensor", None),
                                     "b": (None, "tensor")},
                              {"a": (8, 8), "b": (4, 16)})
  got = sharding.state_shardings(state, sh)
  assert got[("params", "a")] == collectives.P("tensor", None)
  assert got[("params", "b")] == collectives.P(None, "tensor")
  adam = state.opt_state[0] if isinstance(state.opt_state, list) \
      else state.opt_state
  for moment in ("mu", "nu"):
    path = [p for p in got if p[-2:] == (moment, 0)]
    assert len(path) == 1 and got[path[0]] == collectives.P("tensor", None)
    path = [p for p in got if p[-2:] == (moment, 1)]
    assert got[path[0]] == collectives.P(None, "tensor")
  assert adam is not None


def test_train_step_refuses_a_state_laid_out_otherwise():
  """The state's own ``sharding`` is the one record of its layout: a step
  or a loop built for another layout raises, and one built for an equal
  layout takes its step."""
  from torch import nn
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.train_state import TrainState
  model = nn.Module()
  model.w = nn.Parameter(torch.ones(4, 8))
  state = TrainState.create(model, optim.sgd(0.5))
  mesh = _stand_in(data=2)
  state.sharding = sharding.StateSharding(mesh, {"w": (None, None)},
                                          {"w": (4, 8)})
  other = sharding.StateSharding(mesh, {"w": ("fsdp", None)}, {"w": (8, 8)})
  loss_fn = lambda m, b: (m.w * b).sum()  # noqa: E731
  batch = torch.ones(4, 8)
  for make in (sharding.make_train_step,
               lambda fn, mesh, sh: sharding.make_train_loop(fn, mesh, sh,
                                                             unroll=1)):
    with pytest.raises(ValueError, match="built for"):
      make(loss_fn, None, other)(state, batch)
    assert torch.equal(model.w.detach(), torch.ones(4, 8))
  same = sharding.StateSharding(mesh, {"w": (None, None)}, {"w": (4, 8)})
  state, _ = sharding.make_train_step(loss_fn, None, same)(state, batch)
  assert state.step == 1
  assert torch.allclose(model.w.detach(), torch.full((4, 8), 0.5))


def test_logical_rules_are_the_references():
  assert sharding.LOGICAL_RULES == jax_sharding.LOGICAL_RULES
  mesh = _stand_in(data=2, tensor=2)
  assert sharding.batch_sharding(mesh, ("sequence",)) == collectives.P(
      ("data", "fsdp"), "sequence")
  assert sharding.slab_sharding(mesh) == collectives.P(None,
                                                       ("data", "fsdp"))
  # a dimension its axis cannot divide stays whole
  assert sharding.logical_to_mesh(("vocab", "embed"), (63, 32), mesh) == \
      (None, None)


def test_checkpoints_of_a_cut_state_are_refused_by_name(groups, tmp_path):
  """A state cut over fsdp holds this rank's blocks only. Save, restore
  and export of it, once refused by name, now work: each rank of the
  2-rank group calls them, the checkpoint and the export hold the whole
  weight and its AdamW moments (rank 0's rows, then rank 1's), and a
  fresh cut state restores each rank's own blocks to the bit. A state
  every rank holds whole (a stand-in mesh, no process group) saves and
  restores as before."""
  import os
  from torch import nn
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.train_state import TrainState
  from tensorflowonspark_tpu_torch.utils import checkpoint, compat
  recs = [rec["cut_ckpt"] for _, rec in groups[2]]
  for rec in recs:
    assert rec["saved"] and rec["next"] == 1, rec
    assert rec["restored_equal"] == [True] * 3, rec
  assert [rec["exported_to"] for rec in recs] == [True, False]
  root = recs[0]["root"]
  # the whole weight, and AdamW's first moments (0.1 g) and second
  # moments (0.001 g ** 2) of the step each rank took on its rows
  rows = np.repeat([1.0, 2.0], 4)[:, None] * np.ones((1, 8))
  saved = checkpoint.load_tree(os.path.join(root, "cut_ck", "0"))
  exported = compat.import_model(os.path.join(root, "cut_ex"))
  for tree in (saved, exported):
    assert tree["step"] == 1
    w = tree["params"]["w"].numpy()
    assert w.shape == (8, 8)
    np.testing.assert_allclose(w, rows - 1e-3, rtol=1e-6)
    adam = tree["opt_state"][0]
    np.testing.assert_allclose(adam["mu"][0].numpy(), 0.1 * rows, rtol=1e-6)
    np.testing.assert_allclose(adam["nu"][0].numpy(), 1e-3 * rows ** 2,
                               rtol=1e-6)
  model = nn.Module()
  model.w = nn.Parameter(torch.zeros(4, 8))
  state = TrainState.create(model, optim.adamw(1e-3))
  mesh = _stand_in(fsdp=2)
  state.sharding = sharding.StateSharding(mesh, {"w": (None, None)},
                                          {"w": (4, 8)})
  mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"))
  assert mgr.save(0, state, force=True)
  assert mgr.restore_or(state)[1] == 1
