"""Data parallelism across processes: the port under ``cluster.run`` with
two gloo ranks, against the JAX package and against one process.

One ``cluster.run(LocalEngine(2), ..., InputMode.FILES)`` runs every
FILES-mode check in each rank (both ranks join one gloo group through
``ctx.initialize_distributed("gloo")``); the tests read what each rank
wrote:

- the process-group all-reduce (the port's ``test_distributed.py:20-58``);
- ``create_sharded_state``: a rank given another seed ends with rank 0's
  weights;
- 3 data-parallel steps from weights converted from the JAX package
  (``params_from_flax``) on global batches cut by ``shard_batch``, held
  against the reference's ``make_train_step`` over ``MeshSpec(data=2)``
  on 2 CPU devices: losses rtol 1e-4, weights 1e-4 (as
  ``test_torch_train.py`` holds data=1); the two ranks' weights bitwise
  equal;
- 2 ranks against 1 process on the same global batches, per step and
  through an unroll-2 slab, ``train_gpt --dp 2`` and ``train_gpt --pp 2``
  (the 1F1B pipeline over the two ranks) from a TFRecord file against
  ``train_gpt`` in one process (its config made f32 in both): f32, 1e-5
  relative;
- a checkpointed run: a fresh 2-rank cluster restores what the first
  saved through ``ctx.checkpoint_manager`` and continues; its losses and
  weights equal an uninterrupted 2-rank run's to the bit.

A second cluster in InputMode.SPARK feeds partitions of 12 and 8 token
rows to ranks that train from ``next_batch_synced(4)``: both stop at step
2 (the port's ``test_uneven_feeds_stop_at_same_step``), and each step's
global batch, reassembled from the row ids the ranks wrote, gives the
same loss in one process (1e-5 relative).

Main fns are module-level: the port sends them by pickle, by name.
"""

import json
import os
import time

import numpy as np
import pytest

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.cluster import InputMode
from tensorflowonspark_tpu_torch.engine import LocalEngine

STEP_CFG = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                d_model=32, d_ff=64, max_seq_len=32)
OPT = dict(learning_rate=3e-3, clip_norm=1.0, warmup_steps=1,
           schedule="cosine", decay_steps=4)
SEQ, VOCAB, GLOBAL_B = 32, 64, 8
REL = 1e-5           # 2 ranks against 1 process, f32
GPT_ARGV = ["--device", "cpu", "--layers", "2", "--d_model", "32", "--heads",
            "4", "--kv_heads", "2", "--seq_len", "32", "--vocab", "64",
            "--batch", "8", "--steps", "4", "--lr", "3e-3"]
GPT_OPTIONS = ["--optimizer", "adafactor", "--remat_policy", "dots"]


def _cfg():
  import torch
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  return tfm.TransformerConfig(dtype=torch.float32, **STEP_CFG)


def _tx():
  from tensorflowonspark_tpu_torch import optim
  return optim.make_optimizer(**OPT)


def _lm_loss(model, tokens):
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  return tfm.causal_lm_loss(model(tokens), tokens)


def _batches(n, seed):
  rng = np.random.default_rng(seed)
  return [rng.integers(0, VOCAB, size=(GLOBAL_B, SEQ)).astype(np.int32)
          for _ in range(n)]


def _f32_config(train_gpt):
  """``train_gpt.make_config`` in f32: the flag set builds bf16 models,
  whose batch-4 and batch-8 products round apart; the data-parallel
  contract is held in f32."""
  import dataclasses
  import torch
  make = train_gpt.make_config
  return lambda args: dataclasses.replace(make(args), dtype=torch.float32)


def _numpy_params(state):
  return {k: v for k, v in state.model.numpy_params().items()}


# -- the FILES-mode main fn, run by each rank ---------------------------------


def _ckpt_run(ctx, mesh, args, directory, steps):
  """Train from ``args["params"]`` through ``steps`` global batches,
  restoring the newest checkpoint of ``directory`` first and saving each
  step there; (start step, losses, state)."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import sharding
  state, _ = tfm.create_sharded_state(_cfg(), args["params"], mesh,
                                      tx=_tx(), device="cpu")
  mgr = ctx.checkpoint_manager(directory, save_interval_steps=1)
  state, start = mgr.restore_or(state)
  step = sharding.make_train_step(_lm_loss, mesh)
  losses = []
  for s in range(start, steps):
    state, loss = step(state, sharding.shard_batch(args["more"][s], mesh))
    losses.append(float(loss))
    mgr.save(s, state)
  return start, losses, state


def _dp_main(args, ctx):
  import torch
  from tensorflowonspark_tpu_torch.data.readers import Slab
  from tensorflowonspark_tpu_torch.examples import train_gpt
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import collectives
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  from tensorflowonspark_tpu_torch.parallel import sharding
  from tensorflowonspark_tpu_torch.utils.checkpoint import params_fingerprint
  torch.set_num_threads(1)
  ctx.initialize_distributed(backend="gloo")
  rank = ctx.process_id
  mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=-1))
  rec = {"rank": rank, "mesh": dict(mesh.shape), "mesh_rank": mesh.rank}
  arrays = {}
  # the process-group all-reduce: every process a distinct local block
  local = torch.full((8, 4), float(ctx.process_id + 1))
  rec["allreduce"] = float(collectives.all_reduce(local, mesh).sum())
  # every rank takes rank 0's state, whatever seed it was given
  seeded, _ = tfm.create_sharded_state(_cfg(), 100 + rank, mesh,
                                       tx=_tx(), device="cpu")
  rec["seeded_print"] = params_fingerprint(seeded)
  rec["seed_100_print"] = params_fingerprint(
      tfm.create_state(_cfg(), 100, tx=_tx(), device="cpu"))
  # 3 steps from the JAX package's weights
  state, _ = tfm.create_sharded_state(_cfg(), args["params"], mesh,
                                      tx=_tx(), device="cpu")
  step = sharding.make_train_step(_lm_loss, mesh)
  collectives.reset_counts()
  losses = []
  for batch in args["batches"]:
    state, loss = step(state, sharding.shard_batch(batch, mesh))
    losses.append(float(loss))
  rec["jax_losses"], rec["counts"] = losses, dict(collectives.COUNTS)
  rec["jax_print"] = params_fingerprint(state)
  arrays.update({"jax/" + k: v for k, v in _numpy_params(state).items()})
  # 2 per-step steps, then one unroll-2 slab
  state, _ = tfm.create_sharded_state(_cfg(), args["params"], mesh,
                                      tx=_tx(), device="cpu")
  loop = sharding.make_train_loop(_lm_loss, mesh, unroll=2)
  more = args["more"]
  losses = []
  for batch in more[:2]:
    state, loss = step(state, sharding.shard_batch(batch, mesh))
    losses.append(float(loss))
  state, got = loop(state, sharding.shard_slab(Slab(np.stack(more[2:4])),
                                               mesh))
  rec["one_losses"] = losses + got.tolist()
  rec["one_print"] = params_fingerprint(state)
  arrays.update({"one/" + k: v for k, v in _numpy_params(state).items()})
  # train_gpt --dp 2 from the TFRecord file (f32): per step, and unroll 2
  train_gpt.make_config = _f32_config(train_gpt)
  argv = GPT_ARGV + ["--data", args["data"], "--dp", "2"]
  rec["gpt"] = train_gpt.run(train_gpt.parse_args(argv))
  rec["gpt_unroll"] = train_gpt.run(train_gpt.parse_args(
      argv + ["--unroll", "2"]))
  rec["gpt_adafactor_dots"] = train_gpt.run(train_gpt.parse_args(
      argv + GPT_OPTIONS))
  rec["gpt_pp"] = train_gpt.run(train_gpt.parse_args(
      GPT_ARGV + ["--data", args["data"], "--pp", "2", "--microbatches",
                  "2"]))
  # checkpointed: 4 steps uninterrupted, and the first 2 of them apart
  _, rec["full_losses"], state = _ckpt_run(ctx, mesh, args, args["full"], 4)
  rec["full_print"] = params_fingerprint(state)
  arrays.update({"full/" + k: v for k, v in _numpy_params(state).items()})
  rec["half_start"], rec["half_losses"], _ = _ckpt_run(ctx, mesh, args,
                                                      args["half"], 2)
  np.savez(os.path.join(args["out"], "rank%d.npz" % rank), **arrays)
  with open(os.path.join(args["out"], "rank%d.json" % rank), "w") as f:
    json.dump(rec, f)


def _resume_main(args, ctx):
  import torch
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  from tensorflowonspark_tpu_torch.utils.checkpoint import params_fingerprint
  torch.set_num_threads(1)
  ctx.initialize_distributed(backend="gloo")
  mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=2))
  start, losses, state = _ckpt_run(ctx, mesh, args, args["half"], 4)
  np.savez(os.path.join(args["out"], "resumed%d.npz" % ctx.process_id),
           **_numpy_params(state))
  with open(os.path.join(args["out"], "resumed%d.json" % ctx.process_id),
            "w") as f:
    json.dump({"start": start, "losses": losses,
               "print": params_fingerprint(state)}, f)


def _write_tokens(path, rows):
  from tensorflowonspark_tpu_torch.data import example_codec, tfrecord
  rng = np.random.default_rng(5)
  with tfrecord.TFRecordWriter(path) as w:
    for _ in range(rows):
      w.write(example_codec.encode_example(
          {"tokens": rng.integers(0, VOCAB, SEQ).tolist()}))


@pytest.fixture(scope="module")
def jax_start():
  """The JAX package's replicated state over ``MeshSpec(data=2)`` on 2 CPU
  devices, its train step, and its weights for the port."""
  import jax
  import jax.numpy as jnp
  import torch
  from tensorflowonspark_tpu import optim as jax_optim
  from tensorflowonspark_tpu.models import transformer as jax_tfm
  from tensorflowonspark_tpu.parallel import mesh as jax_mesh
  from tensorflowonspark_tpu.parallel import sharding as jax_sharding
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.utils.params import params_from_flax
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False,
                                   attention_impl="flash",
                                   layer_norm_impl="fused", **STEP_CFG)
  mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(data=2),
                             devices=jax.devices()[:2])
  state, shard = jax_tfm.create_sharded_state(
      jax.random.PRNGKey(3), jcfg, mesh, seq_len=SEQ,
      tx=jax_optim.make_optimizer(**OPT))

  def jloss(p, tokens):
    return jax_tfm.causal_lm_loss(state.apply_fn({"params": p}, tokens),
                                  tokens)

  step = jax_sharding.make_train_step(jloss, mesh, shard, donate_state=False)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, **STEP_CFG)
  params = params_from_flax(jax.tree.map(np.asarray, state.params), tcfg)
  return mesh, state, step, params


@pytest.fixture(scope="module")
def files_run(tmp_path_factory, jax_start):
  """Both ranks' records of one FILES-mode cluster run."""
  root = tmp_path_factory.mktemp("dp_files")
  data = str(root / "tokens.tfrecord")
  _write_tokens(data, 40)
  args = {"params": jax_start[3], "batches": _batches(3, 7),
          "more": _batches(4, 8), "data": data, "out": str(root),
          "full": str(root / "ck_full"), "half": str(root / "ck_half")}
  engine = LocalEngine(num_executors=2, workdir=str(root / "engine"))
  try:
    c = cluster.run(engine, _dp_main, args, input_mode=InputMode.FILES,
                    reservation_timeout=60)
    c.shutdown(timeout=240)
  finally:
    engine.stop()
  recs = []
  for r in range(2):
    with open(str(root / ("rank%d.json" % r))) as f:
      rec = json.load(f)
    recs.append((rec, dict(np.load(str(root / ("rank%d.npz" % r))))))
  return args, recs


def _one_process(params, batches, slab):
  """Per-step over ``batches``, then the unroll-2 slab, in this process
  and with no mesh; (losses, weights)."""
  from tensorflowonspark_tpu_torch.data.readers import Slab
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import sharding
  state = tfm.create_state(_cfg(), params, tx=_tx(), device="cpu")
  step = sharding.make_train_step(_lm_loss)
  losses = []
  for batch in batches:
    state, loss = step(state, batch)
    losses.append(float(loss))
  if slab:
    state, got = sharding.make_train_loop(_lm_loss, unroll=len(slab))(
        state, Slab(np.stack(slab)))
    losses += got.tolist()
  return losses, _numpy_params(state)


def test_process_group_all_reduce(files_run):
  _, recs = files_run
  expected = sum(8 * 4 * (p + 1) for p in range(2))
  assert sorted(rec["rank"] for rec, _ in recs) == [0, 1]
  for rec, _ in recs:
    assert rec["allreduce"] == expected
    assert rec["mesh"]["data"] == 2 and rec["mesh_rank"] == rec["rank"]


def test_create_sharded_state_takes_rank0s_weights(files_run):
  _, recs = files_run
  prints = {rec["seeded_print"] for rec, _ in recs}
  # rank 1 was given seed 101; both hold what seed 100 makes
  assert prints == {recs[0][0]["seed_100_print"]}


def test_dp_steps_match_jax_make_train_step(files_run, jax_start):
  import jax
  import jax.numpy as jnp
  from tensorflowonspark_tpu.parallel import sharding as jax_sharding
  from tensorflowonspark_tpu_torch.utils.params import params_to_flax
  mesh, jstate, jstep, _ = jax_start
  args, recs = files_run
  want = []
  for batch in args["batches"]:
    jstate, loss = jstep(jstate, jax_sharding.shard_batch(
        jnp.asarray(batch), mesh))
    want.append(float(loss))
  (r0, a0), (r1, a1) = recs
  np.testing.assert_allclose(r0["jax_losses"], want, rtol=1e-4)
  assert r0["jax_losses"] == r1["jax_losses"]
  assert r0["jax_print"] == r1["jax_print"]
  names = sorted(k for k in a0 if k.startswith("jax/"))
  for k in names:
    assert np.array_equal(a0[k], a1[k]), k          # bitwise across ranks
  got = params_to_flax({k[4:]: a0[k] for k in names}, _cfg())
  for (path, a), (_, b) in zip(
      jax.tree_util.tree_leaves_with_path(got),
      jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                       jstate.params))):
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=str(path))
  # one bucketed all-reduce per step (everything fits one 25 MiB bucket)
  # and the loss's: 2 collectives a step
  counts = r0["counts"]
  assert counts["sync_gradients"] == 3 and counts["buckets"] == 3, counts
  assert counts["all_reduce"] == 6, counts
  n_weights = sum(a0[k].size for k in names)
  assert counts["bucket_bytes"] == 3 * 4 * n_weights, counts


def test_dp_matches_one_process_per_step_and_slab(files_run):
  args, recs = files_run
  more = args["more"]
  want_losses, want = _one_process(args["params"], more[:2], more[2:4])
  (r0, a0), (r1, a1) = recs
  np.testing.assert_allclose(r0["one_losses"], want_losses, rtol=REL)
  assert r0["one_losses"] == r1["one_losses"]
  assert r0["one_print"] == r1["one_print"]
  for k, w in want.items():
    assert np.array_equal(a0["one/" + k], a1["one/" + k]), k
    np.testing.assert_allclose(a0["one/" + k], w, rtol=REL, atol=REL,
                               err_msg=k)


def _dp2_against_one_process(files_run, key, extra, monkeypatch):
  from tensorflowonspark_tpu_torch.examples import train_gpt
  monkeypatch.setattr(train_gpt, "make_config", _f32_config(train_gpt))
  args, recs = files_run
  want = train_gpt.run(train_gpt.parse_args(
      GPT_ARGV + ["--data", args["data"]] + extra))
  assert len(recs[0][0][key]) == 4
  assert recs[0][0][key] == recs[1][0][key]
  np.testing.assert_allclose(recs[0][0][key], want, rtol=REL)


@pytest.mark.parametrize("unroll", [False, True])
def test_train_gpt_dp2_matches_one_process(files_run, unroll, monkeypatch):
  _dp2_against_one_process(files_run, "gpt_unroll" if unroll else "gpt",
                           ["--unroll", "2"] if unroll else [], monkeypatch)


def test_train_gpt_dp2_adafactor_dots_matches_one_process(files_run,
                                                          monkeypatch):
  """``train_gpt --optimizer adafactor --remat_policy dots --data ... --dp
  2`` against the same flags in one process."""
  _dp2_against_one_process(files_run, "gpt_adafactor_dots", GPT_OPTIONS,
                           monkeypatch)


def test_dp_resumes_from_a_checkpoint_to_the_bit(files_run, tmp_path):
  args, recs = files_run
  (r0, a0), (r1, _) = recs
  assert r0["half_start"] == 0 and r0["half_losses"] == r0["full_losses"][:2]
  engine = LocalEngine(num_executors=2, workdir=str(tmp_path / "engine"))
  try:
    c = cluster.run(engine, _resume_main, dict(args, out=str(tmp_path)),
                    input_mode=InputMode.FILES, reservation_timeout=60)
    c.shutdown(timeout=240)
  finally:
    engine.stop()
  for rank in range(2):
    with open(str(tmp_path / ("resumed%d.json" % rank))) as f:
      got = json.load(f)
    assert got["start"] == 2
    assert got["losses"] == r0["full_losses"][2:]
    assert got["print"] == r0["full_print"] == r1["full_print"]
    weights = np.load(str(tmp_path / ("resumed%d.npz" % rank)))
    for k in weights.files:
      assert np.array_equal(weights[k], a0["full/" + k]), k


def test_train_gpt_pp2_matches_one_process(files_run, monkeypatch):
  """``train_gpt --pp 2 --microbatches 2 --data ...`` under
  ``cluster.run``: the two ranks are the pipeline's two stages (``--dp
  -1`` takes one data rank), and their losses equal one process's
  without a pipeline."""
  _dp2_against_one_process(files_run, "gpt_pp", [], monkeypatch)


def test_train_gpt_dp_outside_a_group_raises():
  from tensorflowonspark_tpu_torch.examples import train_gpt
  args = train_gpt.parse_args(GPT_ARGV + ["--dp", "2"])
  with pytest.raises(ValueError, match="cluster.run.*initialize_distributed"):
    train_gpt.run(args)
  assert train_gpt.make_mesh(train_gpt.parse_args(GPT_ARGV)) is None
  with pytest.raises(ValueError, match="--dp must be"):
    train_gpt.parse_args(GPT_ARGV + ["--dp", "0"])


def test_train_gpt_global_batch_must_divide():
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  from tensorflowonspark_tpu_torch.parallel import sharding

  class _Two(object):
    def size(self):
      return 2

    def rank(self):
      return 1

  mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=2), group=_Two())
  with pytest.raises(ValueError, match="5 rows does not divide over the 2"):
    sharding.shard_batch(np.zeros((5, SEQ), np.int32), mesh)


# -- InputMode.SPARK: uneven feeds and next_batch_synced --------------------------


def _spark_rows():
  rng = np.random.default_rng(21)
  return [rng.integers(0, VOCAB, SEQ).astype(np.int32) for _ in range(20)]


def _spark_main(args, ctx):
  import torch
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import collectives
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  from tensorflowonspark_tpu_torch.parallel import sharding
  from tensorflowonspark_tpu_torch.utils.checkpoint import params_fingerprint
  torch.set_num_threads(1)
  with open(os.path.join(args["out"], "ready%d" % ctx.executor_id), "w"):
    pass
  ctx.initialize_distributed(backend="gloo")
  mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=-1))
  ids = {r.tobytes(): i for i, r in enumerate(_spark_rows())}
  state, _ = tfm.create_sharded_state(_cfg(), args["params"], mesh,
                                      tx=_tx(), device="cpu")
  step = sharding.make_train_step(_lm_loss, mesh)
  feed = ctx.get_data_feed()
  trained, losses = [], []
  while not feed.should_stop():
    batch = feed.next_batch_synced(GLOBAL_B // 2)
    if len(batch) < GLOBAL_B // 2:
      break
    tokens = np.stack([np.asarray(r).astype(np.int32) for r in batch])
    trained.append([ids[r.tobytes()] for r in tokens])
    state, loss = step(state, tokens)
    losses.append(float(loss))
  peers = collectives.all_gather(torch.tensor([len(trained)]), mesh)
  with open(os.path.join(args["out"], "spark%d.json" % ctx.process_id),
            "w") as f:
    json.dump({"trained": trained, "losses": losses,
               "peers": peers.tolist(), "print": params_fingerprint(state)},
              f)


@pytest.fixture(scope="module")
def spark_run(tmp_path_factory, jax_start):
  root = tmp_path_factory.mktemp("dp_spark")
  args = {"params": jax_start[3], "out": str(root)}
  engine = LocalEngine(num_executors=2, workdir=str(root / "engine"))
  try:
    c = cluster.run(engine, _spark_main, args, input_mode=InputMode.SPARK,
                    reservation_timeout=60)
    # feed only once both nodes run their fn: a node still starting would
    # leave both partitions to the other
    for eid in range(2):
      ready = str(root / ("ready%d" % eid))
      deadline = time.time() + 120
      while not os.path.exists(ready) and time.time() < deadline:
        time.sleep(0.05)
      assert os.path.exists(ready), "node %d never started its fn" % eid
    rows = _spark_rows()
    # partitions of 12 and 8 rows at 4 a rank: the short rank has 2 full
    # batches, the long one 3; without the vote the long one would enter
    # step 3's all-reduce alone and hang
    c.train([rows[:12], rows[12:]], num_epochs=1, feed_timeout=120)
    c.shutdown(timeout=240)
  finally:
    engine.stop()
  recs = []
  for r in range(2):
    with open(str(root / ("spark%d.json" % r))) as f:
      recs.append(json.load(f))
  return args, recs


def test_uneven_feeds_stop_at_same_step(spark_run):
  _, recs = spark_run
  for rec in recs:
    assert len(rec["trained"]) == 2 and rec["peers"] == [2, 2], rec
  # exactly the vote-passed batches trained: rows 0-7 of the long
  # partition (its 3rd batch, 8-11, is dropped by the failing vote) and
  # all of 12-19
  total = sum(i for rec in recs for batch in rec["trained"] for i in batch)
  assert total == sum(range(8)) + sum(range(12, 20))


def test_dp_from_next_batch_synced_matches_one_process(spark_run):
  args, recs = spark_run
  rows = np.stack(_spark_rows())
  globals_ = [rows[recs[0]["trained"][s] + recs[1]["trained"][s]]
              for s in range(2)]
  want, _ = _one_process(args["params"], globals_, None)
  assert recs[0]["losses"] == recs[1]["losses"]
  np.testing.assert_allclose(recs[0]["losses"], want, rtol=REL)
  assert recs[0]["print"] == recs[1]["print"]
