"""Decoding over a serving mesh, in gloo processes against the JAX package
on the 8 virtual CPU devices.

Two groups of ranks are spawned once for the module (2 ranks and 4
ranks, side by side, from the jax-free helper ``torch_serving_mesh_ranks``)
with a third process, rank 0 of a serving group whose follower is killed
mid-serve. The weights are the JAX package's, carried across by
``params_from_flax`` before the ranks start; the JAX package decodes the
same seeded prompts, on one device and on its own meshes, while the ranks
run. Cases:

1. the reference's decode test at its own config
   (``tests/test_models.py``'s ``test_sharded_decode_matches_single_device``:
   vocab 128, 2 layers, 4 heads, 2 KV heads, d 64, f32, a 4 x 8 prompt of
   ``RandomState(0)``, 6 steps): tokens on ``tensor=2`` and ``data=2 x
   tensor=2`` (and ``tensor=4``, ``fsdp=2``, ``sequence=2``) equal to the
   JAX decode on one device and on its ``data=-1, tensor=2`` mesh; a
   3-row batch padded and sliced back; a sampled decode on ``tensor=2``
   and ``data=2 x tensor=2`` equal to one process's at the same seed;
   the forced-flash 128-token prefill logits within the reference's 1e-4
   of the JAX meshed ones (its dense prefill, which the reference holds
   its flash one to), on ``tensor=4`` too, where the KV heads stay whole;
2. the int8 cache on ``tensor=2``; 3. ``speculative_generate_kv`` on
   ``tensor=2``; 4. MoE (4 experts, top-2) on ``expert=2`` and ``data=2 x
   expert=2``: tokens equal to the JAX package's;
5. ``serving_params`` of models cut over ``fsdp=2``, ``tensor=2`` (fused
   QKV too) and ``expert=2``: bitwise the uncut model's and the JAX
   weights';
6. a state cut over ``tensor=2`` saved by the ranks (checkpoint, export,
   registry version), served on ``data=2 x tensor=2``: tokens equal to
   one process's;
7. the reference's bundle test at its config through
   ``TFModel.transform`` on ``LocalEngine(2)``, each executor serving
   over its own serving group; the predict fn pickles after a smoke
   serve; the followers are gone after ``engine.stop()``;
8. ``serve_gpt --tensor 2`` against ``--tensor 1``;
9. what stays refused by name, and a follower killed mid-serve.

Tolerances: tokens exact, logits 1e-4, weights bitwise.
"""

import json
import multiprocessing as mp
import os
import pickle
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu_torch import pipeline
from tensorflowonspark_tpu_torch.engine import LocalEngine
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.parallel import serving_group
from tensorflowonspark_tpu_torch.serving import ServingEngine
from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port
from tensorflowonspark_tpu_torch.utils.params import (init_params,
                                                      params_from_flax,
                                                      params_to_flax)

import torch_serving_mesh_ranks as R

LOGIT_TOL = 1e-4
#: weights file -> (config fields, JAX seed) of the JAX inits
WEIGHTS = {"cfg": (R.CFG, 0), "long": (R.CFG, 1), "moe": (R.MOE, 3),
           "bundle": (R.BUNDLE, 0)}


def _jcfg(fields, **kw):
  return jax_tfm.TransformerConfig(dtype=jnp.float32, **dict(fields, **kw))


def _jmesh(**degrees):
  return jax_mesh.build_mesh(jax_mesh.MeshSpec(**degrees))


def _jax_weights(root) -> dict:
  """Each config's JAX params (the flax model's initializers, as numpy
  trees), also written for the ranks in the port's names; then the file
  the ranks wait for. The draft is the first layer of ``cfg``'s weights
  (a shallow draft of the target), the fused config's ``qkv`` kernel is
  ``cfg``'s q, k and v along the heads, the JAX model's fused layout."""
  import flax.linen as nn
  trees = {}
  for name, (fields, seed) in WEIGHTS.items():
    init = jax.jit(jax_tfm.Transformer(_jcfg(fields)).init)
    trees[name] = jax.tree.map(np.asarray, nn.unbox(init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16), jnp.int32))["params"]))
  a = trees["cfg"]
  trees["draft"] = {k: v for k, v in a.items() if k != "layer_1"}
  trees["fused"] = {k: v for k, v in a.items() if not k.startswith("layer_")}
  for layer in ("layer_0", "layer_1"):
    attn = a[layer]["attn"]
    trees["fused"][layer] = dict(a[layer], attn={
        "qkv": {"kernel": np.concatenate([attn[n]["kernel"] for n in "qkv"],
                                         axis=1)},
        "out": attn["out"]})
  for name, fields in (("cfg", R.CFG), ("long", R.CFG), ("moe", R.MOE),
                       ("bundle", R.BUNDLE), ("draft", R.DRAFT),
                       ("fused", R.FUSED)):
    np.savez(os.path.join(root, "weights_%s.npz" % name),
             **params_from_flax(trees[name], R.config(fields)))
  with open(os.path.join(root, "weights.ready"), "w") as f:
    f.write("ok")
  return trees


def _jax_prefill_logits(params, cfg, mesh, tokens, exit_layer=None):
  """The reference test's ``meshed_prefill_logits`` (which holds its
  forced-flash prefill to its dense one within 1e-4: the dense one is
  taken here, the flash kernel's interpret mode being the slow one);
  through the first ``exit_layer`` blocks only, with it."""
  model = jax_tfm.Transformer(cfg, mesh=mesh)

  @jax.jit
  def prefill(params, tokens):
    cache = jax.tree.map(jnp.zeros_like, model.init(
        jax.random.PRNGKey(0), jnp.zeros((tokens.shape[0], 1), jnp.int32),
        decode=True)["cache"])
    return model.apply({"params": params, "cache": cache}, tokens,
                       decode=True, exit_layer=exit_layer,
                       mutable=["cache"])[0]

  return np.asarray(prefill(params, jnp.asarray(tokens)))


def _jax_references(trees) -> dict:
  """The JAX package's side of every case, computed while the ranks
  run."""
  a, p = trees["cfg"], jnp.asarray(R.prompt())
  cfg = _jcfg(R.CFG)
  tp2 = _jmesh(data=-1, tensor=2)
  out = {"single": np.asarray(jax_tfm.greedy_generate_kv(a, cfg, p,
                                                         R.STEPS)),
         "mesh": np.asarray(jax_tfm.greedy_generate_kv(a, cfg, p, R.STEPS,
                                                       mesh=tp2)),
         "mesh_3rows": np.asarray(jax_tfm.greedy_generate_kv(
             a, cfg, p[:3], R.STEPS, mesh=tp2)),
         "sequence": np.asarray(jax_tfm.greedy_generate_kv(
             a, _jcfg(R.CFG, use_ring_attention=True), p, R.STEPS,
             mesh=_jmesh(data=-1, sequence=2)))}
  out["exit1_logits"] = _jax_prefill_logits(a, cfg, None, R.prompt(),
                                            exit_layer=1)
  out["long_logits"] = _jax_prefill_logits(
      trees["long"], _jcfg(R.LONG, attention_impl="dense"), tp2,
      R.long_prompt())
  # the int8 prefill runs the flash kernel (interpret mode) over the raw
  # projections, as the port's does
  out["int8"] = np.asarray(jax_tfm.greedy_generate_kv(
      a, _jcfg(R.CFG, kv_cache_dtype="int8", attention_impl="flash",
               layer_norm_impl="fused"), p, R.STEPS))
  out["spec"] = np.asarray(jax_tfm.speculative_generate_kv(
      trees["draft"], _jcfg(R.DRAFT), a, cfg, p, R.STEPS,
      draft_k=R.DRAFT_K))
  out["moe"] = np.asarray(jax_tfm.greedy_generate_kv(
      trees["moe"], _jcfg(R.MOE), p, R.STEPS))
  out["bundle"] = np.asarray(jax_tfm.greedy_generate_kv(
      trees["bundle"], _jcfg(R.BUNDLE),
      np.asarray(R.bundle_prompts(), np.int32), R.BUNDLE_STEPS))
  return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
  """{2: [(arrays, record) of each rank], 4: ..., "kill": the kill run's
  record, "jax": references, "trees": JAX params, "root": where the
  ranks wrote}."""
  root = str(tmp_path_factory.mktemp("serving_mesh"))
  ctx = mp.get_context("spawn")
  procs = [ctx.Process(target=R.kill_main, args=(root,))]
  for n in (2, 4):
    port = get_free_port()
    procs += [ctx.Process(target=R.rank_main, args=(r, n, port, root))
              for r in range(n)]
  for p in procs:
    p.start()
  trees = _jax_weights(root)
  want = _jax_references(trees)
  for p in procs:
    p.join(timeout=300)
  alive = [p for p in procs if p.is_alive()]
  for p in alive:
    p.kill()
  assert not alive and [p.exitcode for p in procs] == [0] * len(procs)
  got = {"jax": want, "trees": trees, "root": root}
  for n in (2, 4):
    got[n] = []
    for r in range(n):
      out = os.path.join(root, "w%d_rank%d" % (n, r))
      with open(out + ".json") as f:
        got[n].append((dict(np.load(out + ".npz")), json.load(f)))
  with open(os.path.join(root, "kill.json")) as f:
    got["kill"] = json.load(f)
  return got


def _same_on_every_rank(ranks, n, key):
  """The array every rank of group ``n`` holds under ``key``, checked
  equal across the ranks."""
  first = ranks[n][0][0][key]
  for arrays, _ in ranks[n][1:]:
    np.testing.assert_array_equal(arrays[key], first)
  return first


# -- 1: the reference's decode test ------------------------------------------------


@pytest.mark.parametrize("n,key", [(2, "tok/tp2"), (4, "tok/dp2_tp2"),
                                   (4, "tok/tp4"), (2, "tok/fsdp2")])
def test_meshed_decode_matches_jax_single_and_meshed(ranks, n, key):
  """Greedy tokens on the mesh equal the JAX decode on one device and on
  its ``data=-1, tensor=2`` mesh, the same on every rank."""
  got = _same_on_every_rank(ranks, n, key)
  np.testing.assert_array_equal(ranks["jax"]["single"], ranks["jax"]["mesh"])
  np.testing.assert_array_equal(got, ranks["jax"]["single"])
  assert got.shape == (4, 8 + R.STEPS)


@pytest.mark.parametrize("n,key", [(2, "tok/tp2_3rows"),
                                   (4, "tok/dp2_tp2_3rows")])
def test_a_three_row_batch_pads_and_slices_back(ranks, n, key):
  got = _same_on_every_rank(ranks, n, key)
  np.testing.assert_array_equal(ranks["jax"]["mesh_3rows"],
                                ranks["jax"]["single"][:3])
  np.testing.assert_array_equal(got, ranks["jax"]["single"][:3])


@pytest.mark.parametrize("n,key,rows", [(2, "tok/tp2_sampled", 4),
                                        (4, "tok/dp2_tp2_sampled", 4),
                                        (4, "tok/dp2_tp2_sampled_3rows", 3)])
def test_sampled_decode_over_the_mesh_matches_one_process(ranks, n, key, rows):
  """Sampling (temperature 1, top-k 32) on the mesh, every rank's
  generator of one seed, gives one process's tokens at that seed: the
  ranks draw for the whole batch and keep their rows. Rows 0 and 2 hold
  one prompt, on different data ranks at ``data=2``, and still draw
  their own tokens, as in one process."""
  got = _same_on_every_rank(ranks, n, key)
  model = tfm.Transformer(R.config(R.CFG), R.weights(ranks["root"], "cfg"),
                          device="cpu")
  one = R.sample(model, R.sampled_prompt()[:rows])
  np.testing.assert_array_equal(got, one)
  assert not np.array_equal(one[0], one[2])
  assert not np.array_equal(one, ranks["jax"]["single"][:rows])


@pytest.mark.parametrize("n,key", [(2, "logits/tp2_long"),
                                   (4, "logits/dp2_tp2_long"),
                                   (4, "logits/tp4_long")])
def test_forced_flash_prefill_logits_match_jax_meshed(ranks, n, key):
  """The 128-token prefill's logits (the flash kernel's plain version at
  the rank's heads) within 1e-4 of the JAX meshed prefill's; on
  ``tensor=4`` the 2 KV heads stay whole on every rank and each query
  head takes its own."""
  got = _same_on_every_rank(ranks, n, key)
  np.testing.assert_allclose(got, ranks["jax"]["long_logits"],
                             atol=LOGIT_TOL, rtol=LOGIT_TOL)
  if key == "logits/tp4_long":
    rec = ranks[4][0][1]
    assert rec["tp4_kv_whole"] and rec["tp4_kv_heads"] == 2
  else:
    assert ranks[2][0][1]["tp2_kv_heads"] == 1


@pytest.mark.parametrize("n,key", [(2, "logits/tp2_exit1"),
                                   (4, "logits/dp2_tp2_exit1")])
def test_exit_layer_forward_over_the_mesh_matches_jax(ranks, n, key):
  """The shallow-exit forward (the speculative draft's) over the mesh:
  its prefill logits through the first block within 1e-4 of the JAX
  model's ``exit_layer=1``."""
  np.testing.assert_allclose(_same_on_every_rank(ranks, n, key),
                             ranks["jax"]["exit1_logits"], atol=LOGIT_TOL,
                             rtol=LOGIT_TOL)


def test_sequence_axis_decodes_as_the_reference_does(ranks):
  """The reference decodes on a ``sequence=2`` mesh (each sequence rank
  the same rows), and so does the port: both equal one device's."""
  np.testing.assert_array_equal(ranks["jax"]["sequence"],
                                ranks["jax"]["single"])
  np.testing.assert_array_equal(_same_on_every_rank(ranks, 2, "tok/sp2"),
                                ranks["jax"]["single"])


# -- 2-4: int8, speculative, MoE -----------------------------------------------------


@pytest.mark.parametrize("n,key,ref", [
    (2, "tok/tp2_int8", "int8"), (2, "tok/tp2_spec", "spec"),
    (2, "tok/ep2_moe", "moe"), (4, "tok/dp2_ep2_moe", "moe"),
    (4, "tok/dp2_ep2_moe_a2a", "moe")])
def test_meshed_decode_variants_match_jax(ranks, n, key, ref):
  """The int8 cache cut on heads, speculative decoding and MoE over the
  expert axis (dense dispatch, and all-to-all at a capacity nothing
  drops at) give the JAX package's tokens."""
  np.testing.assert_array_equal(_same_on_every_rank(ranks, n, key),
                                ranks["jax"][ref])


# -- 5: serving_params of a cut model ----------------------------------------------


@pytest.mark.parametrize("case,weights", [
    ("fsdp2_cfg", "cfg"), ("tp2_cfg", "cfg"), ("tp2_fused", "fused"),
    ("ep2_moe", "moe")])
def test_serving_params_of_a_cut_model_are_whole(ranks, case, weights):
  """Every rank's ``serving_params`` of the cut model equal the uncut
  model's to the bit and, through ``params_to_flax``, the JAX params."""
  fields = {"cfg": R.CFG, "fused": R.FUSED, "moe": R.MOE}[weights]
  tree = ranks["trees"][weights]
  for arrays, rec in ranks[2]:
    equal = rec["serving_params"][case]
    assert equal and all(equal.values()), equal
    got = {k.split("/", 2)[2]: v for k, v in arrays.items()
           if k.startswith("sp/%s/" % case)}
    flax = params_to_flax(got, R.config(fields))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
      node = flax
      for part in path:
        node = node[part.key]
      np.testing.assert_array_equal(node, leaf)


# -- 6: a cut state's checkpoint, export and registry version ---------------------


@pytest.mark.parametrize("src", ["ckpt", "export", "registry"])
def test_a_cut_states_weights_serve_on_another_mesh(ranks, src):
  """A state cut over ``tensor=2`` saved by its ranks (checkpoint,
  export, registry version: the whole weights) serves on ``data=2 x
  tensor=2`` with one process's tokens."""
  assert all(rec["cut"]["cut"] and rec["cut"]["saved"]
             for _, rec in ranks[2])
  params = R.cut_sources(ranks["root"])[src]
  np.testing.assert_array_equal(
      np.asarray(params["embed.embedding"]),
      init_params(R.config(R.CFG), R.CUT_SEED)["embed.embedding"])
  one = tfm.greedy_generate_kv(tfm.Transformer(R.config(R.CFG), params,
                                               device="cpu"),
                               R.prompt(), R.STEPS).numpy()
  np.testing.assert_array_equal(
      _same_on_every_rank(ranks, 4, "tok/cut_" + src), one)


# -- 7-8: the bundle and serve_gpt ---------------------------------------------------


def _pids_of_groups(it):
  del it
  return [serving_group.follower_pids()]


def _gone(pid: int) -> bool:
  try:
    with open("/proc/%d/stat" % pid) as f:
      return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
  except OSError:
    return True


def _await_gone(pids, timeout=20.0) -> list:
  deadline = time.monotonic() + timeout
  while time.monotonic() < deadline:
    left = [p for p in pids if not _gone(p)]
    if not left:
      return []
    time.sleep(0.1)
  return left


def test_bundle_serves_over_each_executors_serving_group(ranks, tmp_path):
  """The reference's ``test_bundle_serves_tensor_parallel_via_mesh_spec``
  at its config: the bundle carries ``MeshSpec(data=-1, tensor=2)``, each
  of 2 executors starts its own serving group on its first serve, and the
  served rows equal the JAX package's ``greedy_generate_kv``; the other
  ranks are gone once the engine stops."""
  cfg = R.config(R.BUNDLE)
  params = dict(np.load(os.path.join(ranks["root"], "weights_bundle.npz")))
  export_dir = str(tmp_path / "lm_bundle_tp")
  pipeline.export_bundle(params, tfm.make_serving_predict_fn(
      cfg, R.BUNDLE_STEPS, mesh_spec=mesh_lib.MeshSpec(data=-1, tensor=2),
      device="cpu"), export_dir)
  prompts = R.bundle_prompts()
  engine = LocalEngine(num_executors=2)
  try:
    rows = pipeline.TFModel({"export_dir": export_dir,
                             "batch_size": 4}).transform(
        engine, [[(p,) for p in prompts[:4]], [(p,) for p in prompts[4:]]])
    pids = [p for r in engine.run_on_executors(_pids_of_groups).wait(
        timeout=60) for per in r for p in per]
  finally:
    engine.stop()
  assert len(rows) == 8
  np.testing.assert_array_equal(np.asarray(sorted(rows)),
                                np.asarray(sorted(
                                    ranks["jax"]["bundle"].tolist())))
  assert len(pids) == 2, pids            # one follower an executor
  assert _await_gone(pids) == []


def test_mesh_spec_predict_fn_picklable_after_smoke_serve(ranks):
  """The reference's pickling test: a smoke serve starts this process's
  serving group, which lives in the module's cache and not in the
  predict fn; the unpickled fn serves the same tokens through it."""
  cfg = R.config(R.BUNDLE)
  params = dict(np.load(os.path.join(ranks["root"], "weights_bundle.npz")))
  fn = tfm.make_serving_predict_fn(
      cfg, 2, mesh_spec=mesh_lib.MeshSpec(data=-1, tensor=2), device="cpu")
  batch = {"input": np.ones((4, 4), np.int32)}
  try:
    out1 = fn(params, batch)
    pids = serving_group.follower_pids()
    out2 = pickle.loads(pickle.dumps(fn))(params, batch)
  finally:
    serving_group.shutdown_all()
  assert len(pids) == 1
  np.testing.assert_array_equal(out1["tokens"], out2["tokens"])
  want = tfm.greedy_generate_kv(tfm.Transformer(cfg, params, device="cpu"),
                                batch["input"], 2).numpy()
  np.testing.assert_array_equal(out1["tokens"], want)
  assert not torch.distributed.is_initialized()
  assert _await_gone(pids) == []


def test_serve_gpt_tensor_2_serves_the_rows_of_tensor_1(tmp_path):
  """``serve_gpt --tensor 2`` (bf16; the bundle's ``MeshSpec(data=-1,
  tensor=2)``, 2 ranks an executor) serves the rows of ``--tensor 1``:
  the row-parallel products of the decode sum in f32 and round once."""
  from tensorflowonspark_tpu_torch.examples import serve_gpt
  common = ["--device", "cpu", "--prompts", "8", "--steps", "4"]
  one = serve_gpt.run(serve_gpt.parse_args(
      common + ["--export_dir", str(tmp_path / "t1")]))
  two = serve_gpt.run(serve_gpt.parse_args(
      common + ["--tensor", "2", "--export_dir", str(tmp_path / "t2")]))
  assert len(two) == 8 and sorted(one) == sorted(two)


# -- 9: what stays refused, and a follower killed -----------------------------------


class _Group(object):
  """A stand-in process group: a size and a rank, no collectives."""

  def __init__(self, n, rank=0):
    self.n, self.r = n, rank

  def size(self):
    return self.n

  def rank(self):
    return self.r


def _stand_in(**degrees):
  return mesh_lib.build_mesh(mesh_lib.MeshSpec(**dict({"data": 1}, **degrees)),
                             group=_Group(int(np.prod(list(
                                 degrees.values())))))


def test_ragged_batch_over_a_mesh_raises_naming_part_3b_ii():
  cfg = R.config(R.BUNDLE)
  fn = tfm.make_serving_predict_fn(
      cfg, 2, mesh_spec=mesh_lib.MeshSpec(data=-1, tensor=2), device="cpu")
  ragged = np.empty(2, dtype=object)
  ragged[0], ragged[1] = [1, 2, 3], [4, 5]
  with pytest.raises(NotImplementedError, match="item 10c, part 3b-ii"):
    fn(init_params(cfg, 0), {"input": ragged})
  assert serving_group.follower_pids() == []     # no group was started


def test_serving_engine_over_a_mesh_raises_naming_part_3b_ii():
  cfg = R.config(R.BUNDLE)
  with pytest.raises(NotImplementedError, match="item 10c, part 3b-ii"):
    ServingEngine(init_params(cfg, 0), cfg, mesh=_stand_in(tensor=2),
                  device="cpu")
  # a mesh of one process is one card
  ServingEngine(init_params(cfg, 0), cfg, num_slots=1,
                mesh=mesh_lib.build_mesh(), device="cpu")


def test_moe_with_tensor_raises_naming_part_3c():
  with pytest.raises(NotImplementedError, match="item 10c, part 3c"):
    tfm.Transformer(R.config(R.MOE), init_params(R.config(R.MOE), 0),
                    device="cpu", mesh=_stand_in(tensor=2))


def test_a_follower_killed_mid_serve_makes_rank_0_raise_naming_it(ranks):
  """Rank 1 SIGKILLed in its second serve, after it took the prompt: rank
  0 raises within the group's timeout (60 s) naming rank 1, after a first
  serve that gave one process's tokens, and the group is torn down."""
  rec = ranks["kill"]
  np.testing.assert_array_equal(rec["first"], ranks["jax"]["single"])
  assert rec["raised"] is not None and "rank 1 of 2" in rec["raised"], rec
  assert rec["seconds"] < 60.0, rec
  assert rec["follower_alive"] == [False] and rec["group_left"], rec
  assert rec["cached"] == [], rec
