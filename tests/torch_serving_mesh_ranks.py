"""What each gloo rank runs for ``tests/test_torch_serving_mesh.py``:
decoding over a serving mesh.

A helper, not a test file: it imports PyTorch and the port only, so a
spawned rank starts without loading JAX. The test process writes the
weights (the JAX package's, carried across by ``params_from_flax``) to
``<root>/weights_<name>.npz`` while the ranks start, then the file
``<root>/weights.ready``, which they wait for. :func:`rank_main`
runs every case of a group of ``world`` ranks and writes what the rank
saw to ``<root>/w<world>_rank<rank>.npz`` (arrays) and ``.json`` (a
record). The 2-rank group also saves a state cut over ``tensor`` (a
checkpoint, an export and a registry version) under ``<root>/cut/``,
which the 4-rank group serves once it is written. :func:`kill_main` is
rank 0 of a serving group whose rank 1 is killed in its second serve.
"""

import json
import os
import time

import numpy as np
import torch

CFG = dict(vocab_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
           d_model=64, d_ff=128, max_seq_len=32, remat=False)
#: the forced-flash 128-token prefill (the reference's cfg_f)
LONG = dict(CFG, max_seq_len=160, attention_impl="flash")
MOE = dict(CFG, moe_experts=4, moe_top_k=2, moe_every=2)
DRAFT = dict(CFG, num_layers=1)
FUSED = dict(CFG, fuse_qkv=True)
#: the reference's bundle test
BUNDLE = dict(vocab_size=64, num_layers=1, num_heads=4, num_kv_heads=2,
              d_model=32, d_ff=64, max_seq_len=32, remat=False)
STEPS = 6
BUNDLE_STEPS = 4
DRAFT_K = 4
MOE_A2A_CAPACITY = 4.0
#: the sampled decode: temperature, top-k and the generator's seed
SAMPLE = dict(temperature=1.0, top_k=32)
SAMPLE_SEED = 11
CUT_SEED = 7
#: (world, name) -> mesh degrees
MESHES = {2: {"tp2": dict(data=1, tensor=2), "ep2": dict(data=1, expert=2),
              "fsdp2": dict(data=1, fsdp=2), "sp2": dict(data=1, sequence=2)},
          4: {"dp2_tp2": dict(data=2, tensor=2), "tp4": dict(data=1, tensor=4),
              "dp2_ep2": dict(data=2, expert=2)}}
MARK_S = 120.0


def prompt() -> np.ndarray:
  """The reference's decode prompt: 4 x 8 of ``RandomState(0)``."""
  return np.random.RandomState(0).randint(0, 128, (4, 8)).astype("int32")


def long_prompt() -> np.ndarray:
  return np.random.RandomState(5).randint(0, 128, (4, 128)).astype("int32")


def bundle_prompts() -> list:
  rng = np.random.RandomState(1)
  return [rng.randint(0, 64, 6).tolist() for _ in range(8)]


def config(fields: dict, **kw):
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  return tfm.TransformerConfig(dtype=torch.float32, **dict(fields, **kw))


def weights(root: str, name: str) -> dict:
  return dict(np.load(os.path.join(root, "weights_%s.npz" % name)))


def _await_weights(root: str) -> None:
  deadline = time.monotonic() + MARK_S
  while not os.path.exists(os.path.join(root, "weights.ready")):
    if time.monotonic() > deadline:
      raise RuntimeError("no weights from the test process in %d s" % MARK_S)
    time.sleep(0.05)


def cut_dir(root: str, what: str) -> str:
  return os.path.join(root, "cut", what)


def _mesh(degrees: dict):
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  return mesh_lib.build_mesh(mesh_lib.MeshSpec(**degrees))


def _model(fields, params, mesh, **kw):
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  return tfm.Transformer(config(fields, **kw), params, device="cpu",
                         mesh=mesh)


def _decode(model, tokens, steps=STEPS) -> np.ndarray:
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  return tfm.greedy_generate_kv(model, tokens, steps).numpy()


def sampled_prompt() -> np.ndarray:
  """:func:`prompt` with row 2 a copy of row 0: on ``data=2`` the two
  equal prompts sit on different data ranks at the same local row."""
  p = prompt()
  p[2] = p[0]
  return p


def sample(model, tokens) -> np.ndarray:
  """A sampled decode (:data:`SAMPLE`) from a generator of seed
  :data:`SAMPLE_SEED`, the same on every rank."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  gen = torch.Generator(device="cpu")
  gen.manual_seed(SAMPLE_SEED)
  return tfm.greedy_generate_kv(model, tokens, STEPS, generator=gen,
                                **SAMPLE).numpy()


def _prefill_logits(model, tokens, exit_layer=None) -> np.ndarray:
  """The whole batch's fresh-cache prefill logits (through the first
  ``exit_layer`` blocks only, with it), whole over the vocabulary, on
  every rank: this rank's rows gathered over the data axes."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  with torch.inference_mode():
    mine = tfm._my_rows(torch.as_tensor(tokens).long(), model.mesh)
    logits = model.whole_logits(model(mine, model.init_cache(
        mine.shape[0]), exit_layer=exit_layer))
    return tfm._all_rows(logits, model.mesh, tokens.shape[0]).numpy()


def _serving_params(fields, params, mesh) -> dict:
  """The cut model's ``serving_params`` (whole), and whether each equals
  the uncut model's to the bit."""
  cut = _model(fields, params, mesh).serving_params()
  whole = _model(fields, params, None).serving_params()
  return cut, {n: bool(torch.equal(cut[n], whole[n])) for n in whole}


def _two_rank_cases(root, rank):
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  m = {k: _mesh(v) for k, v in MESHES[2].items()}
  a, arrays, rec = weights(root, "cfg"), {}, {}
  tp2 = _model(CFG, a, m["tp2"])
  rec["tp2_kv_heads"] = tp2.plan.local_kv_heads()
  arrays["tok/tp2"] = _decode(tp2, prompt())
  arrays["tok/tp2_3rows"] = _decode(tp2, prompt()[:3])
  arrays["tok/tp2_sampled"] = sample(tp2, sampled_prompt())
  arrays["logits/tp2_exit1"] = _prefill_logits(tp2, prompt(), exit_layer=1)
  arrays["logits/tp2_long"] = _prefill_logits(
      _model(LONG, weights(root, "long"), m["tp2"]), long_prompt())
  arrays["tok/tp2_int8"] = _decode(_model(CFG, a, m["tp2"],
                                          kv_cache_dtype="int8"), prompt())
  draft = _model(DRAFT, weights(root, "draft"), m["tp2"])
  arrays["tok/tp2_spec"] = tfm.speculative_generate_kv(
      draft, tp2, prompt(), STEPS, draft_k=DRAFT_K).numpy()
  arrays["tok/ep2_moe"] = _decode(_model(MOE, weights(root, "moe"),
                                         m["ep2"]), prompt())
  arrays["tok/fsdp2"] = _decode(_model(CFG, a, m["fsdp2"]), prompt())
  arrays["tok/sp2"] = _decode(_model(CFG, a, m["sp2"],
                                     use_ring_attention=True), prompt())
  rec["serving_params"] = {}
  for tag, fields, name in (("fsdp2", CFG, "cfg"), ("tp2", CFG, "cfg"),
                            ("tp2", FUSED, "fused"), ("ep2", MOE, "moe")):
    got, rec["serving_params"]["%s_%s" % (tag, name)] = _serving_params(
        fields, weights(root, name), m[tag])
    arrays.update({"sp/%s_%s/%s" % (tag, name, k): v.numpy()
                   for k, v in got.items()})
  rec["cut"] = _save_cut(root, rank, m["tp2"])
  return arrays, rec


def _save_cut(root, rank, mesh):
  """A state cut over ``tensor`` (weights of seed CUT_SEED) through the
  save path of cut states: every rank saves, exports and publishes; then
  the marker the 4-rank group waits for."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.serving.registry import ModelRegistry
  from tensorflowonspark_tpu_torch.utils import checkpoint, compat
  state, _ = tfm.create_sharded_state(config(CFG), CUT_SEED, mesh,
                                      device="cpu")
  mgr = checkpoint.CheckpointManager(cut_dir(root, "ckpt"),
                                     save_interval_steps=1)
  ModelRegistry(cut_dir(root, "registry")).publish_on_checkpoint(mgr)
  rec = {"cut": bool(state.sharding.sharded), "saved": mgr.save(0, state)}
  out = compat.export_model(state, cut_dir(root, "export"), rank == 0)
  if rank:
    import shutil
    shutil.rmtree(out, ignore_errors=True)
  torch.distributed.barrier()
  if rank == 0:
    with open(cut_dir(root, "done"), "w") as f:
      f.write("ok")
  return rec


def cut_sources(root) -> dict:
  """The cut state's whole weights from each place it was written: the
  checkpoint, the export and the registry's newest version."""
  from tensorflowonspark_tpu_torch.serving.registry import ModelRegistry
  from tensorflowonspark_tpu_torch.utils import checkpoint, compat
  reg = ModelRegistry(cut_dir(root, "registry"))
  return {"ckpt": checkpoint.load_tree(os.path.join(cut_dir(root, "ckpt"),
                                                    "0"))["params"],
          "export": compat.import_model(cut_dir(root, "export"))["params"],
          "registry": reg.get(reg.latest())[0]}


def _four_rank_cases(root, rank):
  m = {k: _mesh(v) for k, v in MESHES[4].items()}
  a, arrays, rec = weights(root, "cfg"), {}, {}
  dp2_tp2 = _model(CFG, a, m["dp2_tp2"])
  arrays["tok/dp2_tp2"] = _decode(dp2_tp2, prompt())
  arrays["tok/dp2_tp2_3rows"] = _decode(dp2_tp2, prompt()[:3])
  arrays["tok/dp2_tp2_sampled"] = sample(dp2_tp2, sampled_prompt())
  arrays["tok/dp2_tp2_sampled_3rows"] = sample(dp2_tp2, sampled_prompt()[:3])
  arrays["logits/dp2_tp2_exit1"] = _prefill_logits(dp2_tp2, prompt(),
                                                   exit_layer=1)
  long = weights(root, "long")
  arrays["logits/dp2_tp2_long"] = _prefill_logits(
      _model(LONG, long, m["dp2_tp2"]), long_prompt())
  tp4 = _model(LONG, long, m["tp4"])
  rec["tp4_kv_whole"] = tp4.plan.kv_index() is not None
  rec["tp4_kv_heads"] = tp4.plan.local_kv_heads()
  arrays["logits/tp4_long"] = _prefill_logits(tp4, long_prompt())
  arrays["tok/tp4"] = _decode(_model(CFG, a, m["tp4"]), prompt())
  moe = weights(root, "moe")
  arrays["tok/dp2_ep2_moe"] = _decode(_model(MOE, moe, m["dp2_ep2"]),
                                      prompt())
  arrays["tok/dp2_ep2_moe_a2a"] = _decode(
      _model(MOE, moe, m["dp2_ep2"], moe_capacity_factor=MOE_A2A_CAPACITY),
      prompt())
  deadline = time.monotonic() + MARK_S
  while not os.path.exists(cut_dir(root, "done")):
    if time.monotonic() > deadline:
      raise RuntimeError("no cut state from the 2-rank group in %d s"
                         % MARK_S)
    time.sleep(0.05)
  for src, params in cut_sources(root).items():
    arrays["tok/cut_" + src] = _decode(_model(CFG, params, m["dp2_tp2"]),
                                       prompt())
  return arrays, rec


def rank_main(rank, world, port, root):
  import torch.distributed as dist
  torch.set_num_threads(1)
  _await_weights(root)
  dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                          rank=rank, world_size=world)
  try:
    cases = _two_rank_cases if world == 2 else _four_rank_cases
    arrays, rec = cases(root, rank)
  finally:
    dist.destroy_process_group()
  out = os.path.join(root, "w%d_rank%d" % (world, rank))
  np.savez(out + ".npz", **arrays)
  with open(out + ".json", "w") as f:
    json.dump(rec, f)


def kill_main(root):
  """Rank 0 of a ``tensor=2`` serving group on the CPU whose rank 1 is
  SIGKILLed in its second serve, after it took the prompt
  (``TOS_CHAOS_KILL``, the ``serve-group`` point): the first serve's
  tokens, then what the second raised and after how many seconds, and
  whether the follower and the process group are gone."""
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  from tensorflowonspark_tpu_torch.parallel import serving_group
  torch.set_num_threads(1)
  _await_weights(root)
  os.chdir(root)                 # the kill point's sentinel file
  os.environ["TOS_CHAOS_KILL"] = "serve-group@1#2"
  group = serving_group.ServingGroup(mesh_lib.MeshSpec(data=1, tensor=2),
                                     device="cpu", timeout=60)
  rec = {"first": group.generate(weights(root, "cfg"), config(CFG), prompt(),
                                 STEPS).tolist()}
  t0 = time.monotonic()
  try:
    group.generate(weights(root, "cfg"), config(CFG), prompt(), STEPS)
    rec["raised"] = None
  except Exception as e:  # noqa: BLE001 - recorded for the test
    rec["raised"] = "%s: %s" % (type(e).__name__, e)
  rec["seconds"] = time.monotonic() - t0
  rec["follower_alive"] = [p.is_alive() for p in group.procs]
  rec["group_left"] = not torch.distributed.is_initialized()
  rec["cached"] = serving_group.follower_pids()
  with open(os.path.join(root, "kill.json"), "w") as f:
    json.dump(rec, f)
