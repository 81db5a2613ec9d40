"""What each gloo rank runs for ``tests/test_torch_expert_parallel.py``
and ``tests/test_torch_pipeline_parallel.py``, and the seeded inputs both
sides share.

A helper, not a test file: it imports PyTorch and the port only, so a
spawned rank starts without loading JAX. Each ``*_rank_main`` joins a
4-rank gloo group, runs every case of its file and writes what it saw to
``out % rank`` (``.npz`` arrays and a ``.json`` record).
"""

import json

import numpy as np
import torch

WORLD = 4

# -- shared inputs -------------------------------------------------------------

#: (name, top_k, capacity factor or None for the dense dispatch, tokens)
EP_FFN_CASES = (("dense_top1", 1, None, 24), ("dense_top2", 2, None, 24),
                ("a2a_top1", 1, 8.0, 64), ("a2a_top2", 2, 8.0, 64),
                ("a2a_top1_tight", 1, 0.5, 64),
                ("a2a_top2_tight", 2, 0.5, 64))
EP_E, EP_D, EP_F = 8, 16, 32
MOE_CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64,
               d_ff=128, max_seq_len=16, remat=False, moe_experts=4,
               moe_top_k=2, moe_every=2)
MOE_STEPS = 3
MOE_LR = 0.1
#: the expert-cut model decoded over a mesh
MOE_DECODE_CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32,
                      d_ff=64, moe_experts=4)
MOE_DECODE_PROMPT = np.ones((1, 4), "int64")
MOE_DECODE_STEPS = 2
PP_CFG = dict(vocab_size=128, num_layers=4, num_heads=4, d_model=64,
              d_ff=128, max_seq_len=16, remat=False)
PP_FUSED_CFG = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                    d_model=32, d_ff=64, max_seq_len=8, remat=False,
                    fuse_qkv=True, ln_matmul_impl="fused",
                    act_matmul_impl="fused")
#: (name, mesh degrees (data, pipeline), microbatches, config overrides)
PP_LM_CASES = (("s4_m4", (1, 4), 4, {}), ("s2_m2", (1, 2), 2, {}),
               ("s4_m2", (1, 4), 2, {}), ("dp2_pp2", (2, 2), 4, {}),
               ("remat", (1, 4), 4, {"remat": True}),
               ("fused_gqa", (2, 2), 2, {}))
PP_GPT = ["--device", "cpu", "--layers", "2", "--d_model", "32", "--heads",
          "4", "--seq_len", "16", "--vocab", "64", "--batch", "8", "--steps",
          "3", "--pp", "2", "--dp", "2", "--microbatches", "2",
          "--optimizer", "sgd", "--lr", "0.1"]


def moe_inputs(tokens: int, seed: int = 0) -> dict:
  """MoE weights (the reference's laws), tokens and an output cotangent,
  f32 numpy."""
  rng = np.random.RandomState(seed)
  s_in = np.float32(1.0 / EP_D ** 0.5)
  return {"w_gate": rng.randn(EP_D, EP_E).astype("float32") * s_in,
          "w_up": rng.randn(EP_E, EP_D, EP_F).astype("float32") * s_in,
          "w_down": rng.randn(EP_E, EP_F, EP_D).astype("float32")
                    * np.float32(1.0 / EP_F ** 0.5),
          "x": rng.randn(tokens, EP_D).astype("float32"),
          "w": rng.randn(tokens, EP_D).astype("float32")}


def cyclic(rows: int, seq: int, period: int = 8) -> np.ndarray:
  return np.tile(np.arange(seq) % period, (rows, 1)).astype("int32")


def stage_inputs(n_stages: int, d: int, b: int, seed: int):
  """The reference's ``TestPipeline1F1B`` stacks: W [S, d, d], x and t."""
  rng = np.random.RandomState(seed)
  w = (rng.randn(n_stages, d, d) * 0.3).astype("float32")
  return w, rng.randn(b, d).astype("float32"), \
      rng.randn(b, d).astype("float32")


def pp_tokens(cfg: dict, rows: int) -> np.ndarray:
  return np.random.RandomState(0).randint(
      0, cfg["vocab_size"], (rows, cfg["max_seq_len"])).astype("int32")


# -- the rank side -------------------------------------------------------------


def _join(rank, port):
  import torch.distributed as dist
  torch.set_num_threads(1)
  dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                          rank=rank, world_size=WORLD)


def _save(out, rank, arrays, rec):
  np.savez(out % rank, **{k: np.asarray(v) for k, v in arrays.items()})
  with open((out % rank) + ".json", "w") as f:
    json.dump(rec, f)


def _np(t):
  return t.detach().float().cpu().numpy()


def _ffn_case(mesh, fn, top_k, cap, tokens):
  """One expert-parallel FFN on ``mesh``: the global output and the
  gradients of ``sum(out * w)`` (each data rank's share summed), every
  expert rank's router gradient, and the rank's dropped assignments."""
  from tensorflowonspark_tpu_torch.parallel import collectives as C
  from tensorflowonspark_tpu_torch.parallel import expert_parallel as EP
  from tensorflowonspark_tpu_torch.parallel import sharding
  inp = moe_inputs(tokens)
  whole = {k: torch.as_tensor(inp[k]) for k in ("w_gate", "w_up", "w_down")}
  params = {k: v.clone().requires_grad_()
            for k, v in EP.shard_moe_params(whole, mesh).items()}
  x = torch.as_tensor(sharding.shard_batch(inp["x"], mesh)).requires_grad_()
  w = torch.as_tensor(sharding.shard_batch(inp["w"], mesh))
  drops = []
  if cap is None:
    out = EP.moe_ffn(params, x, mesh, top_k)
  else:
    out = EP.moe_ffn_a2a(params, x, mesh, cap, top_k, drops=drops)
  (out * w).sum().backward()
  data = ("data",)
  g = {k: C.all_reduce(p.grad, mesh, data) for k, p in params.items()}
  got = {"out": C.all_gather(out.detach(), mesh, data),
         "g_x": C.all_gather(x.grad, mesh, data), "g_w_gate": g["w_gate"],
         "g_w_up": C.all_gather(g["w_up"], mesh, "expert"),
         "g_w_down": C.all_gather(g["w_down"], mesh, "expert"),
         "g_w_gate_ranks": C.all_gather(g["w_gate"][None], mesh, "expert")}
  got = {k: _np(v) for k, v in got.items()}
  dropped = int(drops[0]) if drops else 0
  return got, dropped


def _moe_state(mesh, seed=0, **kw):
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.utils.params import init_params
  cfg = tfm.TransformerConfig(dtype=torch.float32, **dict(MOE_CFG, **kw))
  tx = optim.make_optimizer(learning_rate=MOE_LR, clip_norm=1.0,
                            optimizer="sgd")
  return cfg, tfm.create_sharded_state(cfg, init_params(cfg, seed), mesh,
                                       tx=tx, device="cpu")[0]


def _lm_loss(model, tokens):
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  return tfm.causal_lm_loss(model(tokens), tokens, mesh=model.mesh)


def _moe_model(mesh):
  """The MoE Transformer on data 2 x expert 2: its logits and aux losses,
  the first step's router gradients on every expert rank, 3 SGD steps
  (dense and all-to-all dispatch) and 8 AdamW steps on a cyclic corpus."""
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import collectives as C
  from tensorflowonspark_tpu_torch.parallel import sharding
  from tensorflowonspark_tpu_torch.utils.params import init_params
  arrays, rec = {}, {}
  tokens = cyclic(8, 16)
  for tag, kw in (("dense", {}), ("a2a", {"moe_capacity_factor": 4.0})):
    cfg, state = _moe_state(mesh, **kw)
    rec[tag + "_local_w_up"] = list(state.params["layers.1.moe.w_up"].shape)
    rec[tag + "_sharded"] = bool(state.sharding.sharded)
    batch = torch.as_tensor(sharding.shard_batch(tokens, mesh))
    logits = state.model(batch)
    arrays[tag + "/logits"] = _np(C.all_gather(logits.detach(), mesh,
                                               "data"))
    rec[tag + "_aux"] = [float(a) for a in state.model.moe_aux()]
    loss = _lm_loss(state.model, batch)
    grads = torch.autograd.grad(loss, list(state.params.values()))
    grads = sharding.sync_state_gradients(grads, list(state.params),
                                          state.sharding, mesh)
    g_gate = dict(zip(state.params, grads))["layers.1.moe.w_gate"]
    arrays[tag + "/g_gate_ranks"] = _np(C.all_gather(g_gate[None], mesh,
                                                     "expert"))
    step = sharding.make_train_step(_lm_loss, mesh, state.sharding)
    losses = []
    for _ in range(MOE_STEPS):
      state, loss = step(state, batch)
      losses.append(float(loss))
    rec[tag + "_losses"] = losses
    for k, v in sharding.gather_state_params(state).items():
      arrays["%s/w/%s" % (tag, k)] = v
  # the reference's test_moe_transformer_sharded_over_expert_axis: AdamW
  # at 1e-2, 8 steps on the cyclic corpus
  for tag, kw in (("dense", {}), ("a2a", {"moe_capacity_factor": 4.0})):
    cfg = tfm.TransformerConfig(dtype=torch.float32, **dict(MOE_CFG, **kw))
    state = tfm.create_sharded_state(cfg, init_params(cfg, 0), mesh,
                                     tx=optim.adamw(1e-2, weight_decay=0.01),
                                     device="cpu")[0]
    step = sharding.make_train_step(_lm_loss, mesh, state.sharding)
    batch = torch.as_tensor(sharding.shard_batch(tokens, mesh))
    losses = []
    for _ in range(8):
      state, loss = step(state, batch)
      losses.append(float(loss))
    rec[tag + "_learn"] = losses
  return arrays, rec


def _moe_checkpoint(mesh, root, rank):
  """The MoE state cut over data 2 x expert 2 after one SGD step: every
  rank saves, restores into a fresh state from other weights and
  exports; this rank's blocks of the expert stack ``layers.1.moe.w_up``
  and of its momentum."""
  import os
  from tensorflowonspark_tpu_torch.parallel import sharding
  from tensorflowonspark_tpu_torch.utils import checkpoint, compat
  _, state = _moe_state(mesh)
  step = sharding.make_train_step(_lm_loss, mesh, state.sharding)
  state, _ = step(state, torch.as_tensor(sharding.shard_batch(cyclic(8, 16),
                                                              mesh)))
  ck, ex = os.path.join(root, "moe_ck"), os.path.join(root, "moe_ex")
  rec = {"saved": checkpoint.CheckpointManager(ck).save(0, state,
                                                        force=True),
         "root": root}
  fresh, rec["next"] = checkpoint.CheckpointManager(ck).restore_or(
      _moe_state(mesh, seed=1)[1])
  rec["restored_equal"] = [
      torch.equal(a, b) for (_, a), (_, b) in zip(
          sharding._state_tensors(state), sharding._state_tensors(fresh))]
  compat.export_model(state, ex, rank == 0)
  names = list(state.params)
  i = names.index("layers.1.moe.w_up")
  trace = [t for path, t in sharding._state_tensors(state)
           if path[-1] == i and path[0] == "opt_state"]
  rec["w_up_index"] = i
  return rec, {"w_up": _np(state.params["layers.1.moe.w_up"]),
               "w_up_trace": _np(trace[0])}


def _moe_decode(meshes) -> dict:
  """Greedy tokens of the expert-cut model (MOE_DECODE_CFG, f32, the
  weights of seed 0) over each mesh: a 1-row batch, padded over
  ``data``."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.utils.params import init_params
  cfg = tfm.TransformerConfig(dtype=torch.float32, **MOE_DECODE_CFG)
  return {"decode_" + tag: tfm.greedy_generate_kv(
      tfm.Transformer(cfg, init_params(cfg, 0), device="cpu", mesh=mesh),
      MOE_DECODE_PROMPT, MOE_DECODE_STEPS).numpy()
          for tag, mesh in meshes.items()}


def ep_rank_main(rank, port, out):
  from tensorflowonspark_tpu_torch.parallel import mesh as M
  import torch.distributed as dist
  _join(rank, port)
  try:
    arrays, rec = {}, {"drops": {}}
    mesh = M.build_mesh(M.MeshSpec(data=2, expert=2))
    for name, top_k, cap, tokens in EP_FFN_CASES:
      got, rec["drops"][name] = _ffn_case(mesh, name, top_k, cap, tokens)
      arrays.update({"%s/%s" % (name, k): v for k, v in got.items()})
    four = M.build_mesh(M.MeshSpec(data=1, expert=4))
    for name, top_k, cap in (("e4_tight_top1", 1, 0.5),
                             ("e4_tight_top2", 2, 0.5),
                             ("e4_ample_top2", 2, 8.0)):
      got, rec["drops"][name] = _ffn_case(four, name, top_k, cap, 32)
      arrays.update({"%s/%s" % (name, k): v for k, v in got.items()})
    more, rec["model"] = _moe_model(mesh)
    arrays.update({"model/" + k: v for k, v in more.items()})
    import os
    rec["ckpt"], more = _moe_checkpoint(mesh, os.path.dirname(out), rank)
    arrays.update({"ckpt/" + k: v for k, v in more.items()})
    arrays.update(_moe_decode({"dp2_ep2": mesh, "ep4": four}))
    _save(out, rank, arrays, rec)
  finally:
    dist.destroy_process_group()


# -- the pipeline ranks --------------------------------------------------------


def _seq_apply(w, x):
  for i in range(w.shape[0]):
    x = torch.tanh(x @ w[i])
  return x


def _generic_cases(meshes):
  """TestPipelineParallel and TestPipeline1F1B's cases: GPipe outputs and
  gradients, 1F1B losses and gathered gradients."""
  from tensorflowonspark_tpu_torch.parallel import collectives as C
  from tensorflowonspark_tpu_torch.parallel import pipeline_parallel as PP
  arrays, rec = {}, {}

  def stage_fn(w, a):
    return torch.tanh(a @ w)

  def loss_fn(y, t):
    return torch.mean((y - t) ** 2)

  # GPipe forward over data 2 x pipeline 2 and pipeline 4
  for tag, mesh, n in (("apply_dp2_pp2", meshes["dp2_pp2"], 2),
                       ("apply_pp4", meshes["pp4"], 4)):
    w, x, _ = stage_inputs(n, 16, 8, 0)
    arrays[tag] = _np(PP.pipeline_apply(stage_fn, torch.as_tensor(w),
                                        torch.as_tensor(x), mesh, 4))
  # differentiable: the gradient of sum(out^2) in the stacked weights
  w, x, _ = stage_inputs(4, 8, 4, 1)
  wt = torch.as_tensor(w).requires_grad_()
  (PP.pipeline_apply(stage_fn, wt, torch.as_tensor(x), meshes["pp4"], 2)
   ** 2).sum().backward()
  arrays["apply_grad"] = _np(wt.grad)
  # 1F1B: n_micro 2, 4, 8 on pipeline 4; bf16; data 2 x pipeline 2
  for tag, mesh, n_micro, dtype in (
      ("f1b_m2", meshes["pp4"], 2, torch.float32),
      ("f1b_m4", meshes["pp4"], 4, torch.float32),
      ("f1b_m8", meshes["pp4"], 8, torch.float32),
      ("f1b_bf16", meshes["pp4"], 4, torch.bfloat16),
      ("f1b_dp2_pp2", meshes["dp2_pp2"], 4, torch.float32)):
    n = mesh.shape["pipeline"]
    w, x, t = (torch.as_tensor(a).to(dtype) for a in stage_inputs(n, 16, 8,
                                                                  7))
    loss, g = PP.pipeline_train_step(stage_fn, loss_fn, w, x, t, mesh,
                                     n_micro)
    rec[tag + "_loss"] = float(loss)
    rec[tag + "_dtype"] = str(g.dtype)
    arrays[tag] = _np(C.all_gather(g, mesh, "pipeline"))
  w, x, t = (torch.as_tensor(a) for a in stage_inputs(2, 16, 8, 7))
  try:
    PP.pipeline_train_step(stage_fn, loss_fn, w, x, t, meshes["dp2_pp2"], 8)
    rec["assert"] = None
  except AssertionError as e:
    rec["assert"] = str(e)
  return arrays, rec


def _counted_lm(mesh):
  """pipeline_lm_train_step with a table-lookup embed and a tied
  head + loss that count their calls on this rank (an activation-shape
  probe on the meta device is no call)."""
  from tensorflowonspark_tpu_torch.parallel import pipeline_parallel as PP
  calls = {"embed": 0, "head": 0}
  rng = np.random.RandomState(3)
  table = torch.as_tensor(rng.randn(32, 8).astype("float32") * 0.3)
  stages = torch.as_tensor(rng.randn(4, 8, 8).astype("float32") * 0.3)
  tokens = torch.as_tensor(rng.randint(0, 32, (8, 6)))

  def embed_fn(outer, tok):
    if tok.device.type != "meta":
      calls["embed"] += 1
    return outer["table"][tok]

  def head_fn(outer, y, tok):
    calls["head"] += 1
    logits = y @ outer["table"].t()
    return torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, 32), tok[:, 1:].reshape(-1))

  loss, g_outer, _ = PP.pipeline_lm_train_step(
      embed_fn, lambda w, a: torch.tanh(a @ w), head_fn, {"table": table},
      stages, tokens, tokens, mesh, 4)
  return calls, float(loss), _np(g_outer["table"])


def _lm_cases(meshes):
  """TestTransformerPipeline / TestTransformerPipelineFused: the loss and
  every gradient of ``make_pipeline_train_step``."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.utils.params import init_params
  arrays, rec = {}, {}
  for name, (d, p), n_micro, kw in PP_LM_CASES:
    base = PP_FUSED_CFG if name == "fused_gqa" else PP_CFG
    cfg = tfm.TransformerConfig(dtype=torch.float32, **dict(base, **kw))
    params = {k: torch.as_tensor(v) for k, v in init_params(cfg, 0).items()}
    mesh = meshes["dp%d_pp%d" % (d, p) if d > 1 else "pp%d" % p]
    step = tfm.make_pipeline_train_step(cfg, mesh, n_micro)
    loss, grads = step(params, pp_tokens(base, 8))
    rec[name + "_loss"] = float(loss)
    rec[name + "_names"] = list(grads) == list(params)
    arrays.update({"%s/%s" % (name, k): _np(v) for k, v in grads.items()})
  return arrays, rec


def _train_gpt_pp():
  """``train_gpt --pp 2 --dp 2`` (f32): its pieces for 3 steps (losses,
  the whole weights after) and ``run`` itself."""
  import dataclasses
  from tensorflowonspark_tpu_torch.examples import train_gpt
  args = train_gpt.parse_args(PP_GPT)
  mesh = train_gpt.make_mesh(args)
  cfg = dataclasses.replace(train_gpt.make_config(args), dtype=torch.float32)
  state = train_gpt.make_state(args, cfg, mesh)
  step = train_gpt.make_pp_step(args, cfg, mesh)
  stream = train_gpt.batch_stream(args)
  losses = []
  for _ in range(args.steps):
    state, loss = step(state, next(stream))
    losses.append(float(loss))
  make = train_gpt.make_config
  train_gpt.make_config = lambda a: dataclasses.replace(make(a),
                                                        dtype=torch.float32)
  try:
    run = train_gpt.run(train_gpt.parse_args(PP_GPT))
  finally:
    train_gpt.make_config = make
  return {"losses": losses, "run": run, "mesh": dict(mesh.shape),
          "dp": args.dp}, {k: _np(v) for k, v in state.params.items()}


def pp_rank_main(rank, port, out):
  from tensorflowonspark_tpu_torch.parallel import mesh as M
  import torch.distributed as dist
  _join(rank, port)
  try:
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    meshes = {"pp4": M.build_mesh(M.MeshSpec(data=1, pipeline=4)),
              "dp2_pp2": M.build_mesh(M.MeshSpec(data=2, pipeline=2)),
              "pp2": M.build_mesh(M.MeshSpec(data=1, pipeline=2),
                                  group=pairs[rank // 2])}
    arrays, rec = _generic_cases(meshes)
    rec["calls"], rec["counted_loss"], arrays["counted_g_table"] = \
        _counted_lm(meshes["pp4"])
    more, lm = _lm_cases(meshes)
    arrays.update(more)
    rec.update(lm)
    rec["gpt"], weights = _train_gpt_pp()
    arrays.update({"gpt/" + k: v for k, v in weights.items()})
    _save(out, rank, arrays, rec)
  finally:
    dist.destroy_process_group()
