"""The port's expert axis (MoE layers) in gloo processes against the JAX
package on the 8 virtual CPU devices.

Four ranks, spawned once for the module (``torch_pp_ep_ranks.
ep_rank_main``), run every case on meshes of ``data`` 2 x ``expert`` 2
and ``expert`` 4 and write what each saw; the JAX package runs the same
numpy inputs on meshes of the same shapes while the ranks run:

- ``tests/test_parallel.py``'s ``TestExpertParallel``: ``moe_ffn``
  (top-1 and top-2) and ``moe_ffn_a2a`` (top-1 and top-2, ample and
  tight capacity) against JAX's ``moe_ffn`` / ``moe_ffn_a2a`` and
  ``moe_ffn_reference``, in the outputs and in every gradient (router,
  both expert stacks, the tokens); the router's gradient the same on
  every expert rank; the tight capacity dropping what JAX's drops;
  the load-balancing loss and its gradient;
- the two MoE cases of ``TestShardedTrainStep``: a MoE Transformer on
  ``data`` x ``expert`` (dense and all-to-all dispatch) through
  ``create_sharded_state`` + ``make_train_step``: its logits and aux
  losses against the JAX model's, 3 SGD steps against JAX's
  ``make_train_step`` on the same mesh (losses and gathered weights),
  and 8 AdamW steps learning the cyclic corpus;
- ``tests/test_models.py``'s ``test_moe_transformer_learns`` in one
  process, and MoE greedy decoding against the JAX model's tokens.

Tolerances are the reference's: 1e-5 for MoE outputs and gradients and
for f32 losses.
"""

import json
import multiprocessing as mp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu.parallel import expert_parallel as jax_ep
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu.parallel import sharding as jax_sharding
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.parallel import expert_parallel as ep
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port
from tensorflowonspark_tpu_torch.utils.params import (init_params,
                                                      params_from_flax,
                                                      params_to_flax)

import torch_pp_ep_ranks as R

TOL = 1e-5


def _jmesh(**degrees):
  n = int(np.prod(list(degrees.values())))
  return jax_mesh.build_mesh(jax_mesh.MeshSpec(**degrees),
                             devices=jax.devices()[:n])


def _jax_ffn(mesh, top_k, cap, tokens):
  """JAX's sharded FFN (``moe_ffn`` or ``moe_ffn_a2a``) and the
  single-device reference on ``R.moe_inputs``: outputs and the gradients
  of ``sum(out * w)``."""
  inp = R.moe_inputs(tokens)
  params = {k: jnp.asarray(inp[k]) for k in ("w_gate", "w_up", "w_down")}
  x, w = jnp.asarray(inp["x"]), jnp.asarray(inp["w"])

  def sharded(p, x):
    if cap is None:
      return jax_ep.moe_ffn(p, x, mesh, top_k=top_k)
    return jax_ep.moe_ffn_a2a(p, x, mesh, capacity_factor=cap, top_k=top_k)

  def reference(p, x):
    return jax_ep.moe_ffn_reference(p, x, top_k=top_k)

  out = {}
  for tag, fn in (("sharded", sharded), ("reference", reference)):
    y, (gp, gx) = jax.jit(lambda p, x, fn=fn: (
        fn(p, x), jax.grad(lambda p, x: jnp.sum(fn(p, x) * w),
                           argnums=(0, 1))(p, x)))(params, x)
    out[tag] = {"out": np.asarray(y), "g_x": np.asarray(gx),
                **{"g_" + k: np.asarray(v) for k, v in gp.items()}}
  return out


def _jax_model(mesh, **kw):
  """JAX's MoE Transformer on the port's seed-0 weights: logits and aux
  losses, then 3 SGD steps of ``make_train_step`` on ``mesh``."""
  tcfg = tfm.TransformerConfig(dtype=torch.float32, **dict(R.MOE_CFG, **kw))
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32,
                                   **dict(R.MOE_CFG, **kw))
  tx = jax_optim.make_optimizer(learning_rate=R.MOE_LR, clip_norm=1.0,
                                optimizer="sgd")
  state, shard = jax_tfm.create_sharded_state(
      jax.random.PRNGKey(0), jcfg, mesh, seq_len=16, tx=tx)
  flax = jax.tree.map(jnp.asarray, params_to_flax(init_params(tcfg, 0),
                                                  tcfg))
  state = jax.jit(lambda p: state.replace(params=p, opt_state=tx.init(p)),
                  out_shardings=shard)(flax)
  tokens = jnp.asarray(R.cyclic(8, 16))
  logits, inter = jax_tfm.Transformer(jcfg, None).apply(
      {"params": flax}, tokens, mutable=["intermediates"])
  aux = [float(v) for v in jax.tree.leaves(inter["intermediates"])]

  def loss_fn(params, tokens):
    return jax_tfm.causal_lm_loss(state.apply_fn({"params": params}, tokens),
                                  tokens)

  step = jax_sharding.make_train_step(loss_fn, mesh, shard)
  losses = []
  for _ in range(R.MOE_STEPS):
    state, loss = step(state, jax_sharding.shard_batch(tokens, mesh))
    losses.append(float(loss))
  return {"logits": np.asarray(logits), "aux": aux, "losses": losses,
          "weights": params_from_flax(jax.tree.map(np.asarray, state.params),
                                      tcfg)}


def _jax_side():
  want = {}
  mesh = _jmesh(data=2, expert=2)
  for name, top_k, cap, tokens in R.EP_FFN_CASES:
    want[name] = _jax_ffn(mesh, top_k, cap, tokens)
  four = _jmesh(expert=4)
  for name, top_k, cap in (("e4_tight_top1", 1, 0.5),
                           ("e4_tight_top2", 2, 0.5),
                           ("e4_ample_top2", 2, 8.0)):
    want[name] = _jax_ffn(four, top_k, cap, 32)
  want["model_dense"] = _jax_model(mesh)
  want["model_a2a"] = _jax_model(mesh, moe_capacity_factor=4.0)
  return want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
  out = str(tmp_path_factory.mktemp("ep") / "rank%d.npz")
  port = get_free_port()
  ctx = mp.get_context("spawn")
  procs = [ctx.Process(target=R.ep_rank_main, args=(r, port, out))
           for r in range(R.WORLD)]
  for p in procs:
    p.start()
  want = _jax_side()
  for p in procs:
    p.join(timeout=300)
  assert [p.exitcode for p in procs] == [0] * R.WORLD
  got = []
  for r in range(R.WORLD):
    with open((out % r) + ".json") as f:
      got.append((dict(np.load(out % r)), json.load(f)))
  return got, want


FFN_NAMES = [c[0] for c in R.EP_FFN_CASES] + ["e4_tight_top1",
                                               "e4_tight_top2",
                                               "e4_ample_top2"]
FIELDS = ("out", "g_x", "g_w_gate", "g_w_up", "g_w_down")


@pytest.mark.parametrize("name", FFN_NAMES)
def test_ffn_matches_jax_in_outputs_and_every_gradient(ranks, name):
  got, want = ranks
  for rank, (arrays, _) in enumerate(got):
    for field in FIELDS:
      np.testing.assert_allclose(
          arrays["%s/%s" % (name, field)], want[name]["sharded"][field],
          atol=TOL, rtol=TOL, err_msg="%s %s rank %d" % (name, field, rank))


@pytest.mark.parametrize("name", [n for n in FFN_NAMES if "tight" not in n])
def test_ffn_matches_the_single_device_reference(ranks, name):
  """Dense dispatch, and all-to-all with capacity for every assignment,
  equal ``moe_ffn_reference`` (and JAX's, which they match above)."""
  got, want = ranks
  for arrays, rec in got:
    assert rec["drops"][name] == 0
    for field in FIELDS:
      np.testing.assert_allclose(arrays["%s/%s" % (name, field)],
                                 want[name]["reference"][field], atol=TOL,
                                 rtol=TOL, err_msg="%s %s" % (name, field))


@pytest.mark.parametrize("name", FFN_NAMES)
def test_router_gradient_is_whole_on_every_expert_rank(ranks, name):
  """Each rank routes with its local experts' columns (dense) or its own
  token slice (all-to-all): its share of the router's gradient is summed
  over the expert axis, so the ranks' routers stay equal."""
  got, _ = ranks
  for arrays, _ in got:
    per = arrays[name + "/g_w_gate_ranks"]
    for other in per[1:]:
      np.testing.assert_array_equal(other, per[0])


@pytest.mark.parametrize("name", ["e4_tight_top1", "e4_tight_top2",
                                  "a2a_top1_tight", "a2a_top2_tight"])
def test_tight_capacity_drops_only_overflow(ranks, name):
  """Finite outputs; something was dropped (on some rank) and some
  tokens' outputs survive exactly, as the reference's test holds; the
  drops match JAX's to 1e-5 above."""
  got, want = ranks
  out = got[0][0][name + "/out"]
  ample = want[name]["reference"]["out"]
  assert np.isfinite(out).all()
  per_token = np.abs(out - ample).max(axis=-1)
  assert per_token.max() > 1e-6
  assert int((per_token < 1e-6).sum()) >= 1
  assert sum(rec["drops"][name] for _, rec in got) > 0


def test_top2_differs_from_top1(ranks):
  _, want = ranks
  assert np.abs(want["dense_top1"]["reference"]["out"]
                - want["dense_top2"]["reference"]["out"]).max() > 1e-4


def test_load_balancing_loss_matches_jax():
  inp = R.moe_inputs(256, seed=3)
  params = {k: torch.as_tensor(inp[k]).requires_grad_()
            for k in ("w_gate", "w_up", "w_down")}
  x = torch.as_tensor(inp["x"])
  for top_k in (1, 2):
    aux = ep.load_balancing_loss(params, x, top_k)
    g, = torch.autograd.grad(aux, [params["w_gate"]])
    jp = {k: jnp.asarray(inp[k]) for k in ("w_gate", "w_up", "w_down")}
    want = jax_ep.load_balancing_loss(jp, jnp.asarray(inp["x"]), top_k)
    jg = jax.grad(lambda p: jax_ep.load_balancing_loss(
        p, jnp.asarray(inp["x"]), top_k))(jp)["w_gate"]
    assert float(aux.detach()) >= 1.0 - 1e-3
    np.testing.assert_allclose(float(aux.detach()), float(want), rtol=TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=TOL,
                               rtol=TOL)
    assert float(g.abs().sum()) > 0


def test_topk_breaks_ties_to_the_lower_expert():
  probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
  got = ep._topk_dispatch(probs, 2)
  want = np.asarray(jax_ep._topk_dispatch(jnp.asarray(probs.numpy()), 2))
  np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(got.numpy(), [[1, 1, 0, 0], [0, 1, 1, 0]])


def test_shard_moe_params_cut_the_experts():
  mesh = mesh_lib.Mesh(mesh_lib.CANONICAL_ORDER, dict(
      {a: 1 for a in mesh_lib.CANONICAL_ORDER}, expert=4), 3)
  params = ep.init_moe_params(0, 8, 16, 32)
  cut = ep.shard_moe_params(params, mesh)
  assert tuple(cut["w_up"].shape) == (2, 16, 32)
  assert torch.equal(cut["w_down"], params["w_down"][6:])
  assert torch.equal(cut["w_gate"], params["w_gate"])
  with pytest.raises(ValueError, match="do not divide"):
    ep.moe_ffn(cut, torch.zeros(4, 16), mesh.__class__(
        mesh.axis_names, dict(mesh.shape, expert=3), 0))


# -- the MoE Transformer -------------------------------------------------------


@pytest.mark.parametrize("tag", ["dense", "a2a"])
def test_sharded_moe_model_matches_jax(ranks, tag):
  """Logits and aux losses on data 2 x expert 2, then 3 SGD steps of
  ``make_train_step`` against JAX's on the same mesh; the router's
  synced gradient equal on the expert ranks; the experts cut in two."""
  got, want = ranks
  ref = want["model_" + tag]
  for arrays, rec in got:
    m = rec["model"]
    assert m[tag + "_sharded"] and m[tag + "_local_w_up"] == [2, 64, 128]
    np.testing.assert_allclose(arrays["model/%s/logits" % tag],
                               ref["logits"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(m[tag + "_aux"], ref["aux"], rtol=TOL)
    np.testing.assert_allclose(m[tag + "_losses"], ref["losses"], atol=TOL,
                               rtol=TOL)
    for k, w in ref["weights"].items():
      np.testing.assert_allclose(arrays["model/%s/w/%s" % (tag, k)], w,
                                 atol=TOL, rtol=TOL, err_msg=k)
    per = arrays["model/%s/g_gate_ranks" % tag]
    np.testing.assert_array_equal(per[1], per[0])


@pytest.mark.parametrize("tag", ["dense", "a2a"])
def test_sharded_moe_model_learns_the_cyclic_corpus(ranks, tag):
  got, _ = ranks
  losses = got[0][1]["model"][tag + "_learn"]
  assert losses[-1] < losses[0] * 0.8, losses
  assert all(rec["model"][tag + "_learn"] == losses for _, rec in got)


def test_moe_transformer_learns():
  """The reference's test_moe_transformer_learns in one process: layer 1
  is the MoE layer, its aux loss joins the loss, 30 steps learn."""
  cfg = tfm.TransformerConfig(vocab_size=32, num_layers=2, num_heads=2,
                              d_model=32, d_ff=64, remat=False,
                              dtype=torch.float32, moe_experts=4,
                              moe_top_k=2, moe_every=2)
  state = tfm.create_state(cfg, 0, device="cpu", learning_rate=3e-3)
  names = list(state.params)
  assert "layers.1.moe.w_up" in names and "layers.0.mlp.up" in names
  assert not any(n.startswith("layers.1.mlp") for n in names)
  tokens = torch.as_tensor(np.tile(np.arange(16) % 8, (4, 1)))
  losses = []
  for _ in range(30):
    loss = tfm.causal_lm_loss(state.model(tokens), tokens) + \
        0.01 * sum(state.model.moe_aux())
    grads = torch.autograd.grad(loss, list(state.params.values()))
    state.apply_gradients(dict(zip(state.params, grads)))
    losses.append(float(loss))
  assert losses[-1] < losses[0] * 0.8, losses[:3] + losses[-3:]


@pytest.mark.parametrize("capacity", [0.0, 2.0])
def test_moe_logits_aux_and_gradients_match_jax(capacity):
  """One process (no expert axis, so ``moe_ffn_reference``): the logits,
  each MoE layer's aux loss and every gradient of loss + 0.01 * aux
  against ``jax.value_and_grad`` of the flax model; the capacity factor
  changes nothing without an expert axis, as in the reference."""
  kw = dict(vocab_size=32, num_layers=4, num_heads=2, d_model=32, d_ff=64,
            remat=False, moe_experts=4, moe_top_k=2, moe_every=2,
            moe_capacity_factor=capacity)
  cfg = tfm.TransformerConfig(dtype=torch.float32, **kw)
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, **kw)
  params = init_params(cfg, 1)
  model = tfm.Transformer(cfg, params, device="cpu", trainable=True)
  tokens = np.random.default_rng(0).integers(0, 32, (4, 16))
  logits = model(torch.as_tensor(tokens))
  aux = model.moe_aux()
  loss = tfm.causal_lm_loss(logits, torch.as_tensor(tokens)) + 0.01 * sum(aux)
  grads = torch.autograd.grad(loss, list(model.parameters()))
  flax = jax.tree.map(jnp.asarray, params_to_flax(params, cfg))
  jt = jnp.asarray(tokens, jnp.int32)

  def jloss(p):
    lg, it = jax_tfm.Transformer(jcfg).apply({"params": p}, jt,
                                             mutable=["intermediates"])
    return jax_tfm.causal_lm_loss(lg, jt) + 0.01 * sum(
        jax.tree.leaves(it["intermediates"])), (lg, it)

  (_, (jl, it)), jg = jax.value_and_grad(jloss, has_aux=True)(flax)
  np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                             atol=TOL, rtol=TOL)
  np.testing.assert_allclose([float(a) for a in aux],
                             [float(v) for v in jax.tree.leaves(
                                 it["intermediates"])], rtol=TOL)
  jg = params_from_flax(jax.tree.map(np.asarray, jg), cfg)
  for (n, _), g in zip(model.named_parameters(), grads):
    np.testing.assert_allclose(g.numpy(), jg[n], atol=TOL, rtol=1e-4,
                               err_msg=n)


def test_moe_greedy_decode_matches_jax():
  """The KV decode takes MoE layers token by token: the port's greedy
  tokens equal the JAX model's ``greedy_generate_kv``, and the argmax of
  the non-cached forward."""
  kw = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=32, remat=False, moe_experts=4, moe_top_k=2,
            moe_every=2)
  cfg = tfm.TransformerConfig(dtype=torch.float32, **kw)
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, **kw)
  params = init_params(cfg, 2)
  model = tfm.Transformer(cfg, params, device="cpu")
  prompt = np.random.default_rng(5).integers(1, 64, (3, 8))
  got = tfm.greedy_generate_kv(model, prompt, 8).numpy()
  flax = jax.tree.map(jnp.asarray, params_to_flax(params, cfg))
  want = np.asarray(jax_tfm.greedy_generate_kv(flax, jcfg,
                                               jnp.asarray(prompt), 8))
  np.testing.assert_array_equal(got, want)
  with torch.no_grad():
    full = model(torch.as_tensor(got[:, :-1]))
  np.testing.assert_array_equal(full[:, 7:].argmax(-1).numpy(), got[:, 8:])


def test_moe_serving_params_keep_f32_experts():
  cfg = tfm.TransformerConfig(vocab_size=32, num_layers=2, num_heads=2,
                              d_model=32, d_ff=64, moe_experts=2)
  model = tfm.Transformer(cfg, init_params(cfg, 0), device="cpu")
  assert model.layers[1].moe.w_up.dtype == torch.float32
  served = model.serving_params()
  assert served["layers.1.moe.w_gate"].dtype == torch.float32
  assert served["layers.0.mlp.up"].dtype == torch.bfloat16


# -- what stays refused --------------------------------------------------------


def _stand_in(**degrees):
  return mesh_lib.Mesh(mesh_lib.CANONICAL_ORDER, dict(
      {a: 1 for a in mesh_lib.CANONICAL_ORDER}, **degrees), 0)


@pytest.mark.parametrize("axis", ["fsdp", "sequence", "tensor"])
def test_moe_with_other_cut_axes_raises_naming_part_3(axis):
  cfg = tfm.TransformerConfig(vocab_size=64, num_layers=2, num_heads=4,
                              d_model=32, d_ff=64, moe_experts=4,
                              use_ring_attention=axis == "sequence")
  with pytest.raises(NotImplementedError, match="item 10c, part 3"):
    tfm.Transformer(cfg, init_params(cfg, 0), device="cpu",
                    mesh=_stand_in(**{axis: 2}))


def test_expert_axis_must_divide_the_experts():
  cfg = tfm.TransformerConfig(vocab_size=64, num_layers=2, num_heads=4,
                              d_model=32, d_ff=64, moe_experts=3)
  with pytest.raises(ValueError, match="must divide moe_experts"):
    tfm.Transformer(cfg, init_params(cfg, 0), device="cpu",
                    mesh=_stand_in(expert=2))


def test_expert_cut_state_checkpoints_are_refused_by_name(ranks):
  """An expert-cut state holds this rank's experts only. Its checkpoints
  and exports, once refused by name, now hold the whole expert stacks and
  their momentum: each of the 4 ranks (data 2 x expert 2) saves, and the
  checkpoint's experts 2c and 2c + 1 are the blocks of the ranks at
  expert coordinate c; a fresh state restores every rank's blocks to the
  bit. Its decode, once refused by name, runs over the mesh: the 4 ranks
  decode an expert-cut model on ``data 2 x expert 2`` and on ``expert
  4``, each with one process's tokens."""
  import os
  from tensorflowonspark_tpu_torch.utils import checkpoint, compat
  got, _ = ranks
  root = got[0][1]["ckpt"]["root"]
  saved = checkpoint.load_tree(os.path.join(root, "moe_ck", "0"))
  exported = compat.import_model(os.path.join(root, "moe_ex"))
  for rank, (arrays, rec) in enumerate(got):
    rec = rec["ckpt"]
    assert rec["saved"] and rec["next"] == 1, rec
    assert all(rec["restored_equal"]), rec
    e = slice(2 * (rank % 2), 2 * (rank % 2) + 2)
    for tree in (saved, exported):
      assert tuple(tree["params"]["layers.1.moe.w_up"].shape) == (4, 64, 128)
      np.testing.assert_array_equal(
          tree["params"]["layers.1.moe.w_up"].numpy()[e],
          arrays["ckpt/w_up"])
      trace = tree["opt_state"][1][0][rec["w_up_index"]]
      np.testing.assert_array_equal(trace.numpy()[e],
                                    arrays["ckpt/w_up_trace"])
  cfg = tfm.TransformerConfig(vocab_size=64, num_layers=2, num_heads=4,
                              d_model=32, d_ff=64, moe_experts=4,
                              dtype=torch.float32)
  mesh = _stand_in(expert=2)
  cut = tfm.Transformer(cfg, init_params(cfg, 0), device="cpu",
                        mesh=mesh)
  assert cut.param_specs()["layers.1.moe.w_up"] == ("expert", None, None)
  assert cut.param_specs()["layers.1.moe.w_gate"] == (None, None)
  assert cfg == tfm.TransformerConfig(dtype=torch.float32,
                                      **R.MOE_DECODE_CFG)
  want = tfm.greedy_generate_kv(
      tfm.Transformer(cfg, init_params(cfg, 0), device="cpu"),
      R.MOE_DECODE_PROMPT, R.MOE_DECODE_STEPS).numpy()
  for arrays, _ in got:
    for tag in ("dp2_ep2", "ep4"):
      np.testing.assert_array_equal(arrays["decode_" + tag], want)
