"""The port's pipeline axis (1F1B and GPipe) in gloo processes against
the JAX package on the 8 virtual CPU devices.

Four ranks, spawned once for the module (``torch_pp_ep_ranks.
pp_rank_main``), run every case on meshes of ``pipeline`` 4, ``data`` 2 x
``pipeline`` 2 and ``pipeline`` 2 (two pairs side by side) and write
what each saw; the tests hold it against the JAX package, which runs the
same numpy inputs and converted weights while the ranks run:

- ``tests/test_parallel.py``'s ``TestPipelineParallel`` (the GPipe
  forward against the sequential stages and JAX's ``pipeline_apply``,
  and its gradient) and ``TestPipeline1F1B`` (losses and gradients at
  2, 4 and 8 microbatches, in bf16, with a data axis, and the
  microbatch-divisibility assertion); the HLO-only cases have the
  per-rank embed and head call counts as their counterpart;
- ``tests/test_models.py``'s ``TestTransformerPipeline`` ((stages,
  microbatches) in (4, 4), (2, 2), (4, 2), data x pipeline, remat, the
  partition round trip) and ``TestTransformerPipelineFused``: the loss
  and every gradient of ``make_pipeline_train_step`` against JAX's dense
  AD of the same weights (and JAX's own pipeline step on data x
  pipeline);
- ``train_gpt --pp 2 --dp 2`` (f32, SGD) against JAX's
  ``make_pipeline_train_step`` on the same mesh: losses and weights after
  3 steps; ``run`` gives the same losses.

Tolerances are the reference's own: 1e-5 for f32 losses, 2e-4 for the
pipeline's gradients (1e-4 for the generic stages), 0.05 in bf16.
"""

import json
import multiprocessing as mp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu.parallel import pipeline_parallel as jax_pp
from tensorflowonspark_tpu_torch.examples import train_gpt
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port
from tensorflowonspark_tpu_torch.utils.params import (init_params,
                                                      params_from_flax,
                                                      params_to_flax)

import torch_pp_ep_ranks as R

LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
STAGE_TOL = 1e-4


def _jmesh(data, pipeline):
  return jax_mesh.build_mesh(jax_mesh.MeshSpec(data=data, pipeline=pipeline),
                             devices=jax.devices()[:data * pipeline])


def _seq(w, x):
  for i in range(w.shape[0]):
    x = jnp.tanh(x @ w[i])
  return x


def _jax_generic():
  want = {}

  def stage_fn(w, a):
    return jnp.tanh(a @ w)

  def loss_fn(y, t):
    return jnp.mean((y - t) ** 2)

  for tag, (d, p) in (("apply_dp2_pp2", (2, 2)), ("apply_pp4", (1, 4))):
    w, x, _ = R.stage_inputs(p, 16, 8, 0)
    want[tag] = np.asarray(jax.jit(lambda w, x, m=_jmesh(d, p): jax_pp.
                                   pipeline_apply(stage_fn, w, x, m, 4))(w, x))
    want[tag + "_seq"] = np.asarray(_seq(w, x))
  w, x, _ = R.stage_inputs(4, 8, 4, 1)
  want["apply_grad"] = np.asarray(jax.grad(
      lambda w: jnp.sum(_seq(w, x) ** 2))(jnp.asarray(w)))
  for tag, p, n_micro, data in (("f1b_m2", 4, 2, 1), ("f1b_m4", 4, 4, 1),
                                ("f1b_m8", 4, 8, 1),
                                ("f1b_dp2_pp2", 2, 4, 2)):
    w, x, t = R.stage_inputs(p, 16, 8, 7)
    loss, g = jax.jit(lambda w, x, t, m=_jmesh(data, p), k=n_micro: jax_pp.
                      pipeline_train_step(stage_fn, loss_fn, w, x, t, m,
                                          k))(w, x, t)
    want[tag] = (float(loss), np.asarray(g))
    want[tag + "_seq"] = (
        float(loss_fn(_seq(w, x), t)),
        np.asarray(jax.grad(lambda w: loss_fn(_seq(w, x), t))(
            jnp.asarray(w))))
  return want


def _jcfg(base, **kw):
  return jax_tfm.TransformerConfig(dtype=jnp.float32, **dict(base, **kw))


def _dense_ad(base, **kw):
  """JAX's loss and every gradient of the dense model on the port's seed-0
  weights, by the port's names."""
  tcfg = tfm.TransformerConfig(dtype=torch.float32, **dict(base, **kw))
  jcfg = _jcfg(base, **kw)
  flax = jax.tree.map(jnp.asarray, params_to_flax(init_params(tcfg, 0),
                                                  tcfg))
  tokens = jnp.asarray(R.pp_tokens(base, 8))

  def loss(p):
    return jax_tfm.causal_lm_loss(
        jax_tfm.Transformer(jcfg, None).apply({"params": p}, tokens), tokens)

  val, grads = jax.value_and_grad(loss)(flax)
  return float(val), params_from_flax(jax.tree.map(np.asarray, grads), tcfg), \
      (flax, tokens, jcfg, tcfg)


def _jax_lm():
  want = {}
  want["plain"] = _dense_ad(R.PP_CFG)
  want["fused"] = _dense_ad(R.PP_FUSED_CFG)
  # JAX's own pipeline step on data 2 x pipeline 2
  flax, tokens, jcfg, tcfg = want["plain"][2]
  step = jax_tfm.make_pipeline_train_step(jcfg, _jmesh(2, 2), 4)
  loss, grads = jax.jit(step)(flax, tokens)
  want["jax_pp"] = (float(loss), params_from_flax(
      jax.tree.map(np.asarray, grads), tcfg))
  return want


def _jax_gpt():
  """3 steps of JAX's ``make_pipeline_train_step`` at ``train_gpt --pp 2
  --dp 2``'s flags (f32, SGD) from the port's seed-0 weights."""
  from tensorflowonspark_tpu import optim as jax_optim
  args = train_gpt.parse_args([a for a in R.PP_GPT])
  tcfg = tfm.TransformerConfig(
      vocab_size=args.vocab, num_layers=args.layers, num_heads=args.heads,
      d_model=args.d_model, d_ff=args.d_model * 4, max_seq_len=args.seq_len,
      dtype=torch.float32)
  jcfg = jax_tfm.TransformerConfig(
      vocab_size=args.vocab, num_layers=args.layers, num_heads=args.heads,
      d_model=args.d_model, d_ff=args.d_model * 4, max_seq_len=args.seq_len,
      dtype=jnp.float32)
  tx = jax_optim.make_optimizer(learning_rate=args.lr, clip_norm=1.0,
                                optimizer=args.optimizer)
  params = jax.tree.map(jnp.asarray, params_to_flax(init_params(tcfg, 0),
                                                    tcfg))
  opt = tx.init(params)
  pipe = jax_tfm.make_pipeline_train_step(jcfg, _jmesh(2, 2),
                                          args.microbatches)

  @jax.jit
  def step(params, opt, tokens):
    loss, grads = pipe(params, tokens)
    updates, opt = tx.update(grads, opt, params)
    return optax.apply_updates(params, updates), opt, loss

  base = jnp.asarray(np.random.RandomState(0).randint(
      0, args.vocab, (args.batch, args.seq_len)), jnp.int32)
  losses = []
  for _ in range(args.steps):
    params, opt, loss = step(params, opt, base)
    losses.append(float(loss))
  return losses, params_from_flax(jax.tree.map(np.asarray, params), tcfg)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
  """The 4 ranks' arrays and records, and the JAX side of every test."""
  out = str(tmp_path_factory.mktemp("pp") / "rank%d.npz")
  port = get_free_port()
  ctx = mp.get_context("spawn")
  procs = [ctx.Process(target=R.pp_rank_main, args=(r, port, out))
           for r in range(R.WORLD)]
  for p in procs:
    p.start()
  want = {"generic": _jax_generic(), "lm": _jax_lm(), "gpt": _jax_gpt()}
  for p in procs:
    p.join(timeout=300)
  assert [p.exitcode for p in procs] == [0] * R.WORLD
  got = []
  for r in range(R.WORLD):
    with open((out % r) + ".json") as f:
      got.append((dict(np.load(out % r)), json.load(f)))
  return got, want


# -- TestPipelineParallel ------------------------------------------------------


@pytest.mark.parametrize("tag", ["apply_dp2_pp2", "apply_pp4"])
def test_pipeline_apply_matches_sequential_and_jax(ranks, tag):
  got, want = ranks
  for arrays, _ in got:
    np.testing.assert_allclose(arrays[tag], want["generic"][tag],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(arrays[tag], want["generic"][tag + "_seq"],
                               atol=1e-5, rtol=1e-5)


def test_pipeline_apply_is_differentiable(ranks):
  got, want = ranks
  for arrays, _ in got:
    np.testing.assert_allclose(arrays["apply_grad"],
                               want["generic"]["apply_grad"],
                               atol=STAGE_TOL, rtol=STAGE_TOL)


# -- TestPipeline1F1B ----------------------------------------------------------


@pytest.mark.parametrize("tag", ["f1b_m2", "f1b_m4", "f1b_m8",
                                 "f1b_dp2_pp2"])
def test_1f1b_matches_sequential_grads_and_jax(ranks, tag):
  got, want = ranks
  for ref in (want["generic"][tag], want["generic"][tag + "_seq"]):
    for arrays, rec in got:
      np.testing.assert_allclose(rec[tag + "_loss"], ref[0], atol=LOSS_TOL,
                                 rtol=LOSS_TOL)
      np.testing.assert_allclose(arrays[tag], ref[1], atol=STAGE_TOL,
                                 rtol=STAGE_TOL)


def test_1f1b_bf16_params_and_loss(ranks):
  """bf16 end to end: the grads come back in bf16, accumulated in f32."""
  got, want = ranks
  loss, grads = want["generic"]["f1b_m4_seq"]
  for arrays, rec in got:
    assert rec["f1b_bf16_dtype"] == "torch.bfloat16"
    np.testing.assert_allclose(rec["f1b_bf16_loss"], loss, atol=0.05)
    np.testing.assert_allclose(arrays["f1b_bf16"], grads, atol=0.05)


def test_microbatch_data_divisibility_asserts(ranks):
  got, _ = ranks
  for _, rec in got:
    assert "data-axis extent" in rec["assert"]


def test_only_the_edge_stages_embed_and_run_the_head(ranks):
  """Stage 0 embeds each microbatch twice (its forward slot and its
  backward slot's embed gradient), the last stage runs the head once a
  microbatch, and no other rank does either; every rank agrees on the
  loss and the tied table's gradient (both sides summed)."""
  got, _ = ranks
  calls = [rec["calls"] for _, rec in got]
  assert calls == [{"embed": 8, "head": 0}, {"embed": 0, "head": 0},
                   {"embed": 0, "head": 0}, {"embed": 0, "head": 4}]
  for arrays, rec in got[1:]:
    assert rec["counted_loss"] == got[0][1]["counted_loss"]
    np.testing.assert_array_equal(arrays["counted_g_table"],
                                  got[0][0]["counted_g_table"])


def test_split_microbatches_messages():
  from tensorflowonspark_tpu_torch.parallel import pipeline_parallel as pp
  mesh = mesh_lib.build_mesh()
  with pytest.raises(AssertionError, match="not divisible into 3"):
    pp._split_microbatches(torch.zeros(8, 2), 3, mesh)
  assert pp._split_microbatches(torch.arange(8), 4, mesh).shape == (4, 2)


# -- TestTransformerPipeline / Fused ------------------------------------------


@pytest.mark.parametrize("name", [c[0] for c in R.PP_LM_CASES])
def test_pipeline_step_matches_jax_dense_ad(ranks, name):
  got, want = ranks
  loss, grads, _ = want["lm"]["fused" if name == "fused_gqa" else "plain"]
  for arrays, rec in got:
    assert rec[name + "_names"]
    np.testing.assert_allclose(rec[name + "_loss"], loss, atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    for k, g in grads.items():
      np.testing.assert_allclose(arrays["%s/%s" % (name, k)], g,
                                 atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=k)


def test_pipeline_step_matches_jax_pipeline_on_data_x_pipeline(ranks):
  got, want = ranks
  loss, grads = want["lm"]["jax_pp"]
  for arrays, rec in got:
    np.testing.assert_allclose(rec["dp2_pp2_loss"], loss, atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    for k, g in grads.items():
      np.testing.assert_allclose(arrays["dp2_pp2/" + k], g, atol=GRAD_TOL,
                                 rtol=GRAD_TOL, err_msg=k)


def test_partition_roundtrip_matches_jax():
  """The port's partition stacks what the reference's does; unpartition
  gives the flat weights back, bit for bit, tensors or arrays."""
  cfg = tfm.TransformerConfig(dtype=torch.float32, **R.PP_CFG)
  params = init_params(cfg, 0)
  outer, stage = tfm.pipeline_partition_params(params, 2)
  flax = params_to_flax(params, cfg)
  j_outer, j_stage = jax_tfm.pipeline_partition_params(flax, 2)
  np.testing.assert_array_equal(stage["attn.q"],
                                np.asarray(j_stage["attn"]["q"]["kernel"]))
  np.testing.assert_array_equal(stage["mlp.down"],
                                np.asarray(j_stage["mlp"]["down"]["kernel"]))
  assert sorted(outer) == ["embed.embedding", "ln_f.scale"]
  assert sorted(j_outer) == ["embed", "ln_f"]
  back = tfm.pipeline_unpartition_grads(outer, stage, 4)
  assert sorted(back) == sorted(params)
  for k in params:
    np.testing.assert_array_equal(back[k], params[k])
  tensors = {k: torch.as_tensor(v) for k, v in params.items()}
  t_outer, t_stage = tfm.pipeline_partition_params(tensors, 4)
  assert t_stage["attn.q"].shape == (4, 1, 64, 4, 16)
  for k, v in tfm.pipeline_unpartition_grads(t_outer, t_stage, 4).items():
    assert torch.equal(v, tensors[k])
  with pytest.raises(AssertionError, match="4 layers do not split into 3"):
    tfm.pipeline_partition_params(params, 3)


def test_pipeline_step_refuses_moe():
  cfg = tfm.TransformerConfig(dtype=torch.float32, moe_experts=2,
                              **R.PP_CFG)
  with pytest.raises(AssertionError, match="homogeneous"):
    tfm.make_pipeline_train_step(cfg, mesh_lib.build_mesh(), 2)


# -- train_gpt --pp ------------------------------------------------------------


def test_train_gpt_pp_matches_jax(ranks):
  got, want = ranks
  losses, weights = want["gpt"]
  for arrays, rec in got:
    assert rec["gpt"]["mesh"]["data"] == 2 and \
        rec["gpt"]["mesh"]["pipeline"] == 2
    np.testing.assert_allclose(rec["gpt"]["losses"], losses, atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert rec["gpt"]["run"] == rec["gpt"]["losses"]
    for k, w in weights.items():
      np.testing.assert_allclose(arrays["gpt/" + k], w, atol=LOSS_TOL,
                                 rtol=LOSS_TOL, err_msg=k)
  assert losses[-1] < losses[0]


def test_train_gpt_pp_flags_follow_the_reference():
  """``--pp`` composes with ``--dp`` only, ``--dp -1`` takes the group
  over ``--pp``, and the batch must split into microbatches that divide
  over ``--dp``: the reference's ``parser.error`` texts."""
  base = ["--device", "cpu", "--pp", "2"]
  for flags in (["--fsdp", "2"], ["--sp", "2"], ["--tp", "2"],
                ["--blocked_loss"], ["--z_loss", "1e-4"]):
    with pytest.raises(SystemExit):
      train_gpt.parse_args(base + flags)
  with pytest.raises(SystemExit):
    train_gpt.parse_args(base + ["--batch", "6", "--microbatches", "4"])
  args = train_gpt.parse_args(base + ["--batch", "8", "--microbatches",
                                      "4"])
  assert args.dp == 1                  # no group: one process over --pp
  with pytest.raises(ValueError, match="--pp 2 needs a torch.distributed"):
    train_gpt.make_mesh(args)


def test_train_gpt_pp_flag_errors_print_the_reference_text(capsys):
  with pytest.raises(SystemExit):
    train_gpt.parse_args(["--device", "cpu", "--pp", "2", "--tp", "2"])
  assert "--pp composes with --dp only" in capsys.readouterr().err
  with pytest.raises(SystemExit):
    train_gpt.parse_args(["--device", "cpu", "--pp", "2", "--dp", "2",
                          "--batch", "4", "--microbatches", "4"])
  assert "must split into 4 microbatches divisible by dp=2 (e.g. --batch " \
      "8)" in capsys.readouterr().err
