"""The PyTorch port's training path against the JAX package's, on the CPU.

The JAX model runs with ``attention_impl="flash"`` and
``layer_norm_impl="fused"`` (its Pallas kernels, forward and backward,
in interpret mode); the port runs on the CPU, where its ops take their
plain versions. Weights go across with ``params_from_flax`` and come back
with ``params_to_flax``; tokens are made with numpy.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu.parallel import sharding as jax_sharding
from tensorflowonspark_tpu_torch import optim
from tensorflowonspark_tpu_torch.data.readers import (Slab, feed_batches,
                                                      slab_batches)
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.parallel import sharding
from tensorflowonspark_tpu_torch.utils.params import (init_params,
                                                      params_from_flax,
                                                      params_to_flax)

GRAD_CFG = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64,
                d_ff=128, max_seq_len=128)
SEQ = 128
Z_LOSS = 1e-4
CHUNK = 48          # does not divide the 127 shifted positions: a ragged tail


def _configs(remat=False, **kw):
  kw = dict(GRAD_CFG, **kw)
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False,
                                   attention_impl="flash",
                                   layer_norm_impl="fused", **kw)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, remat=remat, **kw)
  return jcfg, tcfg


def _jax_losses(jcfg, params, tokens):
  model = jax_tfm.Transformer(jcfg)

  def plain(p):
    return jax_tfm.causal_lm_loss(model.apply({"params": p}, tokens), tokens,
                                  z_loss=Z_LOSS)

  def blocked(p):
    hidden = model.apply({"params": p}, tokens, return_hidden=True)
    return jax_tfm.causal_lm_loss_blocked(
        hidden, jax_tfm.tied_embedding_table(p), tokens, chunk=CHUNK,
        z_loss=Z_LOSS)
  return {"plain": plain, "blocked": blocked}


def _port_loss(kind, model, tokens):
  if kind == "plain":
    return tfm.causal_lm_loss(model(tokens), tokens, z_loss=Z_LOSS)
  hidden = model(tokens, return_hidden=True)
  return tfm.causal_lm_loss_blocked(hidden, tfm.tied_embedding_table(model),
                                    tokens, chunk=CHUNK, z_loss=Z_LOSS)


@pytest.fixture(scope="module", params=["mha", "gqa"])
def jax_reference(request):
  """(kv heads, flax params, tokens, {loss kind: (loss, flat grads)})."""
  kv = 0 if request.param == "mha" else 2
  jcfg, tcfg = _configs(num_kv_heads=kv)
  state = jax_tfm.create_state(jax.random.PRNGKey(1), jcfg, seq_len=16)
  params = jax.tree.map(np.asarray, state.params)
  tokens = np.random.default_rng(2).integers(0, GRAD_CFG["vocab_size"],
                                             size=(2, SEQ))
  out = {}
  for kind, fn in _jax_losses(jcfg, params, jnp.asarray(tokens,
                                                        jnp.int32)).items():
    loss, grads = jax.value_and_grad(fn)(params)
    out[kind] = (float(loss), params_from_flax(
        jax.tree.map(np.asarray, grads), tcfg))
  return kv, params, tokens, out


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("kind", ["plain", "blocked"])
def test_loss_and_every_gradient_match_jax(jax_reference, remat, kind):
  kv, params, tokens, ref = jax_reference
  _, tcfg = _configs(remat=remat, num_kv_heads=kv)
  model = tfm.Transformer(tcfg, params_from_flax(params, tcfg), device="cpu",
                          trainable=True)
  loss = _port_loss(kind, model, torch.from_numpy(tokens))
  names, weights = zip(*model.named_parameters())
  grads = torch.autograd.grad(loss, weights)
  want_loss, want_grads = ref[kind]
  np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-4)
  assert sorted(names) == sorted(want_grads)
  for name, g in zip(names, grads):
    np.testing.assert_allclose(g.numpy(), want_grads[name], atol=1e-4,
                               rtol=1e-4, err_msg=name)


def test_blocked_loss_equals_plain_loss():
  _, tcfg = _configs()
  model = tfm.Transformer(tcfg, init_params(tcfg, seed=3), device="cpu",
                          trainable=True)
  tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 96, (2, 40)))
  with torch.no_grad():
    a = _port_loss("plain", model, tokens)
    b = _port_loss("blocked", model, tokens)
  np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_params_to_flax_inverts_params_from_flax():
  jcfg, tcfg = _configs(num_kv_heads=2)
  state = jax_tfm.create_state(jax.random.PRNGKey(0), jcfg, seq_len=16)
  tree = jax.tree.map(np.asarray, state.params)
  back = params_to_flax(params_from_flax(tree, tcfg), tcfg)
  flat_a = jax.tree_util.tree_leaves_with_path(tree)
  flat_b = jax.tree_util.tree_leaves_with_path(back)
  assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
  for (_, a), (_, b) in zip(flat_a, flat_b):
    assert np.array_equal(a, b)
  with pytest.raises(KeyError, match="does not have"):
    params_to_flax(dict(params_from_flax(tree, tcfg), extra=np.zeros(1)),
                   tcfg)


# -- the train step ------------------------------------------------------------

STEP_CFG = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                d_model=32, d_ff=64, max_seq_len=32)
OPT = dict(learning_rate=3e-3, clip_norm=1.0, warmup_steps=1,
           schedule="cosine", decay_steps=4)


def _step_batches(n):
  rng = np.random.default_rng(7)
  return [rng.integers(0, 64, size=(4, 32)).astype(np.int32)
          for _ in range(n)]


def _lm_loss(model, tokens):
  return tfm.causal_lm_loss(model(tokens), tokens)


def _port_state(params, tcfg):
  return tfm.create_state(tcfg, params, tx=optim.make_optimizer(**OPT),
                          device="cpu")


@pytest.fixture(scope="module")
def step_pair():
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False,
                                   attention_impl="flash",
                                   layer_norm_impl="fused", **STEP_CFG)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, **STEP_CFG)
  state = jax_tfm.create_state(jax.random.PRNGKey(3), jcfg, seq_len=32,
                               tx=jax_optim.make_optimizer(**OPT))
  params = params_from_flax(jax.tree.map(np.asarray, state.params), tcfg)
  return jcfg, tcfg, state, params


def test_train_steps_match_jax_make_train_step(step_pair):
  jcfg, tcfg, jstate, params = step_pair
  mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(data=1),
                             devices=jax.devices()[:1])

  def jloss(p, tokens):
    return jax_tfm.causal_lm_loss(jstate.apply_fn({"params": p}, tokens),
                                  tokens)

  jstep = jax_sharding.make_train_step(jloss, mesh, donate_state=False)
  tstate = _port_state(params, tcfg)
  tstep = sharding.make_train_step(_lm_loss)
  for tokens in _step_batches(3):
    jstate, jl = jstep(jstate, jnp.asarray(tokens))
    tstate, tl = tstep(tstate, tokens)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
  assert tstate.step == 3
  # updated weights, carried back to a flax tree, agree too
  got = params_to_flax(tstate.model.numpy_params(), tcfg)
  for (path, a), (_, b) in zip(
      jax.tree_util.tree_leaves_with_path(got),
      jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                       jstate.params))):
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=str(path))


def test_fused_loop_is_bit_identical_to_per_step(step_pair):
  _, tcfg, _, params = step_pair
  batches = _step_batches(3)
  a = _port_state(params, tcfg)
  step = sharding.make_train_step(_lm_loss)
  per_step = []
  for tokens in batches:
    a, loss = step(a, tokens)
    per_step.append(loss)
  b = _port_state(params, tcfg)
  loop = sharding.make_train_loop(_lm_loss, unroll=3)
  b, losses = loop(b, Slab(np.stack(batches)))
  assert loop.steps == 3 and losses.shape == (3,)
  assert torch.equal(torch.stack(per_step), losses)
  for (n, pa), (_, pb) in zip(a.model.named_parameters(),
                              b.model.named_parameters()):
    assert torch.equal(pa, pb), n
  # a plain batch and a short slab take the per-step path
  b, one = loop(b, batches[0])
  b, two = loop(b, Slab(np.stack(batches[:2])))
  assert one.shape == (1,) and two.shape == (2,) and loop.steps == 6


def test_train_step_keeps_state_without_donation(step_pair):
  _, tcfg, _, params = step_pair
  state = _port_state(params, tcfg)
  before = {n: p.clone() for n, p in state.model.named_parameters()}
  new, _ = sharding.make_train_step(_lm_loss, donate_state=False)(
      state, _step_batches(1)[0])
  assert new is not state and state.step == 0 and new.step == 1
  for n, p in state.model.named_parameters():
    assert torch.equal(p, before[n]), n


class _Feed(object):
  """The DataFeed surface slab_batches reads, over a fixed row array."""

  def __init__(self, rows):
    self.rows, self.pos = rows, 0

  def should_stop(self):
    return self.pos >= len(self.rows)

  def _take(self, n):
    out = self.rows[self.pos:self.pos + n]
    self.pos += n
    return out

  def next_batch_arrays(self, batch_size, dtype=None):
    return self._take(batch_size)

  def next_slab_arrays(self, batch_size, unroll, dtype=None):
    got = self._take(batch_size * unroll)
    if len(got) == batch_size * unroll:
      return Slab(got.reshape(unroll, batch_size, *got.shape[1:]))
    return got


def test_slab_batches_keep_the_per_step_batch_order(monkeypatch):
  rows = np.arange(22 * 3).reshape(22, 3)
  plain = list(feed_batches(_Feed(rows), 4))
  items = list(slab_batches(_Feed(rows), 4, unroll=2))
  assert [type(i).__name__ for i in items] == ["Slab", "Slab", "ndarray",
                                               "ndarray"]
  flat = [b for i in items for b in (i.data if isinstance(i, Slab) else [i])]
  assert len(flat) == len(plain)
  assert all(np.array_equal(a, b) for a, b in zip(flat, plain))
  monkeypatch.setenv("TOS_TRAIN_UNROLL", "junk")
  assert sharding.resolve_unroll() == 1
  monkeypatch.setenv("TOS_TRAIN_UNROLL", "3")
  assert sharding.resolve_unroll() == 3 and sharding.resolve_unroll(2) == 2
  with pytest.raises(ValueError, match=">= 1"):
    sharding.resolve_unroll(0)


def test_unported_training_options_raise():
  """A mesh of another type names item 10c; a mesh with a pipeline axis
  takes the train loop (nothing is cut over it); extra
  batch axes without a mesh are refused; ``exit_layer`` (the
  shallow-exit forward) now runs on a training model: one block's
  logits, held against the JAX model's on the same weights."""
  cfg = tfm.TransformerConfig(dtype=torch.float32, **STEP_CFG)
  state = tfm.create_state(cfg, 0, device="cpu")
  tokens = np.random.default_rng(4).integers(1, 64, size=(2, 8))
  got = state.model(torch.as_tensor(tokens), exit_layer=1)
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False,
                                   attention_impl="dense",
                                   layer_norm_impl="flax", **STEP_CFG)
  want = jax_tfm.Transformer(jcfg).apply(
      {"params": params_to_flax(state.model.numpy_params(), cfg)},
      jnp.asarray(tokens, jnp.int32), exit_layer=1)
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             atol=1e-4, rtol=1e-4)
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  with pytest.raises(NotImplementedError, match="item 10c"):
    sharding.make_train_step(_lm_loss, mesh=object())
  pipe = mesh_lib.Mesh(mesh_lib.CANONICAL_ORDER, dict(
      {a: 1 for a in mesh_lib.CANONICAL_ORDER}, pipeline=2), 0)
  assert sharding.make_train_loop(_lm_loss, pipe, unroll=2).unroll == 2
  with pytest.raises(ValueError, match="without one"):
    sharding.make_train_loop(_lm_loss, batch_extra_axes=("sequence",))


def test_create_state_defaults_to_the_reference_adamw():
  cfg = tfm.TransformerConfig(dtype=torch.float32, **STEP_CFG)
  state = tfm.create_state(cfg, 5, device="cpu", learning_rate=1e-2)
  assert state.model.trainable and state.step == 0
  assert all(p.dtype == torch.float32 and p.requires_grad
             for p in state.params.values())
  twin = tfm.create_state(cfg, 5, device="cpu",
                          tx=optim.adamw(1e-2, weight_decay=0.01))
  tokens = _step_batches(1)[0]
  state, la = sharding.make_train_step(_lm_loss)(state, tokens)
  twin, lb = sharding.make_train_step(_lm_loss)(twin, tokens)
  assert torch.equal(la, lb)
  for (n, a), (_, b) in zip(state.model.named_parameters(),
                            twin.model.named_parameters()):
    assert torch.equal(a, b), n
