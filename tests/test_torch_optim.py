"""The PyTorch port's optimizers against the JAX package's optax recipes.

Identical numpy gradients go into both for five steps; the parameters
must agree to 1e-6 after every step (f32 arithmetic in another order).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import optax
import torch

from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu_torch import optim

SHAPES = {"w": (4, 3), "b": (3,), "e": (5, 2)}
STEPS = 5

# make_optimizer kwargs per case; grads are scaled by "scale" so clipping
# at 1.0 triggers on some steps and not on others
CASES = {
    "adamw_constant": dict(learning_rate=1e-2),
    "adamw_cosine_warmup_clip": dict(learning_rate=1e-2, schedule="cosine",
                                     warmup_steps=2, decay_steps=4,
                                     end_value=1e-3, clip_norm=1.0),
    "adamw_linear_no_mask": dict(learning_rate=1e-2, schedule="linear",
                                 decay_steps=3, decay_mask=None),
    "adamw_no_decay": dict(learning_rate=1e-2, weight_decay=0.0),
    "lion_clip": dict(learning_rate=1e-3, optimizer="lion", clip_norm=1.0,
                      weight_decay=0.1),
    "sgd_nesterov_decay": dict(learning_rate=1e-1, optimizer="sgd",
                               schedule="linear", decay_steps=5),
    "sgd_no_mask": dict(learning_rate=1e-1, optimizer="sgd",
                        decay_mask=None),
    "adamw_accum2_clip": dict(learning_rate=1e-2, grad_accum_steps=2,
                              clip_norm=1.0, warmup_steps=1,
                              schedule="cosine", decay_steps=3),
    "lion_accum3": dict(learning_rate=1e-3, optimizer="lion",
                        grad_accum_steps=3),
}


def _data(seed):
  rng = np.random.default_rng(seed)
  params = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}
  grads = [{n: (rng.standard_normal(s) * (0.2 + i)).astype(np.float32)
            for n, s in SHAPES.items()} for i in range(STEPS)]
  return params, grads


def _run_both(jtx, ttx, seed=0):
  params, grads = _data(seed)
  jp = {n: jnp.asarray(v) for n, v in params.items()}
  jstate = jtx.init(jp)
  tp = {n: torch.tensor(v) for n, v in params.items()}
  tstate = ttx.init(tp)
  for g in grads:
    upd, jstate = jtx.update({n: jnp.asarray(v) for n, v in g.items()},
                             jstate, jp)
    jp = optax.apply_updates(jp, upd)
    tupd, tstate = ttx.update({n: torch.tensor(v) for n, v in g.items()},
                              tstate, tp)
    optim.apply_updates(tp, tupd)
    for n in SHAPES:
      np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), atol=1e-6,
                                 rtol=1e-6, err_msg=n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_optimizer_matches_optax(case):
  kw = CASES[case]
  _run_both(jax_optim.make_optimizer(**kw), optim.make_optimizer(**kw))


def test_create_state_default_adamw_matches_optax():
  # the default transform of create_state: b2 0.999 and NO decay mask
  _run_both(optax.adamw(3e-2, weight_decay=0.01),
            optim.adamw(3e-2, weight_decay=0.01), seed=1)


def test_explicit_mask_dict_matches_optax():
  mask = {"w": True, "b": True, "e": False}
  _run_both(jax_optim.make_optimizer(learning_rate=1e-2, decay_mask=mask),
            optim.make_optimizer(learning_rate=1e-2, decay_mask=mask), seed=2)


@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-3),
    dict(learning_rate=1e-3, schedule="cosine", decay_steps=7,
         end_value=1e-5),
    dict(learning_rate=1e-3, schedule="linear", decay_steps=5,
         warmup_steps=3, end_value=1e-4),
    dict(learning_rate=2e-3, schedule="cosine", decay_steps=4,
         warmup_steps=2)])
def test_schedules_match_optax(kw):
  js = jax_optim.make_schedule(**kw)
  ts = optim.make_schedule(**kw)
  for count in range(14):
    np.testing.assert_allclose(ts(count), float(js(count)), rtol=1e-6,
                               atol=1e-12)


def test_default_decay_mask_and_refusals():
  params = {n: torch.zeros(s) for n, s in SHAPES.items()}
  assert optim.default_decay_mask(params) == {"w": True, "b": False,
                                              "e": True}
  with pytest.raises(ValueError, match="optimizer"):
    optim.make_optimizer(optimizer="adam")
  with pytest.raises(ValueError, match="decay_steps"):
    optim.make_schedule(1e-3, "cosine")


def test_multisteps_emits_every_k():
  tx = optim.make_optimizer(learning_rate=1e-2, grad_accum_steps=3)
  params = {"w": torch.ones(2, 2)}
  state = tx.init(params)
  seen = []
  for _ in range(6):
    upd, state = tx.update({"w": torch.ones(2, 2)}, state, params)
    optim.apply_updates(params, upd)
    seen.append((bool(upd), tx.has_updated(state)))
  assert seen == [(False, False), (False, False), (True, True)] * 2


# -- Adafactor -----------------------------------------------------------------

# factored over their two largest dims ([256, 160], [3, 200, 130], the
# [H, d, D] out kernel) or not (a second largest dim under 128: [160, 12,
# 16], the [D, H, d] q kernel, whose flattened [768, 768] view WOULD
# factor; a vector)
ADAFACTOR_SHAPES = {"m": (256, 160), "t": (3, 200, 130), "s": (160, 12, 16),
                    "v": (130,), "q": (768, 12, 64), "out": (12, 64, 768)}
ADAFACTOR_STEPS = 10
ADAFACTOR_CASES = {
    "defaults": dict(learning_rate=1e-2),
    "clip_decay_accum2": dict(learning_rate=1e-2, clip_norm=1.0,
                              weight_decay=0.1, grad_accum_steps=2,
                              schedule="cosine", warmup_steps=2,
                              decay_steps=4),
}


@pytest.mark.parametrize("case", sorted(ADAFACTOR_CASES))
def test_adafactor_matches_optax(case):
  """Ten updates of the reference's ``make_optimizer(optimizer=
  "adafactor")`` and the port's on the same gradients (the mask decays
  the ndim >= 2 parameters only)."""
  kw = dict(ADAFACTOR_CASES[case], optimizer="adafactor")
  jtx, ttx = jax_optim.make_optimizer(**kw), optim.make_optimizer(**kw)
  rng = np.random.default_rng(4)
  params = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in ADAFACTOR_SHAPES.items()}
  jp = {n: jnp.asarray(v) for n, v in params.items()}
  tp = {n: torch.tensor(v) for n, v in params.items()}
  jstate, tstate = jtx.init(jp), ttx.init(tp)
  for i in range(ADAFACTOR_STEPS):
    g = {n: (rng.standard_normal(s) * (0.2 + i)).astype(np.float32)
         for n, s in ADAFACTOR_SHAPES.items()}
    upd, jstate = jtx.update({n: jnp.asarray(v) for n, v in g.items()},
                             jstate, jp)
    jp = optax.apply_updates(jp, upd)
    tupd, tstate = ttx.update({n: torch.tensor(v) for n, v in g.items()},
                              tstate, tp)
    optim.apply_updates(tp, tupd)
    for n in ADAFACTOR_SHAPES:
      np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-5,
                                 atol=1e-6, err_msg="%s step %d" % (n, i))


def test_adafactor_state_has_optax_shapes():
  """Each parameter's second moments have the shapes of optax's
  ``FactoredState``, placeholders included."""
  from optax._src import factorized
  params = {n: torch.zeros(s) for n, s in ADAFACTOR_SHAPES.items()}
  state = optim.scale_by_factored_rms().init(params)
  want = factorized.scale_by_factored_rms().init(
      {n: jnp.zeros(s) for n, s in ADAFACTOR_SHAPES.items()})
  for i, n in enumerate(ADAFACTOR_SHAPES):
    for slot in ("v_row", "v_col", "v"):
      assert tuple(getattr(state, slot)[i].shape) == \
          getattr(want, slot)[n].shape, (n, slot)


@pytest.mark.parametrize("shape", [(128, 128), (200, 128, 300), (127, 4096),
                                   (130, 130, 2), (5,), (4, 128, 4)])
def test_factored_dims_match_optax(shape):
  from optax._src import factorized
  assert optim._factored_dims(shape, 128) == \
      factorized._factored_dims(shape, True, 128)


@pytest.mark.parametrize("optimizer,want", [("adafactor", 76074668),
                                            ("adamw", 800741376)])
def test_state_bytes_at_long_context_widths_match_optax(optimizer, want):
  """The optimizer state of ``chip_smoke.py`` [6n]'s model (the flagship
  with 4 KV heads: 100,092,672 weights), counted on the meta device:
  the tensors of optax's state (``jax.eval_shape``, its scalar counters
  aside, which the port keeps on the host)."""
  import jax
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import collectives
  from tensorflowonspark_tpu_torch.utils.params import param_specs
  specs = param_specs(tfm.TransformerConfig(num_kv_heads=4))
  meta = {n: torch.empty(spec[0], device="meta") for n, spec in specs.items()}
  assert sum(t.numel() for t in meta.values()) == 100092672
  kw = dict(learning_rate=3e-4, clip_norm=1.0, optimizer=optimizer)
  port = sum(t.numel() * t.element_size() for t in
             collectives.tensors_of(optim.make_optimizer(**kw).init(meta)))
  ref = jax.eval_shape(jax_optim.make_optimizer(**kw).init, {
      n: jax.ShapeDtypeStruct(spec[0], jnp.float32)
      for n, spec in specs.items()})
  ref_bytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                  for x in jax.tree_util.tree_leaves(ref) if x.shape)
  assert port == ref_bytes == want
