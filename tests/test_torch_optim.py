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
  with pytest.raises(NotImplementedError, match="adafactor"):
    optim.make_optimizer(optimizer="adafactor")
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
