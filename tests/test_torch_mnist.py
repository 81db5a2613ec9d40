"""The PyTorch port's ``models/mnist.py`` on the CPU, held against the JAX
package's flax modules in f32: the MLP's and the CNN's logits, one
``train_step`` (loss and updated weights), ``eval_step`` and the
synthetic dataset's draws; and the parallel-inference example through
the port's runner."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu.models import mnist as jax_mnist
from tensorflowonspark_tpu_torch.models import mnist

TOL = 1e-5


def test_synthetic_dataset_is_the_references():
  for seed in (0, 3):
    a = jax_mnist.synthetic_dataset(16, seed=seed)
    b = mnist.synthetic_dataset(16, seed=seed)
    for x, y in zip(a, b):
      assert x.dtype == y.dtype
      np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module", params=["MLP", "CNN"])
def pair(request):
  jmod = getattr(jax_mnist, request.param)(dtype=jnp.float32)
  state = jax_mnist.create_state(jax.random.PRNGKey(0), jmod)
  params = mnist.params_from_flax(jax.tree.map(np.asarray, state.params))
  tmod = getattr(mnist, request.param)(dtype=torch.float32, device="cpu")
  return jmod, state, params, tmod


def test_logits_match_flax(pair):
  jmod, state, params, tmod = pair
  images, _ = mnist.synthetic_dataset(8, seed=1)
  tmod.load_params(params)
  want = np.asarray(jmod.apply({"params": state.params}, images))
  with torch.no_grad():
    got = tmod(images).numpy()
  assert got.dtype == np.float32
  np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _to_flax(flat):
  """The port's flat weights (or gradients) as a flax param tree."""
  tree = {}
  for name, value in flat.items():
    module, leaf = name.split(".")
    arr = np.asarray(value)
    if module.startswith("Conv_") and leaf == "kernel":
      arr = arr.transpose(2, 3, 1, 0)                  # OIHW -> HWIO
    tree.setdefault(module, {})[leaf] = jnp.asarray(arr)
  return tree


def test_one_train_step_matches_optax_adam(pair):
  """One ``train_step``: the loss and every gradient within 1e-5 of
  ``jax.value_and_grad`` of the flax module, and the updated weights
  within 1e-5 of ``optax.adam`` applied to the same gradients. (Adam's
  first step divides each gradient by its own magnitude plus 1e-8, so a
  gradient of ~1e-8 — float32 rounding noise of a sum that cancels —
  moves its weight by a share of the learning rate that the noise
  decides; the step is therefore held on the port's own gradients.)"""
  import optax
  jmod, state, params, tmod = pair
  images, labels = mnist.synthetic_dataset(32, seed=2)
  jloss, jgrads = jax.value_and_grad(
      lambda p: jax_mnist.loss_fn(jmod.apply({"params": p}, images),
                                  labels))(state.params)
  tstate = mnist.create_state(params, tmod)
  names = list(tstate.params)
  loss = mnist.loss_fn(tstate.model(images), labels)
  value = float(loss.detach())
  grads = dict(zip(names, (g.numpy() for g in torch.autograd.grad(
      loss, list(tstate.params.values())))))
  np.testing.assert_allclose(value, float(jloss), atol=TOL, rtol=0)
  want_g = mnist.params_from_flax(jax.tree.map(np.asarray, jgrads))
  for name in names:
    np.testing.assert_allclose(grads[name], want_g[name], atol=TOL, rtol=0,
                               err_msg=name)
  tx = optax.adam(1e-3)
  updates, _ = tx.update(_to_flax(grads), tx.init(state.params),
                         state.params)
  want = mnist.params_from_flax(jax.tree.map(
      np.asarray, optax.apply_updates(state.params, updates)))
  tstate, step_loss = mnist.train_step(tstate, images, labels)
  assert tstate.step == 1 and float(step_loss) == value
  got = {n: p.detach().numpy() for n, p in tstate.model.named_parameters()}
  assert sorted(got) == sorted(want)
  for name in want:
    np.testing.assert_allclose(got[name], want[name], atol=TOL, rtol=0,
                               err_msg=name)
  new, _ = jax_mnist.train_step(state, images, labels)
  jl, jacc = jax_mnist.eval_step(new, images, labels)
  tl, tacc = mnist.eval_step(tstate, images, labels)
  np.testing.assert_allclose(float(tl), float(jl), atol=TOL, rtol=0)
  assert float(tacc) == pytest.approx(float(jacc))


def test_bf16_compute_over_f32_weights():
  model = mnist.CNN(device="cpu")
  model.load_params(mnist.init_params(model, 0))
  assert {p.dtype for p in model.parameters()} == {torch.float32}
  images, _ = mnist.synthetic_dataset(2)
  with torch.no_grad():
    out = model(images)
  assert out.dtype == torch.float32 and out.shape == (2, 10)
  with pytest.raises(KeyError, match="do not match"):
    model.load_params({"Dense_0.kernel": np.zeros((3136, 256))})


def test_parallel_inference_example_through_the_runner():
  """``examples/mnist_parallel_inference.py`` at a small size: two
  gang-scheduled tasks, each scoring its own shard."""
  from tensorflowonspark_tpu_torch.examples import mnist_parallel_inference
  results = mnist_parallel_inference.run(mnist_parallel_inference.parse_args(
      ["--device", "cpu", "--num_samples", "128", "--warm_steps", "20"]))
  assert sorted(r["task"] for r in results) == [0, 1]
  assert sum(r["rows"] for r in results) == 128
  assert min(r["accuracy"] for r in results) > 0.9
