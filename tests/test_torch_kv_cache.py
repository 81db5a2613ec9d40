"""The port's decode-speed cache layouts against the JAX package's, on the CPU.

One seeded JAX state, carried across with ``params_from_flax``, in f32:

- the int8 cache: its leaf dtypes, its prefill logits within the
  reference's envelope of the model-dtype cache (atol and rtol 0.15), and
  its decode logits equal to the JAX package's within 1e-4;
- multi-token writes at per-row cursors, on the model-dtype, int8 and
  paged caches, with a window that overshoots ``max_seq_len`` (dropped in
  both packages, never clamped over live entries): logits within 1e-4 and
  the caches' live entries equal;
- ``exit_layer``, with and without a cache, and its bounds;
- ``speculative_generate_kv``: tokens equal to the port's and to JAX's
  ``greedy_generate_kv`` for a self-draft, an unrelated draft and an int8
  target, and the reference's guards.

No difference of one int8 step at a rounding tie showed at these seeds;
the 1e-4 bound would name one if it did.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.tree_util import tree_map_with_path

from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.utils.params import (init_params,
                                                      params_from_flax)

SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             d_model=32, d_ff=64, max_seq_len=64)
# row 0 takes 16 pages (its whole span), row 1 takes 8; page 0 is trash
PAGED = dict(kv_page_size=4, kv_num_pages=25, kv_pages_per_slot=16)
TOL = dict(atol=1e-4, rtol=1e-4)


def _configs(kernels=False, **kw):
  """The JAX config runs its Pallas kernels (interpret mode) where the
  comparison reaches a fresh-cache prefill of an int8 cache, whose flash
  attends the raw projections where dense attention would attend the
  quantized cache; elsewhere its plain attention and LayerNorm."""
  kw = dict(SMALL, **kw)
  impl = dict(attention_impl="flash", layer_norm_impl="fused") if kernels \
      else dict(attention_impl="dense", layer_norm_impl="flax")
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False,
                                   **impl, **kw)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, **kw)
  return jcfg, tcfg


@pytest.fixture(scope="module")
def params():
  jcfg, _ = _configs()
  state = jax_tfm.create_state(jax.random.PRNGKey(4), jcfg, seq_len=16)
  return jax.tree.map(np.asarray, state.params)


def _port(params, **kw):
  jcfg, tcfg = _configs(kernels=kw.get("kv_cache_dtype") == "int8", **kw)
  return jcfg, tfm.Transformer(tcfg, params_from_flax(params, tcfg),
                               device="cpu")


def _set_leaves(cache, **values):
  """Set the JAX cache's ``index`` / ``page_table`` leaves of every layer."""
  def f(path, leaf):
    key = getattr(path[-1], "key", None) if path else None
    if key in values:
      return jnp.asarray(values[key], leaf.dtype)
    return leaf
  return tree_map_with_path(f, cache)


def _jax_leaves(cache, name):
  """The JAX cache's ``name`` leaves, one per layer, as numpy."""
  out = []

  def f(path, leaf):
    if path and getattr(path[-1], "key", None) == name:
      out.append(np.asarray(leaf))
    return leaf
  tree_map_with_path(f, cache)
  return out


@functools.lru_cache(maxsize=None)
def _jax_decode(jmodel, exit_layer):
  """One jitted decode call of the JAX model (one compile per shape)."""
  return jax.jit(lambda p, c, t: jmodel.apply(
      {"params": p, "cache": c}, t, decode=True, mutable=["cache"],
      exit_layer=exit_layer))


class _Pair(object):
  """One decode state in both packages, advanced call by call."""

  def __init__(self, params, jcfg, model, batch):
    self.params, self.model = params, model
    self.jmodel = jax_tfm.Transformer(jcfg)
    self.jcache = jax_tfm._zero_cache(self.jmodel, batch)
    self.cache = model.init_cache(batch)

  def set(self, index=None, page_table=None):
    vals = {k: v for k, v in (("index", index), ("page_table", page_table))
            if v is not None}
    self.jcache = _set_leaves(self.jcache, **vals)
    if index is not None:
      self.cache.index = index if np.ndim(index) == 0 \
          else torch.as_tensor(np.asarray(index), dtype=torch.long)
    if page_table is not None:
      self.cache.page_table = torch.as_tensor(np.asarray(page_table),
                                              dtype=torch.long)

  def step(self, tokens, exit_layer=None):
    want, mut = _jax_decode(self.jmodel, exit_layer)(
        self.params, self.jcache, jnp.asarray(tokens, jnp.int32))
    self.jcache = mut["cache"]
    with torch.inference_mode():
      got = self.model(torch.as_tensor(np.asarray(tokens)), self.cache,
                       exit_layer=exit_layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return got


def test_int8_cache_leaves_and_prefill_envelope(params):
  jcfg8, model8 = _port(params, kv_cache_dtype="int8")
  _, model = _port(params)
  cache8 = model8.init_cache(2)
  assert {t.dtype for t in cache8.k + cache8.v} == {torch.int8}
  assert {t.dtype for t in cache8.k_scale + cache8.v_scale} == \
      {torch.float32}
  assert cache8.k_scale[0].shape == (2, 64, 2)
  jleaves = jax.tree.leaves(jax_tfm._zero_cache(jax_tfm.Transformer(jcfg8),
                                                2))
  assert {np.dtype(x.dtype) for x in jleaves} >= {np.dtype(np.int8),
                                                  np.dtype(np.float32)}
  prompt = torch.as_tensor(np.random.RandomState(7).randint(0, 64, (2, 16)))
  with torch.inference_mode():
    got8 = model8(prompt, model8.init_cache(2))
    got = model(prompt, model.init_cache(2))
  np.testing.assert_allclose(got8.numpy(), got.numpy(), atol=0.15, rtol=0.15)


def test_int8_decode_logits_match_jax(params):
  """Prefill (flash, the raw projections), a chunk at cursor 16 and
  single steps (dense over the int8 cache, scales on the scores and the
  probs), and the quantized cache itself, equal to the reference's."""
  jcfg, model = _port(params, kv_cache_dtype="int8")
  pair = _Pair(params, jcfg, model, 2)
  rng = np.random.RandomState(11)
  pair.step(rng.randint(0, 64, (2, 16)))
  pair.step(rng.randint(0, 64, (2, 5)))
  for _ in range(3):
    pair.step(rng.randint(0, 64, (2, 1)))
  for name, got in (("cached_k", pair.cache.k), ("k_scale",
                                                 pair.cache.k_scale)):
    for want, have in zip(_jax_leaves(pair.jcache, name), got):
      np.testing.assert_allclose(have.float().numpy(), want.astype(
          np.float32), atol=1e-6 if name == "k_scale" else 0)


@pytest.mark.parametrize("layout", ["model", "int8", "paged"])
def test_per_row_windows_match_jax(params, layout):
  """Vector cursors on every layout: a multi-token window at per-row
  cursors, single steps, a rollback, and a window whose end overshoots
  ``max_seq_len`` on row 0 (its overflow dropped: the live entries below
  the cursor keep their values in both packages)."""
  kw = {"model": {}, "int8": dict(kv_cache_dtype="int8"),
        "paged": PAGED}[layout]
  jcfg, model = _port(params, **kw)
  pair = _Pair(params, jcfg, model, 2)
  rng = np.random.RandomState(13)
  if layout == "paged":
    table = np.zeros((2, 16), np.int64)
    table[0] = np.arange(1, 17)
    table[1, :8] = np.arange(17, 25)
    pair.set(page_table=table)
  else:
    pair.set(index=np.zeros(2))
  pair.step(rng.randint(0, 64, (2, 12)))
  pair.set(index=np.asarray([12, 9]))
  pair.step(rng.randint(0, 64, (2, 3)))
  pair.step(rng.randint(0, 64, (2, 1)))
  pair.step(rng.randint(0, 64, (2, 1)))
  pair.set(index=np.asarray([61, 3]))           # row 0: 61, 62, 63, (64)
  pair.step(rng.randint(0, 64, (2, 4)))
  pair.set(index=np.asarray([20, 5]))           # the rollback
  pair.step(rng.randint(0, 64, (2, 2)))
  if layout == "paged":
    for want, have in zip(_jax_leaves(pair.jcache, "pages_k"), pair.cache.k):
      # page 0 is trash: duplicate writes leave either package's winner
      np.testing.assert_allclose(have.numpy()[1:], want[1:], **TOL)
  else:
    for want, have in zip(_jax_leaves(pair.jcache, "cached_k"), pair.cache.k):
      np.testing.assert_allclose(have.float().numpy(),
                                 want.astype(np.float32),
                                 atol=0 if layout == "int8" else 1e-4)


def test_exit_layer_matches_jax_and_is_bounded(params):
  jcfg, model = _port(params)
  tokens = np.random.RandomState(17).randint(0, 64, (2, 12))
  want = jax_tfm.Transformer(jcfg).apply(
      {"params": params}, jnp.asarray(tokens, jnp.int32), exit_layer=1)
  with torch.inference_mode():
    got = model(torch.as_tensor(tokens), exit_layer=1)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
  # a shallow step advances only the visited layers' cursors in the
  # reference and the one shared cursor in the port: the drafting caller
  # rolls it back, as here, and both packages agree again
  pair = _Pair(params, jcfg, model, 2)
  pair.step(tokens)
  pair.step(tokens[:, :3], exit_layer=1)
  pair.set(index=12)
  pair.step(tokens[:, 3:5], exit_layer=2)
  for bad in (0, 3):
    with pytest.raises(ValueError, match="exit_layer"):
      jax_tfm.Transformer(jcfg).apply({"params": params},
                                      jnp.asarray(tokens, jnp.int32),
                                      exit_layer=bad)
    with pytest.raises(ValueError, match="exit_layer"):
      model(torch.as_tensor(tokens), exit_layer=bad)


def _draft(seed):
  dj, dcfg = _configs(num_layers=1)
  state = jax_tfm.create_state(jax.random.PRNGKey(seed), dj, seq_len=8)
  return tfm.Transformer(dcfg, params_from_flax(
      jax.tree.map(np.asarray, state.params), dcfg), device="cpu")


@pytest.mark.parametrize("case", ["self_k4", "other_k3", "int8_other_k3"])
def test_speculative_equals_greedy(params, case):
  """Greedy speculative decoding is lossless: whatever the draft
  proposes (the target itself: full acceptance; an unrelated 1-layer
  model: mostly rejections, through the bonus and rollback paths), the
  tokens are the target's greedy decode in both packages."""
  kw = dict(kv_cache_dtype="int8") if case.startswith("int8") else {}
  jcfg, model = _port(params, **kw)
  draft, k = (model, 4) if case == "self_k4" else (_draft(9), 3)
  prompt = np.random.RandomState(2).randint(0, 64, (2, 8))
  want = np.asarray(jax_tfm.greedy_generate_kv(
      params, jcfg, jnp.asarray(prompt, jnp.int32), 12))
  got = tfm.speculative_generate_kv(draft, model, prompt, 12, draft_k=k)
  np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(
      got.numpy(), tfm.greedy_generate_kv(model, prompt, 12).numpy())


def test_speculative_guards_match_jax(params):
  jcfg, model = _port(params)
  jd, dcfg = _configs(vocab_size=32)
  other = tfm.Transformer(dcfg, init_params(dcfg, seed=0), device="cpu")
  prompt = np.ones((1, 8), np.int64)
  jp = jnp.asarray(prompt, jnp.int32)
  cases = [
      ("share a vocabulary", (None, jd, params, jcfg, jp, 4),
       (other, model, prompt, 4), {}),
      ("draft_k", (params, jcfg, params, jcfg, jp, 4),
       (model, model, prompt, 4), dict(draft_k=0)),
      ("max_seq_len", (params, jcfg, params, jcfg, jp, 54),
       (model, model, prompt, 54), dict(draft_k=4)),
  ]
  for match, jargs, targs, kw in cases:
    with pytest.raises(ValueError, match=match):
      jax_tfm.speculative_generate_kv(*jargs, **kw)
    with pytest.raises(ValueError, match=match):
      tfm.speculative_generate_kv(*targs, **kw)
