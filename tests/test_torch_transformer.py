"""The PyTorch port's Transformer against the JAX package's, on the CPU.

The JAX model runs with ``attention_impl="flash"`` and
``layer_norm_impl="fused"`` (its Pallas kernels in interpret mode); its
params from ``create_state`` are carried across with ``params_from_flax``.
The port runs on the CPU, where its ops take their plain versions.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu.serving import slots as jax_slots
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.serving import slots
from tensorflowonspark_tpu_torch.utils.params import (init_params,
                                                      params_from_flax)

SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             d_model=32, d_ff=64, max_seq_len=64)


def _configs(**kw):
  kw = dict(SMALL, **kw)
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False,
                                   attention_impl="flash",
                                   layer_norm_impl="fused", **kw)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, **kw)
  return jcfg, tcfg


def _pair(window=0):
  jcfg, tcfg = _configs(attention_window=window)
  state = jax_tfm.create_state(jax.random.PRNGKey(0), jcfg, seq_len=16)
  params = jax.tree.map(np.asarray, state.params)
  model = tfm.Transformer(tcfg, params_from_flax(params, tcfg), device="cpu")
  return jcfg, params, model


@pytest.fixture(scope="module")
def full_causal():
  return _pair()


@pytest.fixture(scope="module")
def windowed():
  return _pair(window=8)


def test_logits_match_jax(full_causal):
  jcfg, params, model = full_causal
  tokens = np.random.default_rng(0).integers(0, 64, size=(2, 32))
  want = jax_tfm.Transformer(jcfg).apply({"params": params},
                                         jnp.asarray(tokens, jnp.int32))
  with torch.inference_mode():
    got = model(torch.from_numpy(tokens))
  assert got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                             rtol=1e-4)


@pytest.mark.parametrize("plen", [32, 37])
@pytest.mark.parametrize("which", ["full_causal", "windowed"])
def test_greedy_generate_kv_tokens_equal_jax(request, which, plen):
  jcfg, params, model = request.getfixturevalue(which)
  prompt = np.random.default_rng(plen).integers(1, 64, size=(1, plen))
  want = np.asarray(jax_tfm.greedy_generate_kv(
      params, jcfg, jnp.asarray(prompt, jnp.int32), 8))
  got = tfm.greedy_generate_kv(model, prompt, 8).numpy()
  np.testing.assert_array_equal(got, want)


def test_params_from_flax_refuses_mismatched_trees(full_causal):
  _, params, _ = full_causal
  _, tcfg = _configs(fuse_qkv=True)
  with pytest.raises(KeyError, match="qkv"):
    params_from_flax(params, tcfg)
  _, wide = _configs(d_ff=128)
  with pytest.raises(ValueError, match="shape"):
    params_from_flax(params, wide)


def test_init_params_laws():
  _, tcfg = _configs()
  p = init_params(tcfg, seed=3)
  assert p["embed.embedding"].shape == (64, 32)
  assert abs(float(p["embed.embedding"].std()) - 0.02) < 0.005
  assert (p["layers.1.ln2.scale"] == 1).all()
  up = p["layers.0.mlp.up"]
  assert np.abs(up).max() <= 2.0 / np.sqrt(32) / 0.8796 + 1e-6
  np.testing.assert_array_equal(init_params(tcfg, seed=3)["layers.0.attn.q"],
                                p["layers.0.attn.q"])


# -- the reference's guards, carried into the port --------------------------

INVALID_CONFIGS = {
    "attention_impl": dict(attention_impl="bogus"),
    "layer_norm_impl": dict(layer_norm_impl="bogus"),
    "num_kv_heads_negative": dict(num_kv_heads=-1),
    "num_kv_heads_divides": dict(num_kv_heads=5),
    "attention_window": dict(attention_window=-1),
    "embed_lookup": dict(embed_lookup="bogus"),
    "ln_matmul_impl": dict(ln_matmul_impl="bogus"),
    "act_matmul_impl": dict(act_matmul_impl="bogus"),
    "remat_policy": dict(remat_policy="bogus"),
    "kv_cache_dtype": dict(kv_cache_dtype="int4"),
    "moe_every": dict(moe_experts=2, moe_every=0),
    "kv_pages": dict(kv_page_size=4, kv_num_pages=1, kv_pages_per_slot=1),
}


@pytest.mark.parametrize("case", sorted(INVALID_CONFIGS))
def test_config_validation_matches_jax(case):
  kw = INVALID_CONFIGS[case]
  with pytest.raises(ValueError):
    jax_tfm.TransformerConfig(**kw)
  with pytest.raises(ValueError):
    tfm.TransformerConfig(**kw)


@pytest.mark.parametrize("kw,item", [
    pytest.param(kw, item, id=next(iter(kw))) for kw, item in (
        (dict(kv_cache_dtype="int8"), None),
        (dict(kv_page_size=4, kv_num_pages=8, kv_pages_per_slot=2), None),
        (dict(moe_experts=2), None),
        (dict(use_ring_attention=True), None),
        (dict(attention_impl="dense"), "item 11"),
        (dict(layer_norm_impl="flax"), "item 11"))])
def test_unported_options_raise(kw, item):
  """The options the port still refuses name their ROADMAP item; the
  decode-speed layouts (int8 and paged KV), ring attention and MoE
  layers build in both packages."""
  jax_tfm.TransformerConfig(**kw)            # valid for the reference
  if item is None:
    cfg = tfm.TransformerConfig(**kw)
    assert all(getattr(cfg, key) == value for key, value in kw.items())
    return
  with pytest.raises(NotImplementedError, match="ROADMAP .*%s" % item):
    tfm.TransformerConfig(**kw)


def test_generate_guards_match_jax(full_causal):
  jcfg, params, model = full_causal
  prompt = np.ones((1, 60), np.int64)
  with pytest.raises(ValueError, match="exceeds"):
    jax_tfm.greedy_generate_kv(params, jcfg, jnp.asarray(prompt), 8)
  with pytest.raises(ValueError, match="exceeds"):
    tfm.greedy_generate_kv(model, prompt, 8)
  short = prompt[:, :4]
  with pytest.raises(ValueError, match="must differ"):
    jax_tfm.greedy_generate_kv(params, jcfg, jnp.asarray(short), 2,
                               eos_id=0, pad_id=0)
  with pytest.raises(ValueError, match="must differ"):
    tfm.greedy_generate_kv(model, short, 2, eos_id=0, pad_id=0)
  # sampling needs an explicit source of randomness in both packages
  with pytest.raises(ValueError, match="explicit"):
    jax_tfm.greedy_generate_kv(params, jcfg, jnp.asarray(short), 2,
                               temperature=0.7)
  with pytest.raises(ValueError, match="explicit"):
    tfm.greedy_generate_kv(model, short, 2, temperature=0.7)


def test_prefill_decode_room_guard_matches_jax(full_causal):
  jcfg, params, model = full_causal
  prompt = np.ones(64, np.int32)              # = max_seq_len: no room left
  with pytest.raises(ValueError, match="no decode room"):
    jax_slots.SlotDecoder(jcfg, 1).prefill(params, prompt)
  with pytest.raises(ValueError, match="no decode room"):
    slots.SlotDecoder(model, 1).prefill(prompt)


def test_chunk_plan_matches_jax():
  for n in (1, 2, 37, 600, 1023):
    assert slots.chunk_plan(n) == jax_slots.chunk_plan(n)
  assert slots.chunk_plan(37, (128, 32, 8, 4, 2, 1)) == [32, 4, 1]


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
  if torch.cuda.is_available():
    pytest.skip("a card is present: device=None would use it")
  _, tcfg = _configs()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    tfm.Transformer(tcfg, init_params(tcfg, seed=0))
