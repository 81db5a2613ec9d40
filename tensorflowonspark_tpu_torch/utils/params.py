"""Transformer weights for the port: carried across from a flax tree, or
made from a seed.

Both functions return the same flat ``{name: float32 ndarray}`` dict,
keyed by the port's parameter names (``Transformer.named_parameters``);
:func:`params_to_flax` carries such a dict back to a flax tree:

=============================  ======================  ==================
port name                      flax path               shape
=============================  ======================  ==================
``embed.embedding``            embed/embedding         [V, D]
``layers.i.ln1.scale``         layer_i/ln1/scale       [D]
``layers.i.attn.q``            layer_i/attn/q/kernel   [D, H, d]
``layers.i.attn.k`` / ``v``    layer_i/attn/k|v/kernel [D, Hk, d]
``layers.i.attn.qkv``          layer_i/attn/qkv/kernel [D, H + 2Hk, d]
``layers.i.attn.out``          layer_i/attn/out/kernel [H, d, D]
``layers.i.ln2.scale``         layer_i/ln2/scale       [D]
``layers.i.mlp.up``            layer_i/mlp/up/kernel   [D, F]
``layers.i.mlp.down``          layer_i/mlp/down/kernel [F, D]
``layers.i.moe.w_gate``        layer_i/moe/w_gate      [D, E]
``layers.i.moe.w_up``          layer_i/moe/w_up        [E, D, F]
``layers.i.moe.w_down``        layer_i/moe/w_down      [E, F, D]
``ln_f.scale``                 ln_f/scale              [D]
=============================  ======================  ==================

(``qkv`` replaces ``q``/``k``/``v`` when ``cfg.fuse_qkv``; with
``cfg.moe_experts`` > 0 the MoE layers, those with ``i % moe_every ==
moe_every - 1``, hold ``moe`` instead of ``mlp``.) The flax tree
arrives as nested dicts of numpy arrays — a caller holding JAX params
passes ``jax.tree.map(np.asarray, params)`` — and leaves as one, so this
module never sees a JAX type.
"""

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# flax's lecun_normal: truncated normal on [-2, 2] rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def is_moe_layer(cfg, i: int) -> bool:
  """Whether layer ``i`` routes through experts: every ``moe_every``-th
  layer when ``moe_experts`` > 0, as the reference picks them."""
  return cfg.moe_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1


def param_specs(cfg) -> Dict[str, Tuple[Tuple[int, ...], str, int]]:
  """``{name: (shape, init law, fan_in)}`` for every parameter of a
  Transformer built from ``cfg``. Laws: ``lecun`` (truncated normal,
  std 1/sqrt(fan_in)), ``embed`` (normal 0.02), ``ones``. flax's
  ``lecun_normal`` counts a stacked expert leaf's leading dimension as
  its receptive field, so ``w_up`` [E, D, F] draws at fan-in E * D and
  ``w_down`` [E, F, D] at E * F."""
  d_model, h, hk, d = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.head_dim
  specs = {"embed.embedding": ((cfg.vocab_size, d_model), "embed", 0)}
  for i in range(cfg.num_layers):
    p = "layers.%d." % i
    specs[p + "ln1.scale"] = ((d_model,), "ones", 0)
    if cfg.fuse_qkv:
      specs[p + "attn.qkv"] = ((d_model, h + 2 * hk, d), "lecun", d_model)
    else:
      specs[p + "attn.q"] = ((d_model, h, d), "lecun", d_model)
      specs[p + "attn.k"] = ((d_model, hk, d), "lecun", d_model)
      specs[p + "attn.v"] = ((d_model, hk, d), "lecun", d_model)
    specs[p + "attn.out"] = ((h, d, d_model), "lecun", h * d)
    specs[p + "ln2.scale"] = ((d_model,), "ones", 0)
    if is_moe_layer(cfg, i):
      e, f = cfg.moe_experts, cfg.d_ff
      specs[p + "moe.w_gate"] = ((d_model, e), "lecun", d_model)
      specs[p + "moe.w_up"] = ((e, d_model, f), "lecun", e * d_model)
      specs[p + "moe.w_down"] = ((e, f, d_model), "lecun", e * f)
    else:
      specs[p + "mlp.up"] = ((d_model, cfg.d_ff), "lecun", d_model)
      specs[p + "mlp.down"] = ((cfg.d_ff, d_model), "lecun", cfg.d_ff)
  specs["ln_f.scale"] = ((d_model,), "ones", 0)
  return specs


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
  z = rng.standard_normal(shape, dtype=np.float32)
  bad = np.abs(z) > 2.0
  while bad.any():
    z[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
    bad = np.abs(z) > 2.0
  return z


def lecun_normal(rng: np.random.Generator, shape, fan_in: int) -> np.ndarray:
  """flax's ``lecun_normal`` law drawn with numpy: a truncated normal of
  std ``1 / sqrt(fan_in)``."""
  std = np.float32(np.sqrt(1.0 / fan_in) / _TRUNC_STD)
  return _truncated_normal(rng, shape) * std


def copy_into(own: Mapping[str, torch.Tensor],
              params: Mapping[str, Any]) -> None:
  """Copy a flat weight dict (numpy arrays or tensors) into a module's
  ``named_parameters`` ``own``, each cast to its parameter's dtype; a
  tensor is copied as it is (numpy has no bfloat16). Raises on a missing
  or unexpected name or a shape that disagrees."""
  missing = sorted(set(own) - set(params))
  extra = sorted(set(params) - set(own))
  if missing or extra:
    raise KeyError("weights do not match the model: missing %s, "
                   "unexpected %s" % (missing[:4], extra[:4]))
  with torch.no_grad():
    for name, p in own.items():
      src = params[name]
      src = src.detach() if torch.is_tensor(src) else \
          torch.tensor(np.asarray(src))
      if tuple(src.shape) != tuple(p.shape):
        raise ValueError("%s: shape %s, model expects %s"
                         % (name, tuple(src.shape), tuple(p.shape)))
      p.copy_(src.to(p.dtype))


def init_params(cfg, seed: int) -> Dict[str, np.ndarray]:
  """Random float32 weights with the flax model's shapes and init laws,
  from ``seed`` — so the port runs at full width with no JAX present.
  (The numbers differ from flax's own init: numpy and JAX draw
  differently from the same seed.)"""
  rng = np.random.default_rng(seed)
  out = {}
  for name, (shape, law, fan_in) in param_specs(cfg).items():
    if law == "ones":
      out[name] = np.ones(shape, np.float32)
    elif law == "embed":
      out[name] = rng.standard_normal(shape, dtype=np.float32) * \
          np.float32(0.02)
    else:
      out[name] = lecun_normal(rng, shape, fan_in)
  return out


def _flax_path(name: str) -> Tuple[str, ...]:
  """``layers.3.attn.q`` -> ``("layer_3", "attn", "q", "kernel")``."""
  parts = name.split(".")
  if parts[0] == "layers":
    parts = ["layer_" + parts[1]] + parts[2:]
  if parts[-1] not in ("scale", "embedding", "w_gate", "w_up", "w_down"):
    parts.append("kernel")
  return tuple(parts)


def params_from_flax(tree: Mapping, cfg) -> Dict[str, np.ndarray]:
  """Carry a flax Transformer param tree (nested dicts of numpy arrays)
  across to the port's flat names. Raises on a missing leaf or a shape
  that disagrees with ``cfg``."""
  out = {}
  for name, (shape, _, _) in param_specs(cfg).items():
    node = tree
    path = _flax_path(name)
    for key in path:
      if not isinstance(node, Mapping) or key not in node:
        raise KeyError("flax param tree has no %s" % "/".join(path))
      node = node[key]
    arr = np.asarray(node, np.float32)
    if arr.shape != shape:
      raise ValueError("%s has shape %s, cfg expects %s"
                       % ("/".join(path), arr.shape, shape))
    out[name] = arr
  return out


def params_to_flax(params: Mapping[str, np.ndarray], cfg) -> Dict:
  """The inverse of :func:`params_from_flax`: a flat weight dict (e.g.
  ``Transformer.numpy_params()``) as a flax Transformer param tree of
  nested dicts of f32 numpy arrays. Raises on a missing or unexpected
  name, or a shape that disagrees with ``cfg``."""
  specs = param_specs(cfg)
  extra = sorted(set(params) - set(specs))
  if extra:
    raise KeyError("weights the cfg does not have: %s" % extra[:4])
  tree: Dict = {}
  for name, (shape, _, _) in specs.items():
    if name not in params:
      raise KeyError("missing weight %s" % name)
    arr = np.asarray(params[name], np.float32)
    if arr.shape != shape:
      raise ValueError("%s has shape %s, cfg expects %s"
                       % (name, arr.shape, shape))
    path = _flax_path(name)
    node = tree
    for key in path[:-1]:
      node = node.setdefault(key, {})
    node[path[-1]] = arr
  return tree
