"""tensorflowonspark_tpu on PyTorch and CUDA (NVIDIA Hopper): the port.

The JAX package ``tensorflowonspark_tpu`` is the reference; this package
sits beside it and imports nothing from it (nor JAX, flax or optax). Each Pallas
kernel on a ported path becomes a kernel written by hand for Hopper
(``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use), with its
plain PyTorch version beside it for the CPU.

Two slices are ported, serving and single-card training of the flagship
Transformer, in these modules:

* :mod:`.ops` — LayerNorm and flash attention, forward and backward;
* :mod:`.models.transformer` — the model (serving weights, or f32 master
  weights for training), its KV-cache decode, ``greedy_generate_kv``, the
  LM losses and ``create_state``;
* :mod:`.serving` — the continuous-batching ``ServingEngine``;
* :mod:`.optim`, :mod:`.train_state`, :mod:`.parallel.sharding` and
  :mod:`.data.readers` — the optimizers, the train state, the train step
  and the fused K-step loop on one card, and its slabs;
* :mod:`.utils.params` — weights from (and back to) a flax tree, or from
  a seed.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
