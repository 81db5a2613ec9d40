"""tensorflowonspark_tpu on PyTorch and CUDA (NVIDIA Hopper): the port.

The JAX package ``tensorflowonspark_tpu`` is the reference; this package
sits beside it and imports nothing from it (nor JAX, flax or optax). Each Pallas
kernel on a ported path becomes a kernel written by hand for Hopper
(``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use), with its
plain PyTorch version beside it for the CPU.

Serving, single-card training (unfused, all-fused, and long-context
grouped-KV from TFRecord files) of the flagship Transformer, the cluster
runtime in InputMode.TENSORFLOW and its engine feed plane
(InputMode.SPARK), checkpointing, data parallelism across processes and
the pipeline layer are ported, in these modules:

* :mod:`.ops` — LayerNorm, flash attention (forward, and the fused and
  split backward plans), LN->matmul and GELU->matmul;
* :mod:`.models.transformer` — the model (serving weights, or f32 master
  weights for training), its KV-cache decode, ``greedy_generate_kv``, the
  LM losses and ``create_state``;
* :mod:`.serving` — the continuous-batching ``ServingEngine``;
* :mod:`.optim`, :mod:`.train_state` and :mod:`.parallel.sharding` —
  the optimizers, the train state, the train step and the fused K-step
  loop on one card;
* :mod:`.data` — TFRecord files, tf.Example rows, the FILES-mode reader
  pipeline, slabs and ``device_prefetch``;
* :mod:`.examples.train_gpt` — the long-context training entry point;
* :mod:`.utils.params` — weights from (and back to) a flax tree, or from
  a seed;
* :mod:`.cluster`, :mod:`.node`, :mod:`.control`, :mod:`.engine`,
  :mod:`.obs` and :mod:`.utils.gpu_info` — ``cluster.run`` brings up
  ``LocalEngine`` executors through the rendezvous, gives each node its
  CUDA cards and runs the user's ``main_fn(args, ctx)`` on it;
* :mod:`.datafeed` and :mod:`.control.shmring` — ``Cluster.train`` /
  ``inference`` feed partitions to the nodes over a shared-memory ring or
  the hub's queues, and ``ctx.get_data_feed()`` reads them as batches;
* :mod:`.pipeline`, :mod:`.parallel.runner`, :mod:`.inference_cli`,
  :mod:`.data.dfutil` and :mod:`.models.mnist` — ``TFEstimator.fit`` /
  ``export_bundle`` / ``TFModel.transform`` (serving bundles from
  ``models.transformer.make_serving_predict_fn``), the TFParallel
  runner, the batch-inference CLI, the TFRecord <-> rows converter, and
  the MNIST models of the examples.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
