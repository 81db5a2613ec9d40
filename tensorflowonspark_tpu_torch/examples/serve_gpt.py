"""Serve a Transformer LM through the pipeline bundle path.

The port of the JAX package's ``examples/transformer/serve_gpt.py``, with
the same flags and defaults: exports a (toy) causal LM as a model bundle
(``make_serving_predict_fn``, weights from a seed), then runs batched
KV-cache decoding over prompt partitions with ``TFModel.transform`` on
LocalEngine executor processes, with ``collect=False`` streaming so the
driver never holds the full output.

  python -m tensorflowonspark_tpu_torch.examples.serve_gpt --steps 8 \\
      --prompts 32

``--tensor N`` above 1 exports the bundle with ``MeshSpec(data=-1,
tensor=N)``: each executor serves over its own serving group of N ranks
or more (``parallel.serving_group``; the ``-1`` absorbs its visible cards
divided by N), started on its first serve and stopped when the executor
exits; on one card the ranks share it over gloo. ``--device cpu`` serves
with the kernels' plain versions on the CPU (tests); without it every
executor serves on the card.
"""

import argparse
import os
import sys
import tempfile

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--steps", type=int, default=8,
                      help="tokens to generate per prompt")
  parser.add_argument("--prompts", type=int, default=32)
  parser.add_argument("--prompt_len", type=int, default=8)
  parser.add_argument("--temperature", type=float, default=0.0)
  parser.add_argument("--export_dir", default=os.path.join(
      tempfile.gettempdir(), "tos_torch_serve_gpt"))
  parser.add_argument("--executors", type=int, default=2)
  parser.add_argument("--tensor", type=int, default=1,
                      help="tensor-parallel degree per executor: the "
                           "bundle's MeshSpec(data=-1, tensor=N)")
  parser.add_argument("--device", default=None,
                      help="'cpu' for the plain versions (default: the "
                           "card)")
  return parser.parse_args(argv)


def run(args) -> list:
  """Export the bundle, serve the prompts; returns the served rows."""
  import torch
  from tensorflowonspark_tpu_torch import pipeline
  from tensorflowonspark_tpu_torch.engine import LocalEngine
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  from tensorflowonspark_tpu_torch.utils.params import init_params

  cfg = tfm.TransformerConfig(vocab_size=256, num_layers=2, num_heads=4,
                              num_kv_heads=2, d_model=128, d_ff=256,
                              max_seq_len=64, remat=False,
                              dtype=torch.bfloat16)
  mesh_spec = None
  if args.tensor > 1:
    mesh_spec = mesh_lib.MeshSpec(data=-1, tensor=args.tensor)
  predict_fn = tfm.make_serving_predict_fn(
      cfg, args.steps, temperature=args.temperature, mesh_spec=mesh_spec,
      device=args.device)
  pipeline.export_bundle(init_params(cfg, seed=0), predict_fn,
                         args.export_dir)
  print("exported bundle to", args.export_dir)

  rng = np.random.RandomState(0)
  prompts = [(rng.randint(0, 256, args.prompt_len).tolist(),)
             for _ in range(args.prompts)]
  partitions = [prompts[i::args.executors] for i in range(args.executors)]

  engine = LocalEngine(num_executors=args.executors)
  served = []
  try:
    model = pipeline.TFModel({"export_dir": args.export_dir,
                              "batch_size": 8})
    for tokens in model.transform(engine, partitions, collect=False):
      if len(served) < 3:
        print("prompt+generation:", tokens)
      served.append(tokens)
  finally:
    engine.stop()
  print("served %d prompts x %d generated tokens each"
        % (len(served), args.steps))
  assert len(served) == args.prompts
  return served


def main(argv=None) -> int:
  run(parse_args(argv))
  return 0


if __name__ == "__main__":
  sys.exit(main())
