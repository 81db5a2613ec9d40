"""MNIST embarrassingly parallel inference with the barrier runner.

The port of the JAX package's ``examples/mnist/
mnist_parallel_inference.py`` (TFParallel.run): independent single-node
instances, gang-scheduled, each scoring its own shard — no cluster, no
feed plane.

  python -m tensorflowonspark_tpu_torch.examples.mnist_parallel_inference \\
      --executors 2

``--device cpu`` runs on the CPU (tests); without it each task claims
its card share (``chips_per_node=1``) and runs there.
"""

import argparse
import sys


def infer_fn(args, ctx):
  """Fit the MLP briefly on this task's shard and score it."""
  from tensorflowonspark_tpu_torch.models import mnist

  # each task scores its own shard (sharded by task id among gang size)
  n = max(1, len(ctx.cluster_spec.get("worker", [1])))
  images, labels = mnist.synthetic_dataset(args.num_samples,
                                           seed=args.seed)
  images, labels = images[ctx.task_index::n], labels[ctx.task_index::n]
  state = mnist.create_state(0, device=args.device)
  for _ in range(args.warm_steps):  # quick fit so predictions are sane
    state, _ = mnist.train_step(state, images[:64], labels[:64])
  _, acc = mnist.eval_step(state, images, labels)
  return {"task": ctx.task_index, "rows": int(len(images)),
          "accuracy": float(acc)}


def parse_args(argv=None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--executors", type=int, default=2)
  parser.add_argument("--num_samples", type=int, default=1024)
  parser.add_argument("--warm_steps", type=int, default=60)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--no_barrier", action="store_true")
  parser.add_argument("--device", default=None,
                      help="'cpu' for PyTorch on the CPU (default: the "
                           "card)")
  return parser.parse_args(argv)


def run(args) -> list:
  from tensorflowonspark_tpu_torch.engine import LocalEngine
  from tensorflowonspark_tpu_torch.parallel import runner

  engine = LocalEngine(num_executors=args.executors)
  try:
    results = runner.run(engine, infer_fn, tf_args=args,
                         num_tasks=args.executors,
                         use_barrier=not args.no_barrier,
                         chips_per_node=0 if args.device == "cpu" else 1)
    for r in sorted(results, key=lambda r: r["task"]):
      print("task %d: %d rows, accuracy %.3f"
            % (r["task"], r["rows"], r["accuracy"]))
  finally:
    engine.stop()
  return results


def main(argv=None) -> int:
  run(parse_args(argv))
  return 0


if __name__ == "__main__":
  sys.exit(main())
