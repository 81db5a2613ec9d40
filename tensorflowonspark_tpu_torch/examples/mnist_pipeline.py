"""MNIST through the Estimator/Model pipeline API.

The port of the JAX package's ``examples/mnist/mnist_pipeline.py``:
``TFEstimator.fit`` trains the MLP on a cluster fed by the engine
(InputMode.SPARK), the chief exports a bundle, and ``TFModel.transform``
runs batch inference on each executor. The train fn and the predict fn
are module-level, because the port pickles them by name.

  python -m tensorflowonspark_tpu_torch.examples.mnist_pipeline \\
      --executors 2

``--device cpu`` trains and serves with PyTorch on the CPU (tests);
without it every node and executor runs on the card.
"""

import argparse
import os
import sys
import tempfile

# per-process models of MnistPredictFn, keyed by the params object it
# served (never pickled with the fn)
_MODELS = {}


class MnistPredictFn(object):
  """The bundle's ``predict_fn(params, batch)``: the MLP's argmax label
  for each image of ``batch["x"]``, on ``device`` (None: the card)."""

  def __init__(self, device=None):
    self.device = device

  def __call__(self, params, batch):
    import numpy as np
    import torch
    from tensorflowonspark_tpu_torch.models import mnist
    key = (id(params), str(self.device))
    if key not in _MODELS:
      model = mnist.MLP(device=self.device)
      model.load_params(params)
      _MODELS[key] = model
    with torch.no_grad():
      logits = _MODELS[key](np.asarray(batch["x"], "float32"))
    return {"label": logits.argmax(-1).cpu().numpy()}


def train_fn(args, ctx):
  """Train the MLP on every batch the feed gives; the chief exports."""
  import numpy as np
  from tensorflowonspark_tpu_torch import pipeline
  from tensorflowonspark_tpu_torch.models import mnist

  feed = ctx.get_data_feed(train_mode=True,
                           input_mapping={"image": "x", "label": "y"})
  state = mnist.create_state(0, device=args["device"])
  while not feed.should_stop():
    batch = feed.next_batch(args["batch_size"])
    if len(batch["x"]) == 0:
      continue
    images = np.asarray(batch["x"], "float32")
    labels = np.asarray(batch["y"], "int32")
    state, _ = mnist.train_step(state, images, labels)

  if ctx.is_chief:
    params = {n: p.detach().cpu() for n, p in state.params.items()}
    pipeline.export_bundle(params, MnistPredictFn(args["device"]),
                           args["export_dir"], is_chief=True)


def parse_args(argv=None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--executors", type=int, default=2)
  parser.add_argument("--export_dir", default=os.path.join(
      tempfile.gettempdir(), "tos_torch_mnist_export"))
  parser.add_argument("--num_samples", type=int, default=2048)
  parser.add_argument("--device", default=None,
                      help="'cpu' for PyTorch on the CPU (default: the "
                           "card)")
  return parser.parse_args(argv)


def run(args) -> float:
  """Fit, then transform 256 rows; returns the accuracy."""
  from tensorflowonspark_tpu_torch.engine import LocalEngine
  from tensorflowonspark_tpu_torch.models import mnist
  from tensorflowonspark_tpu_torch.pipeline import TFEstimator

  images, labels = mnist.synthetic_dataset(args.num_samples)
  rows = list(zip(images.tolist(), labels.tolist()))
  partitions = [rows[i::8] for i in range(8)]

  engine = LocalEngine(num_executors=args.executors)
  try:
    est = TFEstimator(train_fn, {"export_dir": args.export_dir,
                                 "batch_size": 64, "device": args.device})
    est.setEpochs(3).setGraceSecs(2).setReservationTimeout(60)
    model = est.fit(engine, partitions)

    model.setExportDir(args.export_dir) \
         .setInputMapping({"image": "x"}) \
         .setOutputMapping({"label": "prediction"})
    test_rows = [(img,) for img, _ in rows[:256]]
    preds = model.transform(engine, [test_rows])
    truth = [lbl for _, lbl in rows[:256]]
    acc = sum(int(p == t) for p, t in zip(preds, truth)) / len(truth)
    print("pipeline inference accuracy: %.3f over %d rows" %
          (acc, len(truth)))
  finally:
    engine.stop()
  return acc


def main(argv=None) -> int:
  run(parse_args(argv))
  return 0


if __name__ == "__main__":
  sys.exit(main())
