"""Batch-inference CLI: TFRecords in, predictions out, no cluster setup.

The port's copy of ``tensorflowonspark_tpu/inference_cli.py`` (which
replaced TensorFlowOnSpark's Scala ``Inference`` CLI): ``--export_dir`` /
``--input`` / ``--schema_hint`` / ``--input_mapping`` /
``--output_mapping`` / ``--output``, over the port's ``LocalEngine``
(``--engine spark`` is refused by ``get_engine``: ROADMAP Queue 1 item
11). The bundle's predict fn runs on each executor's card, or where its
own settings say (a serving bundle made with ``device="cpu"`` runs on the
CPU).

Example::

  python -m tensorflowonspark_tpu_torch.inference_cli \\
      --export_dir /models/m1 \\
      --input /data/part-*.tfrecord \\
      --schema_hint 'struct<x1:float,x2:float>' \\
      --input_mapping '{"x1":"x1","x2":"x2"}' \\
      --output_mapping '{"y":"pred"}' \\
      --output preds.jsonl
"""

import argparse
import json
import logging
import os
import sys

logger = logging.getLogger(__name__)


def _validate_output_path(path: str) -> None:
  """Fail fast on an unwritable --output destination.

  Predictions stream to the output file only AFTER the engine ran the
  whole transform — a bad path must be rejected up front, not as a
  traceback after minutes of inference.
  """
  parent = os.path.dirname(os.path.abspath(path))
  if not os.path.isdir(parent):
    raise SystemExit(
        "--output %s: parent directory %s does not exist — create it "
        "first (predictions are written only after inference completes, "
        "so this would fail at the very end)" % (path, parent))
  if not os.access(parent, os.W_OK):
    raise SystemExit("--output %s: parent directory %s is not writable"
                     % (path, parent))
  if os.path.isdir(path):
    raise SystemExit("--output %s is a directory; pass a file path"
                     % path)


def build_parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(
      prog="tensorflowonspark_tpu_torch.inference_cli",
      description="Batch inference over TFRecord files (the port of the "
                  "JAX package's inference CLI).")
  p.add_argument("--export_dir", required=True,
                 help="model bundle directory (pipeline.export_bundle)")
  p.add_argument("--input", required=True,
                 help="TFRecord file, directory, or glob")
  p.add_argument("--output", required=True,
                 help="output path for JSONL predictions")
  p.add_argument("--schema_hint", default=None,
                 help="struct<name:type,...> schema for the input records")
  p.add_argument("--input_mapping", default=None,
                 help="JSON {column: input_tensor}")
  p.add_argument("--output_mapping", default=None,
                 help="JSON {output_tensor: column}")
  p.add_argument("--batch_size", type=int, default=128)
  p.add_argument("--num_executors", type=int, default=1)
  p.add_argument("--engine", choices=["local", "spark"], default="local")
  p.add_argument("--verbose", action="store_true")
  return p


def main(argv=None) -> int:
  args = build_parser().parse_args(argv)
  if args.verbose:
    logging.basicConfig(level=logging.INFO)
  _validate_output_path(args.output)

  from tensorflowonspark_tpu_torch.data import dfutil
  from tensorflowonspark_tpu_torch.data.schema import parse_schema
  from tensorflowonspark_tpu_torch.engine import get_engine
  from tensorflowonspark_tpu_torch.pipeline import (TFModel,
                                                    signature_output_names)

  schema = parse_schema(args.schema_hint) if args.schema_hint else None
  partitions, schema = dfutil.load_tfrecords(
      args.input, schema=schema, num_partitions=args.num_executors)
  logger.info("loaded %d partition(s), schema %s", len(partitions), schema)

  input_mapping = json.loads(args.input_mapping) if args.input_mapping \
      else {name: name for name in schema.names()}
  output_mapping = json.loads(args.output_mapping) if args.output_mapping \
      else {}

  # order row columns by sorted(input_mapping) as the estimator does
  col_index = {n: i for i, n in enumerate(schema.names())}
  ordered_cols = sorted(input_mapping)
  missing = [c for c in ordered_cols if c not in col_index]
  if missing:
    raise SystemExit("input_mapping columns %r not in schema %s"
                     % (missing, schema))
  projected = [[tuple(row[col_index[c]] for c in ordered_cols)
                for row in part] for part in partitions]

  if output_mapping:
    out_names = [output_mapping[t] for t in sorted(output_mapping)]
  else:
    # without an explicit mapping the bundle's recorded signature names
    # the output columns; the shared helper keeps this in lockstep with
    # TFModel.transform's value order
    out_names = signature_output_names(args.export_dir) or ["prediction"]
  engine = get_engine(args.engine, num_executors=args.num_executors)
  count = 0
  try:
    model = TFModel({"export_dir": args.export_dir,
                     "input_mapping": input_mapping,
                     "output_mapping": output_mapping,
                     "batch_size": args.batch_size})
    # collect=False: predictions stream to the output file one window of
    # partitions at a time — the driver never holds the full result set
    stream = model.transform(engine, projected, collect=False)
    with open(args.output, "w") as f:
      for row in stream:
        values = row if isinstance(row, tuple) else (row,)
        f.write(json.dumps(dict(zip(out_names, values))) + "\n")
        count += 1
  finally:
    engine.stop()

  logger.info("wrote %d prediction(s) to %s", count, args.output)
  print("wrote %d predictions to %s" % (count, args.output))
  return 0


if __name__ == "__main__":
  sys.exit(main())
