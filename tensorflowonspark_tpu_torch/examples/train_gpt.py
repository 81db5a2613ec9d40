"""Long-context Transformer training on one card.

The port of the single-device path of the JAX package's
``examples/transformer/train_gpt.py`` (:186-243): the same flags and
config, batches from TFRecord files through the FILES-mode pipeline
(``shard_files`` -> ``shuffled`` -> ``batched``) with one batch always
staged ahead on the card (``device_prefetch``), or one synthetic batch;
the per-step train step, or the fused K-step loop with ``--unroll``. The
flash-attention backward plan comes from ``TFOS_TPU_FLASH_BWD`` (default
``fused``; grouped K/V at long sequence lengths takes the split plan, as
in the reference). Mesh flags other than 1 and ``--pp`` > 1 raise: multi-
GPU parallelism is not ported yet (ROADMAP Queue 1 item 10).

  python -m tensorflowonspark_tpu_torch.examples.train_gpt --layers 12 \\
      --d_model 768 --heads 12 --kv_heads 4 --seq_len 16384 --vocab 32000 \\
      --batch 1 --steps 10 --data 'tokens/part-*.tfrecord'

``--device cpu`` runs the kernels' plain versions on the CPU (tests).
"""

import argparse
import functools
import itertools
import sys
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np


def make_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--dp", type=int, default=-1)
  parser.add_argument("--fsdp", type=int, default=1)
  parser.add_argument("--sp", type=int, default=1)
  parser.add_argument("--tp", type=int, default=1)
  parser.add_argument("--pp", type=int, default=1,
                      help="pipeline stages (> 1 is not ported yet)")
  parser.add_argument("--microbatches", type=int, default=4)
  parser.add_argument("--layers", type=int, default=4)
  parser.add_argument("--d_model", type=int, default=256)
  parser.add_argument("--heads", type=int, default=8)
  parser.add_argument("--seq_len", type=int, default=512)
  parser.add_argument("--vocab", type=int, default=1024)
  parser.add_argument("--batch", type=int, default=8)
  parser.add_argument("--steps", type=int, default=10)
  parser.add_argument("--blocked_loss", action="store_true",
                      help="fused projection+cross-entropy (peak memory "
                           "[B,chunk,V] instead of [B,S,V])")
  parser.add_argument("--kv_heads", type=int, default=0,
                      help="grouped-query attention: 0=MHA, 1=MQA")
  parser.add_argument("--fused", action="store_true",
                      help="ln1+QKV, ln2+up and gelu+down each as ONE "
                           "kernel (fuse_qkv + ln_matmul + act_matmul)")
  parser.add_argument("--remat_policy", default="none",
                      choices=("none", "dots"))
  parser.add_argument("--optimizer", default="adamw",
                      choices=("adamw", "lion", "adafactor", "sgd"))
  parser.add_argument("--lr", type=float, default=3e-4)
  parser.add_argument("--grad_accum", type=int, default=1,
                      help="average gradients over k steps, update once")
  parser.add_argument("--data", default=None,
                      help="TFRecord path/glob of token rows (schema "
                           "struct<tokens:array<long>>); default: "
                           "synthetic random tokens")
  parser.add_argument("--z_loss", type=float, default=0.0,
                      help="auxiliary logit stabilizer (e.g. 1e-4)")
  parser.add_argument("--unroll", type=int, default=0,
                      help="K optimizer steps per dispatch of the fused "
                           "loop (0 = TOS_TRAIN_UNROLL env, default "
                           "per-step)")
  parser.add_argument("--device", default=None,
                      help="default: the card; 'cpu' runs the plain "
                           "versions of the kernels")
  return parser


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  """The flags, with the options the port does not run refused by name."""
  args = make_parser().parse_args(argv)
  # --dp -1 means every device: one card here
  wide = ["--%s %d" % (flag, n) for flag, n, ok in (
      ("dp", args.dp, args.dp in (-1, 1)), ("fsdp", args.fsdp, args.fsdp == 1),
      ("sp", args.sp, args.sp == 1), ("tp", args.tp, args.tp == 1),
      ("pp", args.pp, args.pp <= 1)) if not ok]
  if wide:
    raise NotImplementedError(
        "%s: multi-GPU parallelism (a mesh, ring attention, the 1F1B "
        "pipeline) is not ported to PyTorch yet (ROADMAP Queue 1 item 10)"
        % ", ".join(wide))
  if args.remat_policy == "dots":
    raise NotImplementedError(
        "--remat_policy dots is not ported to PyTorch yet (ROADMAP Queue 1 "
        "item 12)")
  return args


def make_config(args: argparse.Namespace):
  """``TransformerConfig`` exactly as the reference builds it."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  fused = dict(fuse_qkv=True, ln_matmul_impl="fused",
               act_matmul_impl="fused") if args.fused else {}
  return tfm.TransformerConfig(
      vocab_size=args.vocab, num_layers=args.layers, num_heads=args.heads,
      d_model=args.d_model, d_ff=args.d_model * 4, max_seq_len=args.seq_len,
      num_kv_heads=args.kv_heads, remat_policy=args.remat_policy, **fused)


def make_state(args: argparse.Namespace, cfg):
  """The train state: weights from seed 0 and the reference's optimizer
  recipe (``--optimizer adafactor`` raises by name)."""
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  tx = optim.make_optimizer(learning_rate=args.lr, clip_norm=1.0,
                            optimizer=args.optimizer,
                            grad_accum_steps=args.grad_accum)
  return tfm.create_state(cfg, 0, tx=tx, device=args.device)


def make_loss_fn(args: argparse.Namespace):
  """``loss_fn(model, tokens)``: the plain or blocked LM loss."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm

  def loss_fn(model, tokens):
    if args.blocked_loss:
      hidden = model(tokens, return_hidden=True)
      return tfm.causal_lm_loss_blocked(hidden,
                                        tfm.tied_embedding_table(model),
                                        tokens, z_loss=args.z_loss)
    return tfm.causal_lm_loss(model(tokens), tokens, z_loss=args.z_loss)
  return loss_fn


def batch_stream(args: argparse.Namespace) -> Iterator[np.ndarray]:
  """``[batch, seq_len]`` int32 token batches: TFRecords through the
  FILES-mode input pipeline when ``--data`` is given, else one synthetic
  batch repeated (the reference's ``batch_stream``)."""
  if not args.data:
    base = np.random.RandomState(0).randint(0, args.vocab,
                                            (args.batch, args.seq_len))
    while True:
      yield base
  from tensorflowonspark_tpu_torch.data import readers
  from tensorflowonspark_tpu_torch.data import schema as schema_mod
  sch = schema_mod.parse_schema("struct<tokens:array<long>>")
  files = readers.shard_files(args.data, 1, 0)
  rows = readers.shuffled(
      readers.read_tfrecord_examples(files, schema=sch, repeat=True),
      buffer_size=max(64, 4 * args.batch))

  yield from readers.batched(
      rows, args.batch, collate=functools.partial(
          pad_tokens, seq_len=args.seq_len, vocab=args.vocab))


def pad_tokens(rows, seq_len: int, vocab: int) -> np.ndarray:
  """Rows of ``(tokens,)`` as one ``[len(rows), seq_len]`` int32 batch,
  each padded with 0 or cut to ``seq_len``. Raises ``ValueError`` on a
  token id outside the vocabulary."""
  arr = np.zeros((len(rows), seq_len), "int32")
  for i, r in enumerate(rows):
    t = np.asarray(r[0], "int64")[:seq_len]
    arr[i, :len(t)] = t
  hi = int(arr.max())
  if hi >= vocab:
    raise ValueError(
        "--data contains token id %d >= --vocab %d; raise --vocab to the "
        "tokenizer's size (the embedding lookup would fail otherwise)"
        % (hi, vocab))
  return arr


def run(args: argparse.Namespace) -> List[float]:
  """Train ``args.steps`` steps, printing each step's loss and time as
  the reference does; returns the losses."""
  from tensorflowonspark_tpu_torch.data.readers import Slab, device_prefetch
  from tensorflowonspark_tpu_torch.parallel import sharding
  cfg = make_config(args)
  state = make_state(args, cfg)
  loss_fn = make_loss_fn(args)
  losses = []
  unroll = sharding.resolve_unroll(args.unroll or None)
  if unroll > 1:
    loop = sharding.make_train_loop(loss_fn, unroll=unroll)
    stream = batch_stream(args)
    while loop.steps < args.steps:
      group = [np.asarray(b, "int32") for b in
               itertools.islice(stream, min(unroll, args.steps - loop.steps))]
      if not group:
        break
      t0 = time.time()
      state, got = loop(state, Slab(np.stack(group)))
      got = got.float().cpu().numpy()
      losses += got.tolist()
      print("steps %d..%d mean loss %.4f (%.0f ms, %d step(s)/dispatch)"
            % (loop.steps - len(group), loop.steps - 1, got.mean(),
               1000 * (time.time() - t0), len(group)))
  else:
    step = sharding.make_train_step(loss_fn)
    # one batch always staged ahead on the device: its copy overlaps the
    # step before it and stays out of the printed step time
    batches = device_prefetch(batch_stream(args), size=2, device=args.device)
    for i, batch in zip(range(args.steps), batches):
      t0 = time.time()
      state, loss = step(state, batch)
      losses.append(float(loss))
      print("step %d loss %.4f (%.0f ms)"
            % (i, losses[-1], 1000 * (time.time() - t0)))
  print("done; tokens/step = %d" % (args.batch * args.seq_len))
  return losses


def main(argv: Optional[Sequence[str]] = None) -> int:
  run(parse_args(argv))
  return 0


if __name__ == "__main__":
  sys.exit(main())
