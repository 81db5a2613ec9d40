"""Long-context Transformer training on one card, or over a mesh of the
processes of a ``torch.distributed`` group.

The port of the JAX package's ``examples/transformer/train_gpt.py``
(:186-260), its SPMD path: the same flags and config, batches
from TFRecord files through the FILES-mode pipeline (``shard_files`` ->
``shuffled`` -> ``batched``) with one batch always staged ahead on the
card (``device_prefetch``), or one synthetic batch; the per-step train
step, or the fused K-step loop with ``--unroll``. The flash-attention
backward plan comes from ``TFOS_TPU_FLASH_BWD`` (default ``fused``;
grouped K/V at long sequence lengths takes the split plan, as in the
reference).

``--dp``, ``--fsdp``, ``--sp`` and ``--tp`` lay the mesh over a process
group, which the caller opens first (under ``cluster.run``,
``ctx.initialize_distributed``): data parallelism, FSDP (weights cut over
``fsdp``, gathered a block at a time), sequence parallelism (ring
attention, ``use_ring_attention = sp > 1`` as in the reference) and
tensor parallelism (heads, mlp and vocab cut); ``--dp -1`` (the default)
takes what the other axes leave of the group, or one card outside a
group. ``--batch`` is the GLOBAL batch, as in the reference: every rank
reads the same stream and keeps its block of each batch, its rows over
``data`` x ``fsdp`` and its positions over ``sequence``
(``parallel.sharding.shard_batch``). Rank 0 prints the losses, every rank
returns them.

``--pp`` above 1 trains through the 1F1B pipeline instead (the
reference's ``:151-184``): a ``data`` x ``pipeline`` mesh (``--pp``
composes with ``--dp`` only; ``--dp -1`` takes the group's size over
``--pp``), the layers split into ``--pp`` contiguous stages, each batch
cut into ``--microbatches`` microbatches of rows that divide over
``--dp``. Every rank holds the whole state, as the reference's ``--pp``
does; a step's gradients are every stage's, gathered over ``pipeline``
(``models.transformer.make_pipeline_train_step``), and the step applies
them to the whole state. ``--unroll`` does not apply to it, as in the
reference.

  python -m tensorflowonspark_tpu_torch.examples.train_gpt --layers 12 \\
      --d_model 768 --heads 12 --kv_heads 4 --seq_len 16384 --vocab 32000 \\
      --batch 1 --steps 10 --data 'tokens/part-*.tfrecord'

``--optimizer adafactor`` keeps factored second moments (a tenth of
AdamW's optimizer state at these widths); ``--remat_policy dots`` saves
each block's weight products for the backward and recomputes the rest.
``--device cpu`` runs the kernels' plain versions on the CPU (tests).
"""

import argparse
import functools
import itertools
import sys
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np

#: the batch axes beyond the data axes a mesh cuts a batch over (a no-op
#: at ``--sp 1``), as the reference passes ``batch_extra_axes``
SEQUENCE_AXES = ("sequence",)


def make_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--dp", type=int, default=-1,
                      help="data-parallel ranks: the process group's size "
                           "(-1: every process of the group)")
  parser.add_argument("--fsdp", type=int, default=1,
                      help="FSDP ranks (weights cut over them)")
  parser.add_argument("--sp", type=int, default=1,
                      help="sequence-parallel ranks (ring attention)")
  parser.add_argument("--tp", type=int, default=1,
                      help="tensor-parallel ranks (heads, mlp, vocab)")
  parser.add_argument("--pp", type=int, default=1,
                      help="pipeline stages: >1 trains through the 1F1B "
                           "schedule (layers split into contiguous stages)")
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


def _world() -> int:
  import torch.distributed as dist
  return dist.get_world_size() if dist.is_available() and \
      dist.is_initialized() else 1


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  """The flags. With ``--pp`` above 1, the reference's checks and
  ``parser.error`` texts: ``--pp`` composes with ``--dp`` only, ``--dp
  -1`` takes the process group's size over ``--pp``, and the batch must
  split into microbatches that divide over ``--dp`` (the mesh degrees
  are checked against the process group by :func:`make_mesh`)."""
  parser = make_parser()
  args = parser.parse_args(argv)
  if args.dp == 0 or args.dp < -1:
    raise ValueError("--dp must be -1 (every process) or a rank count >= 1, "
                     "got %d" % args.dp)
  for flag in ("fsdp", "sp", "tp"):
    if getattr(args, flag) < 1:
      raise ValueError("--%s must be >= 1, got %d"
                       % (flag, getattr(args, flag)))
  if args.pp < 1:
    raise ValueError("--pp must be >= 1, got %d" % args.pp)
  if args.pp > 1:
    if args.fsdp > 1 or args.sp > 1 or args.tp > 1 or args.blocked_loss \
        or args.z_loss:
      parser.error("--pp composes with --dp only (--fsdp/--sp/--tp/"
                   "--blocked_loss/--z_loss are the SPMD path)")
    if args.dp == -1:
      args.dp = max(1, _world() // args.pp)
    micro_b = args.batch // args.microbatches
    if args.batch % args.microbatches or micro_b % args.dp:
      parser.error(
          "batch %d must split into %d microbatches divisible by dp=%d "
          "(e.g. --batch %d)" % (args.batch, args.microbatches, args.dp,
                                 args.microbatches * args.dp))
  return args


def _model_ranks(args: argparse.Namespace) -> int:
  return args.fsdp * args.sp * args.tp * args.pp


def make_mesh(args: argparse.Namespace):
  """The mesh (``data`` x ``fsdp`` x ``sequence`` x ``tensor``, or
  ``data`` x ``pipeline`` with ``--pp``) over the ``torch.distributed``
  group, or None (one card) outside a group when every degree is 1
  (``--dp`` -1 or 1). The degrees must multiply to the group's size;
  outside a group anything above 1 raises."""
  import torch.distributed as dist
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  if not (dist.is_available() and dist.is_initialized()):
    if args.dp in (-1, 1) and _model_ranks(args) == 1:
      return None
    ranks = max(args.dp, 1) * _model_ranks(args)
    raise ValueError(
        "--dp %d --fsdp %d --sp %d --tp %d --pp %d needs a torch.distributed "
        "process group of %d ranks: run train_gpt in each node of "
        "cluster.run after ctx.initialize_distributed() (or "
        "init_process_group yourself)"
        % (args.dp, args.fsdp, args.sp, args.tp, args.pp, ranks))
  return mesh_lib.build_mesh(mesh_lib.MeshSpec(
      data=args.dp, fsdp=args.fsdp, sequence=args.sp, tensor=args.tp,
      pipeline=args.pp))


def make_config(args: argparse.Namespace):
  """``TransformerConfig`` exactly as the reference builds it."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  fused = dict(fuse_qkv=True, ln_matmul_impl="fused",
               act_matmul_impl="fused") if args.fused else {}
  return tfm.TransformerConfig(
      vocab_size=args.vocab, num_layers=args.layers, num_heads=args.heads,
      d_model=args.d_model, d_ff=args.d_model * 4, max_seq_len=args.seq_len,
      num_kv_heads=args.kv_heads, remat_policy=args.remat_policy,
      use_ring_attention=args.sp > 1, **fused)


def make_state(args: argparse.Namespace, cfg, mesh=None):
  """The train state: weights from seed 0 and the reference's optimizer
  recipe; over a ``mesh``, each rank's blocks of it
  (``create_sharded_state``; ``state.sharding`` says how they lie), or
  with ``--pp`` the whole state on every rank, as the reference keeps
  it."""
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  tx = optim.make_optimizer(learning_rate=args.lr, clip_norm=1.0,
                            optimizer=args.optimizer,
                            grad_accum_steps=args.grad_accum)
  if mesh is not None and args.pp == 1:
    return tfm.create_sharded_state(cfg, 0, mesh, tx=tx,
                                    device=args.device)[0]
  return tfm.create_state(cfg, 0, tx=tx, device=args.device)


def make_loss_fn(args: argparse.Namespace):
  """``loss_fn(model, tokens)``: the plain or blocked LM loss (over the
  model's mesh, this rank's share of the global batch's)."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm

  def loss_fn(model, tokens):
    if args.blocked_loss:
      hidden = model(tokens, return_hidden=True)
      return tfm.causal_lm_loss_blocked(hidden,
                                        tfm.tied_embedding_table(model),
                                        tokens, z_loss=args.z_loss,
                                        mesh=model.mesh)
    return tfm.causal_lm_loss(model(tokens), tokens, z_loss=args.z_loss,
                              mesh=model.mesh)
  return loss_fn


def make_pp_step(args: argparse.Namespace, cfg, mesh):
  """``pp_step(state, tokens) -> (state, loss)``: one 1F1B step over the
  mesh's ``pipeline`` axis on the GLOBAL batch, its gradients (every
  stage's) applied to the whole state, as the reference's ``pp_step``."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  pipe = tfm.make_pipeline_train_step(cfg, mesh, args.microbatches)

  def pp_step(state, tokens):
    loss, grads = pipe(state.params, tokens)
    state.apply_gradients(grads)
    return state, loss
  return pp_step


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
  the reference does (rank 0 alone over a mesh); returns the losses,
  the global batch's on every rank."""
  from tensorflowonspark_tpu_torch.data.readers import Slab, device_prefetch
  from tensorflowonspark_tpu_torch.parallel import sharding
  mesh = make_mesh(args)
  say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
  if mesh is not None:
    say("mesh:", dict(mesh.shape))
  cfg = make_config(args)
  state = make_state(args, cfg, mesh)
  loss_fn = make_loss_fn(args)
  losses = []
  extra = SEQUENCE_AXES if mesh is not None else ()
  unroll = sharding.resolve_unroll(args.unroll or None)
  if args.pp > 1:
    step = make_pp_step(args, cfg, mesh)
    # every rank reads the whole batch: stage 0 embeds its rows of each
    # microbatch, the last stage takes them as labels
    batches = device_prefetch(batch_stream(args), size=2, device=args.device)
    for i, batch in zip(range(args.steps), batches):
      t0 = time.time()
      state, loss = step(state, batch)
      losses.append(float(loss))
      say("step %d loss %.4f (%.0f ms)"
          % (i, losses[-1], 1000 * (time.time() - t0)))
  elif unroll > 1:
    loop = sharding.make_train_loop(loss_fn, mesh, state.sharding,
                                    batch_extra_axes=extra, unroll=unroll)
    stream = batch_stream(args)
    while loop.steps < args.steps:
      group = [np.asarray(b, "int32") for b in
               itertools.islice(stream, min(unroll, args.steps - loop.steps))]
      if not group:
        break
      t0 = time.time()
      slab = Slab(np.stack(group))
      if mesh is not None:
        slab = sharding.shard_slab(slab, mesh, extra)
      state, got = loop(state, slab)
      got = got.float().cpu().numpy()
      losses += got.tolist()
      say("steps %d..%d mean loss %.4f (%.0f ms, %d step(s)/dispatch)"
          % (loop.steps - len(group), loop.steps - 1, got.mean(),
             1000 * (time.time() - t0), len(group)))
  else:
    step = sharding.make_train_step(loss_fn, mesh, state.sharding,
                                    batch_extra_axes=extra)
    stream = batch_stream(args)
    if mesh is not None:
      stream = (sharding.shard_batch(b, mesh, extra) for b in stream)
    # one batch always staged ahead on the device: its copy overlaps the
    # step before it and stays out of the printed step time
    batches = device_prefetch(stream, size=2, device=args.device)
    for i, batch in zip(range(args.steps), batches):
      t0 = time.time()
      state, loss = step(state, batch)
      losses.append(float(loss))
      say("step %d loss %.4f (%.0f ms)"
          % (i, losses[-1], 1000 * (time.time() - t0)))
  say("done; tokens/step = %d" % (args.batch * args.seq_len))
  return losses


def main(argv: Optional[Sequence[str]] = None) -> int:
  run(parse_args(argv))
  return 0


if __name__ == "__main__":
  sys.exit(main())
