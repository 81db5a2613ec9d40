"""Pipeline parallelism: microbatched stage execution over the
``pipeline`` mesh axis.

Counterpart of ``tensorflowonspark_tpu/parallel/pipeline_parallel.py``.
Stage ``s`` of the pipeline is the process at coordinate ``s`` of the
axis; activations move one stage down the ring by ``ring_permute(+1)``
and cotangents one stage up by ``ring_permute(-1)``, in lockstep: every
stage posts both sides of every permute at every step, so no stage waits
on one that skipped a slot. The stage parameters are a tree stacked on a
leading stage axis (every rank is given the whole stack, as the
reference's global arrays, and computes with its own stage); a batch is
the global one, cut into microbatches, each cut over the data axes.

- :func:`pipeline_apply` — the GPipe fill-drain forward, differentiable
  through autograd: the backward runs the schedule in reverse, each
  step's permute conjugated by the inverse permute, with each stage's
  forward recomputed from the input it kept.
- :func:`pipeline_lm_train_step` — 1F1B: at global step ``t`` stage
  ``s`` runs the forward of microbatch ``t - s`` and the backward of
  microbatch ``t - (2S - 1) + s`` (``n_micro + 2S - 1`` steps in all).
  A stage keeps only the inputs of its forward slots, in a ring of ``2S``
  slots, and its backward slot runs the stage forward again from the
  input it kept, under autograd; stage 0 embeds and pushes its input
  cotangent through the embed, the last stage runs the head and the
  loss. Gradients accumulate in f32 and are cast back to each
  parameter's dtype at the end; the outer parameters' gradients (the
  embed's on stage 0, the head's on the last stage; a tied table's two
  contributions) are summed over ``pipeline``, and every gradient and
  the loss are averaged over the other axes.
- :func:`pipeline_train_step` — the same schedule with an identity embed
  and the loss as the head.

What differs from the reference, by design of the port:

* slots outside ``[0, n_micro)`` do no compute (the reference computes
  them and masks the result): a stage sends zeros there, which its
  neighbour does not read;
* the reference scatters the token and target microbatches over the
  pipeline axis and conveys them one hop a step (a ``shard_map`` layout);
  here every process is handed the batch and reads only what it
  consumes: stage 0 the tokens, the last stage the targets;
* the 1F1B functions return this rank's stage block of the stacked
  gradients (leading dimension 1), which ``collectives.all_gather`` over
  ``pipeline`` makes whole, where the reference returns the global array.
"""

from typing import Callable, List

import torch

from tensorflowonspark_tpu_torch.parallel import collectives
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib


def _split_microbatches(arr: torch.Tensor, num_microbatches: int, mesh):
  """Reshape ``[batch, ...]`` to ``[n_micro, micro_batch, ...]``, checking
  both the microbatch split and that each microbatch divides over the
  data axes, with the reference's messages."""
  b = arr.shape[0]
  assert b % num_microbatches == 0, \
      "batch %d not divisible into %d microbatches" % (b, num_microbatches)
  micro_b = b // num_microbatches
  data_size = mesh_lib.axis_size(mesh, *mesh_lib.data_axes(mesh))
  assert micro_b % data_size == 0, \
      "microbatch size %d (batch %d / %d microbatches) not divisible by " \
      "the data-axis extent %d" % (micro_b, b, num_microbatches, data_size)
  return arr.reshape((num_microbatches, micro_b) + tuple(arr.shape[1:]))


def _local_micro(arr: torch.Tensor, num_microbatches: int, mesh):
  """This rank's block of each microbatch: ``[n_micro, micro_b / data,
  ...]`` (the reference's ``P(None, batch_axes)``)."""
  micro = _split_microbatches(arr, num_microbatches, mesh)
  return collectives._cut(micro, collectives.P(
      None, mesh_lib.data_axes(mesh) or None), mesh)


def _stage_of(tree, s: int):
  """Stage ``s`` of a tree stacked on a leading stage axis."""
  return collectives._map(lambda p: p[s], tree)


def _rebuild(tree, leaves: List[torch.Tensor]):
  """``tree`` with its tensors replaced, in order, by ``leaves``."""
  it = iter(leaves)
  return collectives._map(lambda _: next(it), tree)


def _as_leaves(tree):
  """A copy of ``tree`` whose tensors are fresh autograd leaves."""
  return collectives._map(lambda p: p.detach().requires_grad_(), tree)


class _GPipe(torch.autograd.Function):
  """The fill-drain schedule of one stage. Forward: at step ``t`` the
  stage runs microbatch ``t - s`` when it is in range (stage 0 takes it
  from ``x_local``, the others from the previous stage) and passes its
  output on; the last stage's outputs are summed over the axis, so every
  rank holds them. Backward: the steps in reverse, each stage's forward
  recomputed from its kept input under autograd; the cotangent of its
  input goes one stage up by the inverse permute."""

  @staticmethod
  def forward(ctx, x_local, spec, *leaves):
    stage_fn, tree, mesh, axis_name = spec
    params = _rebuild(tree, list(leaves))
    n = mesh.shape[axis_name]
    s = mesh.coord(axis_name)
    n_micro = x_local.shape[0]
    zeros = torch.zeros_like(x_local[0])
    recv, inputs = zeros, {}
    outputs = torch.zeros_like(x_local)
    for t in range(n_micro + n - 1):
      m = t - s
      y = zeros
      if 0 <= m < n_micro:
        inputs[m] = x_local[m] if s == 0 else recv
        y = stage_fn(params, inputs[m])
        if s == n - 1:
          outputs[m] = y
      recv = collectives.ring_permute(y, mesh, axis_name, 1)
    ctx.spec, ctx.inputs, ctx.n_micro = spec, inputs, n_micro
    ctx.save_for_backward(*leaves)
    return collectives.all_reduce(outputs, mesh, axis_name)

  @staticmethod
  def backward(ctx, g_out):
    stage_fn, tree, mesh, axis_name = ctx.spec
    leaves = [p.detach().requires_grad_() for p in ctx.saved_tensors]
    params = _rebuild(tree, leaves)
    n = mesh.shape[axis_name]
    s = mesh.coord(axis_name)
    n_micro = ctx.n_micro
    zeros = torch.zeros_like(g_out[0])
    g_x = torch.zeros_like(g_out)
    g_leaves = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    g_up = zeros                       # the cotangent of this stage's input
    for t in reversed(range(n_micro + n - 1)):
      g_y = collectives.ring_permute(g_up, mesh, axis_name, -1)
      m = t - s
      g_up = zeros
      if 0 <= m < n_micro:
        if s == n - 1:
          g_y = g_out[m]
        x_in = ctx.inputs[m].detach().requires_grad_()
        with torch.enable_grad():
          y = stage_fn(params, x_in)
        got = torch.autograd.grad(y, leaves + [x_in], g_y)
        for acc, g in zip(g_leaves, got[:-1]):
          acc += g.float()
        if s == 0:
          g_x[m] = got[-1]
        else:
          g_up = got[-1]
    return (g_x, None) + tuple(g.to(p.dtype) for g, p in zip(g_leaves,
                                                             leaves))


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                   num_microbatches: int,
                   axis_name: str = mesh_lib.AXIS_PIPELINE) -> torch.Tensor:
  """Apply the stages to ``x`` with microbatched pipelining (GPipe).

  ``stage_fn(params_for_one_stage, activation) -> activation`` keeps the
  shape; ``stage_params``: a tensor or a tree of them stacked on a
  leading stage axis of ``mesh.shape[axis_name]``; ``x``: the global
  ``[batch, ...]`` (``num_microbatches`` divides it, and each microbatch
  divides over the data axes). Returns the global ``[batch, ...]`` on
  every rank. Differentiable in ``x`` and ``stage_params``: each rank's
  gradients are the whole ones of a loss every rank computes alike from
  the output."""
  # every rank is handed x and the whole stack, and computes on its stage
  # and data block: their gradients are summed over both
  axes = (axis_name,) + mesh_lib.data_axes(mesh)
  x = collectives.copy_to(x, mesh, axes)
  stage_params = collectives._map(
      lambda p: collectives.copy_to(p, mesh, axes), stage_params)
  tree = _stage_of(stage_params, mesh.coord(axis_name))
  out = _GPipe.apply(_local_micro(x, num_microbatches, mesh),
                     (stage_fn, tree, mesh, axis_name),
                     *collectives.tensors_of(tree))
  out = collectives.gather_to(out, mesh, mesh_lib.data_axes(mesh), axis=1)
  return out.reshape(x.shape)


def _lm_leaves(embed_fn, stage_fn, head_loss_fn, outer_params, own_stage,
               tokens, targets, mesh, num_microbatches, axis_name):
  """The 1F1B schedule of this rank's stage (``own_stage``: its
  parameters, not stacked): ``(summed microbatch losses (nonzero on the
  last stage), (outer leaves, their f32 gradients), (stage leaves, their
  f32 gradients))``, before any reduction over the mesh."""
  n = mesh.shape[axis_name]
  s = mesh.coord(axis_name)
  ring = 2 * n
  inv_micro = 1.0 / num_microbatches
  outer = _as_leaves(outer_params)
  stage = _as_leaves(own_stage)
  o_leaves = collectives.tensors_of(outer)
  s_leaves = collectives.tensors_of(stage)
  g_outer = [torch.zeros_like(p, dtype=torch.float32) for p in o_leaves]
  g_stage = [torch.zeros_like(p, dtype=torch.float32) for p in s_leaves]
  first, last = s == 0, s == n - 1
  micro = _split_microbatches(tokens, num_microbatches, mesh)
  rows = micro.shape[1] // mesh_lib.axis_size(mesh, *mesh_lib.data_axes(mesh))
  tok = _local_micro(tokens, num_microbatches, mesh) if first else None
  tgt = _local_micro(targets, num_microbatches, mesh) if last else None
  # the activation's shape and dtype, without running the embed anywhere
  meta = embed_fn(collectives._map(lambda p: p.detach().to("meta"),
                                   outer_params), micro[0, :rows].to("meta"))
  device = (o_leaves + s_leaves)[0].device
  zeros = torch.zeros(meta.shape, dtype=meta.dtype, device=device)
  fwd_recv = bwd_recv = zeros
  kept = [None] * ring
  loss_acc = torch.zeros((), dtype=torch.float32, device=device)
  for t in range(num_microbatches + 2 * n - 1):
    # ---- forward slot: microbatch t - s, its input kept for the backward
    m_f = t - s
    y = zeros
    if 0 <= m_f < num_microbatches:
      with torch.no_grad():
        inp = embed_fn(outer, tok[m_f]).to(zeros.dtype) if first \
            else fwd_recv
        kept[m_f % ring] = inp
        y = stage_fn(stage, inp)
    # ---- backward slot: microbatch t - (2S - 1) + s, its stage forward
    # run again from the kept input
    m_b = t - (2 * n - 1) + s
    g_x = zeros
    if 0 <= m_b < num_microbatches:
      x_in = kept[m_b % ring].detach().requires_grad_()
      kept[m_b % ring] = None
      y_b = stage_fn(stage, x_in)
      if last:
        lval = head_loss_fn(outer, y_b, tgt[m_b])
        loss_acc += lval.detach().float()
        got = torch.autograd.grad(lval * inv_micro, o_leaves + s_leaves
                                  + [x_in], allow_unused=True)
        for acc, g in zip(g_outer, got[:len(o_leaves)]):
          if g is not None:
            acc += g.float()
        got = got[len(o_leaves):]
      else:
        got = torch.autograd.grad(y_b, s_leaves + [x_in], bwd_recv)
      for acc, g in zip(g_stage, got[:-1]):
        acc += g.float()
      g_x = got[-1]
      if first and o_leaves:
        emb = embed_fn(outer, tok[m_b])
        got = torch.autograd.grad(emb, o_leaves, g_x.to(emb.dtype),
                                  allow_unused=True)
        for acc, g in zip(g_outer, got):
          if g is not None:
            acc += g.float()
    fwd_recv = collectives.ring_permute(y, mesh, axis_name, 1)
    bwd_recv = collectives.ring_permute(g_x.to(zeros.dtype), mesh, axis_name,
                                        -1)
  return loss_acc, (outer, g_outer), (stage, g_stage)


def pipeline_lm_train_step(embed_fn: Callable, stage_fn: Callable,
                           head_loss_fn: Callable, outer_params,
                           stage_params, tokens: torch.Tensor,
                           targets: torch.Tensor, mesh,
                           num_microbatches: int,
                           axis_name: str = mesh_lib.AXIS_PIPELINE):
  """Full-model 1F1B training step: embed -> pipelined stages -> head and
  loss (see the module docstring for the schedule).

  ``embed_fn(outer_params, tokens_micro) -> activation`` runs on the
  first stage only; ``stage_fn(stage_params_one, activation) ->
  activation``; ``head_loss_fn(outer_params, activation, targets_micro)
  -> scalar`` (the microbatch's mean loss) on the last stage only, and
  may share parameters with the embed (tied embeddings).
  ``outer_params``: a tree of the parameters outside the stages, whole
  on every rank; ``stage_params``: a tree stacked on a leading stage
  axis; ``tokens`` / ``targets``: the global ``[batch, ...]``.

  Returns ``(loss, outer_grads, stage_grads)``: the global batch's mean
  loss and the outer gradients on every rank, and this rank's stage
  block of the stacked gradients (leading dimension 1), each in its
  parameter's dtype. The permutes, the sums over ``pipeline`` and the
  averages over the other axes count in ``collectives.COUNTS``.
  """
  return lm_stage_step(embed_fn, stage_fn, head_loss_fn, outer_params,
                       _stage_of(stage_params, mesh.coord(axis_name)),
                       tokens, targets, mesh, num_microbatches, axis_name)


def lm_stage_step(embed_fn: Callable, stage_fn: Callable,
                  head_loss_fn: Callable, outer_params, own_stage,
                  tokens: torch.Tensor, targets: torch.Tensor, mesh,
                  num_microbatches: int,
                  axis_name: str = mesh_lib.AXIS_PIPELINE):
  """:func:`pipeline_lm_train_step` given this rank's own stage
  parameters (a tree, not stacked) instead of the whole stack: for
  training loops that hold each stage's weights on its own rank."""
  loss_acc, (outer, g_outer), (stage, g_stage) = _lm_leaves(
      embed_fn, stage_fn, head_loss_fn, outer_params, own_stage, tokens,
      targets, mesh, num_microbatches, axis_name)
  inv_micro = 1.0 / num_microbatches
  # the loss lives on the last stage and the outer gradients on the first
  # and last: one sum over the pipeline joins them (and a tied table's
  # embed- and head-side contributions)
  joined = collectives.sync_gradients([loss_acc.reshape(1)] + g_outer, mesh,
                                      mean=False, axis_name=axis_name)
  loss, g_outer = joined[0][0] * inv_micro, joined[1:]
  others = tuple(a for a in mesh.axis_names if a != axis_name)
  if mesh.wide(others):
    synced = collectives.sync_gradients([loss.reshape(1)] + g_outer +
                                        g_stage, mesh, axis_name=others)
    loss, g_outer, g_stage = synced[0][0], synced[1:1 + len(g_outer)], \
        synced[1 + len(g_outer):]
  o_leaves = collectives.tensors_of(outer)
  s_leaves = collectives.tensors_of(stage)
  g_outer = _rebuild(outer, [g.to(p.dtype) for g, p in zip(g_outer,
                                                           o_leaves)])
  g_stage = _rebuild(stage, [g.to(p.dtype)[None] for g, p in zip(g_stage,
                                                                 s_leaves)])
  return loss, g_outer, g_stage


def pipeline_train_step(stage_fn: Callable, loss_fn: Callable, stage_params,
                        x: torch.Tensor, targets: torch.Tensor, mesh,
                        num_microbatches: int,
                        axis_name: str = mesh_lib.AXIS_PIPELINE):
  """1F1B loss and gradients in one pass, with an identity embed and
  ``loss_fn(final_activation_micro, target_micro) -> scalar`` (a mean
  over the microbatch) as the head: ``(loss, stage_grads)``, the grads
  this rank's stage block of the stacked layout (leading dimension 1)."""
  loss, _, grads = pipeline_lm_train_step(
      lambda _outer, xx: xx, stage_fn, lambda _outer, y, tgt: loss_fn(y, tgt),
      {}, stage_params, x, targets, mesh, num_microbatches,
      axis_name=axis_name)
  return loss, grads


__all__ = ["pipeline_apply", "pipeline_lm_train_step", "lm_stage_step",
           "pipeline_train_step"]
