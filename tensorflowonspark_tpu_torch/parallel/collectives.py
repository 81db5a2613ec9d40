"""Collectives over a mesh axis's process group.

Counterpart of ``tensorflowonspark_tpu/parallel/collectives.py``. The
reference wraps ``jax.lax`` collectives over an axis name inside
``shard_map``; here each helper runs ``torch.distributed`` over the group
of one mesh axis, or of several
(:meth:`~tensorflowonspark_tpu_torch.parallel.mesh.Mesh.group`), where
every process holds one shard. Helpers are functional as the reference's
are: the input tensor is left as it was. :func:`shard_map_fn` is the
per-process form of ``shard_map``: each rank cuts its block of every
input by ``in_specs`` (:class:`P`), runs the function on it and puts the
blocks of the output together by ``out_specs``.

An axis with no group (degree 1 outside a process group) needs no
collective: the helpers return the local value. When a group is given
the collective runs even at degree 1.

Transport: NCCL takes CUDA tensors; gloo takes CPU tensors and, for
``all_reduce`` and ``broadcast``, CUDA tensors through its own CUDA
support (copies through the host). Under gloo only, ``all_gather``,
``reduce_scatter``, ``all_to_all`` and ``ring_permute`` stage a CUDA
tensor through pinned host memory themselves, the way gloo's CUDA support
does, and hand back a CUDA tensor (gloo has no CUDA send/recv or
all-to-all). NCCL never gives way to gloo or to the host, and a failed
collective raises.

Autograd: ``ring_permute`` and ``all_to_all`` are differentiable (the
backward is the inverse permute, the all-to-all with its axes swapped).
:func:`copy_to` (identity forward, all-reduce backward),
:func:`reduce_from` (all-reduce forward, identity backward) and
:func:`gather_from` (all-gather forward, reduce-scatter backward) are the
conjugate pairs tensor parallelism and FSDP build on; :func:`split_to`
(this rank's piece forward, all-gather backward) and :func:`gather_to`
(all-gather forward, this rank's piece backward) those of a value every
rank of the axis holds alike, cut for work each rank does on its piece
(the expert axis's token slices). The other helpers are not
differentiable.
"""

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

from tensorflowonspark_tpu_torch.parallel.mesh import AXIS_DATA

#: bytes of one gradient bucket of :func:`sync_gradients`
BUCKET_BYTES = 25 * 2 ** 20

#: collective -> calls since the last :func:`reset_counts`, and
#: ``<collective>_bytes`` -> the bytes each rank put in; ``buckets`` and
#: ``bucket_bytes`` count :func:`sync_gradients`' all-reduces (also
#: counted under ``all_reduce``) and the bytes they reduce
COUNTS: Dict[str, int] = {"sync_gradients": 0, "buckets": 0,
                          "bucket_bytes": 0, "all_reduce": 0, "broadcast": 0,
                          "all_gather": 0, "reduce_scatter": 0,
                          "ring_permute": 0, "all_to_all": 0,
                          "all_reduce_bytes": 0, "all_gather_bytes": 0,
                          "reduce_scatter_bytes": 0, "ring_permute_bytes": 0,
                          "all_to_all_bytes": 0}


def reset_counts() -> None:
  for name in COUNTS:
    COUNTS[name] = 0


def _count(name: str, x: torch.Tensor) -> None:
  COUNTS[name] += 1
  COUNTS[name + "_bytes"] += x.numel() * x.element_size()


def _axes(axis_name) -> tuple:
  return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _axis(mesh, axis_name):
  """(group, degree) of one axis or a tuple of axes; the group is None
  when no collective is needed."""
  axes = _axes(axis_name)
  return mesh.group(axes), math.prod(mesh.shape[a] for a in axes)


def _staged_on_host(x: torch.Tensor, group) -> bool:
  """True for a CUDA tensor in a gloo collective that gloo cannot take
  from the card (all-gather, reduce-scatter, all-to-all, send/recv),
  which the port stages through the host."""
  return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
  host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
  host.copy_(x)
  return host


def _staged(x: torch.Tensor, group) -> torch.Tensor:
  return _to_host(x) if _staged_on_host(x, group) else x.contiguous()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _reduce(out: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
  _count("all_reduce", out)
  dist.all_reduce(out, op=_OPS[op], group=group)
  return out


def all_reduce(x: torch.Tensor, mesh, axis_name=AXIS_DATA, op: str = "sum"):
  """Sum (or with ``op="max"`` the maximum) of ``x`` over the axis or
  axes (the reference's ``lax.psum``)."""
  group, _ = _axis(mesh, axis_name)
  out = x.clone()
  return out if group is None else _reduce(out, group, op)


def psum_mean(x: torch.Tensor, mesh, axis_name=AXIS_DATA):
  """All-reduce average over the axis or axes (the gradient-sync
  primitive; the reference's ``lax.pmean``)."""
  group, n = _axis(mesh, axis_name)
  out = x.clone()
  if group is None:
    return out
  return _reduce(out, group).div_(n)


def all_gather(x: torch.Tensor, mesh, axis_name=AXIS_DATA,
               axis: int = 0, tiled: bool = True):
  """Every shard's ``x`` in rank order: concatenated along ``axis``
  (``tiled``) or stacked in a new dimension ``axis``."""
  group, n = _axis(mesh, axis_name)
  if group is None:
    return x.clone() if tiled else x.unsqueeze(axis)
  src = _staged(x, group)
  parts = [torch.empty_like(src) for _ in range(n)]
  _count("all_gather", src)
  dist.all_gather(parts, src, group=group)
  out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)
  return out.to(x.device)


def reduce_scatter(x: torch.Tensor, mesh, axis_name=AXIS_DATA,
                   axis: int = 0):
  """The sum of ``x`` over the axis, cut into equal pieces along ``axis``;
  shard ``i`` keeps piece ``i`` (the reference's tiled
  ``lax.psum_scatter``). ``x.shape[axis]`` must divide by the degree."""
  group, n = _axis(mesh, axis_name)
  if group is None:
    return x.clone()
  if x.shape[axis] % n:
    raise ValueError("reduce_scatter: dimension %d of size %d does not "
                     "divide into %d shards" % (axis, x.shape[axis], n))
  src = _staged(x.movedim(axis, 0), group)
  out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                    dtype=src.dtype, device=src.device)
  _count("reduce_scatter", src)
  dist.reduce_scatter_tensor(out, src, group=group)
  return out.movedim(0, axis).to(x.device)


def broadcast_from(x: torch.Tensor, mesh, axis_name=AXIS_DATA,
                   src_index: int = 0):
  """Every shard receives shard ``src_index``'s value."""
  group, _ = _axis(mesh, axis_name)
  out = x.clone()
  if group is None:
    return out
  COUNTS["broadcast"] += 1
  dist.broadcast(out, src=dist.get_global_rank(group, src_index),
                 group=group)
  return out


def _global_rank(mesh, rank: int) -> int:
  """The world rank of mesh rank ``rank``."""
  if mesh._group is None or mesh._group == dist.group.WORLD:
    return rank
  return dist.get_global_rank(mesh._group, rank)


def _permute(x: torch.Tensor, mesh, axis_name: str, shift: int):
  group, n = _axis(mesh, axis_name)
  if group is None or shift % n == 0:
    return x.clone()
  me = mesh.coord(axis_name)
  dst = _global_rank(mesh, mesh.rank_at(**{axis_name: (me + shift) % n}))
  src = _global_rank(mesh, mesh.rank_at(**{axis_name: (me - shift) % n}))
  send = _staged(x, group)
  recv = torch.empty(send.shape, dtype=send.dtype, device=send.device,
                     pin_memory=send.is_pinned())
  _count("ring_permute", send)
  # both posted before either is waited on: no order of the ranks can
  # deadlock, and NCCL runs the pair as one group call
  for work in dist.batch_isend_irecv([
      dist.P2POp(dist.irecv, recv, src, group),
      dist.P2POp(dist.isend, send, dst, group)]):
    work.wait()
  return recv.to(x.device)


class _Permute(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, axis_name, shift):
    ctx.args = (mesh, axis_name, shift)
    return _permute(x, mesh, axis_name, shift)

  @staticmethod
  def backward(ctx, g):
    mesh, axis_name, shift = ctx.args
    return _permute(g, mesh, axis_name, -shift), None, None, None


def ring_permute(x: torch.Tensor, mesh, axis_name: str, shift: int = 1):
  """Rotate shards around the axis's ring: coordinate ``i`` receives
  coordinate ``i - shift``'s ``x`` (neighbour exchange; the reference's
  ``lax.ppermute`` with pairs ``(i, i + shift)``). Differentiable: the
  backward rotates the gradient by ``-shift``."""
  if torch.is_grad_enabled() and x.requires_grad:
    return _Permute.apply(x, mesh, axis_name, int(shift))
  return _permute(x, mesh, axis_name, int(shift))


def _all_to_all(x: torch.Tensor, mesh, axis_name: str, split_axis: int,
                concat_axis: int):
  group, n = _axis(mesh, axis_name)
  if group is None:
    return x.clone()
  if x.shape[split_axis] % n:
    raise ValueError("all_to_all: dimension %d of size %d does not divide "
                     "into %d shards" % (split_axis, x.shape[split_axis], n))
  src = _staged(torch.stack(x.chunk(n, dim=split_axis)), group)
  out = torch.empty(src.shape, dtype=src.dtype, device=src.device,
                    pin_memory=src.is_pinned())
  _count("all_to_all", src)
  dist.all_to_all_single(out, src, group=group)
  return torch.cat(out.to(x.device).unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, axis_name, split_axis, concat_axis):
    ctx.args = (mesh, axis_name, split_axis, concat_axis)
    return _all_to_all(x, mesh, axis_name, split_axis, concat_axis)

  @staticmethod
  def backward(ctx, g):
    mesh, axis_name, split_axis, concat_axis = ctx.args
    return (_all_to_all(g, mesh, axis_name, concat_axis, split_axis), None,
            None, None, None)


def all_to_all(x: torch.Tensor, mesh, axis_name: str, split_axis: int,
               concat_axis: int):
  """The tiled all-to-all (Ulysses-style head/sequence exchange, the
  reference's ``lax.all_to_all(..., tiled=True)``): ``x`` is cut into
  equal pieces along ``split_axis``, piece ``j`` goes to coordinate
  ``j``, and the pieces received are concatenated along ``concat_axis``
  in coordinate order. Differentiable: the backward is the all-to-all
  with the two axes swapped."""
  if torch.is_grad_enabled() and x.requires_grad:
    return _AllToAll.apply(x, mesh, axis_name, split_axis, concat_axis)
  return _all_to_all(x, mesh, axis_name, split_axis, concat_axis)


def hierarchical_all_reduce(x: torch.Tensor, mesh, ici_axis: str,
                            dcn_axis: str, scatter_axis: int = 0,
                            mean: bool = False):
  """``all_reduce`` over both axes as the bandwidth-optimal hierarchy:
  reduce-scatter over ``ici_axis`` along ``scatter_axis``, all-reduce the
  shard over ``dcn_axis``, all-gather back over ``ici_axis`` (the
  reference's two-tier ICI x DCN reduction). ``mean`` divides by both
  degrees."""
  shard = reduce_scatter(x, mesh, ici_axis, axis=scatter_axis)
  shard = all_reduce(shard, mesh, dcn_axis)
  out = all_gather(shard, mesh, ici_axis, axis=scatter_axis)
  if mean:
    out = out / (mesh.shape[ici_axis] * mesh.shape[dcn_axis])
  return out


# -- the conjugate pairs of tensor parallelism and FSDP ------------------------


class _CopyTo(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, axis_name):
    ctx.args = (mesh, axis_name)
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return all_reduce(g, *ctx.args), None, None


class _ReduceFrom(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, axis_name, op):
    return all_reduce(x, mesh, axis_name, op)

  @staticmethod
  def backward(ctx, g):
    return g, None, None, None


class _GatherFrom(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, axis_name, axis):
    ctx.args = (mesh, axis_name, axis)
    return all_gather(x, mesh, axis_name, axis=axis)

  @staticmethod
  def backward(ctx, g):
    mesh, axis_name, axis = ctx.args
    return reduce_scatter(g, mesh, axis_name, axis=axis), None, None, None


def _piece(x: torch.Tensor, mesh, axis_name, axis: int) -> torch.Tensor:
  """This rank's piece of ``x`` along ``axis``: coordinate ``i`` of the
  axis (or axes, the first outermost) keeps the ``i``-th of equal
  pieces."""
  index, count = block_index(mesh, _axes(axis_name))
  if x.shape[axis] % count:
    raise ValueError("dimension %d of size %d does not divide into %d "
                     "pieces" % (axis, x.shape[axis], count))
  size = x.shape[axis] // count
  return x.narrow(axis, index * size, size)


class _SplitTo(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, axis_name, axis):
    ctx.args = (mesh, axis_name, axis)
    return _piece(x, mesh, axis_name, axis).clone()

  @staticmethod
  def backward(ctx, g):
    mesh, axis_name, axis = ctx.args
    return all_gather(g.contiguous(), mesh, axis_name, axis=axis), None, \
        None, None


class _GatherTo(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, mesh, axis_name, axis):
    ctx.args = (mesh, axis_name, axis)
    return all_gather(x, mesh, axis_name, axis=axis)

  @staticmethod
  def backward(ctx, g):
    mesh, axis_name, axis = ctx.args
    return _piece(g, mesh, axis_name, axis).contiguous(), None, None, None


def split_to(x: torch.Tensor, mesh, axis_name, axis: int = 0):
  """This rank's piece of ``x`` along ``axis`` (coordinate ``i`` keeps
  the ``i``-th of equal pieces), where every rank of the axis holds ``x``
  alike; the gradient is the ranks' pieces all-gathered, so ``x``'s is
  whole on every rank (Megatron's scatter)."""
  if mesh is None or mesh.group(_axes(axis_name)) is None:
    return x
  return _SplitTo.apply(x, mesh, axis_name, axis)


def gather_to(x: torch.Tensor, mesh, axis_name, axis: int = 0):
  """The ranks' pieces of a value concatenated along ``axis`` in
  coordinate order, where what follows runs alike on every rank of the
  axis: the gradient, the same on every rank, gives each rank its own
  piece back (Megatron's gather; :func:`split_to`'s conjugate)."""
  if mesh is None or mesh.group(_axes(axis_name)) is None:
    return x
  return _GatherTo.apply(x, mesh, axis_name, axis)


def copy_to(x: torch.Tensor, mesh, axis_name):
  """``x`` as it is; its gradient summed over the axis. Where a value
  every rank of the axis holds alike enters computation each rank does
  on its own part (a column-parallel product, a vocabulary shard), the
  ranks' partial gradients add up to its gradient (Megatron's ``f``)."""
  if mesh is None or mesh.group(_axes(axis_name)) is None:
    return x
  return _CopyTo.apply(x, mesh, axis_name)


def reduce_from(x: torch.Tensor, mesh, axis_name, op: str = "sum"):
  """The all-reduce of ``x`` over the axis, its gradient passed through
  as it is (Megatron's ``g``: a row-parallel product's partial sums).
  ``op="max"`` is for values whose gradient is not wanted."""
  if mesh is None or mesh.group(_axes(axis_name)) is None:
    return x
  return _ReduceFrom.apply(x, mesh, axis_name, op)


def gather_from(x: torch.Tensor, mesh, axis_name, axis: int = 0):
  """``x``'s shards concatenated along ``axis`` in coordinate order; the
  gradient reduce-scattered back (summed over the axis, each shard's
  piece to its rank): FSDP's gather of a parameter."""
  if mesh is None or mesh.group(_axes(axis_name)) is None:
    return x
  return _GatherFrom.apply(x, mesh, axis_name, axis)


def tensors_of(tree) -> List[torch.Tensor]:
  """Every tensor of a tree of dicts, tuples (NamedTuples included),
  lists and objects (the optimizer's state objects), in order; other
  leaves (host counters) are left out."""
  if isinstance(tree, torch.Tensor):
    return [tree]
  if isinstance(tree, dict):
    return [t for v in tree.values() for t in tensors_of(v)]
  if isinstance(tree, (list, tuple)):
    return [t for v in tree for t in tensors_of(v)]
  if hasattr(tree, "__dict__"):
    return tensors_of(vars(tree))
  return []


def _map(fn, tree):
  if isinstance(tree, dict):
    return type(tree)((k, _map(fn, v)) for k, v in tree.items())
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map(fn, v) for v in tree)
  return fn(tree) if isinstance(tree, torch.Tensor) else tree


def global_norm(tree, mesh=None, axis_names: Sequence[str] = ()):
  """L2 norm (f32) over a tree of tensors (dicts, lists, tuples). With
  ``axis_names``, the partial squares are summed over those axes first,
  so the norm of row-sharded leaves is the true global norm."""
  leaves = tensors_of(tree)
  sq = sum(torch.sum(torch.square(g.float())) for g in leaves) if leaves \
      else torch.zeros(())
  if axis_names:
    sq = all_reduce(sq, mesh, _axes(axis_names))
  return torch.sqrt(sq)


def clip_by_global_norm(tree, max_norm: float, mesh=None,
                        axis_names: Sequence[str] = ()):
  """``(tree scaled so its global norm is <= max_norm, the norm)``."""
  norm = global_norm(tree, mesh, axis_names)
  scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
  return _map(lambda g: (g * scale).to(g.dtype), tree), norm


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int):
  """Index lists of the buckets: the tensors in reverse order (the order
  the backward produces them), each bucket of one dtype and at most
  ``bucket_bytes``; a tensor larger than that has a bucket of its own."""
  out, cur, size, dtype = [], [], 0, None
  for i in reversed(range(len(tensors))):
    t = tensors[i]
    nbytes = t.numel() * t.element_size()
    if cur and (t.dtype != dtype or size + nbytes > bucket_bytes):
      out.append(cur)
      cur, size = [], 0
    cur.append(i)
    size += nbytes
    dtype = t.dtype
  if cur:
    out.append(cur)
  return out


def sync_gradients(grads, mesh, mean: bool = True,
                   axis_name=AXIS_DATA,
                   bucket_bytes: int = BUCKET_BYTES):
  """Average (or with ``mean=False`` sum) gradients over the axis (or the
  tuple of axes: one group over all of them) by a
  bucketed all-reduce: the tensors, in reverse parameter order, are
  flattened into contiguous buckets of one dtype and about
  ``bucket_bytes``; each bucket's all-reduce is started at once
  (``async_op``), then each is waited for and divided by the degree.
  ``grads`` is a ``{name: tensor}`` dict or a sequence of tensors; the
  result has its form, its tensors views of the reduced buckets.

  Each rank passes the gradient of its own local batch's loss. When the
  loss is a mean over equal local batches (``causal_lm_loss``), their
  average is the gradient of the global batch's loss, which the
  reference's jitted step computes.
  """
  group, n = _axis(mesh, axis_name)
  names = list(grads) if isinstance(grads, dict) else None
  tensors = list(grads.values()) if names is not None else list(grads)
  if group is None:
    return grads
  COUNTS["sync_gradients"] += 1
  pending = []
  for idx in _buckets(tensors, bucket_bytes):
    flat = torch.cat([tensors[i].reshape(-1) for i in idx])
    COUNTS["buckets"] += 1
    COUNTS["bucket_bytes"] += flat.numel() * flat.element_size()
    _count("all_reduce", flat)
    pending.append((idx, flat, dist.all_reduce(flat, group=group,
                                               async_op=True)))
  out = list(tensors)
  for idx, flat, work in pending:
    work.wait()
    if mean:
      flat.div_(n)
    offset = 0
    for i in idx:
      k = tensors[i].numel()
      out[i] = flat[offset:offset + k].view(tensors[i].shape)
      offset += k
  if names is not None:
    return dict(zip(names, out))
  return type(grads)(out) if isinstance(grads, tuple) else out


def all_processes_agree(flag: bool, group=None) -> bool:
  """True iff ``flag`` is True in EVERY process of ``group`` (default: the
  world group): one ``all_reduce(MIN)`` of a one-element tensor, on the
  card under NCCL and on the CPU otherwise; the local vote when no
  process group is initialized.

  The primitive behind step agreement over uneven data partitions: a
  synchronous collective deadlocks if one participant stops early, so all
  agree on "everyone still has data" before each step.
  """
  if not (dist.is_available() and dist.is_initialized()):
    return bool(flag)
  if dist.get_backend(group) == "nccl":
    device = torch.device("cuda", torch.cuda.current_device())
  else:
    device = torch.device("cpu")
  vote = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
  dist.all_reduce(vote, op=dist.ReduceOp.MIN, group=group)
  return bool(vote.item())


class P(tuple):
  """A partition spec of :func:`shard_map_fn` (``jax.sharding.
  PartitionSpec``): one entry per leading dimension, each None (whole on
  every rank), an axis name, or a tuple of axis names (the dimension cut
  over their product, the first name outermost). ``P()`` is replicated."""

  def __new__(cls, *parts):
    return tuple.__new__(cls, parts)

  def __repr__(self):
    return "P%s" % (tuple.__repr__(self),)


def block_index(mesh, axes) -> tuple:
  """(this rank's block index, the block count) of a dimension cut over
  ``axes``, the first outermost."""
  index, count = 0, 1
  for a in axes:
    index = index * mesh.shape[a] + mesh.coord(a)
    count *= mesh.shape[a]
  return index, count


def _entry_axes(entry) -> tuple:
  if entry is None:
    return ()
  return _axes(entry)


def _cut(x, spec: "P", mesh):
  """This rank's block of a global ``x`` under ``spec``."""
  if not isinstance(x, torch.Tensor):
    return x
  for dim, entry in enumerate(spec):
    index, count = block_index(mesh, _entry_axes(entry))
    if count > 1:
      if x.shape[dim] % count:
        raise ValueError("shard_map_fn: dimension %d of size %d does not "
                         "divide into %d blocks" % (dim, x.shape[dim],
                                                    count))
      size = x.shape[dim] // count
      x = x.narrow(dim, index * size, size)
  return x


def _join(x, spec: "P", mesh):
  """The global value of local blocks ``x`` under ``spec``: every
  dimension cut over some axes is all-gathered over them, in the spec's
  order of the axes."""
  if not isinstance(x, torch.Tensor):
    return x
  for dim, entry in enumerate(spec):
    axes = tuple(a for a in _entry_axes(entry) if mesh.shape[a] > 1)
    if not axes:
      continue
    group = mesh.group(axes)
    if group is None:
      continue
    # the group holds its ranks in the mesh's axis order; the spec may
    # name them in another
    parts = all_gather(x, mesh, axes, tiled=False)
    pieces = [None] * len(parts)
    for part, r in zip(parts.unbind(0), mesh.ranks(axes)):
      pieces[block_index(type(mesh)(mesh.axis_names, mesh.shape, r), axes)[0]] \
          = part
    x = torch.cat(pieces, dim=dim)
  return x


def _over(fn, spec, tree, mesh):
  """``fn(leaf, P, mesh)`` on each leaf of ``tree`` whose spec is the
  prefix ``spec`` names (a :class:`P` or None covers a whole subtree)."""
  if spec is None or isinstance(spec, P):
    spec = spec if spec is not None else P()
    return _map(lambda leaf: fn(leaf, spec, mesh), tree)
  if isinstance(spec, dict):
    return type(tree)((k, _over(fn, spec[k], v, mesh))
                      for k, v in tree.items())
  if isinstance(spec, (list, tuple)):
    if len(spec) != len(tree):
      raise ValueError("shard_map_fn: %d specs for %d values"
                       % (len(spec), len(tree)))
    return type(tree)(_over(fn, sp, v, mesh) for sp, v in zip(spec, tree))
  raise TypeError("shard_map_fn: a spec must be a P, None, or a tuple, "
                  "list or dict of them; got %r" % (spec,))


def shard_map_fn(fn: Callable, mesh, in_specs, out_specs) -> Callable:
  """``shard_map`` in one process of the mesh: the returned function
  takes the GLOBAL inputs (every rank passes the same values), cuts this
  rank's block of each by ``in_specs``, runs ``fn`` on the blocks (where
  the collectives of this module run over the mesh's groups) and puts the
  output's blocks together by ``out_specs`` (an all-gather over each
  sharded dimension's axes; a dimension ``out_specs`` leaves whole keeps
  this rank's value). Specs are :class:`P` prefixes of the arguments'
  and the output's trees, as in the reference. Not differentiable."""

  def run(*args):
    if isinstance(in_specs, P) or in_specs is None:
      local = tuple(_over(_cut, in_specs, a, mesh) for a in args)
    else:
      local = _over(_cut, tuple(in_specs), tuple(args), mesh)
    return _over(_join, out_specs, fn(*local), mesh)
  return run
