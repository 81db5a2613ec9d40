"""Collectives over a mesh axis's process group.

Counterpart of the process-group subset of
``tensorflowonspark_tpu/parallel/collectives.py``. The reference wraps
``jax.lax`` collectives over an axis name inside ``shard_map``; here each
helper runs ``torch.distributed`` over the group of a mesh axis
(:meth:`~tensorflowonspark_tpu_torch.parallel.mesh.Mesh.group`), where
every process holds one shard. Helpers are functional as the reference's
are: the input tensor is left as it was.

An axis with no group (degree 1 outside a process group) needs no
collective: the helpers return the local value. When a group is given
the collective runs even at degree 1.

Transport: NCCL takes CUDA tensors; gloo takes CPU tensors and, for
``all_reduce`` and ``broadcast``, CUDA tensors through its own CUDA
support (copies through the host). Under gloo only, ``all_gather`` and
``reduce_scatter`` stage a CUDA tensor through pinned host memory
themselves, the way gloo's CUDA support does, and hand back a CUDA
tensor. NCCL never gives way to gloo or to the host, and a failed
collective raises.

``ring_permute``, ``all_to_all``, ``hierarchical_all_reduce`` and
``shard_map_fn`` serve the mesh axes other than ``data`` and raise by
name: ROADMAP Queue 1 item 10.
"""

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from tensorflowonspark_tpu_torch.parallel.mesh import AXIS_DATA

#: bytes of one gradient bucket of :func:`sync_gradients`
BUCKET_BYTES = 25 * 2 ** 20

#: collective -> calls since the last :func:`reset_counts`; ``buckets``
#: and ``bucket_bytes`` count :func:`sync_gradients`' all-reduces (also
#: counted under ``all_reduce``) and the bytes they reduce
COUNTS: Dict[str, int] = {"sync_gradients": 0, "buckets": 0,
                          "bucket_bytes": 0, "all_reduce": 0, "broadcast": 0,
                          "all_gather": 0, "reduce_scatter": 0}


def reset_counts() -> None:
  for name in COUNTS:
    COUNTS[name] = 0


def _axis(mesh, axis_name: str):
  """(group, degree) of ``axis_name``; the group is None when no
  collective is needed."""
  return mesh.group(axis_name), mesh.shape[axis_name]


def _staged_on_host(x: torch.Tensor, group) -> bool:
  """True for a CUDA tensor in a gloo ``all_gather`` or
  ``reduce_scatter``, which the port stages through the host."""
  return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
  host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
  host.copy_(x)
  return host


def _reduce(out: torch.Tensor, group) -> torch.Tensor:
  COUNTS["all_reduce"] += 1
  dist.all_reduce(out, group=group)
  return out


def all_reduce(x: torch.Tensor, mesh, axis_name: str = AXIS_DATA):
  """Sum of ``x`` over the axis (the reference's ``lax.psum``)."""
  group, _ = _axis(mesh, axis_name)
  out = x.clone()
  return out if group is None else _reduce(out, group)


def psum_mean(x: torch.Tensor, mesh, axis_name: str = AXIS_DATA):
  """All-reduce average over the axis (the gradient-sync primitive;
  the reference's ``lax.pmean``)."""
  group, n = _axis(mesh, axis_name)
  out = x.clone()
  if group is None:
    return out
  return _reduce(out, group).div_(n)


def all_gather(x: torch.Tensor, mesh, axis_name: str = AXIS_DATA,
               axis: int = 0, tiled: bool = True):
  """Every shard's ``x`` in rank order: concatenated along ``axis``
  (``tiled``) or stacked in a new dimension ``axis``."""
  group, n = _axis(mesh, axis_name)
  if group is None:
    return x.clone() if tiled else x.unsqueeze(axis)
  src = _to_host(x) if _staged_on_host(x, group) else x.contiguous()
  parts = [torch.empty_like(src) for _ in range(n)]
  COUNTS["all_gather"] += 1
  dist.all_gather(parts, src, group=group)
  out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)
  return out.to(x.device)


def reduce_scatter(x: torch.Tensor, mesh, axis_name: str = AXIS_DATA,
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
  src = x.movedim(axis, 0)
  src = _to_host(src) if _staged_on_host(x, group) else src.contiguous()
  out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                    dtype=src.dtype, device=src.device)
  COUNTS["reduce_scatter"] += 1
  dist.reduce_scatter_tensor(out, src, group=group)
  return out.movedim(0, axis).to(x.device)


def broadcast_from(x: torch.Tensor, mesh, axis_name: str = AXIS_DATA,
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
  if isinstance(axis_names, str):
    axis_names = (axis_names,)
  for axis in axis_names or ():
    sq = all_reduce(sq, mesh, axis)
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
                   axis_name: str = AXIS_DATA,
                   bucket_bytes: int = BUCKET_BYTES):
  """Average (or with ``mean=False`` sum) gradients over the axis by a
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
    COUNTS["all_reduce"] += 1
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


def _item_10(name: str):
  def refused(*args, **kwargs):
    raise NotImplementedError(
        "collectives.%s serves mesh axes other than data, which are not "
        "ported to PyTorch yet (ROADMAP Queue 1 item 10)" % name)
  refused.__name__ = name
  return refused


ring_permute = _item_10("ring_permute")
all_to_all = _item_10("all_to_all")
hierarchical_all_reduce = _item_10("hierarchical_all_reduce")
shard_map_fn = _item_10("shard_map_fn")
