"""The mesh's named axes over the ``torch.distributed`` process group.

Counterpart of ``tensorflowonspark_tpu/parallel/mesh.py``: the same six
axis names, :class:`MeshSpec` and its ``-1`` rule, :func:`data_axes` and
:func:`axis_size`. Where the reference lays a ``jax.sharding.Mesh`` over
devices, the port lays a :class:`Mesh` over the processes of a group:
one process owns one card (or shares one over gloo), so the group's size
is the device count, and outside a group it is 1.

Ranks lie on the mesh in ``axis_names`` order, row-major (the last axis,
``tensor`` in :data:`CANONICAL_ORDER`, varies fastest), as the
reference's devices fill its mesh in enumeration order. Each process has
a coordinate on every axis (:meth:`Mesh.coord`, the counterpart of
``lax.axis_index``), and :meth:`Mesh.group` is the process group of the
ranks that differ only on the axes asked for. Every axis may be above 1:
``parallel.sharding`` says what ``data``, ``fsdp``, ``expert``,
``sequence`` and ``tensor`` cut; ``pipeline`` is the 1F1B pipeline's
stage axis (``parallel.pipeline_parallel``), which the train step of
``parallel.sharding`` cuts nothing over.

The reference's ``_topology_mesh_devices`` (TPU ICI coordinates, the
multi-slice DCN axis) has no counterpart: a process group has no
topology to read.

Axis conventions (outer to inner), as in the reference:

- ``data``      batch sharding (pure DP; gradients all-reduced)
- ``fsdp``      batch + parameter sharding (ZeRO-style)
- ``pipeline``  layer-stage sharding
- ``expert``    MoE expert sharding
- ``sequence``  sequence/context sharding (ring attention)
- ``tensor``    within-layer parameter sharding (megatron-style TP)
"""

import logging
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

logger = logging.getLogger(__name__)

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_PIPELINE = "pipeline"
AXIS_EXPERT = "expert"
AXIS_SEQUENCE = "sequence"
AXIS_TENSOR = "tensor"

# outer→inner order; tensor innermost (highest-bandwidth neighbor exchanges)
CANONICAL_ORDER = (AXIS_DATA, AXIS_FSDP, AXIS_PIPELINE, AXIS_EXPERT,
                   AXIS_SEQUENCE, AXIS_TENSOR)


@dataclass
class MeshSpec:
  """Requested parallelism degrees; -1 on one axis means "absorb the rest"."""
  data: int = -1
  fsdp: int = 1
  pipeline: int = 1
  expert: int = 1
  sequence: int = 1
  tensor: int = 1

  def degrees(self) -> Dict[str, int]:
    return {AXIS_DATA: self.data, AXIS_FSDP: self.fsdp,
            AXIS_PIPELINE: self.pipeline, AXIS_EXPERT: self.expert,
            AXIS_SEQUENCE: self.sequence, AXIS_TENSOR: self.tensor}


class Mesh(object):
  """The mesh of one process: its axes, their degrees, its coordinate on
  each, and the process group of each set of axes.

  ``shape`` maps each axis name to its degree, in ``axis_names`` order,
  as the reference's ``mesh.shape``; ``rank`` and ``size`` are this
  process's place in the group and the group's size. Rank ``r`` sits at
  the row-major coordinates of ``r`` over ``shape`` (:meth:`coord`).

  ``group(axes)`` is the group a collective over ``axes`` (one name or
  several) runs on: the ranks that differ from this one only on those
  axes. When that is every rank of the mesh it is the mesh's own group
  (so at world size 1 every axis has the one-rank group, and the
  collective still runs); when it is this rank alone the answer is None
  (the collective is the identity); anything between is a subgroup,
  made for every set of axes above 1 when the mesh is built
  (``torch.distributed.new_group`` must be called by every process, in
  one order). Outside a process group every answer is None.
  """

  def __init__(self, axis_names: Sequence[str], shape: Dict[str, int],
               rank: int, group=None, subgroups=None):
    self.axis_names = tuple(axis_names)
    self.shape = OrderedDict((a, int(shape[a])) for a in self.axis_names)
    self.rank = int(rank)
    self.size = math.prod(self.shape.values())
    self._group = group
    self._subgroups = dict(subgroups or {})
    self._coords = {}
    rest = self.rank
    for a in reversed(self.axis_names):
      self._coords[a] = rest % self.shape[a]
      rest //= self.shape[a]

  def _check(self, axes) -> tuple:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
      if a not in self.shape:
        raise KeyError("mesh has no axis %r (axes %r)" % (a,
                                                          self.axis_names))
    return axes

  def wide(self, axes=None) -> tuple:
    """The axes of ``axes`` (default: all) whose degree is above 1, in
    ``axis_names`` order."""
    want = set(self.axis_names if axes is None else self._check(axes))
    return tuple(a for a in self.axis_names
                 if a in want and self.shape[a] > 1)

  def coord(self, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
    return self._coords[self._check(axis)[0]]

  def rank_at(self, **coords) -> int:
    """The rank at this rank's coordinates with ``coords`` replaced."""
    at = dict(self._coords, **coords)
    rank = 0
    for a in self.axis_names:
      if not 0 <= at[a] < self.shape[a]:
        raise ValueError("coordinate %d is off axis %r of degree %d"
                         % (at[a], a, self.shape[a]))
      rank = rank * self.shape[a] + at[a]
    return rank

  def ranks(self, axes) -> list:
    """The ranks of ``group(axes)`` in the order of their coordinates on
    ``axes`` (row-major), which is also their order in the group."""
    axes = self.wide(axes)
    out = []
    for flat in range(math.prod(self.shape[a] for a in axes)):
      coords = {}
      for a in reversed(axes):
        coords[a] = flat % self.shape[a]
        flat //= self.shape[a]
      out.append(self.rank_at(**coords))
    return out

  def group(self, axes):
    axes = self.wide(axes)
    if self._group is None:
      return None
    if len(axes) == len(self.wide()):
      return self._group
    if not axes:
      return None
    if axes not in self._subgroups:
      raise RuntimeError(
          "no process group over %r: a mesh with several axes above 1 is "
          "built by build_mesh over the world group" % (axes,))
    return self._subgroups[axes]

  def __repr__(self):
    return "Mesh(%s, rank=%d)" % (dict(self.shape), self.rank)


def _default_group():
  """The world group when a ``torch.distributed`` process group is up,
  else None."""
  import torch.distributed as dist
  if dist.is_available() and dist.is_initialized():
    return dist.group.WORLD
  return None


def _subgroups(names, degrees, group) -> dict:
  """A process group for every proper subset of the axes above 1 (two or
  more of them): each subset's blocks of ranks, in rank order, through
  ``new_group``, which every process calls alike; this process keeps the
  group of its own block. A mesh with one wide axis needs none, and a
  stand-in group (anything but a ``torch.distributed`` process group)
  gets none."""
  import itertools
  import torch.distributed as dist
  wide = [a for a in names if degrees[a] > 1]
  if len(wide) < 2 or not (dist.is_available() and dist.is_initialized()
                           and isinstance(group, dist.ProcessGroup)):
    return {}
  if group != dist.group.WORLD and \
      dist.get_world_size(group) != dist.get_world_size():
    raise ValueError("a mesh with several axes above 1 spans the whole "
                     "world group")
  probe = Mesh(names, degrees, 0)
  me = int(group.rank())
  out = {}
  for k in range(1, len(wide)):
    for axes in itertools.combinations(wide, k):
      rest = [a for a in names if a not in axes]
      seen = set()
      for r in range(probe.size):
        at = Mesh(names, degrees, r)
        key = tuple(at.coord(a) for a in rest)
        if key in seen:
          continue
        seen.add(key)
        block = at.ranks(axes)
        g = dist.new_group(block)
        if me in block:
          out[tuple(axes)] = g
  return out


def build_mesh(spec: Optional[MeshSpec] = None, group=None,
               axis_names: Optional[Sequence[str]] = None) -> Mesh:
  """A :class:`Mesh` over the processes of ``group`` (default: the world
  group when one is initialized; outside one, a single process).

  ``group`` is a ``torch.distributed`` process group, or anything with
  ``size()`` and ``rank()``. Exactly one axis may be -1; it absorbs the
  process count left after the explicit axes divide in. Axes of degree 1
  stay in the mesh so every canonical axis can be named. The degrees and
  the error messages are the reference's. With
  two or more axes above 1 every process of the world group must call
  this together: it makes the subgroups of :meth:`Mesh.group`.
  """
  spec = spec or MeshSpec()
  if group is None:
    group = _default_group()
  n = int(group.size()) if group is not None else 1
  rank = int(group.rank()) if group is not None else 0

  degrees = spec.degrees()
  wildcard = [a for a, d in degrees.items() if d == -1]
  if len(wildcard) > 1:
    raise ValueError("at most one mesh axis may be -1, got %r" % wildcard)
  explicit = math.prod(d for d in degrees.values() if d != -1)
  if wildcard:
    if n % explicit != 0:
      raise ValueError(
          "explicit axes %r use %d-way parallelism which does not divide %d "
          "devices" % (degrees, explicit, n))
    degrees[wildcard[0]] = n // explicit
  elif explicit != n:
    raise ValueError("mesh %r needs %d devices, have %d"
                     % (degrees, explicit, n))
  names = tuple(axis_names or CANONICAL_ORDER)
  mesh = Mesh(names, degrees, rank, group,
              _subgroups(names, degrees, group))
  logger.info("built mesh %s over %d process(es)", dict(mesh.shape), n)
  return mesh


def axis_index(mesh, axis: str) -> int:
  """This process's coordinate on ``axis`` (``lax.axis_index``); 0
  without a mesh."""
  return 0 if mesh is None else mesh.coord(axis)


def data_axes(mesh) -> tuple:
  """All axes a data batch is sharded over (data + fsdp)."""
  return tuple(a for a in (AXIS_DATA, AXIS_FSDP) if a in mesh.axis_names)


def axis_size(mesh, *axes: str) -> int:
  size = 1
  for a in axes:
    if a in mesh.axis_names:
      size *= mesh.shape[a]
  return size
