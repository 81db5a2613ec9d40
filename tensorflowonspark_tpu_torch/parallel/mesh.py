"""The mesh's named axes over the ``torch.distributed`` process group.

Counterpart of ``tensorflowonspark_tpu/parallel/mesh.py``: the same six
axis names, :class:`MeshSpec` and its ``-1`` rule, :func:`data_axes` and
:func:`axis_size`. Where the reference lays a ``jax.sharding.Mesh`` over
devices, the port lays a :class:`Mesh` over the processes of a group:
one process owns one card, so the group's size is the device count, and
outside a group it is 1.

Only the ``data`` axis may be above 1 (synchronous data parallelism:
each rank holds the whole state and its rows of the batch, and the
gradients are averaged over the group,
:func:`~tensorflowonspark_tpu_torch.parallel.collectives.sync_gradients`).
FSDP, pipeline, expert, sequence and tensor parallelism raise
``NotImplementedError``: ROADMAP Queue 1 item 10.

The reference's ``_topology_mesh_devices`` (TPU ICI coordinates, the
multi-slice DCN axis) has no counterpart: a process group has no
topology to read, and the data axis is the whole group.

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
  """The mesh of one process: its axes, their degrees, and the process
  group of each axis.

  ``shape`` maps each axis name to its degree, in ``axis_names`` order,
  as the reference's ``mesh.shape``; ``rank`` and ``size`` are this
  process's place in the group and the group's size. ``group(axis)`` is
  the group a collective over ``axis`` runs on: the data axis is the
  whole group; an axis of degree 1 has none (its collectives are the
  identity). ``group(AXIS_DATA)`` is None too outside a process group.
  """

  def __init__(self, axis_names: Sequence[str], shape: Dict[str, int],
               rank: int, group=None):
    self.axis_names = tuple(axis_names)
    self.shape = OrderedDict((a, int(shape[a])) for a in self.axis_names)
    self.rank = int(rank)
    self.size = math.prod(self.shape.values())
    self._groups = {a: group if a == AXIS_DATA else None
                    for a in self.axis_names}

  def group(self, axis: str):
    if axis not in self.shape:
      raise KeyError("mesh has no axis %r (axes %r)" % (axis,
                                                        self.axis_names))
    return self._groups[axis]

  def __repr__(self):
    return "Mesh(%s, rank=%d)" % (dict(self.shape), self.rank)


def _default_group():
  """The world group when a ``torch.distributed`` process group is up,
  else None."""
  import torch.distributed as dist
  if dist.is_available() and dist.is_initialized():
    return dist.group.WORLD
  return None


def build_mesh(spec: Optional[MeshSpec] = None, group=None,
               axis_names: Optional[Sequence[str]] = None) -> Mesh:
  """A :class:`Mesh` over the processes of ``group`` (default: the world
  group when one is initialized; outside one, a single process).

  ``group`` is a ``torch.distributed`` process group, or anything with
  ``size()`` and ``rank()``. Exactly one axis may be -1; it absorbs the
  process count left after the explicit axes divide in. Axes of degree 1
  stay in the mesh so every canonical axis can be named. The degrees and
  the error messages are the reference's. Any axis but ``data`` above 1
  raises ``NotImplementedError`` (ROADMAP Queue 1 item 10).
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
  wide = ["%s=%d" % (a, d) for a, d in degrees.items()
          if a != AXIS_DATA and d > 1]
  if wide:
    raise NotImplementedError(
        "mesh axes %s: only the data axis is ported to PyTorch (data "
        "parallelism across processes); FSDP, pipeline, expert, sequence "
        "and tensor parallelism are ROADMAP Queue 1 item 10"
        % ", ".join(wide))

  names = tuple(axis_names or CANONICAL_ORDER)
  mesh = Mesh(names, degrees, rank, group)
  logger.info("built mesh %s over %d process(es)", dict(mesh.shape), n)
  return mesh


def data_axes(mesh) -> tuple:
  """All axes a data batch is sharded over (data + fsdp)."""
  return tuple(a for a in (AXIS_DATA, AXIS_FSDP) if a in mesh.axis_names)


def axis_size(mesh, *axes: str) -> int:
  size = 1
  for a in axes:
    if a in mesh.axis_names:
      size *= mesh.shape[a]
  return size
