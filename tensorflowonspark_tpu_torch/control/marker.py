"""Feed-queue sentinels: the port's copy of
``tensorflowonspark_tpu/control/marker.py`` (itself TensorFlowOnSpark's
``marker.py``).

``None`` on a feed queue means end-of-feed by convention; ``EndPartition``
separates partitions so inference can emit exactly one result batch per input
partition.
"""


class Marker(object):
  """Base class for feed-queue control markers."""


class EndPartition(Marker):
  """Marks the end of one data partition within the feed stream."""

  def __eq__(self, other):
    return isinstance(other, EndPartition)

  def __hash__(self):
    return hash(EndPartition)
