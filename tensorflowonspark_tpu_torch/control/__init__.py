"""The port's control plane: cluster rendezvous and the per-host feed hub.

Copies of the JAX package's ``control/{marker,rendezvous,feedhub,
chunkcodec}.py`` on the same wire: length-prefixed msgpack frames, written
by the port's own msgpack subset (:mod:`._msgpack`), so a client of either
package talks to a server of the other; and ``shmring``, the shared-memory
ring that carries a node's input in InputMode.SPARK.
"""

from tensorflowonspark_tpu_torch.control.marker import (  # noqa: F401
    EndPartition, Marker)
from tensorflowonspark_tpu_torch.control.rendezvous import (  # noqa: F401
    Client, Reservations, Server)
from tensorflowonspark_tpu_torch.control import feedhub  # noqa: F401
