"""The port's control plane: cluster rendezvous and the per-host feed hub.

Copies of the JAX package's ``control/{marker,rendezvous,feedhub,
chunkcodec}.py`` on the same wire: length-prefixed msgpack frames, written
by the port's own msgpack subset (:mod:`._msgpack`), so a client of either
package talks to a server of the other. ``shmring`` (the shared-memory
feed ring) comes with the feed plane, ROADMAP Queue 1 item 14.
"""

from tensorflowonspark_tpu_torch.control.marker import (  # noqa: F401
    EndPartition, Marker)
from tensorflowonspark_tpu_torch.control.rendezvous import (  # noqa: F401
    Client, Reservations, Server)
from tensorflowonspark_tpu_torch.control import feedhub  # noqa: F401
