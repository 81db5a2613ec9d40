"""Host-level utilities: IP discovery, port selection, executor-id persistence.

The port's copy of ``tensorflowonspark_tpu/utils/hostinfo.py``
(TensorFlowOnSpark's ``util.py:52-94``): ``get_ip_address``,
``get_free_port``, ``find_in_path``, ``single_node_env`` and the
executor-id file protocol that lets later tasks on an executor find the
feed hub an earlier task started in the same working directory.

One difference: ``get_ip_address`` reads the address of this host's own
interfaces (the one that carries the default route first) instead of
connecting a UDP socket towards an outside address, so no code of the port
ever addresses a host beyond this one to learn its own IP.
"""

import errno
import fcntl
import logging
import os
import socket
import struct
from typing import Optional

logger = logging.getLogger(__name__)

EXECUTOR_ID_FILE = "executor_id"

_SIOCGIFADDR = 0x8915   # linux/sockios.h: an interface's IPv4 address


def _default_route_interface(route_table: str = "/proc/net/route"
                             ) -> Optional[str]:
  """The name of the interface that carries the IPv4 default route, or
  None (no such route, or no ``/proc``)."""
  try:
    with open(route_table) as f:
      next(f)   # header
      for line in f:
        cols = line.split()
        if len(cols) > 1 and cols[1] == "00000000":
          return cols[0]
  except (OSError, StopIteration):
    return None
  return None


def _interface_address(name: str) -> Optional[str]:
  """The IPv4 address of interface ``name``, or None if it has none."""
  s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
  try:
    packed = fcntl.ioctl(s.fileno(), _SIOCGIFADDR,
                         struct.pack("256s", name[:15].encode()))
    return socket.inet_ntoa(packed[20:24])
  except OSError:
    return None
  finally:
    s.close()


def get_ip_address() -> str:
  """Best-effort routable IPv4 address of the current host.

  The default route's interface first, then any other interface that is
  not loopback, then ``127.0.0.1`` (a single host with no network still
  works).
  """
  names = []
  default = _default_route_interface()
  if default:
    names.append(default)
  try:
    names += [n for _, n in socket.if_nameindex() if n not in names]
  except OSError:
    pass
  for name in names:
    addr = _interface_address(name)
    if addr and not addr.startswith("127."):
      return addr
  return "127.0.0.1"


def get_free_port(host: str = "") -> int:
  """Bind an ephemeral TCP port, release it, and return its number."""
  s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
  try:
    s.bind((host, 0))
    return s.getsockname()[1]
  finally:
    s.close()


def find_in_path(path: str, file_name: str):
  """Find a file in a ':'-separated path string; return full path or False."""
  for p in path.split(os.pathsep):
    candidate = os.path.join(p, file_name)
    if os.path.exists(candidate) and os.path.isfile(candidate):
      return candidate
  return False


def single_node_env(num_chips: int = 0, worker_index: int = 0,
                    workers_per_host: int = 1) -> None:
  """Prepare this process's env for standalone single-node execution.

  Parity with TensorFlowOnSpark's ``util.single_node_env`` (``util.py:
  21-49``), which set GPU visibility for one-off tasks: claims
  ``num_chips`` cards for this process (``CUDA_VISIBLE_DEVICES``) before
  anything initializes CUDA. Raises when the host has too few.
  """
  from tensorflowonspark_tpu_torch.utils import gpu_info
  if num_chips and not os.environ.get(gpu_info.ENV_TEST_MODE):
    gpu_info.apply_chip_env(gpu_info.chip_env_for_worker(
        num_chips, worker_index, workers_per_host,
        num_cards=len(gpu_info.query_gpus())))


def write_executor_id(num: int, working_dir: str = ".") -> None:
  """Persist this executor's id to a file in the executor working dir.

  Later tasks scheduled onto the same executor read this file to find the
  feed hub owned by this executor (TensorFlowOnSpark: ``util.py:77-94``).
  """
  with open(os.path.join(working_dir, EXECUTOR_ID_FILE), "w") as f:
    f.write(str(num))


def read_executor_id(working_dir: str = ".") -> int:
  """Read the executor id written by :func:`write_executor_id`."""
  path = os.path.join(working_dir, EXECUTOR_ID_FILE)
  try:
    with open(path, "r") as f:
      return int(f.read())
  except OSError as e:
    if e.errno == errno.ENOENT:
      raise RuntimeError(
          "No executor_id file found in {}; the node runtime has not started "
          "on this executor".format(os.path.abspath(working_dir)))
    raise
