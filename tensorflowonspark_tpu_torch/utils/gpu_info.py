"""CUDA card discovery and per-worker card allocation.

The port's counterpart of ``tensorflowonspark_tpu/utils/tpu_info.py``,
which replaced TensorFlowOnSpark's ``gpu_info.py`` with TPU chip shares.
On the card it is a GPU finder again, as the original was:

- the cards are counted by parsing ``nvidia-smi --query-gpu=...
  --format=csv,noheader`` (:func:`parse_gpus` takes the command's output,
  so tests feed it text), never through torch: ``torch.cuda.device_count``
  initializes state that ``CUDA_VISIBLE_DEVICES`` can no longer change;
- worker *i* of *n* on a host gets cards ``[i*k, (i+1)*k)`` for ``k``
  cards per node (:func:`chip_env_for_worker`, the by-worker-index
  placement of ``gpu_info.py:80-91``), exported as ``CUDA_VISIBLE_DEVICES``
  by :func:`apply_chip_env` before the user's fn touches CUDA.

There is no fallback: a request for more cards than the host has, or a
host without ``nvidia-smi``, raises and names the count. (The TPU module
skips silently when it finds no topology; here that would leave the
user's fn free to run on whatever card it finds.) ``TOS_TPU_TEST_MODE``
skips claiming altogether, as in the TPU module, so CPU test runs never
touch a card.
"""

import logging
import os
import shutil
import subprocess
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

#: skip all card claiming (CPU test runs); the TPU module's variable, so
#: one setting covers both packages
ENV_TEST_MODE = "TOS_TPU_TEST_MODE"
#: the ``CUDA_VISIBLE_DEVICES`` value this process claimed, exported once
#: a process has claimed its share, so a later task on the same persistent
#: executor process does not claim twice
ENV_CHIP_ENV_APPLIED = "TOS_CHIP_ENV_APPLIED"

QUERY = ("index", "uuid", "name", "memory.total")
_QUERY_TIMEOUT_S = 60


@dataclass(frozen=True)
class Gpu(object):
  """One card as ``nvidia-smi`` lists it."""
  index: int
  uuid: str
  name: str
  memory_total_mib: int


def query_command() -> List[str]:
  return ["nvidia-smi", "--query-gpu=" + ",".join(QUERY),
          "--format=csv,noheader,nounits"]


def parse_gpus(text: str) -> List[Gpu]:
  """The cards in the output of :func:`query_command`, ordered by index."""
  gpus = []
  for line in text.splitlines():
    if not line.strip():
      continue
    cols = [c.strip() for c in line.split(",")]
    if len(cols) != len(QUERY):
      raise ValueError("unexpected nvidia-smi line (want %d columns %s): %r"
                       % (len(QUERY), ",".join(QUERY), line))
    gpus.append(Gpu(int(cols[0]), cols[1], cols[2], int(float(cols[3]))))
  return sorted(gpus, key=lambda g: g.index)


def query_gpus() -> List[Gpu]:
  """This host's cards, from ``nvidia-smi``. Raises when the command is
  missing or fails: a host that cannot list its cards has none to give."""
  exe = shutil.which("nvidia-smi")
  if exe is None:
    raise RuntimeError("nvidia-smi not found on PATH: 0 CUDA card(s) "
                       "counted on this host")
  proc = subprocess.run([exe] + query_command()[1:], capture_output=True,
                        text=True, timeout=_QUERY_TIMEOUT_S)
  if proc.returncode != 0:
    raise RuntimeError("nvidia-smi failed (exit %d): %s"
                       % (proc.returncode, proc.stderr.strip()))
  return parse_gpus(proc.stdout)


def chip_env_for_worker(num_chips: int, worker_index: int,
                        workers_per_host: int,
                        num_cards: int) -> Dict[str, str]:
  """Env granting host-local worker ``worker_index`` (of
  ``workers_per_host`` on this host) ``num_chips`` cards of the
  ``num_cards`` the host has: cards ``[i*num_chips, (i+1)*num_chips)``.

  Raises ``ValueError`` naming the count when the share does not fit.
  """
  if num_chips < 1 or worker_index < 0 or workers_per_host < 1:
    raise ValueError("invalid card allocation request: num_chips={} "
                     "worker_index={} workers_per_host={}".format(
                         num_chips, worker_index, workers_per_host))
  local = worker_index % workers_per_host
  lo = local * num_chips
  if lo + num_chips > num_cards:
    raise ValueError(
        "worker %d of %d on this host asks for %d card(s) (cards %d..%d) "
        "but nvidia-smi counts %d card(s) on this host"
        % (local, workers_per_host, num_chips, lo, lo + num_chips - 1,
           num_cards))
  return {"CUDA_VISIBLE_DEVICES": ",".join(
              str(c) for c in range(lo, lo + num_chips)),
          # nvidia-smi numbers cards in PCI bus order; CUDA's default
          # order (fastest first) may differ on a mixed host
          "CUDA_DEVICE_ORDER": "PCI_BUS_ID"}


def _cuda_initialized() -> bool:
  """True when this process's torch has initialized CUDA already (torch
  is not imported for the check)."""
  torch = sys.modules.get("torch")
  return bool(torch is not None and torch.cuda.is_initialized())


def apply_chip_env(env_updates: Dict[str, str]) -> None:
  """Export a worker's card share; must run before CUDA is initialized.

  A persistent executor that claimed the same share before keeps it. A
  process whose CUDA is already initialized on a different set of cards
  raises instead of running on whatever card it holds.
  """
  want = env_updates["CUDA_VISIBLE_DEVICES"]
  held = os.environ.get(ENV_CHIP_ENV_APPLIED)
  if held == want and os.environ.get("CUDA_VISIBLE_DEVICES") == want:
    return
  if _cuda_initialized() and os.environ.get("CUDA_VISIBLE_DEVICES") != want:
    raise RuntimeError(
        "CUDA is already initialized in this process with "
        "CUDA_VISIBLE_DEVICES=%r; it cannot move to cards %r"
        % (os.environ.get("CUDA_VISIBLE_DEVICES"), want))
  os.environ.update(env_updates)
  os.environ[ENV_CHIP_ENV_APPLIED] = want
  logger.info("CUDA card allocation: %s", env_updates)


def allocate(num_chips: int, local_index: int, workers_per_host: int,
             gpus: Optional[List[Gpu]] = None) -> Dict[str, str]:
  """Claim this worker's cards: counts the host's cards (``nvidia-smi``
  unless ``gpus`` is given), exports the share and returns it."""
  gpus = query_gpus() if gpus is None else gpus
  env = chip_env_for_worker(num_chips, local_index, workers_per_host,
                            len(gpus))
  apply_chip_env(env)
  return env
