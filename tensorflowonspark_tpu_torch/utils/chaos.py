"""Deterministic fault injection: the kill site of the fault-tolerance runtime.

The port's copy of the part of ``tensorflowonspark_tpu/utils/chaos.py``
that the checkpoint-and-resume path needs: :func:`kill_point`, armed by
``TOS_CHAOS_KILL``, with the same spec grammar, the same exactly-once
sentinel in the node's working directory (a relaunched node sails past
the point that killed its predecessor) and the same validation of every
``TOS_CHAOS_*`` name (:func:`check_config`).

``TOS_CHAOS_KILL`` = ``"point[@index][#nth]"`` (comma-separated specs)
    SIGKILL the calling process the nth time (default: 1st) the named
    :func:`kill_point` fires with a matching index. ``"train-step@0#3"``
    kills executor 0 the 3rd time it reaches the ``train-step`` point.

The other fault sites of the reference (``TOS_CHAOS_STALL``, the
rendezvous message faults, the serving, fleet, deploy, host and group
faults) are not ported yet (ROADMAP Queue 1 item 8). Arming one raises
``NotImplementedError`` at the first consult instead of injecting
nothing: a chaos run that silently injects no fault would pass for the
wrong reason.
"""

import logging
import os
import re
import signal
import threading
from typing import Optional

logger = logging.getLogger(__name__)

ENV_KILL = "TOS_CHAOS_KILL"
ENV_STALL = "TOS_CHAOS_STALL"
ENV_RV_DROP = "TOS_CHAOS_RV_DROP"
ENV_RV_DELAY = "TOS_CHAOS_RV_DELAY"
ENV_SERVE = "TOS_CHAOS_SERVE"
ENV_FLEET = "TOS_CHAOS_FLEET"
ENV_GROUP = "TOS_CHAOS_GROUP"
ENV_DEPLOY = "TOS_CHAOS_DEPLOY"
ENV_HOST = "TOS_CHAOS_HOST"

_KNOWN_ENV = (ENV_KILL, ENV_STALL, ENV_RV_DROP, ENV_RV_DELAY, ENV_SERVE,
              ENV_FLEET, ENV_GROUP, ENV_DEPLOY, ENV_HOST)
_ENV_PREFIX = "TOS_CHAOS_"

# per-process invocation counters, keyed by (point, index)
_counts = {}
_lock = threading.Lock()
#: the last validated env signature (hooks consult check_config per call)
_validated = None
#: first-consult guard: with only a typo'd TOS_CHAOS_* name set, the kill
#: hook's fast path would return before reaching check_config
_first_consult_done = False


def _first_consult():
  global _first_consult_done
  if _first_consult_done:
    return
  _first_consult_done = True
  if any(k.startswith(_ENV_PREFIX) for k in os.environ):
    check_config()


def check_config() -> None:
  """Validate every armed fault schedule.

  Raises ``ValueError`` for an unknown ``TOS_CHAOS_*`` name or a malformed
  kill spec, as the reference does, and ``NotImplementedError`` for an
  armed knob whose fault site the port does not have yet (item 8).
  """
  global _validated
  sig = tuple(os.environ.get(k) for k in _KNOWN_ENV) + tuple(
      sorted(k for k in os.environ if k.startswith(_ENV_PREFIX)))
  if sig == _validated:
    return
  unknown = sorted(k for k in os.environ
                   if k.startswith(_ENV_PREFIX) and k not in _KNOWN_ENV)
  if unknown:
    raise ValueError(
        "unknown chaos env var(s) %s — known knobs: %s (a typo'd name "
        "would silently inject nothing)" % (unknown, list(_KNOWN_ENV)))
  for spec in _split_specs(os.environ.get(ENV_KILL)):
    try:
      _parse_point_spec(spec)
    except ValueError:
      raise ValueError("%s: malformed kill spec %r (want "
                       "'point[@index][#nth]')" % (ENV_KILL, spec))
  armed = [k for k in _KNOWN_ENV if k != ENV_KILL and os.environ.get(k)]
  if armed:
    raise NotImplementedError(
        "%s: only the kill site (%s) is ported to PyTorch; the other chaos "
        "fault sites are ROADMAP Queue 1 item 8" % (", ".join(armed),
                                                      ENV_KILL))
  _validated = sig


def _split_specs(env_value):
  if not env_value:
    return []
  return [s.strip() for s in env_value.split(",") if s.strip()]


def enabled() -> bool:
  """True when any chaos env var is armed (cheap fast-path guard)."""
  _first_consult()
  armed = any(os.environ.get(k) for k in _KNOWN_ENV)
  if armed:
    check_config()
  return armed


def reset() -> None:
  """Forget per-process counters (test isolation helper)."""
  global _validated, _first_consult_done
  with _lock:
    _counts.clear()
    _validated = None
    _first_consult_done = False


def _parse_point_spec(spec: str):
  """``"name[@index][#nth]"`` -> (name, index_or_None, nth)."""
  nth = 1
  if "#" in spec:
    spec, n = spec.rsplit("#", 1)
    nth = int(n)
  index = None
  if "@" in spec:
    spec, i = spec.rsplit("@", 1)
    index = int(i)
  return spec, index, nth


def _sentinel_path(name: str, index) -> str:
  safe = re.sub(r"[^A-Za-z0-9_.-]", "_", "%s_%s" % (name, index))
  return os.path.join(os.getcwd(), ".tos_chaos_fired_%s" % safe)


def kill_point(name: str, index: Optional[int] = None) -> None:
  """Deterministic crash site: SIGKILL this process when armed.

  Call sites name a point (e.g. ``"train-step"``) and pass their identity
  (executor id) as ``index``; the ``TOS_CHAOS_KILL`` spec decides whether
  and on which invocation the kill fires. SIGKILL, not an exception, so
  the process dies the way a preempted host does: no traceback, no
  cleanup, heartbeats just stop.
  """
  _first_consult()
  spec_env = os.environ.get(ENV_KILL)
  if not spec_env:
    return
  check_config()
  with _lock:
    count = _counts[(name, index)] = _counts.get((name, index), 0) + 1
  for spec in spec_env.split(","):
    sname, sindex, nth = _parse_point_spec(spec.strip())
    if sname != name or (sindex is not None and sindex != index):
      continue
    if count != nth:
      continue
    sentinel = _sentinel_path(name, index)
    if os.path.exists(sentinel):
      return  # already fired in a previous incarnation of this node
    with open(sentinel, "w") as f:
      f.write("fired at count %d pid %d\n" % (count, os.getpid()))
      f.flush()
      os.fsync(f.fileno())
    logger.warning("chaos: SIGKILL at point %r index %r (invocation %d)",
                   name, index, count)
    os.kill(os.getpid(), signal.SIGKILL)
