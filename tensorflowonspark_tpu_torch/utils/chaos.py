"""Deterministic fault injection for exercising the fault-tolerance runtime.

The port's copy of ``tensorflowonspark_tpu/utils/chaos.py``: the same
knobs, spec grammar, per-process counters and validation of every
``TOS_CHAOS_*`` name (:func:`check_config`). Faults are armed through
environment variables, so they flow into engine executor processes
(``LocalEngine(env=...)``) and every child they spawn. All triggers are
deterministic: named injection points fire on exact invocation counts,
never at random.

``TOS_CHAOS_KILL`` = ``"point[@index][#nth]"`` (comma-separated specs)
    SIGKILL the calling process the nth time (default: 1st) the named
    :func:`kill_point` fires with a matching index. ``"train-step@0#3"``
    kills executor 0 the 3rd time it reaches the ``train-step`` point.
    Exactly once across process restarts: a sentinel file in the working
    directory records the fire, so a relaunched node sails past it.

``TOS_CHAOS_STALL`` = ``"point[@index]:seconds"`` (comma-separated)
    Sleep at the named :func:`stall_point` (first matching call per
    process): ``"feeder@1:3"`` stalls executor 1's feed task.

``TOS_CHAOS_RV_DROP`` = ``"VERB:count"`` (comma-separated)
    Rendezvous client fault: drop the first ``count`` messages of the
    verb before they reach the wire (``"BEAT:3"``: three lost beats).

``TOS_CHAOS_RV_DELAY`` = ``"VERB:seconds[:count]"`` (comma-separated)
    Rendezvous client fault: delay messages of the verb by ``seconds``
    before sending (the first ``count`` of them; default: all).

``TOS_CHAOS_SERVE`` = ``"point[@index][#nth]:raise"`` or
    ``"point[@index][#nth]:stall:seconds"`` (comma-separated)
    Serving fault at a named :func:`serve_fault` point (``serving.slots``
    arms ``prefill``, indexed by the prompt length, and ``decode``, once
    per ``step_many`` dispatch): ``raise`` throws :class:`InjectedFault`
    into the engine loop the nth time the point fires (crash replay),
    ``stall`` sleeps there (a hung device call; deadlines). Without
    ``@index`` the count is global across the point, with it per index:
    ``"prefill@13#1:raise,prefill@13#2:raise"`` makes every 13-token
    prompt a poison request while its neighbours sail through.

``TOS_CHAOS_FLEET`` = ``"point[@replica][#nth]:kill"`` or
    ``"point[@replica][#nth]:stall:seconds"`` (comma-separated)
    Replica fault at a named :func:`fleet_fault` point (``serving.fleet``
    arms ``dispatch`` with the replica id as index): ``kill`` tells the
    caller to kill that replica terminally the nth time the point fires,
    with everything it accepted mid-decode (``"dispatch@1#3:kill"``);
    ``stall`` sleeps at the dispatch (a slow router hop).

``TOS_CHAOS_DEPLOY`` = ``"point[@index][#nth]:kill"``,
    ``"...:poison"`` or ``"...:stall:seconds"`` (comma-separated)
    Deployment fault at a named :func:`deploy_fault` point
    (``serving.deploy`` arms ``canary``, ``verify``, ``promote`` and
    ``rollback``; promote passes the replica id being swapped as index,
    the others the candidate version): ``kill`` tells the caller that
    the controller dies at that boundary (``"promote#1:kill"`` dies
    mid-promote after the first remaining replica swapped), ``poison``
    that the candidate's params are corrupted at the canary build (a bad
    publish VERIFY must catch), ``stall`` sleeps there.

``TOS_CHAOS_HOST`` = ``"point[@host][#nth]:kill"``,
    ``"...:stall:seconds"`` or ``"...:partition:seconds"`` (comma-sep)
    Serving-host fault (``serving.host`` consults :func:`host_fault` at
    each sync round with the host id as index; point ``sync`` ticks every
    round, point ``decode`` only on rounds with requests in flight, so a
    ``decode`` kill lands mid-decode however long the engine build took):
    ``kill`` SIGKILLs the whole host process, ``stall`` sleeps the sync
    loop inline, ``partition`` makes the host skip all wire I/O for
    ``seconds`` while its engine keeps decoding; past
    ``TOS_HOST_TIMEOUT`` that silence reads as death.
    ``"decode@1#3:kill"`` kills host 1 on its 3rd sync round with live
    requests.

``TOS_CHAOS_GROUP`` = ``"kill[@group][#nth]"`` or
    ``"stall[@group][#nth]:seconds"`` (comma-separated)
    Group fault for elastic multi-group training (``parallel.groups``
    consults :func:`group_fault` at each sync-round boundary with the
    group id as index): ``kill`` stops that whole group mid-training
    without a contribution, so the surviving groups complete the round
    with the denominator shrunk and the plane marks it lost; ``stall``
    sleeps the group at the boundary (a slow or partitioned group, past
    the round's deadline). Without ``@group`` the nth count is global
    across all boundary consults.
"""

import logging
import os
import re
import signal
import threading
import time
from typing import Optional, Tuple

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


class InjectedFault(RuntimeError):
  """The exception a ``raise``-action serving fault throws: a stand-in
  for any device or runtime error escaping the engine loop thread."""


# per-process invocation counters, keyed by (point, index)
_counts = {}
_stalled = set()
_rv_counts = {}
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
  spec, with the reference's messages.
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
  for spec in _split_specs(os.environ.get(ENV_STALL)):
    try:
      _parse_stall_spec(spec)
    except ValueError:
      raise ValueError("%s: malformed stall spec %r (want "
                       "'point[@index]:seconds')" % (ENV_STALL, spec))
  for spec in _split_specs(os.environ.get(ENV_RV_DROP)):
    try:
      _parse_drop_spec(spec)
    except ValueError:
      raise ValueError("%s: malformed drop spec %r (want 'VERB:count')"
                       % (ENV_RV_DROP, spec))
  for spec in _split_specs(os.environ.get(ENV_RV_DELAY)):
    try:
      _parse_delay_spec(spec)
    except ValueError:
      raise ValueError("%s: malformed delay spec %r (want "
                       "'VERB:seconds[:count]')" % (ENV_RV_DELAY, spec))
  for spec in _split_specs(os.environ.get(ENV_SERVE)):
    try:
      _parse_serve_spec(spec)
    except ValueError:
      raise ValueError("%s: malformed serve spec %r (want "
                       "'point[@index][#nth]:raise' or "
                       "'point[@index][#nth]:stall:seconds')"
                       % (ENV_SERVE, spec))
  for spec in _split_specs(os.environ.get(ENV_FLEET)):
    try:
      _parse_fleet_spec(spec)
    except ValueError:
      raise ValueError("%s: malformed fleet spec %r (want "
                       "'point[@replica][#nth]:kill' or "
                       "'point[@replica][#nth]:stall:seconds')"
                       % (ENV_FLEET, spec))
  for spec in _split_specs(os.environ.get(ENV_GROUP)):
    try:
      _parse_group_spec(spec)
    except ValueError:
      raise ValueError("%s: malformed group spec %r (want "
                       "'kill[@group][#nth]' or "
                       "'stall[@group][#nth]:seconds')"
                       % (ENV_GROUP, spec))
  for spec in _split_specs(os.environ.get(ENV_DEPLOY)):
    try:
      _parse_deploy_spec(spec)
    except ValueError:
      raise ValueError("%s: malformed deploy spec %r (want "
                       "'point[@index][#nth]:kill', '...:poison' or "
                       "'...:stall:seconds')" % (ENV_DEPLOY, spec))
  for spec in _split_specs(os.environ.get(ENV_HOST)):
    try:
      _parse_host_spec(spec)
    except ValueError:
      raise ValueError("%s: malformed host spec %r (want "
                       "'point[@host][#nth]:kill', '...:stall:seconds' or "
                       "'...:partition:seconds')" % (ENV_HOST, spec))
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
    _stalled.clear()
    _rv_counts.clear()
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


# One parse function per knob grammar, shared by check_config AND the hooks
# — a validator that re-implemented the grammar could accept a spec the hook
# then silently never matched (the no-op class this module exists to kill).

def _parse_stall_spec(spec: str):
  """``"point[@index]:seconds"`` → ((name, index, nth), seconds)."""
  if ":" not in spec:
    raise ValueError(spec)
  target, secs = spec.rsplit(":", 1)
  return _parse_point_spec(target), float(secs)


def _parse_drop_spec(spec: str):
  """``"VERB:count"`` → (verb, count)."""
  parts = spec.split(":")
  if len(parts) != 2 or not parts[0]:
    raise ValueError(spec)
  return parts[0], int(parts[1])


def _parse_delay_spec(spec: str):
  """``"VERB:seconds[:count]"`` → (verb, seconds, count_or_None)."""
  parts = spec.split(":")
  if len(parts) not in (2, 3) or not parts[0]:
    raise ValueError(spec)
  return (parts[0], float(parts[1]),
          int(parts[2]) if len(parts) == 3 else None)


def _parse_action_spec(spec: str, hard_action: str):
  """``"point[@index][#nth]:<hard_action>"`` / ``"...:stall:seconds"`` →
  ((name, index, nth), action, seconds_or_None). The shared grammar
  behind the serve (``raise``) and fleet (``kill``) knobs."""
  parts = spec.split(":")
  if len(parts) < 2 or not parts[0]:
    raise ValueError(spec)
  target = _parse_point_spec(parts[0])
  action = parts[1]
  if action == hard_action:
    if len(parts) != 2:
      raise ValueError(spec)
    return target, action, None
  if action == "stall":
    if len(parts) != 3:
      raise ValueError(spec)
    return target, action, float(parts[2])
  raise ValueError(spec)


def _parse_serve_spec(spec: str):
  """``"point[@index][#nth]:raise"`` / ``"...:stall:seconds"``."""
  return _parse_action_spec(spec, "raise")


def _parse_fleet_spec(spec: str):
  """``"point[@replica][#nth]:kill"`` / ``"...:stall:seconds"``."""
  return _parse_action_spec(spec, "kill")


def _parse_deploy_spec(spec: str):
  """``"point[@index][#nth]:kill"``, ``"...:poison"`` or
  ``"...:stall:seconds"`` → ((name, index, nth), action, secs_or_None):
  the fleet grammar with two hard actions, ``kill`` (the controller dies
  at the boundary) and ``poison`` (the candidate's params are corrupted
  at the canary build)."""
  parts = spec.split(":")
  if len(parts) < 2 or not parts[0]:
    raise ValueError(spec)
  target = _parse_point_spec(parts[0])
  action = parts[1]
  if action in ("kill", "poison"):
    if len(parts) != 2:
      raise ValueError(spec)
    return target, action, None
  if action == "stall":
    if len(parts) != 3:
      raise ValueError(spec)
    return target, action, float(parts[2])
  raise ValueError(spec)


def _parse_host_spec(spec: str):
  """``"point[@host][#nth]:kill"``, ``"...:stall:seconds"`` or
  ``"...:partition:seconds"`` → ((name, host, nth), action,
  secs_or_None). ``partition`` carries a duration (how long the host's
  wire goes dark) but is not an inline stall: the caller keeps
  decoding."""
  parts = spec.split(":")
  if len(parts) < 2 or not parts[0]:
    raise ValueError(spec)
  target = _parse_point_spec(parts[0])
  action = parts[1]
  if action == "kill":
    if len(parts) != 2:
      raise ValueError(spec)
    return target, action, None
  if action in ("stall", "partition"):
    if len(parts) != 3:
      raise ValueError(spec)
    return target, action, float(parts[2])
  raise ValueError(spec)


def _parse_group_spec(spec: str):
  """``"kill[@group][#nth]"`` / ``"stall[@group][#nth]:seconds"`` ->
  ((action, group_or_None, nth), seconds_or_None). The action leads: the
  one injection point is the sync-round boundary, so there is no point
  name to parse."""
  parts = spec.split(":")
  target = _parse_point_spec(parts[0])
  action = target[0]
  if action == "kill":
    if len(parts) != 1:
      raise ValueError(spec)
    return target, None
  if action == "stall":
    if len(parts) != 2:
      raise ValueError(spec)
    return target, float(parts[1])
  raise ValueError(spec)


def _sentinel_path(name: str, index) -> str:
  safe = re.sub(r"[^A-Za-z0-9_.-]", "_", "%s_%s" % (name, index))
  return os.path.join(os.getcwd(), ".tos_chaos_fired_%s" % safe)


def _counted(point: str, index) -> Tuple[int, int]:
  """Bump and return (global, per-index) invocation counts of a point."""
  with _lock:
    gcount = _counts[(point, None)] = _counts.get((point, None), 0) + 1
    icount = gcount
    if index is not None:
      icount = _counts[(point, index)] = \
          _counts.get((point, index), 0) + 1
  return gcount, icount


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


def stall_point(name: str, index: Optional[int] = None) -> float:
  """Deterministic stall site: sleep when armed (first matching call per
  process). Returns the seconds slept (0.0 when disarmed)."""
  _first_consult()
  spec_env = os.environ.get(ENV_STALL)
  if not spec_env:
    return 0.0
  check_config()
  for spec in spec_env.split(","):
    (sname, sindex, _), duration = _parse_stall_spec(spec.strip())
    if sname != name or (sindex is not None and sindex != index):
      continue
    key = (name, index, "stall")
    with _lock:
      if key in _stalled:
        return 0.0
      _stalled.add(key)
    logger.warning("chaos: stalling %.2fs at point %r index %r",
                   duration, name, index)
    time.sleep(duration)
    return duration
  return 0.0


def serve_fault(name: str, index: Optional[int] = None) -> None:
  """Deterministic serving-plane fault site (``serving.slots`` arms
  ``prefill``/``decode``): raise :class:`InjectedFault` or stall when a
  ``TOS_CHAOS_SERVE`` spec matches this invocation.

  Two invocation counters run per point: a GLOBAL one (specs without
  ``@index``: "the nth time this point fires at all") and a per-index
  one (specs with ``@index``: "the nth time it fires for THIS index").
  The ``prefill`` point passes the prompt length as its index — the only
  stable identity a spec can name before request ids are assigned — so a
  per-index spec turns one crafted prompt into a deterministic poison
  request (docs/ROBUSTNESS.md).
  """
  _first_consult()
  spec_env = os.environ.get(ENV_SERVE)
  if not spec_env:
    return
  check_config()
  gcount, icount = _counted("serve." + name, index)
  for spec in _split_specs(spec_env):
    (sname, sindex, nth), action, secs = _parse_serve_spec(spec)
    if sname != name:
      continue
    if sindex is None:
      if gcount != nth:
        continue
    elif sindex != index or icount != nth:
      continue
    if action == "stall":
      logger.warning("chaos: stalling %.2fs at serving point %r index %r "
                     "(occurrence %d)", secs, name, index, nth)
      time.sleep(secs)
      continue
    logger.warning("chaos: raising at serving point %r index %r "
                   "(occurrence %d)", name, index, nth)
    raise InjectedFault(
        "chaos: injected fault at serving point %r (occurrence %d)"
        % (name, nth))


def fleet_fault(name: str, index: Optional[int] = None) -> Optional[str]:
  """Deterministic fleet-plane fault site (``serving.fleet`` arms
  ``dispatch`` with the target replica id as ``index``): returns
  ``"kill"`` when a ``TOS_CHAOS_FLEET`` kill spec matches this
  invocation — the CALLER then terminally kills that replica (the fault
  target is a replica, not the calling thread, so this hook signals
  instead of raising). Stall specs sleep inline (a slow dispatch hop)
  and return None, as does a disarmed/unmatched consult.

  Counters mirror :func:`serve_fault`: a GLOBAL per-point count (specs
  without ``@replica``: "the nth dispatch overall") and a per-index one
  (specs with it: "the nth dispatch routed to THIS replica").
  """
  _first_consult()
  spec_env = os.environ.get(ENV_FLEET)
  if not spec_env:
    return None
  check_config()
  gcount, icount = _counted("fleet." + name, index)
  for spec in _split_specs(spec_env):
    (sname, sindex, nth), action, secs = _parse_fleet_spec(spec)
    if sname != name:
      continue
    if sindex is None:
      if gcount != nth:
        continue
    elif sindex != index or icount != nth:
      continue
    if action == "stall":
      logger.warning("chaos: stalling %.2fs at fleet point %r replica %r "
                     "(occurrence %d)", secs, name, index, nth)
      time.sleep(secs)
      continue
    logger.warning("chaos: kill verdict at fleet point %r replica %r "
                   "(occurrence %d)", name, index, nth)
    return "kill"
  return None


def deploy_fault(name: str, index: Optional[int] = None) -> Optional[str]:
  """Deterministic deployment fault site (``serving.deploy`` arms
  ``canary``/``verify``/``promote``/``rollback``): returns ``"kill"``
  when a ``TOS_CHAOS_DEPLOY`` kill spec matches this invocation (the
  caller then dies as the controller at that state-machine boundary) or
  ``"poison"`` (the caller corrupts the candidate's params). Stall specs
  sleep inline and return None, as does a disarmed or unmatched consult.

  Counters mirror :func:`fleet_fault`: a global per-point count (specs
  without ``@index``) and a per-index one (``promote`` passes the replica
  id being swapped; ``canary``/``verify``/``rollback`` the candidate
  version).
  """
  _first_consult()
  spec_env = os.environ.get(ENV_DEPLOY)
  if not spec_env:
    return None
  check_config()
  gcount, icount = _counted("deploy." + name, index)
  for spec in _split_specs(spec_env):
    (sname, sindex, nth), action, secs = _parse_deploy_spec(spec)
    if sname != name:
      continue
    if sindex is None:
      if gcount != nth:
        continue
    elif sindex != index or icount != nth:
      continue
    if action == "stall":
      logger.warning("chaos: stalling %.2fs at deploy point %r index %r "
                     "(occurrence %d)", secs, name, index, nth)
      time.sleep(secs)
      continue
    logger.warning("chaos: %s verdict at deploy point %r index %r "
                   "(occurrence %d)", action, name, index, nth)
    return action
  return None


def host_fault(name: str, index: Optional[int] = None):
  """Deterministic serving-host fault site (``serving.host`` consults
  ``sync`` at each sync round and ``decode`` on rounds with requests in
  flight, with the host id as ``index``): returns ``("kill", None)`` when
  a ``TOS_CHAOS_HOST`` kill spec matches this invocation (the caller then
  SIGKILLs its own process) or ``("partition", seconds)`` (the caller
  skips all wire I/O for that long while its engine keeps decoding).
  Stall specs sleep inline and return None, as does a disarmed or
  unmatched consult.

  Counters mirror :func:`fleet_fault`: a global per-point count (specs
  without ``@host``) and a per-host one ("this host's nth round").
  """
  _first_consult()
  spec_env = os.environ.get(ENV_HOST)
  if not spec_env:
    return None
  check_config()
  gcount, icount = _counted("host." + name, index)
  for spec in _split_specs(spec_env):
    (sname, sindex, nth), action, secs = _parse_host_spec(spec)
    if sname != name:
      continue
    if sindex is None:
      if gcount != nth:
        continue
    elif sindex != index or icount != nth:
      continue
    if action == "stall":
      logger.warning("chaos: stalling %.2fs at host point %r host %r "
                     "(occurrence %d)", secs, name, index, nth)
      time.sleep(secs)
      continue
    logger.warning("chaos: %s verdict at host point %r host %r "
                   "(occurrence %d)", action, name, index, nth)
    return action, secs
  return None


def group_fault(index: Optional[int] = None) -> Optional[str]:
  """Deterministic training-group fault site (``parallel.groups``
  consults it at each sync-round boundary with the group id as
  ``index``): returns ``"kill"`` when a ``TOS_CHAOS_GROUP`` kill spec
  matches this invocation; the CALLER then stops that whole group
  without contributing to the round (the fault target is a group, not
  the calling thread, so this hook signals instead of raising). Stall
  specs sleep inline at the boundary and return None, as does a disarmed
  or unmatched consult.

  Counters mirror :func:`fleet_fault`: a global count over all boundary
  consults (specs without ``@group``) and a per-group one (specs with it:
  "this group's nth boundary").
  """
  _first_consult()
  spec_env = os.environ.get(ENV_GROUP)
  if not spec_env:
    return None
  check_config()
  gcount, icount = _counted("group.sync", index)
  for spec in _split_specs(spec_env):
    (action, sindex, nth), secs = _parse_group_spec(spec)
    if sindex is None:
      if gcount != nth:
        continue
    elif sindex != index or icount != nth:
      continue
    if action == "stall":
      logger.warning("chaos: stalling %.2fs at sync boundary, group %r "
                     "(occurrence %d)", secs, index, nth)
      time.sleep(secs)
      continue
    logger.warning("chaos: kill verdict for training group %r "
                   "(occurrence %d)", index, nth)
    return "kill"
  return None


def message_fault(verb) -> Tuple[bool, float]:
  """(drop, delay_seconds) for a rendezvous message of the given verb.

  Consulted by ``rendezvous.Client`` before each send. A dropped message
  never reaches the wire — the receiver simply never sees it, exactly like
  a lost datagram — and the client proceeds as if it were sent.
  """
  _first_consult()
  drop_env = os.environ.get(ENV_RV_DROP)
  delay_env = os.environ.get(ENV_RV_DELAY)
  if not drop_env and not delay_env:
    return False, 0.0
  check_config()
  drop = False
  delay = 0.0
  if drop_env:
    for spec in drop_env.split(","):
      sverb, count = _parse_drop_spec(spec.strip())
      if sverb != verb:
        continue
      with _lock:
        seen = _rv_counts[(verb, "drop")] = \
            _rv_counts.get((verb, "drop"), 0) + 1
      if seen <= count:
        drop = True
  if delay_env:
    for spec in delay_env.split(","):
      dverb, secs, limit = _parse_delay_spec(spec.strip())
      if dverb != verb:
        continue
      with _lock:
        seen = _rv_counts[(verb, "delay")] = \
            _rv_counts.get((verb, "delay"), 0) + 1
      if limit is None or seen <= limit:
        delay = secs
  return drop, delay
