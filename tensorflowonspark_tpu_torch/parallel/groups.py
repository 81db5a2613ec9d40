"""Elastic multi-group training: hierarchical data parallelism that
survives group loss, resizes, and reshards its checkpoints.

The port's copy of ``tensorflowonspark_tpu/parallel/groups.py``. Groups
are INTERCHANGEABLE: each steps its own train loop, and every
``sync_every`` steps they merge their weights over the rendezvous plane,
so any group's post-sync state is the model. Losing one shrinks the
sync's denominator instead of killing the job, and a rebooted (or
brand-new) group catches up by pulling the current weights and joins at
the next sync boundary.

Three layers:

- :class:`SyncPlane` — driver-side round state, attached to the
  rendezvous :class:`~control.rendezvous.Server` as ``server.sync_plane``:
  serves the ``SYNC`` (contribute weights to a round), ``SYNCQ`` (poll
  for the merged result) and ``GROUP`` (join / leave / lost / state)
  verbs. A round completes when every member it froze at its creation
  contributed (less those lost since) OR its deadline passes: the
  denominator shrinks to whoever showed up, so a dead group delays a
  round by at most ``sync_timeout``. A group that misses ``miss_limit``
  rounds in a row is marked lost; its next contribution is REJECTED
  (stale weights never enter the average) and it must re-join, pulling
  the current weights.
- :class:`GroupSyncClient` — one group's client over
  :class:`~control.rendezvous.Client`; every wait has a deadline.
- :class:`GroupSet` — the in-process runtime: N groups as threads of
  this process, group ``g`` on card ``g % device_count`` (or all on the
  CPU), each stepping its own ``make_train_loop`` and syncing every
  ``sync_every`` steps. ``TOS_CHAOS_GROUP`` is consulted at each
  boundary; :meth:`GroupSet.save` / :meth:`GroupSet.restore_or` record
  and reshard the group topology through the checkpoint manifest.

Wire budget: a sync payload (one packed weight tree) must fit the
rendezvous frame (``rendezvous.MAX_MESSAGE_BYTES``, 4 MiB), as in the
reference. A payload past it raises ``ValueError`` at the send, and the
group ends as ``error: ...``.

Merge semantics: floating-point leaves take the weighted mean of the
round's contributions in f64 (weights = optimizer steps contributed);
other leaves take the first contribution. A bfloat16 leaf is a float
leaf here (the mean rounded to f32, then to bf16): numpy has no
bfloat16, so the reference's merge sees its dtype as kind ``'V'`` and
keeps the first contribution.
"""

import contextlib
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tensorflowonspark_tpu_torch.control import rendezvous
from tensorflowonspark_tpu_torch.obs import metrics as obs_metrics
from tensorflowonspark_tpu_torch.obs import spans as obs_spans
from tensorflowonspark_tpu_torch.utils import chaos

logger = logging.getLogger(__name__)

#: steps each group runs between cross-group syncs (GroupSet default)
ENV_GROUP_SYNC_EVERY = "TOS_GROUP_SYNC_EVERY"
#: seconds a round waits for stragglers after its first contribution
#: before merging with whoever showed up
ENV_GROUP_SYNC_TIMEOUT = "TOS_GROUP_SYNC_TIMEOUT"
#: consecutive missed rounds before a group is marked lost
ENV_GROUP_MISS_LIMIT = "TOS_GROUP_MISS_LIMIT"

_DEFAULT_SYNC_EVERY = 8
_DEFAULT_SYNC_TIMEOUT = 30.0
_DEFAULT_MISS_LIMIT = 2


def _env_int(name: str, default: int) -> int:
  try:
    return int(os.environ.get(name, default))
  except ValueError:
    return default


def _env_float(name: str, default: float) -> float:
  try:
    return float(os.environ.get(name, default))
  except ValueError:
    return default


class GroupEvicted(RuntimeError):
  """The plane rejected this group's contribution because it was marked
  lost (missed too many rounds, or the supervisor committed the shrink).
  The group must re-join, pulling the current weights, before it syncs
  again."""


# -- payload codec ------------------------------------------------------------
#
# The wire carries a FLAT LEAF LIST (msgpack-safe: dtype string, shape
# list, raw bytes); the tree stays client-side, the server merges by
# position, and unpack_tree copies into the caller's template, which
# every member shares by construction. Leaves are walked in the tree's
# own order (a dict's insertion order): the port's parameter dicts are
# built in one order in every group.

_BF16 = "bfloat16"


def _leaves(tree: Any) -> List[Any]:
  if isinstance(tree, dict):
    return [leaf for v in tree.values() for leaf in _leaves(v)]
  if isinstance(tree, (list, tuple)):
    return [leaf for v in tree for leaf in _leaves(v)]
  return [tree]


def _dtype_name(leaf) -> str:
  if isinstance(leaf, torch.Tensor):
    return str(leaf.dtype).replace("torch.", "")
  return str(np.asarray(leaf).dtype)


def _leaf_bytes(leaf) -> bytes:
  if isinstance(leaf, torch.Tensor):
    t = leaf.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
      t = t.view(torch.int16)
    return t.numpy().tobytes()
  return np.ascontiguousarray(leaf).tobytes()


def pack_tree(tree: Any) -> List[dict]:
  """Flatten a tree of tensors (or numpy arrays) into the wire leaf list."""
  return [{"dtype": _dtype_name(leaf), "shape": list(np.shape(leaf)),
           "data": _leaf_bytes(leaf)} for leaf in _leaves(tree)]


def _leaf_tensor(rec: dict) -> torch.Tensor:
  """A wire leaf as a CPU tensor of its own dtype."""
  if rec["dtype"] == _BF16:
    flat = torch.frombuffer(bytearray(rec["data"]), dtype=torch.bfloat16)
    return flat.reshape(rec["shape"])
  return torch.from_numpy(np.frombuffer(rec["data"], dtype=rec["dtype"])
                          .reshape(rec["shape"]).copy())


def unpack_tree(leaves: List[dict], template: Any) -> Any:
  """Copy the wire list into ``template``'s leaves in place, each keeping
  its device and dtype; returns ``template``. Raises ``ValueError`` when
  the leaf counts or a leaf's shape differ."""
  targets = _leaves(template)
  if len(leaves) != len(targets):
    raise ValueError("payload has %d leaves, template has %d"
                     % (len(leaves), len(targets)))
  for rec, dst in zip(leaves, targets):
    if list(rec["shape"]) != list(np.shape(dst)):
      raise ValueError("payload leaf of shape %s, template's %s"
                       % (list(rec["shape"]), list(np.shape(dst))))
  with torch.no_grad():
    for rec, dst in zip(leaves, targets):
      src = _leaf_tensor(rec)
      if isinstance(dst, torch.Tensor):
        dst.copy_(src)
      else:
        np.copyto(dst, src.float().numpy() if src.dtype == torch.bfloat16
                  else src.numpy(), casting="unsafe")
  return template


def _as_f64(rec: dict) -> np.ndarray:
  return _leaf_tensor(rec).double().numpy()


def _is_float(dtype: str) -> bool:
  return dtype == _BF16 or np.dtype(dtype).kind == "f"


def merge_payloads(contribs: List[Tuple[float, List[dict]]]) -> List[dict]:
  """Weighted-mean merge of wire leaf lists: float leaves (bfloat16
  included) in f64; first-wins for the rest. Runs on the driver."""
  if not contribs:
    raise ValueError("nothing to merge")
  weights = [max(0.0, float(w)) for w, _ in contribs]
  total = sum(weights) or float(len(contribs))
  first = contribs[0][1]
  merged = []
  for i, rec in enumerate(first):
    if not _is_float(rec["dtype"]):
      merged.append(dict(rec))
      continue
    acc = np.zeros(rec["shape"], dtype=np.float64)
    for (_, leaves), wt in zip(contribs, weights):
      acc += _as_f64(leaves[i]).reshape(rec["shape"]) * (wt or 1.0)
    acc /= (total or 1.0)
    if rec["dtype"] == _BF16:
      data = torch.from_numpy(acc.astype(np.float32)).to(
          torch.bfloat16).view(torch.int16).numpy().tobytes()
    else:
      data = acc.astype(rec["dtype"]).tobytes()
    merged.append({"dtype": rec["dtype"], "shape": list(rec["shape"]),
                   "data": data})
  return merged


# -- driver-side round state --------------------------------------------------


class SyncPlane(object):
  """Cross-group sync rounds and group membership, served over rendezvous.

  Attach to a :class:`control.rendezvous.Server` (``server.sync_plane =
  plane`` or :func:`attach_sync_plane`); the server delegates the
  SYNC/SYNCQ/GROUP verbs to :meth:`handle` and adds :meth:`status` to
  HEALTH replies as ``groups``.

  Member requests and round deadlines drive every state change: there is
  no background thread, so the plane is exactly as alive as the server
  serving it. A round's members are frozen when its first contribution
  creates it: a group that joins mid-round takes part from the next
  round, and a contributor the plane does not know admits itself.
  """

  def __init__(self, sync_timeout: Optional[float] = None,
               miss_limit: Optional[int] = None, keep_rounds: int = 4,
               time_fn=time.monotonic):
    self.sync_timeout = (sync_timeout if sync_timeout is not None
                         else _env_float(ENV_GROUP_SYNC_TIMEOUT,
                                         _DEFAULT_SYNC_TIMEOUT))
    self.miss_limit = (miss_limit if miss_limit is not None
                       else _env_int(ENV_GROUP_MISS_LIMIT,
                                     _DEFAULT_MISS_LIMIT))
    self.keep_rounds = keep_rounds
    self._now = time_fn
    self._lock = threading.Lock()
    self.active: set = set()
    self.lost: Dict[int, str] = {}          # gid -> reason
    self._ever: set = set()
    self._miss: Dict[int, int] = {}         # gid -> consecutive misses
    # round -> {"contrib": {gid: (weight, leaves)}, "need": set,
    #           "deadline": float, "t0": float, "merged": leaves|None,
    #           "members": [gid], "step": int}
    self._rounds: Dict[int, dict] = {}
    #: latest merged weights, the catch-up payload a (re)joining group
    #: pulls: {"round": int, "step": int, "payload": leaves}
    self.latest: Optional[dict] = None
    self.rounds_completed = 0
    self.last_sync_ms: Optional[float] = None
    self.step = 0                           # highest synced member step
    self.events: deque = deque(maxlen=256)

  # -- membership -------------------------------------------------------------

  def _event_locked(self, kind: str, **fields) -> None:
    self.events.append(dict(fields, event=kind, t=self._now()))
    logger.info("sync plane: %s %s", kind, fields)

  def join(self, gid: int) -> dict:
    with self._lock:
      fresh = gid not in self.active
      self.active.add(gid)
      self._ever.add(gid)
      self.lost.pop(gid, None)
      self._miss.pop(gid, None)
      if fresh:
        self._event_locked("join", group=gid, active=len(self.active))
      latest = self.latest
      return {"type": "GROUP", "ok": True, "active": sorted(self.active),
              "step": self.step,
              "round": latest["round"] if latest else -1,
              "payload": latest["payload"] if latest else None}

  def leave(self, gid: int) -> dict:
    with self._lock:
      self.active.discard(gid)
      self._miss.pop(gid, None)
      self._event_locked("leave", group=gid, active=len(self.active))
      return {"type": "GROUP", "ok": True, "active": sorted(self.active)}

  def mark_lost(self, gid: int, reason: str = "reported") -> None:
    """Commit the shrink: the group stops counting toward round
    completion and its contributions are rejected until it re-joins.
    Idempotent."""
    with self._lock:
      self._mark_lost_locked(gid, reason)

  def _mark_lost_locked(self, gid: int, reason: str) -> None:
    if gid in self.lost:
      return
    self.active.discard(gid)
    self._ever.add(gid)
    self.lost[gid] = reason
    self._miss.pop(gid, None)
    self._event_locked("lost", group=gid, reason=reason,
                       active=len(self.active))

  def seed(self, step: int, payload: Optional[List[dict]] = None) -> None:
    """Prime the plane after a checkpoint restore: the step counter (and
    optionally the restored weights as late joiners' catch-up payload)
    continue from the checkpoint instead of zero."""
    with self._lock:
      self.step = max(self.step, int(step))
      if payload is not None:
        self.latest = {"round": -1, "step": int(step), "payload": payload}

  # -- rounds -----------------------------------------------------------------

  def contribute(self, gid: int, rnd: int, payload: List[dict],
                 weight: float = 1.0, step: int = 0) -> dict:
    with self._lock:
      if gid in self.lost:
        return {"type": "OK", "accepted": False, "lost": True,
                "reason": self.lost[gid]}
      if gid not in self.active:
        # an unknown contributor admits itself (first-round bootstrap);
        # members join explicitly, so this is the exception path
        self.active.add(gid)
        self._ever.add(gid)
        self._event_locked("join", group=gid, active=len(self.active),
                           implicit=True)
      r = self._rounds.get(rnd)
      if r is None:
        now = self._now()
        r = self._rounds[rnd] = {
            "contrib": {}, "need": set(self.active),
            "deadline": now + self.sync_timeout, "t0": now,
            "merged": None, "members": [], "step": 0}
      r["contrib"][gid] = (float(weight), payload)
      r["step"] = max(r["step"], int(step))
      self._miss[gid] = 0
      return {"type": "OK", "accepted": True,
              "contributed": len(r["contrib"]),
              "need": sorted(r["need"] - self.lost.keys())}

  def poll(self, rnd: int) -> dict:
    with self._lock:
      r = self._rounds.get(rnd)
      if r is None:
        return {"type": "SYNC", "done": False, "round": rnd,
                "waiting_on": []}
      if r["merged"] is None:
        # members are frozen at round creation (a mid-round joiner takes
        # part from the next boundary), but losses committed mid-round
        # shrink the wait at once
        need = r["need"] - set(self.lost)
        have = set(r["contrib"])
        if (have and have >= need) or self._now() >= r["deadline"]:
          self._merge_locked(rnd, r, need)
      if r["merged"] is None:
        need = r["need"] - set(self.lost)
        return {"type": "SYNC", "done": False, "round": rnd,
                "waiting_on": sorted(need - set(r["contrib"]))}
      return {"type": "SYNC", "done": True, "round": rnd,
              "payload": r["merged"], "members": r["members"],
              "denominator": len(r["members"]), "step": r["step"]}

  def _merge_locked(self, rnd: int, r: dict, need: set) -> None:
    missing = sorted(need - set(r["contrib"]))
    for gid in missing:
      misses = self._miss[gid] = self._miss.get(gid, 0) + 1
      if misses >= self.miss_limit:
        self._mark_lost_locked(
            gid, "missed %d consecutive sync round(s)" % misses)
    members = sorted(r["contrib"])
    r["merged"] = merge_payloads([r["contrib"][g] for g in members])
    r["members"] = members
    now = self._now()
    self.last_sync_ms = (now - r["t0"]) * 1000.0
    self.rounds_completed += 1
    self.step = max(self.step, r["step"])
    self.latest = {"round": rnd, "step": r["step"], "payload": r["merged"]}
    self._event_locked("round", round=rnd, members=members,
                       missing=missing, step=r["step"],
                       sync_ms=round(self.last_sync_ms, 3))
    # the contributions served their purpose: keep only the merged
    # result, and only for the last few rounds (stragglers polling late)
    r["contrib"] = {}
    for old in sorted(self._rounds):
      if old < rnd - self.keep_rounds:
        del self._rounds[old]

  # -- wire entry points ------------------------------------------------------

  def handle(self, msg: dict) -> dict:
    """Serve one SYNC/SYNCQ/GROUP message (the Server's delegate)."""
    mtype = msg.get("type")
    if mtype == "SYNC":
      return self.contribute(int(msg["group_id"]), int(msg["round"]),
                             msg["payload"],
                             weight=msg.get("weight", 1.0),
                             step=msg.get("step", 0))
    if mtype == "SYNCQ":
      return self.poll(int(msg["round"]))
    if mtype == "GROUP":
      action = msg.get("action")
      gid = int(msg["group_id"]) if "group_id" in msg else None
      if action == "join":
        return self.join(gid)
      if action == "leave":
        return self.leave(gid)
      if action == "lost":
        self.mark_lost(gid, msg.get("reason", "reported"))
        return {"type": "GROUP", "ok": True, "active": sorted(self.active)}
      if action == "state":
        return dict(self.status(), type="GROUP", ok=True)
      return {"type": "ERROR", "error": "unknown GROUP action %r" % action}
    return {"type": "ERROR", "error": "sync plane cannot serve %r" % mtype}

  def status(self) -> dict:
    """The bounded topology summary for HEALTH replies."""
    with self._lock:
      return {"active": sorted(self.active),
              "lost": sorted(self.lost),
              "groups_active": len(self.active),
              "groups_total": len(self._ever),
              "round": self.latest["round"] if self.latest else -1,
              "step": self.step,
              "rounds_completed": self.rounds_completed,
              "sync_ms": (round(self.last_sync_ms, 3)
                          if self.last_sync_ms is not None else None)}


def attach_sync_plane(server, **kwargs) -> SyncPlane:
  """Create a :class:`SyncPlane` and attach it to a rendezvous server
  (idempotent: returns the plane already attached, if any)."""
  plane = getattr(server, "sync_plane", None)
  if plane is None:
    plane = SyncPlane(**kwargs)
    server.sync_plane = plane
  return plane


# -- group-side client --------------------------------------------------------


class GroupSyncClient(object):
  """One group's handle on the sync plane. Every wait has an explicit
  deadline: a plane that never completes a round surfaces as
  :class:`TimeoutError` here, never as a wedged group."""

  def __init__(self, server_addr: Tuple[str, int], group_id: int,
               request_timeout: float = 30.0):
    self.group_id = int(group_id)
    self._client = rendezvous.Client(tuple(server_addr),
                                     timeout=request_timeout)

  def join(self) -> dict:
    return self._client._request({"type": "GROUP", "action": "join",
                                  "group_id": self.group_id})

  def leave(self) -> dict:
    return self._client._request({"type": "GROUP", "action": "leave",
                                  "group_id": self.group_id})

  def report_lost(self, group_id: int, reason: str = "reported") -> dict:
    return self._client._request({"type": "GROUP", "action": "lost",
                                  "group_id": int(group_id),
                                  "reason": reason})

  def state(self) -> dict:
    return self._client._request({"type": "GROUP", "action": "state",
                                  "group_id": self.group_id})

  def sync(self, round_num: int, tree: Any, weight: float = 1.0,
           step: int = 0, timeout: float = 60.0,
           poll_interval: float = 0.02) -> Tuple[Any, List[int]]:
    """Contribute ``tree`` to ``round_num`` and wait (bounded) for the
    merged result, copied into ``tree`` in place: ``(tree, member_gids)``.

    Raises :class:`GroupEvicted` when the plane marked this group lost
    (the caller must :meth:`join` again, pulling the current weights,
    before its next sync) and :class:`TimeoutError` past ``timeout``;
    ``tree`` is untouched then.
    """
    payload = pack_tree(tree)
    resp = self._client._request(
        {"type": "SYNC", "group_id": self.group_id, "round": int(round_num),
         "payload": payload, "weight": float(weight), "step": int(step)})
    if resp.get("lost"):
      raise GroupEvicted("group %d evicted from the sync plane (%s)"
                         % (self.group_id, resp.get("reason")))
    deadline = time.monotonic() + max(0.0, timeout)
    while True:
      resp = self._client._request({"type": "SYNCQ",
                                    "round": int(round_num)})
      if resp.get("done"):
        return (unpack_tree(resp["payload"], tree),
                [int(g) for g in resp.get("members", [])])
      if time.monotonic() >= deadline:
        raise TimeoutError(
            "sync round %d did not complete within %.1fs (waiting on %s)"
            % (round_num, timeout, resp.get("waiting_on")))
      time.sleep(poll_interval)

  def close(self) -> None:
    try:
      self._client.close()
    except Exception:  # noqa: BLE001 - best-effort socket teardown
      pass


# -- the in-process group runtime --------------------------------------------


class TrainGroup(object):
  """One group: a private TrainLoop on one device, stepping on its own
  between sync boundaries."""

  def __init__(self, group_id: int, state: Any, loop, sync: GroupSyncClient,
               device: torch.device, steps: int = 0):
    self.group_id = int(group_id)
    self.state = state
    self.loop = loop
    self.sync = sync
    self.device = device
    self.steps = int(steps)
    self.losses: List[float] = []
    self.alive = True
    self.exit_reason: Optional[str] = None
    self.sync_ms: Optional[float] = None
    self.thread: Optional[threading.Thread] = None


def _on(device: torch.device):
  """The calling thread's CUDA device set to ``device`` while inside (and
  restored on the way out); nothing for a CPU device."""
  if device.type == "cuda":
    return torch.cuda.device(device)
  return contextlib.nullcontext()


class GroupSet(object):
  """N interchangeable groups training one model (see the module doc).

  ``build_fn(device) -> (state, loss_fn)`` builds each group's initial
  :class:`~tensorflowonspark_tpu_torch.train_state.TrainState` on its
  device and its ``loss_fn(model, batch)``; every group must build the
  SAME structure (interchangeability is the contract). ``batch_fn(
  group_id, step) -> batch`` supplies deterministic per-group data;
  keyed by ``(group_id, step)``, the data position IS the step counter,
  so a resharded restore resumes the feed for free.

  Groups are threads of this process; group ``g`` runs on card ``g %
  device_count`` (``device="cuda"``, the default) or on the CPU
  (``device="cpu"``). A group over several cards is item 10c, part 3d:
  ``devices_per_group > 1`` raises when more than one card is visible,
  and clamps to 1 on one card, as the reference clamps to the devices
  it has.
  """

  def __init__(self, build_fn: Callable, batch_fn: Callable,
               num_groups: int, sync_every: Optional[int] = None,
               sync_timeout: Optional[float] = None,
               miss_limit: Optional[int] = None,
               unroll: Optional[int] = None,
               devices_per_group: int = 1,
               server: Optional[rendezvous.Server] = None,
               device: str = "cuda"):
    if num_groups < 1:
      raise ValueError("need at least one group")
    self.device_type = torch.device(device).type
    cards = torch.cuda.device_count() if self.device_type == "cuda" else 1
    if min(max(1, int(devices_per_group)), cards) > 1:
      raise NotImplementedError(
          "devices_per_group=%d: a group over several cards is not ported "
          "to PyTorch yet (ROADMAP Queue 1 item 10c, part 3d)"
          % devices_per_group)
    self.build_fn = build_fn
    self.batch_fn = batch_fn
    self.sync_every = (sync_every if sync_every is not None
                       else _env_int(ENV_GROUP_SYNC_EVERY,
                                     _DEFAULT_SYNC_EVERY))
    self.sync_timeout = (sync_timeout if sync_timeout is not None
                         else _env_float(ENV_GROUP_SYNC_TIMEOUT,
                                         _DEFAULT_SYNC_TIMEOUT))
    self.unroll = unroll
    self.devices_per_group = 1
    self._own_server = server is None
    if server is None:
      server = rendezvous.Server(1)
      server.start()
    self.server = server
    self.plane = attach_sync_plane(server, sync_timeout=self.sync_timeout,
                                   miss_limit=miss_limit)
    self.groups: Dict[int, TrainGroup] = {}
    self.events: deque = deque(maxlen=256)
    self._plane_events_seen = 0
    self._stop = threading.Event()
    self._total: Optional[int] = None
    self._lock = threading.Lock()
    for gid in range(num_groups):
      self.groups[gid] = self._make_group(gid)
    self._publish_telemetry()

  # -- construction -----------------------------------------------------------

  def _device_for(self, gid: int) -> torch.device:
    """The reference's ``_mesh_for``: one device a group, group ``gid``
    on card ``gid % device_count``."""
    if self.device_type != "cuda":
      return torch.device(self.device_type)
    return torch.device("cuda", gid % torch.cuda.device_count())

  def _make_group(self, gid: int) -> TrainGroup:
    from tensorflowonspark_tpu_torch.parallel import sharding as SH
    device = self._device_for(gid)
    with _on(device):
      state, loss_fn = self.build_fn(device)
    # donation off: the group reads its state at sync boundaries (to
    # pack the params) after the loop call that produced it
    loop = SH.make_train_loop(loss_fn, None, unroll=self.unroll,
                              donate_state=False)
    sync = GroupSyncClient(self.server.addr, gid,
                           request_timeout=max(5.0, self.sync_timeout))
    group = TrainGroup(gid, state, loop, sync, device)
    resp = sync.join()
    payload = resp.get("payload")
    if payload is not None:
      # catch-up: a (re)admitted group adopts the collective's current
      # weights (its optimizer state stays) and step, and joins at the
      # next boundary as a peer
      with _on(device):
        unpack_tree(payload, group.state.params)
      group.steps = int(resp.get("step", 0))
      self._event("catch-up", group=gid, step=group.steps)
    return group

  # -- events + telemetry -----------------------------------------------------

  def _event(self, kind: str, **fields) -> None:
    rec = dict(fields, event=kind, t=time.monotonic())
    self.events.append(rec)
    logger.info("groupset: %s %s", kind, fields)
    rec_obs = obs_spans.active()
    if rec_obs is not None:
      rec_obs.event("groups." + kind,
                    **{k: v for k, v in fields.items()
                       if isinstance(v, (int, float, str, bool))})

  def _drain_plane_events(self) -> None:
    events = list(self.plane.events)
    for rec in events[self._plane_events_seen:]:
      kind = rec.get("event")
      if kind in ("lost", "round"):
        self._event("plane-" + kind,
                    **{k: v for k, v in rec.items()
                       if k not in ("event", "t")})
    self._plane_events_seen = len(events)

  def _publish_telemetry(self) -> None:
    reg = obs_metrics.active()
    if reg is None:
      return
    status = self.plane.status()
    reg.gauge("training.groups_total").set(
        max(status["groups_total"], len(self.groups)))
    reg.gauge("training.groups_active").set(status["groups_active"])
    if status["sync_ms"] is not None:
      reg.gauge("training.sync_ms").set(status["sync_ms"])

  # -- the per-group loop -----------------------------------------------------

  def _group_main(self, g: TrainGroup, total_steps: int) -> None:
    try:
      with _on(g.device):
        self._group_steps(g, total_steps)
    except Exception as e:  # noqa: BLE001 - a group failure must surface
      # as a lost group, never as a silent thread death
      g.alive = False
      g.exit_reason = "error: %s" % e
      logger.exception("group %d failed", g.group_id)
      self._event("group-error", group=g.group_id, error=str(e))

  def _group_steps(self, g: TrainGroup, total_steps: int) -> None:
    while g.alive and g.steps < total_steps and not self._stop.is_set():
      if chaos.group_fault(g.group_id) == "kill":
        # the whole group dies mid-training: no contribution, no goodbye;
        # the plane finds out through the round deadline
        g.alive = False
        g.exit_reason = "chaos-kill"
        self._event("group-killed", group=g.group_id, step=g.steps)
        return
      n = min(self.sync_every or total_steps, total_steps - g.steps)
      for _ in range(n):
        batch = self.batch_fn(g.group_id, g.steps)
        g.state, losses = g.loop(g.state, batch)
        g.steps += 1
        g.losses.extend(losses.detach().float().cpu().reshape(-1).tolist())
      if not self.sync_every:
        continue          # sync disabled (single-group baseline)
      rnd = g.steps // self.sync_every
      t0 = time.monotonic()
      try:
        _, members = g.sync.sync(rnd, g.state.params, weight=n,
                                 step=g.steps,
                                 timeout=self.sync_timeout + 10.0)
      except GroupEvicted:
        # marked lost while stalled or partitioned: its stale weights were
        # rejected; re-admit through join (adopting the current weights
        # and step)
        resp = g.sync.join()
        payload = resp.get("payload")
        if payload is not None:
          unpack_tree(payload, g.state.params)
          g.steps = int(resp.get("step", g.steps))
        self._event("group-readmitted", group=g.group_id, step=g.steps)
        continue
      except (TimeoutError, ConnectionError) as e:
        g.alive = False
        g.exit_reason = "sync-failed: %s" % e
        self._event("group-sync-failed", group=g.group_id,
                    step=g.steps, error=str(e))
        return
      g.sync_ms = (time.monotonic() - t0) * 1000.0
      self._event("sync", group=g.group_id, round=rnd, step=g.steps,
                  denominator=len(members), sync_ms=round(g.sync_ms, 3))
      self._drain_plane_events()
      self._publish_telemetry()
    if g.alive:
      g.exit_reason = "completed"

  def run(self, total_steps: int) -> None:
    """Start every group stepping toward ``total_steps`` (returns at
    once; :meth:`wait` joins)."""
    self._total = int(total_steps)
    for g in self.groups.values():
      self._spawn(g)

  def _spawn(self, g: TrainGroup) -> None:
    g.thread = threading.Thread(
        target=self._group_main, args=(g, self._total),
        name="train-group-%d" % g.group_id, daemon=True)
    g.thread.start()

  def wait(self, timeout: float = 300.0) -> bool:
    """Join every group thread (bounded). True when every thread ended."""
    deadline = time.monotonic() + timeout
    done = True
    for g in list(self.groups.values()):
      if g.thread is None:
        continue
      g.thread.join(max(0.0, deadline - time.monotonic()))
      done = done and not g.thread.is_alive()
    self._drain_plane_events()
    self._publish_telemetry()
    return done

  def stop(self) -> None:
    self._stop.set()

  def close(self) -> None:
    self.stop()
    for g in self.groups.values():
      g.sync.close()
    if self._own_server:
      self.server.stop()

  # -- elasticity -------------------------------------------------------------

  def readmit(self, gid: int) -> TrainGroup:
    """Bring a lost (or brand-new) group back: build it fresh, pull the
    current weights and step from the plane (the join catch-up), and
    start it toward the same target; it takes part from the next sync
    boundary. Scale-up (``grow``) is the same operation with a new id."""
    with self._lock:
      old = self.groups.get(gid)
      if old is not None and old.thread is not None \
          and old.thread.is_alive():
        raise RuntimeError("group %d is still running" % gid)
      g = self._make_group(gid)
      self.groups[gid] = g
    self._event("group-readmitted", group=gid, step=g.steps)
    self._publish_telemetry()
    if self._total is not None:
      self._spawn(g)
    return g

  grow = readmit

  def commit_shrink(self, gid: int, reason: str = "shrink committed") -> None:
    """Give up on a group: evict it from the plane, so rounds never wait
    for it and its stale contributions are rejected."""
    self.plane.mark_lost(gid, reason)
    self._event("resize-shrink", group=gid, reason=reason)
    self._drain_plane_events()
    self._publish_telemetry()

  def active_groups(self) -> List[int]:
    return sorted(g.group_id for g in self.groups.values() if g.alive)

  # -- checkpoints (topology in the manifest, resharding restore) -------------

  def _chief(self) -> TrainGroup:
    alive = [g for g in self.groups.values() if g.alive]
    if not alive:
      raise RuntimeError("no live group to checkpoint")
    return min(alive, key=lambda g: g.group_id)

  def manifest(self) -> dict:
    chief = self._chief()
    return {"schema": 1, "kind": "groupset",
            "num_groups": len(self.active_groups()),
            "groups": self.active_groups(),
            "step": chief.steps,
            "sync_every": self.sync_every,
            "sync_round": (chief.steps // self.sync_every
                           if self.sync_every else 0)}

  def save(self, mgr, force: bool = False) -> bool:
    """The chief group's save, with the group topology in the commit
    manifest. Call it at a sync boundary: post-sync every group holds
    the merged weights, so the chief's state IS the collective state and
    any later group count can restore from it."""
    chief = self._chief()
    saved = mgr.save(chief.steps, chief.state, force=force,
                     manifest=self.manifest())
    if saved:
      self._event("checkpoint", step=chief.steps,
                  groups=len(self.active_groups()))
    return saved

  def restore_or(self, mgr) -> int:
    """Restore the latest committed checkpoint INTO THIS topology,
    resharding across a different group count, and return the next step
    (0 when starting fresh).

    Every group loads the same step into its own state on its own device
    (groups hold the same weights at a boundary, so a change of topology
    is a broadcast, not a re-partition); the plane is seeded so later
    joiners catch up to the restored step, and ``batch_fn(group_id,
    step)`` makes the feed follow the step.
    """
    chief = self._chief()
    with _on(chief.device):
      state, next_step, manifest = mgr.restore_or(chief.state,
                                                  with_manifest=True)
    if next_step == 0:
      return 0
    saved_step = next_step - 1
    if manifest and manifest.get("num_groups") not in (
        None, len(self.groups)):
      logger.info(
          "resharding checkpoint step %d across %d group(s) (saved with "
          "%d)", saved_step, len(self.groups), manifest["num_groups"])
    for g in self.groups.values():
      if g is not chief:
        with _on(g.device):
          g.state = mgr.restore(g.state, step=saved_step)
      else:
        g.state = state
      g.steps = saved_step
    self.plane.seed(saved_step, pack_tree(state.params))
    self._event("restore", step=saved_step, groups=len(self.groups),
                saved_groups=(manifest or {}).get("num_groups"))
    return next_step


__all__ = ["GroupEvicted", "pack_tree", "unpack_tree", "merge_payloads",
           "SyncPlane", "attach_sync_plane", "GroupSyncClient", "TrainGroup",
           "GroupSet", "ENV_GROUP_SYNC_EVERY", "ENV_GROUP_SYNC_TIMEOUT",
           "ENV_GROUP_MISS_LIMIT"]
