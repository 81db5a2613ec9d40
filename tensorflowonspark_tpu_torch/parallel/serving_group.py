"""The executor's serving group: decoding over a mesh from one process.

The port's counterpart of the reference's ``_SERVING_MESH_CACHE`` +
``build_mesh(mesh_spec)`` (``make_serving_predict_fn``): where a JAX
executor drives all its local devices from one process, a PyTorch process
drives one rank of a process group. A serving bundle that carries a
``MeshSpec`` wider than one rank therefore serves through a group of
processes that the executor starts on its first serve:

* the executor process is rank 0; it spawns the other ranks (``spawn``,
  never ``fork``: it may hold a CUDA context already) and hosts the
  group's ``TCPStore`` on a free port (port 0), so groups started at the
  same moment on one host never collide;
* the spec's ``-1`` absorbs the visible cards divided by the explicit
  product (at least 1). With a card for every rank the ranks join over
  NCCL, one card each; with fewer (one card, or none: the CPU), they share
  the cards round-robin over gloo, which is logged once;
* each rank builds the mesh (``parallel.mesh.build_mesh``), receives the
  whole weights once per ``params_fingerprint`` (one broadcast from rank
  0) and cuts its blocks (``Transformer(cfg, whole, mesh=...)``);
* the other ranks then loop on the ops rank 0 posts in the store: a small
  header (the op, the batch shape, ``num_steps``, ``eos_id``, ``pad_id``,
  ``temperature``, ``top_k`` and the sampling seed), then the prompt by
  broadcast, then the same ``greedy_generate_kv`` on every rank; each
  rank posts its status, and rank 0 returns the tokens;
* ``STOP`` ends them when the executor exits (a ``multiprocessing``
  exit finalizer, which an executor process runs where ``atexit`` hooks
  do not; or :func:`shutdown_all`); a follower also exits when rank 0's
  process is gone.

Every wait is bounded: the collectives by the group's timeout, the waits
for a follower's start and status by the same timeout and by the
follower's liveness. A follower that fails or dies makes rank 0 raise,
naming the rank, and the group is torn down (the next serve starts a new
one); serving never falls back to one card.

The live groups sit in this module's cache, never in a pickled predict
fn. A process that already has a default process group (a predict fn
called inside ``cluster.run``'s main fn) is refused by name: the serving
group would need a store and a world of its own beside it (ROADMAP Queue 1
item 10c, part 3b-ii).
"""

import datetime
import json
import logging
import math
import multiprocessing as mp
import multiprocessing.util
import os
import threading
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib

logger = logging.getLogger(__name__)

#: seconds a collective, a follower's start and a serve's statuses may take
TIMEOUT_S = 300.0
#: seconds between rank 0's checks that its followers live, while it waits
_SLICE_S = 1.0

#: live groups of this process by (mesh degrees, device)
_GROUPS: Dict[tuple, "ServingGroup"] = {}
_SHARED_LOGGED = [False]
_GROUPS_LOCK = threading.Lock()


def _cards(device) -> int:
  dev = torch.device("cuda" if device is None else device)
  return torch.cuda.device_count() if dev.type == "cuda" else 0


def resolve_degrees(spec, device=None) -> Dict[str, int]:
  """The degrees of ``spec`` (a ``MeshSpec``) for an executor whose
  device is ``device``: a ``-1`` absorbs the visible cards divided by the
  product of the explicit degrees, and is at least 1 (0 cards on the
  CPU). Every degree 1 is one process: no group."""
  degrees = spec.degrees()
  wild = [a for a, d in degrees.items() if d == -1]
  if len(wild) > 1:
    raise ValueError("at most one mesh axis may be -1, got %r" % wild)
  explicit = math.prod(d for d in degrees.values() if d != -1)
  if wild:
    degrees[wild[0]] = max(1, _cards(device) // explicit)
  return degrees


def _cfg_from_wire(d: dict):
  """The inverse of ``serving.host.cfg_wire``."""
  from tensorflowonspark_tpu_torch.models.transformer import TransformerConfig
  return TransformerConfig(**dict(d, dtype=getattr(torch, d["dtype"])))


def _rank_device(device, rank: int, cards: int) -> torch.device:
  """Rank ``rank``'s device: rank 0's is ``device`` as given (``None``:
  the current card), the others' the next cards round-robin from its
  index."""
  dev = torch.device("cuda" if device is None else device)
  if dev.type != "cuda":
    return dev
  first = torch.cuda.current_device() if dev.index is None else dev.index
  return torch.device("cuda", (first + rank) % cards)


def _pack(params) -> tuple:
  """``(names, shapes, dtypes, byte offsets, one uint8 buffer)`` of a flat
  weight dict (tensors or arrays), each weight at an 8-byte aligned
  offset."""
  names, shapes, dtypes, offsets, parts, at = [], [], [], [], [], 0
  for name in sorted(params):
    v = params[name]
    t = v.detach().cpu() if torch.is_tensor(v) else torch.from_numpy(
        np.array(v, order="C"))
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    pad = (-raw.numel()) % 8
    names.append(name)
    shapes.append(list(t.shape))
    dtypes.append(str(t.dtype).replace("torch.", ""))
    offsets.append(at)
    parts.append(raw)
    if pad:
      parts.append(torch.zeros(pad, dtype=torch.uint8))
    at += raw.numel() + pad
  buf = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8)
  return names, shapes, dtypes, offsets, buf


def _unpack(header: dict, buf: torch.Tensor) -> dict:
  out = {}
  for name, shape, dtype, at in zip(header["names"], header["shapes"],
                                    header["dtypes"], header["offsets"]):
    dt = getattr(torch, dtype)
    n = math.prod(shape) * torch.empty((), dtype=dt).element_size()
    out[name] = buf[at:at + n].view(dt).reshape(shape)
  return out


def _generator(seed, temperature: float, device):
  if temperature <= 0:
    return None
  gen = torch.Generator(device=device)
  gen.manual_seed(int(seed))
  return gen


class _Decoder(object):
  """What every rank of a group holds: its mesh, its model of the last
  weights loaded, and the ops the group runs."""

  def __init__(self, mesh, device: torch.device, comm: torch.device):
    self.mesh, self.device, self.comm = mesh, device, comm
    self.model, self.loaded = None, None

  def load(self, header: dict, buf: Optional[torch.Tensor]) -> None:
    """The whole weights of ``header`` by one broadcast from rank 0 (which
    passes its packed ``buf``), cut into this rank's model."""
    from tensorflowonspark_tpu_torch.models import transformer as tfm
    if buf is None:
      buf = torch.empty(header["bytes"], dtype=torch.uint8, device=self.comm)
    else:
      buf = buf.to(self.comm)
    dist.broadcast(buf, src=0)
    whole = _unpack(header, buf.cpu())
    cfg = _cfg_from_wire(header["cfg"])
    self.model = None
    self.model = tfm.Transformer(cfg, whole, device=self.device,
                                 mesh=self.mesh)
    self.loaded = (header["print"], json.dumps(header["cfg"],
                                               sort_keys=True))

  def generate(self, header: dict, prompt: Optional[np.ndarray]):
    """The op's prompt by broadcast from rank 0 (which passes it), then
    ``greedy_generate_kv`` on this rank's model over the mesh."""
    from tensorflowonspark_tpu_torch.models import transformer as tfm
    t = torch.empty(header["shape"], dtype=torch.long, device=self.comm) \
        if prompt is None else torch.as_tensor(
            np.asarray(prompt, np.int64)).to(self.comm)
    dist.broadcast(t, src=0)
    if self.mesh.rank:
      from tensorflowonspark_tpu_torch.utils import chaos
      chaos.kill_point("serve-group", self.mesh.rank)
    return tfm.greedy_generate_kv(
        self.model, t.to(self.device), header["num_steps"],
        eos_id=header["eos_id"], pad_id=header["pad_id"],
        temperature=header["temperature"], top_k=header["top_k"],
        generator=_generator(header["seed"], header["temperature"],
                             self.device))


def _await_op(store, key: str, parent: int, timeout: float) -> None:
  """Block until rank 0 posts ``key``. Exits this process when rank 0's
  process (``parent``) is gone: its store goes with it, which ends the
  wait at once; a wait that times out checks the parent too."""
  while True:
    try:
      store.wait([key], datetime.timedelta(seconds=timeout))
      return
    except dist.DistNetworkError:
      os._exit(0)                  # the store, rank 0's, is gone
    except dist.DistStoreError:    # the wait's timeout
      if os.getppid() != parent:
        os._exit(0)


def _follower_main(rank: int, world: int, port: int, degrees: dict,
                   device, backend: str, cards: int, timeout: float,
                   parent: int) -> None:
  """Spawn entry of rank ``rank``: join the group, then run rank 0's ops
  until STOP or until rank 0's process (``parent``) is gone."""
  if device is not None and torch.device(device).type == "cpu":
    torch.set_num_threads(1)
  dev = _rank_device(device, rank, cards)
  if dev.type == "cuda":
    torch.cuda.set_device(dev)
  store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                        timeout=datetime.timedelta(seconds=timeout))
  store.set("up/%d" % rank, str(os.getpid()))
  dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=timeout))
  dec = _Decoder(mesh_lib.build_mesh(mesh_lib.MeshSpec(**degrees)), dev,
                 dev if backend == "nccl" else torch.device("cpu"))
  n = 0
  while True:
    key = "op/%d" % n
    _await_op(store, key, parent, timeout)
    header = json.loads(store.get(key))
    if header["op"] == "stop":
      break
    try:
      if header["op"] == "load":
        dec.load(header, None)
      else:
        dec.generate(header, None)
    except Exception:  # noqa: BLE001 - rank 0 raises with it
      store.set("status/%d/%d" % (n, rank), traceback.format_exc())
      os._exit(1)
    store.set("status/%d/%d" % (n, rank), "ok")
    n += 1
  dist.destroy_process_group()


class ServingGroup(object):
  """A serving group of ``resolve_degrees(spec, device)``'s ranks with
  this process as rank 0 (see the module docstring). ``generate`` is
  what a rectangular serving batch calls; ``close`` stops the other
  ranks. Built by :func:`group_for`, which caches it."""

  def __init__(self, spec, device=None, timeout: float = TIMEOUT_S):
    if dist.is_available() and dist.is_initialized():
      raise NotImplementedError(
          "serving over a mesh from a process that already has a default "
          "process group (a predict fn inside cluster.run) is not ported to "
          "PyTorch yet (ROADMAP Queue 1 item 10c, part 3b-ii)")
    self.degrees = resolve_degrees(spec, device)
    self.world = math.prod(self.degrees.values())
    self.timeout = float(timeout)
    cards = _cards(device)
    self.backend = "nccl" if cards >= self.world else "gloo"
    if cards and self.backend == "gloo" and not _SHARED_LOGGED[0]:
      _SHARED_LOGGED[0] = True
      logger.warning("serving group of %d ranks on %d card(s): the ranks "
                     "share the cards round-robin over gloo", self.world,
                     cards)
    self.device = _rank_device(device, 0, cards)
    self._lock = threading.Lock()
    self._next = 0
    self._last = None
    self.broken = None
    self.store = dist.TCPStore("127.0.0.1", 0, self.world, is_master=True,
                               wait_for_workers=False,
                               timeout=datetime.timedelta(seconds=timeout))
    ctx = mp.get_context("spawn")
    self.procs = [ctx.Process(
        target=_follower_main,
        args=(r, self.world, self.store.port, self.degrees,
              str(self.device), self.backend, cards, self.timeout,
              os.getpid()),
        daemon=True, name="tos-serving-group-%d" % r)
        for r in range(1, self.world)]
    for p in self.procs:
      p.start()
    try:
      self._await(["up/%d" % r for r in range(1, self.world)], "start")
      dist.init_process_group(self.backend, store=self.store, rank=0,
                              world_size=self.world,
                              timeout=datetime.timedelta(seconds=timeout))
      self.mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**self.degrees))
    except BaseException:
      self._teardown()
      raise
    self._dec = _Decoder(self.mesh, self.device, self.device
                         if self.backend == "nccl" else torch.device("cpu"))
    logger.info("serving group started: %d ranks over %s, mesh %s",
                self.world, self.backend, self.degrees)

  @property
  def pids(self) -> list:
    """The other ranks' process ids (rank 1 first)."""
    return [p.pid for p in self.procs]

  def _dead(self) -> list:
    return [(r + 1, p) for r, p in enumerate(self.procs) if not p.is_alive()]

  def _check_alive(self, what: str) -> None:
    dead = self._dead()
    if dead:
      raise RuntimeError(
          "serving group rank %d of %d (pid %s) exited with code %s during "
          "the %s" % (dead[0][0], self.world, dead[0][1].pid,
                      dead[0][1].exitcode, what))

  def _await(self, keys, what: str) -> None:
    """Wait for every key, at most the timeout, raising as soon as a
    follower is gone (checked every ``_SLICE_S`` of the wait)."""
    deadline = time.monotonic() + self.timeout
    for key in keys:
      while True:
        left = deadline - time.monotonic()
        if left <= 0:
          raise TimeoutError("serving group rank %s of %d: no %s within %.0f "
                             "s" % (key.rsplit("/", 1)[-1], self.world, what,
                                    self.timeout))
        try:
          self.store.wait([key], datetime.timedelta(
              seconds=min(_SLICE_S, left)))
          break
        except dist.DistStoreError:  # this slice's timeout
          self._check_alive(what)

  def _post(self, header: dict) -> int:
    n, self._next = self._next, self._next + 1
    self.store.set("op/%d" % n, json.dumps(header))
    return n

  def _statuses(self, n: int, what: str) -> None:
    keys = ["status/%d/%d" % (n, r) for r in range(1, self.world)]
    self._await(keys, what)
    for r, key in enumerate(keys, start=1):
      status = self.store.get(key).decode()
      if status != "ok":
        raise RuntimeError("serving group rank %d of %d failed in the %s:\n%s"
                           % (r, self.world, what, status))
    for key in keys + ["op/%d" % n]:
      self.store.delete_key(key)

  def _run(self, what: str, fn):
    """Run rank 0's side of an op; on any failure name the follower at
    fault (a dead one, or one that posted a traceback) when there is one,
    and tear the group down."""
    if self.broken is not None:
      raise RuntimeError("serving group is down: %s" % self.broken)
    try:
      return fn()
    except BaseException as e:
      cause = e
      try:
        time.sleep(0.05)             # a dying follower's exit code
        self._check_alive(what)
        n = self._next - 1
        for r in range(1, self.world):
          key = "status/%d/%d" % (n, r)
          if self.store.check([key]) and \
              self.store.get(key).decode() != "ok":
            raise RuntimeError(
                "serving group rank %d of %d failed in the %s:\n%s"
                % (r, self.world, what, self.store.get(key).decode()))
      except RuntimeError as named:       # the rank at fault, by name
        cause = named
      self.broken = str(cause).splitlines()[0] if str(cause) else repr(cause)
      self._teardown()
      if cause is e:
        raise
      raise cause from e

  def _ensure(self, params, cfg) -> None:
    """Send ``params`` to the other ranks unless they hold them already:
    the same tree object, or the same fingerprint, under the same
    config."""
    from tensorflowonspark_tpu_torch.serving.host import cfg_wire
    from tensorflowonspark_tpu_torch.utils.checkpoint import (
        params_fingerprint)
    wire = cfg_wire(cfg)
    wired = json.dumps(wire, sort_keys=True)
    if self._last is not None and self._last[0] is params and \
        self._dec.loaded is not None and self._dec.loaded[1] == wired:
      return
    key = (params_fingerprint(params), wired)
    self._last = (params,)
    if self._dec.loaded == key:
      return
    names, shapes, dtypes, offsets, buf = _pack(params)
    header = {"op": "load", "cfg": wire, "print": key[0], "names": names,
              "shapes": shapes, "dtypes": dtypes, "offsets": offsets,
              "bytes": int(buf.numel())}
    n = self._post(header)
    self._dec.load(header, buf)
    self._statuses(n, "load")

  def generate(self, params, cfg, prompts, num_steps: int,
               eos_id: Optional[int] = None, pad_id: int = 0,
               temperature: float = 0.0, top_k: int = 0,
               seed: Optional[int] = None) -> np.ndarray:
    """``greedy_generate_kv`` of ``prompts`` ``[B, plen]`` on every rank
    of the group over its mesh, with the whole weights ``params`` (sent
    to the other ranks when their fingerprint or ``cfg`` changes); the
    int64 ``[B, plen + num_steps]`` on the host. ``seed`` starts every
    rank's sampling generator alike (``temperature > 0``)."""
    prompts = np.asarray(prompts, np.int64)

    def run():
      self._check_alive("serve")
      self._ensure(params, cfg)
      header = {"op": "generate", "shape": list(prompts.shape),
                "num_steps": int(num_steps),
                "eos_id": None if eos_id is None else int(eos_id),
                "pad_id": int(pad_id), "temperature": float(temperature),
                "top_k": int(top_k),
                "seed": None if seed is None else int(seed)}
      n = self._post(header)
      out = self._dec.generate(header, prompts)
      self._statuses(n, "serve")
      return out.cpu().numpy()

    with self._lock:
      return self._run("serve", run)

  def close(self, timeout: float = 10.0) -> None:
    """STOP the other ranks, wait for them (then kill what is left) and
    leave the process group."""
    with self._lock:
      if self.broken is None:
        try:
          self._post({"op": "stop"})
        except RuntimeError:
          pass                       # the store is gone: kill below
        self.broken = "closed"
      self._teardown(timeout)

  def _teardown(self, timeout: float = 5.0) -> None:
    deadline = time.monotonic() + timeout
    for p in self.procs:
      p.join(timeout=max(0.1, deadline - time.monotonic()))
      if p.is_alive():
        p.kill()
        p.join(timeout=5.0)
    if dist.is_initialized():
      dist.destroy_process_group()
    with _GROUPS_LOCK:
      for key in [k for k, g in _GROUPS.items() if g is self]:
        _GROUPS.pop(key)


def group_for(spec, device=None) -> Optional[ServingGroup]:
  """This process's serving group for ``spec`` on ``device``, started on
  first use and cached; None when the spec resolves to one process. A
  process is one rank of one group at a time: a group of another spec or
  device is closed first."""
  degrees = resolve_degrees(spec, device)
  if math.prod(degrees.values()) == 1:
    return None
  key = (tuple(sorted(degrees.items())), str(device))
  with _GROUPS_LOCK:
    group = _GROUPS.get(key)
    others = [g for k, g in _GROUPS.items() if k != key]
  if group is None:
    for other in others:
      logger.info("closing the serving group over %s for one over %s",
                  other.degrees, degrees)
      other.close()
    group = ServingGroup(spec, device)
    with _GROUPS_LOCK:
      _GROUPS[key] = group
  return group


def follower_pids() -> list:
  """The other ranks' process ids of every live group of this process."""
  with _GROUPS_LOCK:
    return [pid for g in _GROUPS.values() for pid in g.pids]


def shutdown_all() -> None:
  """Close every group of this process (run at exit)."""
  with _GROUPS_LOCK:
    groups = list(_GROUPS.values())
  for g in groups:
    g.close()


# before multiprocessing terminates this process's daemonic children
multiprocessing.util.Finalize(None, shutdown_all, exitpriority=100)

__all__ = ["ServingGroup", "group_for", "resolve_degrees", "follower_pids",
           "shutdown_all", "TIMEOUT_S"]
