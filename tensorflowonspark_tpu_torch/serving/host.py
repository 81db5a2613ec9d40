"""Executor-side half of the cross-host serving plane: the ServingHost.

The port's copy of ``tensorflowonspark_tpu/serving/host.py``. It runs a
real :class:`~.engine.ServingEngine` inside an executor process and
speaks to the driver only over the rendezvous wire: one ``SHREG`` to
announce itself, then an ``SHSYNC`` round every ``TOS_HOST_SYNC`` seconds
that pushes request events (admission verdicts, token deltas,
completions) and load stats, and pulls queued commands (submit/stage/
cancel/build/drain/stop/kill) from the driver-side
:class:`~.remote.ServingHostPlane`. The driver never dials the host:
executors often live where only the rendezvous server is addressable, so
the host polls. At the default 20 ms cadence a round adds up to one sync
interval to each token hop and each command pickup.

Wire discipline mirrors the driver side: token pushes and command pulls
are budgeted to ``TOS_HOST_CHUNK`` payload tokens per frame, and staged
prompt parts are reassembled here, so no frame approaches the rendezvous
server's 4 MB refusal threshold.

Exactly once across retries: every token event carries its stream
position (``pos``, the index of its first token), so a resend after a
dropped or failed sync is idempotent: the driver-side mirror applies only
the suffix beyond what it holds. That keeps failover replay bit-identical
and stream positions exactly once even on a flaky wire.

The engine is built host-side from the :class:`~.registry.ModelRegistry`
at ``registry_root``: the host waits for the commanded version to commit
in its own filesystem view and rebuilds the :class:`TransformerConfig`
from the manifest's ``extra["model_cfg"]`` (the dtype travels as its
name and resolves to a ``torch`` dtype), so ``deploy.py``'s canary and
promote drive version swaps in processes that share no params with the
driver. ``cfg_wire`` is the publisher's helper that makes a config
manifest-safe. ``build_opts`` are host-local engine options that win
over the manifest's ``serve_opts`` (``{"device": "cpu"}`` on a machine
without a card).

Chaos: each sync round consults ``chaos.host_fault("sync", host_id)``
(``TOS_CHAOS_HOST``): ``kill`` SIGKILLs this whole process (no cleanup,
the wire just goes silent, like a preempted host); ``partition`` keeps
the engine decoding but skips all wire I/O for the spec's duration;
``stall`` sleeps the loop inline. A second point, ``decode``, ticks only
on rounds with requests in flight, so ``decode@K#N:kill`` lands
mid-decode however long the engine build took.
"""

import collections
import dataclasses
import functools
import logging
import os
import queue as std_queue
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from tensorflowonspark_tpu_torch.control import rendezvous
from tensorflowonspark_tpu_torch.serving import remote as remote_mod
from tensorflowonspark_tpu_torch.utils import chaos

logger = logging.getLogger(__name__)

#: seconds between SHSYNC rounds (the host's wire cadence — also the
#: worst-case added latency per token hop and per command pickup)
ENV_HOST_SYNC = "TOS_HOST_SYNC"
#: bound on a host-side engine build: registry-commit wait + params
#: load + engine start must finish within this
ENV_HOST_BUILD = "TOS_HOST_BUILD_TIMEOUT"

_DEFAULT_SYNC = 0.02
_DEFAULT_BUILD = 120.0

_DTYPE_NAMES = ("float32", "bfloat16", "float16", "float64")


def cfg_wire(cfg) -> dict:
  """A ``TransformerConfig`` as a manifest-safe dict (``dtype`` becomes
  its name, ``"bfloat16"`` for ``torch.bfloat16``): what publishers put
  in ``registry.publish(..., extra={"model_cfg": cfg_wire(cfg)})`` so a
  ServingHost can rebuild the config in another process. The same config
  gives the same dict in both packages."""
  d = dataclasses.asdict(cfg)
  dt = d.get("dtype")
  if dt is not None and not isinstance(dt, str):
    d["dtype"] = str(dt).replace("torch.", "")
  return d


def build_engine_from_manifest(params, manifest: dict,
                               overrides: Optional[dict] = None):
  """Reconstruct a ServingEngine from a registry manifest: the config
  from ``extra["model_cfg"]``, engine options from
  ``extra["serve_opts"]`` with host-local ``overrides`` winning (a host
  built with ``{"device": "cpu"}`` serves on the CPU; without a
  ``device`` the engine takes the card and raises when there is none)."""
  # the model imports stay inside the function, so the spawn entry is
  # reachable before the host process has applied its env
  import torch
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.serving import engine as engine_mod
  extra = (manifest or {}).get("extra") or {}
  cfg_d = dict(extra.get("model_cfg") or {})
  if not cfg_d:
    raise RuntimeError(
        "manifest lacks extra['model_cfg'] — publish with "
        "extra={'model_cfg': host.cfg_wire(cfg)} so serving hosts can "
        "rebuild the model config cross-process")
  name = cfg_d.pop("dtype", "float32")
  if name not in _DTYPE_NAMES:
    raise RuntimeError("unknown model dtype %r in manifest (known: %s)"
                       % (name, list(_DTYPE_NAMES)))
  cfg = tfm.TransformerConfig(dtype=getattr(torch, name), **cfg_d)
  opts = dict(extra.get("serve_opts") or {})
  opts.update(overrides or {})
  return engine_mod.ServingEngine(params, cfg, **opts)


class ServingHost(object):
  """One executor-resident serving replica runtime.

  ``run()`` blocks in the sync loop until a ``kill``/``exit`` command
  (or ``stop_event``). All engine-blocking commands (build/drain/stop/
  kill) execute on a serial worker thread so the wire never goes
  silent behind a long drain — driver-side host-death detection keys
  purely on sync staleness.
  """

  def __init__(self, server_addr, host_id: int,
               registry_root: Optional[str] = None,
               make_engine: Optional[Callable] = None,
               build_opts: Optional[dict] = None,
               sync_interval: Optional[float] = None,
               build_timeout: Optional[float] = None,
               client_timeout: float = 10.0,
               chunk: Optional[int] = None):
    self.server_addr = (server_addr[0], int(server_addr[1]))
    self.host_id = int(host_id)
    self.registry_root = registry_root
    #: test/extension hook: ``make_engine(version) -> engine`` (or
    #: ``(engine, version)``) replaces the registry build path
    self.make_engine = make_engine
    self.build_opts = dict(build_opts or {})
    self.sync_interval = float(
        sync_interval if sync_interval is not None
        else os.environ.get(ENV_HOST_SYNC, str(_DEFAULT_SYNC)))
    self.build_timeout = float(
        build_timeout if build_timeout is not None
        else os.environ.get(ENV_HOST_BUILD, str(_DEFAULT_BUILD)))
    self.client_timeout = float(client_timeout)
    self.chunk = max(256, int(
        chunk if chunk is not None
        else os.environ.get(remote_mod.ENV_HOST_CHUNK,
                            str(remote_mod._DEFAULT_CHUNK))))
    self.engine = None
    self.generation = 0
    self.version: Optional[int] = None
    self._outbox: collections.deque = collections.deque()
    self._olock = threading.Lock()
    #: tid -> {"handle": engine request, "sent": tokens shipped}
    self._track: Dict[int, dict] = {}
    #: tid -> [staged prompt parts] awaiting the submit command
    self._staging: Dict[int, list] = {}
    self._work: std_queue.Queue = std_queue.Queue()
    self._stop_event = threading.Event()
    self.stats = {"syncs": 0, "sync_failures": 0, "commands": 0,
                  "events": 0, "builds": 0, "partitions": 0,
                  "requeues": 0}

  # -- event plumbing --------------------------------------------------------

  def _emit(self, ev: dict) -> None:
    with self._olock:
      self._outbox.append(ev)

  def _pop_events(self):
    """Pop outbox events up to the per-frame chunk budget, preserving
    order (a ``done`` never overtakes its tokens)."""
    out, budget = [], self.chunk
    with self._olock:
      while self._outbox:
        ev = self._outbox[0]
        cost = len(ev.get("toks") or ())
        if out and cost > budget:
          break
        out.append(self._outbox.popleft())
        budget -= cost
        if budget <= 0 or len(out) >= 64:
          break
    return out

  def _requeue(self, events) -> None:
    """Put unacked events back at the FRONT (position-stamped token
    events make the eventual resend idempotent driver-side)."""
    if not events:
      return
    with self._olock:
      self._outbox.extendleft(reversed(events))
    self.stats["requeues"] += 1

  # -- command execution -----------------------------------------------------

  def _apply(self, cmd: dict) -> None:
    op = cmd.get("op")
    self.stats["commands"] += 1
    if op == "submit":
      self._do_submit(cmd)
    elif op == "stage":
      self._staging.setdefault(int(cmd["tid"]), []).append(
          (int(cmd.get("seq", 0)), cmd.get("part") or []))
    elif op == "cancel":
      t = self._track.get(cmd.get("tid"))
      if t is not None:
        t["handle"].cancelled.set()
    elif op == "build":
      # _work is unbounded: put_nowait never blocks the sync loop
      self._work.put_nowait(lambda: self._do_build(cmd.get("bid"),
                                                   cmd.get("version")))
    elif op == "drain":
      self._work.put_nowait(
          lambda: self._do_drain(cmd.get("did"),
                                 float(cmd.get("timeout", 30.0))))
    elif op == "stop":
      self._work.put_nowait(
          lambda: self._do_stop(cmd.get("sid"),
                                float(cmd.get("timeout", 30.0))))
    elif op == "kill":
      self._work.put_nowait(lambda: self._do_kill(cmd.get("cause")))
    elif op == "exit":
      self._stop_event.set()
    else:
      logger.warning("serving host %d: unknown command %r",
                     self.host_id, op)

  def _do_submit(self, cmd: dict) -> None:
    tid = int(cmd["tid"])
    try:
      if self.engine is None:
        raise RuntimeError("serving host %d has no engine (not built)"
                           % self.host_id)
      if cmd.get("staged"):
        parts = self._staging.pop(tid, [])
        if len(parts) != int(cmd["staged"]):
          raise RuntimeError(
              "staged prompt for request %d incomplete: %d/%d parts"
              % (tid, len(parts), int(cmd["staged"])))
        prompt = [t for _, part in sorted(parts) for t in part]
      else:
        prompt = cmd.get("prompt") or []
      hrid = self.engine.submit(
          np.asarray(prompt, np.int32),
          max_new_tokens=int(cmd["max_new_tokens"]),
          ttl=cmd.get("ttl"), trace_id=cmd.get("trace_id"))
    except BaseException as e:  # noqa: BLE001 - every admission failure
      # (overload, validation, dead engine) becomes a structured 'rej'
      self._emit({"ev": "rej", "tid": tid,
                  "error": remote_mod.encode_error(e)})
      return
    self._track[tid] = {"handle": self.engine.request(hrid), "sent": 0}
    self._emit({"ev": "acc", "tid": tid})

  def _harvest(self) -> None:
    """Ship new tokens (position-stamped) and completions for every
    tracked request; runs every sync round on the loop thread."""
    for tid in list(self._track):
      t = self._track[tid]
      h = t["handle"]
      done = h.done.is_set()  # read BEFORE tokens: the engine appends
      # the final token before setting done, so done==True means
      # h.tokens is complete
      toks = h.tokens
      if len(toks) > t["sent"]:
        self._emit({"ev": "tok", "tid": tid, "pos": t["sent"],
                    "toks": [int(x) for x in toks[t["sent"]:]]})
        t["sent"] = len(toks)
      if done:
        err = h.error
        self._emit({"ev": "done", "tid": tid,
                    "error": None if err is None
                    else remote_mod.encode_error(err)})
        del self._track[tid]

  # -- blocking ops (serial worker thread) -----------------------------------

  def _worker_loop(self) -> None:
    while not self._stop_event.is_set():
      try:
        thunk = self._work.get(timeout=0.2)
      except std_queue.Empty:
        continue
      try:
        thunk()
      except Exception:  # noqa: BLE001 # tosa: ignore[TOS004] - every op
        # ships its own structured failure event (built/drained/stopped
        # with ok=False or error) which the DRIVER raises; the worker
        # thread must survive for the next command
        logger.warning("serving host %d worker op failed", self.host_id,
                       exc_info=True)

  def _do_build(self, bid, version) -> None:
    self.stats["builds"] += 1
    try:
      # stop the previous generation first (a build commanded by the
      # swap/deploy flow follows a drain, so this is idempotent; it also
      # frees the old engine's slab before the new one allocates)
      if self.engine is not None:
        try:
          self.engine.stop(timeout=5.0)
        except Exception:  # noqa: BLE001 # tosa: ignore[TOS004] - the old
          # generation may already be dead; the build result is what the
          # driver observes, shipped via the 'built' event either way
          pass
        self.engine = None
      eng, v = self._build_engine(version)
      eng.start()
      self.generation += 1
      self.engine, self.version = eng, v
      self._emit({"ev": "built", "bid": bid, "ok": True,
                  "generation": self.generation, "version": v,
                  "meta": {"default_max_new_tokens":
                           int(eng.default_max_new_tokens)}})
    except Exception as e:  # noqa: BLE001 - structured failure ack; the
      # driver-side start() raises it as a build failure
      logger.warning("serving host %d engine build failed: %s",
                     self.host_id, e)
      self._emit({"ev": "built", "bid": bid, "ok": False,
                  "error": "%s: %s" % (type(e).__name__, e)})

  def _build_engine(self, version):
    if self.make_engine is not None:
      result = self.make_engine(version)
      return result if isinstance(result, tuple) else (result, version)
    if self.registry_root is None:
      raise RuntimeError("serving host %d has neither registry_root nor "
                         "make_engine — nothing to build from"
                         % self.host_id)
    from tensorflowonspark_tpu_torch.serving import registry as registry_mod
    reg = registry_mod.ModelRegistry(self.registry_root)
    deadline = time.monotonic() + self.build_timeout
    v = None if version is None else int(version)
    # wait for the commanded version (or any first version) to COMMIT in
    # THIS host's filesystem view — the cross-process registry watch
    while True:
      have = reg.versions()
      if v is None and have:
        v = max(have)
        break
      if v is not None and v in have:
        break
      if time.monotonic() >= deadline:
        raise RuntimeError(
            "version %s not committed in registry %r within %.1fs"
            % ("latest" if v is None else v, self.registry_root,
               self.build_timeout))
      time.sleep(0.05)
    params, manifest = reg.get(v)
    return build_engine_from_manifest(params, manifest, self.build_opts), v

  def _do_drain(self, did, timeout: float) -> None:
    ok = False
    if self.engine is not None:
      try:
        ok = bool(self.engine.drain(timeout))
      except Exception:  # noqa: BLE001 # tosa: ignore[TOS004] - a drain
        # crash ships as ok=False in the 'drained' event; the driver's
        # swap then treats the replica as failed (its observable contract)
        logger.warning("serving host %d drain failed", self.host_id,
                       exc_info=True)
    self._emit({"ev": "drained", "did": did, "ok": ok})

  def _do_stop(self, sid, timeout: float) -> None:
    if self.engine is not None:
      try:
        self.engine.stop(timeout=timeout)
      except Exception:  # noqa: BLE001 # tosa: ignore[TOS004] - stopping a
        # dead engine is fine; the 'stopped' ack below is the observable
        pass
    self._emit({"ev": "stopped", "sid": sid})

  def _do_kill(self, cause) -> None:
    if self.engine is not None:
      try:
        self.engine.kill(RuntimeError(str(cause or "killed over the wire")))
      except Exception:  # noqa: BLE001 # tosa: ignore[TOS004] - killing an
        # already-dead engine is fine; the driver marked its proxy dead
        # before sending this, so there is no observer to fail
        pass

  # -- wire stats ------------------------------------------------------------

  def _stats_payload(self) -> dict:
    eng = self.engine
    out: Dict[str, Any] = {"generation": self.generation,
                           "version": self.version, "pid": os.getpid()}
    if eng is None:
      out.update(engine_alive=False, loop_error=None, queue_depth=0,
                 queued_tokens=0, tokens_per_sec=0.0, occupancy_now=0.0)
      return out
    try:
      err = eng._loop_error
      out.update(engine_alive=bool(eng.alive),
                 loop_error=None if err is None else str(err),
                 queue_depth=int(eng.queue_depth),
                 queued_tokens=int(eng.queued_tokens),
                 tokens_per_sec=float(eng.tokens_per_sec),
                 occupancy_now=float(eng.occupancy_now))
    except Exception:  # noqa: BLE001 - an engine mid-stop can race its
      # own accounting; a conservative "dead" row beats a crashed host
      out.update(engine_alive=False, loop_error="stats unavailable",
                 queue_depth=0, queued_tokens=0, tokens_per_sec=0.0,
                 occupancy_now=0.0)
    return out

  # -- the loop --------------------------------------------------------------

  def run(self, stop_event: Optional[threading.Event] = None) -> None:
    """Register, then sync until told to exit (blocking)."""
    if stop_event is not None:
      self._stop_event = stop_event
    worker = threading.Thread(target=self._worker_loop, daemon=True,
                              name="tos-host-worker-%d" % self.host_id)
    worker.start()
    client = rendezvous.Client(self.server_addr,
                               timeout=self.client_timeout)
    try:
      self._run_wire(client)
    finally:
      self._stop_event.set()
      try:
        client._request({"type": "SHBYE", "host_id": self.host_id})
      except Exception:  # noqa: BLE001 # tosa: ignore[TOS004] - departing
        # is best-effort: a dead server can't be told goodbye, and the
        # plane's staleness timeout covers an unsent SHBYE anyway
        pass
      client.close()
      if self.engine is not None:
        try:
          self.engine.stop(timeout=5.0)
        except Exception:  # noqa: BLE001 # tosa: ignore[TOS004] - exit
          # path; the process ends either way and the driver detects the
          # departure via SHBYE/staleness, not via this stop
          pass

  def _register(self, client) -> None:
    reply = client._request({
        "type": "SHREG", "host_id": self.host_id,
        "meta": {"pid": os.getpid(),
                 "registry_root": self.registry_root}})
    if reply.get("type") != "OK":
      raise RuntimeError("serving host %d registration refused: %r"
                         % (self.host_id, reply))
    # adopt the plane's negotiated chunk budget so both directions of
    # the wire obey ONE framing limit
    if reply.get("chunk"):
      self.chunk = int(reply["chunk"])

  def _chaos_point(self, point: str, partition_until: float) -> float:
    fault = chaos.host_fault(point, self.host_id)
    if fault is not None:
      action, secs = fault
      if action == "kill":
        logger.warning("chaos: serving host %d SIGKILLing itself (%s)",
                       self.host_id, point)
        os.kill(os.getpid(), signal.SIGKILL)
      elif action == "partition":
        self.stats["partitions"] += 1
        partition_until = time.monotonic() + float(secs)
    return partition_until

  def _run_wire(self, client) -> None:
    self._register(client)
    partition_until = 0.0
    while not self._stop_event.is_set():
      partition_until = self._chaos_point("sync", partition_until)
      if self._track:
        # ticks only while requests are in flight: a kill spec'd here
        # is guaranteed to interrupt live decodes, whatever the build
        # and warm-up phases cost in sync rounds
        partition_until = self._chaos_point("decode", partition_until)
      self._harvest()
      if time.monotonic() < partition_until:
        # partitioned: the engine keeps decoding, tokens buffer in the
        # outbox, the wire stays dark — the driver sees pure silence
        time.sleep(self.sync_interval)
        continue
      events = self._pop_events()
      try:
        reply = client._request({"type": "SHSYNC", "host_id": self.host_id,
                                 "events": events,
                                 "stats": self._stats_payload()})
      except Exception as e:  # noqa: BLE001 - transport failure: the server
        # definitely did not apply these events; resend next round
        self.stats["sync_failures"] += 1
        self._requeue(events)
        logger.warning("serving host %d sync failed: %s", self.host_id, e)
        time.sleep(min(0.5, 10 * self.sync_interval))
        continue
      if reply.get("type") != "OK":
        self.stats["sync_failures"] += 1
        # position-stamped events make resending safe even if the plane
        # half-applied before erroring
        self._requeue(events)
        if "unregistered" in str(reply.get("error", "")):
          try:
            self._register(client)
          except Exception:  # noqa: BLE001 # tosa: ignore[TOS004] - keep
            # syncing; every later round retries registration through
            # this same path until the plane answers OK
            pass
        time.sleep(min(0.5, 10 * self.sync_interval))
        continue
      self.stats["syncs"] += 1
      self.stats["events"] += len(events)
      for cmd in reply.get("cmds") or ():
        self._apply(cmd)
      time.sleep(self.sync_interval)


def run_host_thread(server_addr, host_id: int, **kw):
  """Run a ServingHost on a daemon thread in THIS process (the wire is
  still real — sockets, framing, chunking — only the process boundary
  is elided). The cheap tier-1 harness; kill-chaos needs real
  processes via :func:`start_host_process`.

  Returns ``(host, stop)`` where ``stop()`` exits the loop and joins.
  """
  host = ServingHost(server_addr, host_id, **kw)
  stop_event = threading.Event()
  th = threading.Thread(target=host.run, kwargs={"stop_event": stop_event},
                        daemon=True, name="tos-host-%d" % host_id)
  th.start()

  def stop(timeout: float = 10.0) -> None:
    stop_event.set()
    th.join(timeout=timeout)

  return host, stop


def _host_proc_main(server_addr, host_id, registry_root, build_opts,
                    env: Optional[dict]) -> None:
  """Spawn entry for a ServingHost executor process."""
  if env:
    os.environ.update({str(k): str(v) for k, v in env.items()})
  logging.basicConfig(level=logging.INFO)
  host = ServingHost(tuple(server_addr), int(host_id),
                     registry_root=registry_root, build_opts=build_opts)
  host.run()


def start_host_process(server_addr, host_id: int,
                       registry_root: Optional[str] = None,
                       build_opts: Optional[dict] = None,
                       env: Optional[dict] = None):
  """Spawn a ServingHost in a fresh process (the chaos-killable real
  thing). ``spawn``, never fork: the parent may already hold a CUDA
  context. ``env`` entries are applied in the child before anything is
  imported (chaos knobs, sync cadence). Returns the started
  ``multiprocessing.Process``."""
  import multiprocessing as mp
  proc = mp.get_context("spawn").Process(
      target=_host_proc_main,
      args=(list(server_addr), int(host_id), registry_root,
            dict(build_opts or {}), dict(env or {})),
      daemon=True, name="tos-serving-host-%d" % host_id)
  proc.start()
  return proc


def serving_host_main(server_addr, registry_root, build_opts, args,
                      ctx) -> None:
  """The main fn :func:`make_serving_host_main` binds: this worker
  becomes ServingHost ``ctx.executor_id``."""
  del args
  host = ServingHost(tuple(server_addr), int(ctx.executor_id),
                     registry_root=registry_root, build_opts=build_opts)
  host.run()


def make_serving_host_main(server_addr,
                           registry_root: Optional[str] = None,
                           build_opts: Optional[dict] = None):
  """A ``cluster.run`` main fn that turns each worker into a ServingHost
  (host id = executor id): inference as a service on executors. The
  driver keeps the fleet and deploy controllers and drives these hosts
  over the wire::

      c = cluster.run(engine, make_serving_host_main(
          addr, registry_root="/models"), args)

  The port's ``cluster.run`` sends the main fn by pickle, by name, so
  this is a ``functools.partial`` of the module-level
  :func:`serving_host_main`, not a closure.
  """
  return functools.partial(serving_host_main, list(server_addr),
                           registry_root, dict(build_opts or {}))
