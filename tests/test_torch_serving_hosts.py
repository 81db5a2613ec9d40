"""The port's cross-host serving plane held against the JAX package's,
case by case.

Each case of the contract subset of ``tests/test_remote.py`` is one
scenario, written once and run through both packages on the same weights
(one seeded JAX state, carried across with ``params_from_flax``) and the
same ``TOS_CHAOS_HOST`` spec: a real rendezvous ``Server`` with the
serving plane attached, a ``ModelRegistry`` holding the published
versions, and ``ServingHost`` runtimes that build their engines from it.
Hosts run in thread mode (``run_host_thread``: real sockets, framing and
chunking; only the process boundary is elided), the port's with
``build_opts={"device": "cpu"}``. Inside each run the scenario asserts
the reference test's own invariants, with its package's own
``greedy_generate_kv`` as the parity oracle, and returns what is
deterministic; the port's record must equal the JAX one's, outputs token
for token in f32. The subset: ``TestRemoteFleet`` (fleet parity and
stream across the wire, a chunked prompt, overload, deadline and cancel,
a rolling swap onto a new version), ``TestWireHealthProbe``,
``TestPlaneWire`` and ``TestHostChaos``' partition, stall and malformed
spec. The process-kill pin spawns real host processes and is ``slow``,
as in the reference; one more case runs the port's
``make_serving_host_main`` under its ``cluster.run`` with two CPU
executors.

The JAX hosts' engines of one slot count share one ``SlotDecoder`` (its
jit caches warm once; the decoder holds no request state, so the outputs
are the same), which keeps the JAX side cheap.
"""

import contextlib
import os
import threading
import time
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu.control import rendezvous as jax_rdv
from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu.serving import engine as jax_engine_mod
from tensorflowonspark_tpu.serving import fleet as jax_fleet
from tensorflowonspark_tpu.serving import host as jax_host
from tensorflowonspark_tpu.serving import registry as jax_registry
from tensorflowonspark_tpu.serving import remote as jax_remote
from tensorflowonspark_tpu.serving import scheduler as jax_sched
from tensorflowonspark_tpu.utils import chaos as jax_chaos
from tensorflowonspark_tpu_torch import cluster as port_cluster
from tensorflowonspark_tpu_torch.control import rendezvous as port_rdv
from tensorflowonspark_tpu_torch.engine import LocalEngine
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.serving import fleet as port_fleet
from tensorflowonspark_tpu_torch.serving import host as port_host
from tensorflowonspark_tpu_torch.serving import registry as port_registry
from tensorflowonspark_tpu_torch.serving import remote as port_remote
from tensorflowonspark_tpu_torch.serving import scheduler as port_sched
from tensorflowonspark_tpu_torch.utils import chaos as port_chaos
from tensorflowonspark_tpu_torch.utils.params import params_from_flax

pytestmark = pytest.mark.chaos

EOS = 7
PAD = 0
TINY = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_seq_len=48)


@pytest.fixture(scope="module")
def pkgs():
  jcfg = jax_tfm.TransformerConfig(remat=False, dtype=jnp.float32, **TINY)
  jparams = jax_tfm.create_state(jax.random.PRNGKey(0), jcfg,
                                 seq_len=16).params
  tcfg = tfm.TransformerConfig(remat=False, dtype=torch.float32, **TINY)
  tparams = params_from_flax(jax.tree.map(np.asarray, jparams), tcfg)
  decoders = {}
  real_engine = jax_engine_mod.ServingEngine

  class SharedDecoderEngine(real_engine):
    def __init__(self, *a, **kw):
      super().__init__(*a, **kw)
      self.decoder = decoders.setdefault(self.num_slots, self.decoder)

  @contextlib.contextmanager
  def jax_patch():
    # the JAX hosts build their engines through the engine module's name
    jax_engine_mod.ServingEngine = SharedDecoderEngine
    try:
      yield
    finally:
      jax_engine_mod.ServingEngine = real_engine

  def jax_reference(prompt, budget):
    out = np.asarray(jax_tfm.greedy_generate_kv(
        jparams, jcfg, jnp.asarray(prompt)[None], int(budget), eos_id=EOS,
        pad_id=PAD))[0]
    return _truncate(out, prompt, budget)

  model = tfm.Transformer(tcfg, params=tparams, device="cpu")

  def port_reference(prompt, budget):
    out = tfm.greedy_generate_kv(
        model, torch.as_tensor(np.asarray(prompt))[None], int(budget),
        eos_id=EOS, pad_id=PAD).numpy()[0]
    return _truncate(out, prompt, budget)

  def namespace(name, rdv, host, remote, fleet, sched, chaos, registry,
                params, cfg, build_opts, reference, patch):
    return types.SimpleNamespace(
        name=name, rdv=rdv, host=host, remote=remote, fleet=fleet,
        ServingFleet=fleet.ServingFleet, sched=sched, chaos=chaos,
        ModelRegistry=registry.ModelRegistry, params=params, cfg=cfg,
        build_opts=build_opts, reference=reference, patch=patch)

  return (namespace("jax", jax_rdv, jax_host, jax_remote, jax_fleet,
                    jax_sched, jax_chaos, jax_registry, jparams, jcfg, {},
                    jax_reference, jax_patch),
          namespace("torch", port_rdv, port_host, port_remote, port_fleet,
                    port_sched, port_chaos, port_registry, tparams, tcfg,
                    {"device": "cpu"}, port_reference, contextlib.nullcontext))


def _truncate(out, prompt, budget):
  gen = np.asarray(out)[len(prompt):]
  stops = np.where(gen == EOS)[0]
  stop = (int(stops[0]) + 1) if len(stops) else int(budget)
  return np.concatenate([np.asarray(prompt), gen[:stop]]).astype(np.int64)


def _workload(seed, n=8, plens=(3, 5, 7), budgets=(4, 8)):
  rng = np.random.RandomState(seed)
  return [(rng.randint(1, 64, (int(rng.choice(plens)),)).astype(np.int32),
           int(rng.choice(budgets))) for _ in range(n)]


def _ids(a):
  return np.asarray(a).tolist()


def _publish(ns, root, publish=1, serve_opts=None):
  opts = dict(num_slots=2, eos_id=EOS, pad_id=PAD, horizon=2)
  opts.update(serve_opts or {})
  reg = ns.ModelRegistry(root)
  extra = {"model_cfg": ns.host.cfg_wire(ns.cfg), "serve_opts": opts}
  return [reg.publish(ns.params, step=100 * (i + 1), extra=extra)
          for i in range(publish)]


@contextlib.contextmanager
def _hosts_up(ns, root, n=2, publish=1, serve_opts=None, plane_kw=None,
              hosts_out=None):
  """The reference's harness: a Server with the serving plane attached,
  a registry at ``root`` holding ``publish`` versions of the tiny model,
  and ``n`` thread-mode hosts registered and syncing. Yields
  ``(addr, plane, versions)``."""
  versions = _publish(ns, root, publish, serve_opts)
  server = ns.rdv.Server(count=1)
  addr = server.start()
  plane = ns.remote.attach_serving_plane(server, **(plane_kw or {}))
  stops = []
  try:
    with ns.patch():
      for hid in range(n):
        h, stop = ns.host.run_host_thread(addr, hid, registry_root=root,
                                          build_opts=ns.build_opts)
        if hosts_out is not None:
          hosts_out.append(h)
        stops.append(stop)
      plane.await_hosts(n, timeout=60)
      yield addr, plane, versions
  finally:
    for stop in stops:
      stop()
    server.stop()


def _check_parity(ns, work, outs):
  for (p, b), out in zip(work, outs):
    np.testing.assert_array_equal(out, ns.reference(p, b))


# -- TestRemoteFleet -------------------------------------------------------


def fleet_parity_and_stream_across_the_wire(ns, root):
  with _hosts_up(ns, root, n=2) as (addr, plane, versions):
    fl = ns.ServingFleet(
        ns.remote.remote_engine_factory(plane, version=versions[0]),
        num_replicas=2,
        health_probe=ns.remote.wire_health_probe(addr)).start()
    try:
      work = _workload(3, n=8)
      frids = [fl.submit(p, max_new_tokens=b) for p, b in work]
      streamed = list(fl.stream(frids[0], timeout=120))
      outs = [fl.result(fr, timeout=120) for fr in frids[1:]]
      stats = dict(fl.stats)
    finally:
      fl.stop()
    _check_parity(ns, work[1:], outs)
    p0, b0 = work[0]
    assert streamed == [int(t) for t in ns.reference(p0, b0)[len(p0):]]
    assert plane.stats["syncs"] > 0 and plane.stats["bad_messages"] == 0
  return {"streamed": streamed, "outs": [_ids(o) for o in outs],
          "completed": stats["completed"], "shed": stats["shed"]}


def chunked_prompt_reassembles_across_frames(ns, root):
  with _hosts_up(ns, root, n=1, plane_kw={"chunk": 8}) as (addr, plane,
                                                           versions):
    rep = ns.remote.RemoteReplica(plane, version=versions[0])
    rep.start()
    try:
      prompt = np.arange(1, 30, dtype=np.int32) % 60 + 1
      rid = rep.submit(prompt, max_new_tokens=6)
      out = rep.result(rid, timeout=120)
    finally:
      rep.stop()
    np.testing.assert_array_equal(out, ns.reference(prompt, 6))
    chunk = plane.chunk
  return {"out": _ids(out), "chunk": chunk}


def overloaded_reconstructed_with_fields(ns, root):
  hosts = []
  with _hosts_up(ns, root, n=1, serve_opts={"max_queue": 1},
                 hosts_out=hosts) as (addr, plane, versions):
    rep = ns.remote.RemoteReplica(plane, version=versions[0],
                                  admit_timeout=30.0)
    rep.start()
    # hold the host engine's decode, so the queue fills however fast the
    # engine would otherwise clear it
    eng = hosts[0].engine
    orig_decode = eng._decode_once
    resume = threading.Event()
    eng._decode_once = lambda: (resume.wait(timeout=60) and orig_decode())
    try:
      rejection = None
      for p, b in _workload(11, n=6, budgets=(16,)):
        try:
          rep.submit(p, max_new_tokens=b)
        except ns.sched.ServingOverloaded as e:
          rejection = e
          break
      assert rejection is not None
      assert rejection.queue_depth is not None
      assert rejection.retry_after is not None
    finally:
      resume.set()
      eng._decode_once = orig_decode
      rep.stop()
  return {"type": type(rejection).__name__,
          "draining": rejection.draining}


def deadline_and_cancel_cross_the_wire(ns, root):
  hosts = []
  with _hosts_up(ns, root, n=1, serve_opts={"poll_interval": 0.005},
                 hosts_out=hosts) as (addr, plane, versions):
    rep = ns.remote.RemoteReplica(plane, version=versions[0])
    rep.start()
    eng = hosts[0].engine
    orig_decode = eng._decode_once
    try:
      warm = rep.result(rep.submit(np.asarray([3, 1, 4], np.int32),
                                   max_new_tokens=4), timeout=120)
      rid = rep.submit(np.asarray([5, 9, 2], np.int32), max_new_tokens=32,
                       ttl=0.01)
      with pytest.raises(ns.sched.DeadlineExceeded):
        rep.result(rid, timeout=120)
      # gate the host engine's decode until the relayed cancel is seen on
      # the host's own request handle, then let the reap fail it
      resume = threading.Event()
      eng._decode_once = lambda: (resume.wait(timeout=60)
                                  and orig_decode())
      rid2 = rep.submit(np.asarray([6, 5, 3], np.int32), max_new_tokens=32)
      rep.request(rid2).cancelled.set()
      deadline = time.monotonic() + 30
      while True:
        t = hosts[0]._track.get(rid2)
        if t is not None and t["handle"].cancelled.is_set():
          break
        assert time.monotonic() < deadline, \
            "cancel command never reached the host engine"
        time.sleep(0.01)
      resume.set()
      cancelled = rep.cancel(rid2, timeout=60)
      with pytest.raises(ns.sched.RequestCancelled):
        rep.result(rid2, timeout=60)
    finally:
      eng._decode_once = orig_decode
      rep.stop()
  return {"warm": _ids(warm), "cancelled": cancelled}


def rolling_swap_rebuilds_hosts_on_new_version(ns, root):
  with _hosts_up(ns, root, n=2, publish=2) as (addr, plane, versions):
    v1, v2 = versions
    fl = ns.ServingFleet(
        ns.remote.remote_engine_factory(plane, version=v1),
        num_replicas=2).start()
    try:
      for rid in fl.replica_states():
        fl.set_replica_version(rid, v1)
      work = _workload(7, n=6)
      frids = [fl.submit(p, max_new_tokens=b) for p, b in work]
      swap = fl.rolling_swap(
          timeout=120.0,
          engine_factory=ns.remote.remote_engine_factory(plane, version=v2),
          version=v2)
      outs = [fl.result(fr, timeout=120) for fr in frids]
      stats = dict(fl.stats)
      served = sorted(set(fl.served_versions().values()))
    finally:
      fl.stop()
    assert all(r["drained"] for r in swap["replicas"])
    assert stats["shed"] == 0 and stats["replay_mismatches"] == 0
    _check_parity(ns, work, outs)
    status = plane.status()
  return {"swapped": swap["swapped"], "served": served,
          "outs": [_ids(o) for o in outs],
          "hosts": {h: (row["generation"], row["version"])
                    for h, row in sorted(status.items())}}


# -- TestWireHealthProbe and TestPlaneWire ---------------------------------


def probe_rides_health_verb_and_keeps_local_path(ns, root):
  got = []
  with _hosts_up(ns, os.path.join(root, "a"), n=1) as (addr, plane,
                                                       versions):
    probe = ns.remote.wire_health_probe(addr)
    rep = ns.remote.RemoteReplica(plane, version=versions[0])
    rep.start()
    got.append(probe(ns.fleet.Replica(0, rep)))
    client = ns.rdv.Client(addr, timeout=5.0)
    try:
      reply = client._request({"type": "HEALTH"})
      row = (reply.get("hosts") or {}).get("0")
      got.append(sorted(row))
    finally:
      client.close()
    rep.stop()

    class _Local:
      alive = True
    got.append(probe(ns.fleet.Replica(1, _Local())))
    _Local.alive = False
    got.append(probe(ns.fleet.Replica(1, _Local())))
  with _hosts_up(ns, os.path.join(root, "b"), n=1) as (addr, plane,
                                                       versions):
    probe = ns.remote.wire_health_probe(addr)
    rep = ns.remote.RemoteReplica(plane, version=versions[0])
    rep.start()
    wrapped = ns.fleet.Replica(0, rep)
    got.append(probe(wrapped))
    rep.kill(RuntimeError("probe pin"))
    deadline = time.monotonic() + 10
    while probe(wrapped) and time.monotonic() < deadline:
      time.sleep(0.05)
    got.append(probe(wrapped))
  assert got[0] is True and got[2] is True and got[3] is False
  assert got[4] is True and got[5] is False
  return got


def dispatch_arms_and_unregistered_resync(ns, root):
  del root
  server = ns.rdv.Server(count=1)
  addr = server.start()
  ns.remote.attach_serving_plane(server)
  client = ns.rdv.Client(addr, timeout=5.0)
  try:
    replies = [
        client._request({"type": "SHREG", "host_id": 5, "meta": {}}),
        client._request({"type": "SHSYNC", "host_id": 5, "events": [],
                         "stats": {}}),
        client._request({"type": "SHSYNC", "host_id": 77, "events": [],
                         "stats": {}}),
        client._request({"type": "SHBYE", "host_id": 5})]
  finally:
    client.close()
    server.stop()
  assert replies[0]["type"] == "OK" and replies[0]["chunk"] > 0
  assert replies[1]["type"] == "OK" and replies[1]["cmds"] == []
  assert replies[2]["type"] == "ERROR"
  assert "unregistered" in replies[2]["error"]
  return [{k: v for k, v in r.items() if k != "server_time"}
          for r in replies]


def serving_verbs_error_without_plane(ns, root):
  del root
  server = ns.rdv.Server(count=1)
  addr = server.start()
  client = ns.rdv.Client(addr, timeout=5.0)
  try:
    replies = [client._request({"type": verb, "host_id": 0, "meta": {}})
               for verb in ("SHREG", "SHSYNC", "SHBYE")]
  finally:
    client.close()
    server.stop()
  assert all(r["type"] == "ERROR" and "no serving plane" in r["error"]
             for r in replies)
  return replies


def token_events_apply_exactly_once(ns, root):
  del root
  req = ns.remote.RemoteRequest(np.asarray([1], np.int32), 4, None,
                                lambda: None)
  req._apply_tokens(0, [11, 12])
  req._apply_tokens(0, [11, 12, 13])
  req._apply_tokens(3, [14])
  drained = []
  while not req.stream_q.empty():
    drained.append(req.stream_q.get_nowait())
  with pytest.raises(RuntimeError) as e:
    req._apply_tokens(9, [99])
  return {"tokens": list(req.tokens), "drained": drained,
          "gap": str(e.value).split(" for request")[0]}


def error_codec_roundtrips_typed(ns, root):
  del root
  sched, remote = ns.sched, ns.remote
  over = sched.ServingOverloaded("busy", queue_depth=3, queued_tokens=40,
                                 retry_after=0.5, draining=True)
  back = remote.decode_error(remote.encode_error(over))
  assert isinstance(back, sched.ServingOverloaded)
  out = [remote.encode_error(over),
         (back.queue_depth, back.queued_tokens, back.retry_after,
          back.draining)]
  for exc, typ in ((sched.DeadlineExceeded("late"), sched.DeadlineExceeded),
                   (sched.RequestCancelled("bye"), sched.RequestCancelled),
                   (sched.PoisonedRequest("bad"), sched.PoisonedRequest),
                   (ValueError("empty prompt"), ValueError),
                   (RuntimeError("boom"), RuntimeError)):
    wire = remote.encode_error(exc)
    back = remote.decode_error(wire)
    assert isinstance(back, typ)
    out.append((wire, type(back).__name__, str(back)))
  assert remote.decode_error(None) is None
  return out


# -- TestHostChaos ------------------------------------------------------------


def partition_past_timeout_reads_as_death(ns, root):
  """The reference's case, made deterministic: host 0's decode is held
  until its replica is ejected, so the partition always lands on
  requests host 0 has acknowledged and not finished. (Left to timing, a
  partition can instead land while an acknowledgement is in flight: the
  submit then fails over to the other host as a retry, the partitioned
  replica holds nothing, and no failover happens.) The plane reads 2 s
  of silence as death, not the reference's 0.5 s: under a loaded test
  worker the surviving host's sync loop can stall past 0.5 s, and then
  both replicas are ejected."""
  os.environ[ns.chaos.ENV_HOST] = "decode@0#3:partition:60"
  hosts = []
  try:
    with _hosts_up(ns, root, n=2, plane_kw={"timeout": 2.0},
                   hosts_out=hosts) as (addr, plane, versions):
      fl = ns.ServingFleet(
          ns.remote.remote_engine_factory(plane, version=versions[0]),
          num_replicas=2, poll_interval=0.02,
          health_probe=ns.remote.wire_health_probe(addr)).start()
      eng = hosts[0].engine
      orig_decode = eng._decode_once
      resume = threading.Event()
      eng._decode_once = lambda: (resume.wait(timeout=60)
                                  and orig_decode())
      try:
        work = _workload(13, n=8, budgets=(8, 16))
        frids = [fl.submit(p, max_new_tokens=b) for p, b in work]
        deadline = time.monotonic() + 30
        while fl.replica_states()[0] != ns.fleet.EJECTED:
          assert time.monotonic() < deadline, "replica 0 never ejected"
          time.sleep(0.02)
        resume.set()
        outs = [fl.result(fr, timeout=120) for fr in frids]
        stats = dict(fl.stats)
        states = fl.replica_states()
      finally:
        resume.set()
        eng._decode_once = orig_decode
        fl.stop()
  finally:
    del os.environ[ns.chaos.ENV_HOST]
  assert ns.fleet.EJECTED in states.values()
  assert stats["ejections"] >= 1 and stats["failovers"] >= 1
  assert stats["shed"] == 0 and stats["replay_mismatches"] == 0
  _check_parity(ns, work, outs)
  return {"outs": [_ids(o) for o in outs],
          "ejected": sorted(r for r, s in states.items()
                            if s == ns.fleet.EJECTED)}


def stall_slows_but_never_ejects(ns, root):
  os.environ[ns.chaos.ENV_HOST] = "sync@0#5:stall:0.3"
  try:
    with _hosts_up(ns, root, n=2) as (addr, plane, versions):
      fl = ns.ServingFleet(
          ns.remote.remote_engine_factory(plane, version=versions[0]),
          num_replicas=2, poll_interval=0.02).start()
      try:
        work = _workload(17, n=6)
        frids = [fl.submit(p, max_new_tokens=b) for p, b in work]
        outs = [fl.result(fr, timeout=120) for fr in frids]
        stats = dict(fl.stats)
        states = fl.replica_states()
      finally:
        fl.stop()
  finally:
    del os.environ[ns.chaos.ENV_HOST]
  _check_parity(ns, work, outs)
  return {"outs": [_ids(o) for o in outs], "states": states,
          "ejections": stats["ejections"], "shed": stats["shed"]}


def malformed_host_spec_raises(ns, root):
  del root
  os.environ[ns.chaos.ENV_HOST] = "sync@0:partition"
  try:
    with pytest.raises(ValueError) as e:
      ns.chaos.check_config()
  finally:
    del os.environ[ns.chaos.ENV_HOST]
  return str(e.value)


CASES = {f.__name__: f for f in (
    fleet_parity_and_stream_across_the_wire,
    chunked_prompt_reassembles_across_frames,
    overloaded_reconstructed_with_fields, deadline_and_cancel_cross_the_wire,
    rolling_swap_rebuilds_hosts_on_new_version,
    probe_rides_health_verb_and_keeps_local_path,
    dispatch_arms_and_unregistered_resync, serving_verbs_error_without_plane,
    token_events_apply_exactly_once, error_codec_roundtrips_typed,
    partition_past_timeout_reads_as_death, stall_slows_but_never_ejects,
    malformed_host_spec_raises)}


def _clean_env(monkeypatch):
  for name in list(os.environ):
    if name.startswith(("TOS_CHAOS_", "TOS_HOST_", "TOS_FLEET_",
                        "TOS_REGISTRY_")):
      monkeypatch.delenv(name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_serving_hosts_match_the_reference(pkgs, monkeypatch, tmp_path,
                                                case):
  _clean_env(monkeypatch)
  records = {}
  for ns in pkgs:
    jax_chaos.reset()
    port_chaos.reset()
    root = tmp_path / ns.name
    root.mkdir()
    records[ns.name] = CASES[case](ns, str(root))
  jax_chaos.reset()
  port_chaos.reset()
  assert records["torch"] == records["jax"]


@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32),
                                    (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fields", [TINY, {}, dict(num_kv_heads=4,
                                                   fuse_qkv=True)],
                         ids=["tiny", "flagship", "grouped"])
def test_cfg_wire_agrees_between_packages(dtypes, fields):
  """A manifest's ``extra["model_cfg"]`` means the same in both packages:
  ``cfg_wire`` gives equal dicts, dtype as the same name, and the port
  rebuilds the same config from either."""
  jcfg = jax_tfm.TransformerConfig(dtype=dtypes[0], **fields)
  tcfg = tfm.TransformerConfig(dtype=dtypes[1], **fields)
  wire = port_host.cfg_wire(tcfg)
  assert wire == jax_host.cfg_wire(jcfg)
  assert isinstance(wire["dtype"], str)
  d = dict(wire)
  name = d.pop("dtype")
  assert tfm.TransformerConfig(dtype=getattr(torch, name), **d) == tcfg


def test_manifest_builds_the_engine_it_names(pkgs, tmp_path):
  """``build_engine_from_manifest``: the config from ``model_cfg``, the
  engine options from ``serve_opts``, host-local overrides winning; a
  manifest without ``model_cfg`` or with an unknown dtype is refused with
  the reference's messages."""
  port = pkgs[1]
  reg = port.ModelRegistry(str(tmp_path))
  v = _publish(port, str(tmp_path))[0]
  params, manifest = reg.get(v)
  eng = port_host.build_engine_from_manifest(
      params, manifest, {"device": "cpu", "num_slots": 3})
  assert eng.cfg == port.cfg and eng.num_slots == 3 and eng.eos_id == EOS
  assert eng.horizon == 2
  for bad, jbad in (({}, {}), ({"extra": {"model_cfg": {"dtype": "int3"}}},
                               {"extra": {"model_cfg": {"dtype": "int3"}}})):
    with pytest.raises(RuntimeError) as got:
      port_host.build_engine_from_manifest(params, bad)
    with pytest.raises(RuntimeError) as want:
      jax_host.build_engine_from_manifest(params, jbad)
    assert str(got.value) == str(want.value)


def test_serving_hosts_under_cluster_run(pkgs, tmp_path, monkeypatch):
  """``make_serving_host_main`` under the port's ``cluster.run``: two CPU
  executors become serving hosts 0 and 1, a driver-side fleet serves
  across them with outputs equal to the JAX package's
  ``greedy_generate_kv``, and the hosts leave at an ``exit`` command."""
  _clean_env(monkeypatch)
  jax_ns, port = pkgs
  root = str(tmp_path / "reg")
  v = _publish(port, root)[0]
  server = port_rdv.Server(count=1)
  addr = server.start()
  plane = port_remote.attach_serving_plane(server)
  main = port_host.make_serving_host_main(addr, registry_root=root,
                                          build_opts={"device": "cpu"})
  c = port_cluster.run(LocalEngine(num_executors=2), main, None,
                       reservation_timeout=120)
  try:
    assert plane.await_hosts(2, timeout=120) == [0, 1]
    fl = port_fleet.ServingFleet(
        port_remote.remote_engine_factory(plane, version=v),
        num_replicas=2,
        health_probe=port_remote.wire_health_probe(addr)).start()
    try:
      work = _workload(23, n=6)
      outs = [fl.result(fr, timeout=120) for fr in
              [fl.submit(p, max_new_tokens=b) for p, b in work]]
      stats = dict(fl.stats)
      hosts = {r.engine.host_id for r in fl._replicas.values()}
    finally:
      fl.stop()
    assert hosts == {0, 1}
    assert stats["completed"] == len(work) and stats["shed"] == 0
    _check_parity(jax_ns, work, outs)
  finally:
    for hid in plane.host_ids():
      plane.enqueue(hid, {"op": "exit"})
    c.shutdown(timeout=120)
    server.stop()


@pytest.mark.slow
def test_host_process_kill_mid_decode_fails_over_bit_identical(
    pkgs, tmp_path, monkeypatch):
  """The reference's acceptance pin across a real process boundary, on
  the port: two spawned ServingHost processes, ``TOS_CHAOS_HOST``
  SIGKILLs host 0 mid-decode, the fleet ejects it and replays its
  requests on the survivor to the bit, and a rolling swap afterwards
  sheds nothing. The outputs equal the JAX package's
  ``greedy_generate_kv``. Slow, as in the reference: it spawns two
  processes that each import torch."""
  _clean_env(monkeypatch)
  jax_ns, port = pkgs
  root = str(tmp_path)
  v1, v2 = _publish(port, root, publish=2)
  server = port_rdv.Server(count=1)
  addr = server.start()
  plane = port_remote.attach_serving_plane(server, timeout=1.0)
  env = {port_chaos.ENV_HOST: "decode@0#5:kill"}
  procs = [port_host.start_host_process(addr, hid, registry_root=root,
                                        build_opts={"device": "cpu"},
                                        env=env)
           for hid in range(2)]
  try:
    plane.await_hosts(2, timeout=180)
    fl = port_fleet.ServingFleet(
        port_remote.remote_engine_factory(plane, version=v1),
        num_replicas=2, poll_interval=0.02,
        health_probe=port_remote.wire_health_probe(addr)).start()
    try:
      work = _workload(19, n=8, budgets=(8, 16))
      frids = [fl.submit(p, max_new_tokens=b) for p, b in work]
      outs = [fl.result(fr, timeout=300) for fr in frids]
      stats = dict(fl.stats)
      states = fl.replica_states()
      procs[0].join(timeout=60)
      assert procs[0].exitcode == -9
      frids2 = [fl.submit(p, max_new_tokens=b) for p, b in work[:4]]
      swap = fl.rolling_swap(
          timeout=120.0,
          engine_factory=port_remote.remote_engine_factory(plane,
                                                           version=v2),
          version=v2)
      outs2 = [fl.result(fr, timeout=300) for fr in frids2]
      stats2 = dict(fl.stats)
    finally:
      fl.stop()
  finally:
    for hid in plane.host_ids():
      plane.enqueue(hid, {"op": "exit"})
    for p in procs:
      p.join(timeout=15)
      if p.is_alive():
        p.terminate()
    server.stop()
  assert port_fleet.EJECTED in states.values()
  assert stats["ejections"] >= 1 and stats["failovers"] >= 1
  assert stats["shed"] == 0 and stats["replay_mismatches"] == 0
  assert swap["swapped"] == 1
  assert stats2["shed"] == 0
  _check_parity(jax_ns, work, outs)
  _check_parity(jax_ns, work[:4], outs2)
