"""The port's control plane, engine and card finder, held against the JAX
package where the two must agree.

- ``control/_msgpack``: byte-identical to ``msgpack.packb(...,
  use_bin_type=True)`` over the frame types (hypothesis) and their size
  boundaries;
- ``control/chunkcodec``: identical bytes for the same columnar chunks,
  and each package decodes the other's envelopes;
- ``control/rendezvous``: the contract subset of ``tests/test_rendezvous.py``
  run on both packages, and a client of each package registering with a
  server of the other;
- ``control/feedhub``: queues, the kv store, the stale-hub reclaim;
- ``engine/local``: the contract subset of ``tests/test_engine.py``;
- ``utils/gpu_info``: allocation over fed ``nvidia-smi`` text (the
  original ``gpu_info`` policy matrix).
"""

import os
import pickle
import signal
import stat
import threading
import time
from unittest import mock

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tensorflowonspark_tpu.control import chunkcodec as jax_codec
from tensorflowonspark_tpu.control import rendezvous as jax_rdv
from tensorflowonspark_tpu_torch import node as port_node
from tensorflowonspark_tpu_torch.control import _msgpack
from tensorflowonspark_tpu_torch.control import chunkcodec as port_codec
from tensorflowonspark_tpu_torch.control import feedhub
from tensorflowonspark_tpu_torch.control import rendezvous as port_rdv
from tensorflowonspark_tpu_torch.control.feedhub import FeedQueue, QueueFull
from tensorflowonspark_tpu_torch.engine import LocalEngine, get_engine
from tensorflowonspark_tpu_torch.engine.base import is_executor_lost
from tensorflowonspark_tpu_torch.utils import gpu_info

RDV = {"jax": jax_rdv, "torch": port_rdv}


# -- _msgpack -----------------------------------------------------------------

_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
            | st.floats(allow_nan=True, allow_infinity=True)
            | st.text(max_size=300) | st.binary(max_size=300))
_frames = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=40), inner,
                                     max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_frames)
def test_msgpack_bytes_equal_the_msgpack_package(obj):
  want = msgpack.packb(obj, use_bin_type=True)
  assert _msgpack.packb(obj) == want
  # and the port reads msgpack's bytes back to what msgpack reads
  assert _msgpack.packb(_msgpack.unpackb(want)) == msgpack.packb(
      msgpack.unpackb(want, raw=False), use_bin_type=True)


# every size boundary of every sized format (fix / 8 / 16 / 32 bits)
BOUNDARY_FRAMES = [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 0.0, -0.0, 1e300, "", "x" * 31, "x" * 32, "x" * 255,
    "x" * 256, "x" * 65535, "x" * 65536, "é中", b"", b"y" * 255,
    b"y" * 256, b"y" * 65536, [], [0] * 15, [0] * 16, [0] * 65535,
    [0] * 65536, {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {str(i): i for i in range(65536)},
    (1, "tuple"), bytearray(b"ba"), memoryview(b"mv"),
]


@pytest.mark.parametrize("obj", BOUNDARY_FRAMES,
                         ids=lambda o: "%s-%d" % (type(o).__name__,
                                                  len(o) if hasattr(
                                                      o, "__len__")
                                                  else 0))
def test_msgpack_size_boundaries(obj):
  want = msgpack.packb(obj, use_bin_type=True)
  assert _msgpack.packb(obj) == want
  assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_msgpack_refuses_what_msgpack_refuses():
  with pytest.raises(TypeError):
    _msgpack.packb(np.int64(3))     # numpy scalars: TypeError in both
  with pytest.raises(TypeError):
    msgpack.packb(np.int64(3), use_bin_type=True)
  with pytest.raises(OverflowError):
    _msgpack.packb(2 ** 64)
  frame = msgpack.packb({"type": "REG", "data": [1, 2]}, use_bin_type=True)
  with pytest.raises(ValueError, match="truncated"):
    _msgpack.unpackb(frame[:-1])
  with pytest.raises(ValueError, match="extra data"):
    _msgpack.unpackb(frame + b"\x00")
  # float32 (written by msgpack only on request) still reads
  f32 = msgpack.packb(1.5, use_single_float=True)
  assert _msgpack.unpackb(f32) == 1.5


# -- chunkcodec ---------------------------------------------------------------

def _chunks():
  rng = np.random.default_rng(0)
  return {
      "arrays": [rng.standard_normal((3, 4)).astype("float32")
                 for _ in range(50)],
      "tuples": [(rng.integers(0, 9, 6), int(i), float(i) / 3)
                 for i in range(64)],
      "dict_delta": [(np.full(8, i % 3, "int64"), 1000 + 3 * i)
                     for i in range(256)],
      "bitpack": [(np.array([i % 2 == 0] * 600),) for i in range(4)],
      "zlib": [np.zeros(2048, "float64") for _ in range(4)],
      "pickle_mixed": [1, "a", None, {"k": [1, 2]}],
      "pickle_scalars": [1, 2, 3],
  }


@pytest.mark.parametrize("name", sorted(_chunks()))
def test_chunkcodec_bytes_and_envelopes_match_the_jax_package(name,
                                                              monkeypatch):
  chunk = _chunks()[name]
  # fresh probe-backoff state in both, so both take the same decisions
  monkeypatch.setattr(jax_codec, "_probe_backoff", {})
  monkeypatch.setattr(port_codec, "_probe_backoff", {})
  ours, theirs = port_codec.encode(chunk), jax_codec.encode(chunk)
  if not name.startswith("pickle"):
    assert ours == theirs
  for payload in (ours, theirs):
    for codec in (port_codec, jax_codec):
      got = codec.decode(payload)
      assert pickle.dumps(got) == pickle.dumps(jax_codec.decode(theirs))


def test_chunkcodec_column_chunk_encodes_identically(monkeypatch):
  monkeypatch.setattr(jax_codec, "_probe_backoff", {})
  monkeypatch.setattr(port_codec, "_probe_backoff", {})
  rows = _chunks()["tuples"]
  cc_port = port_codec.decode_columns(port_codec.encode(rows))
  cc_jax = jax_codec.decode_columns(jax_codec.encode(rows))
  assert port_codec.encode(cc_port) == jax_codec.encode(cc_jax)


# -- rendezvous: the contract subset, on both packages ------------------------

def _meta(i, host="h0", **kw):
  d = {"executor_id": i, "host": host, "port": 4000 + i}
  d.update(kw)
  return d


@pytest.fixture(params=["jax", "torch"])
def rdv(request):
  return RDV[request.param]


@pytest.mark.parametrize("adds,remaining,dups", [
    # counting
    ([_meta(0), _meta(1)], 0, 0),
    # a retried task re-registers idempotently
    ([_meta(0), _meta(0, port=9999)], 1, 0),
    # another host claiming the same slot
    ([_meta(0, host="h0"), _meta(0, host="h1")], 1, 1),
    # two fresh tasks on one host claiming one slot
    ([_meta(0, pid=100), _meta(0, pid=200)], 1, 1),
    # a retry that reclaimed the dead predecessor's hub
    ([_meta(0, pid=100), _meta(0, pid=200, reclaimed=True)], 1, 0),
    # reclaimed on ANOTHER host cannot have seen the hub
    ([_meta(0, pid=100), _meta(0, host="h1", pid=200, reclaimed=True)], 1, 1),
    # a lost-reply resend from the same process
    ([_meta(0, pid=100), _meta(0, pid=100, port=4242)], 1, 0),
])
def test_reservations_count_duplicates_and_reclaim(rdv, adds, remaining,
                                                   dups):
  r = rdv.Reservations(2)
  for m in adds:
    r.add(m)
  assert r.remaining() == remaining and len(r.duplicates) == dups
  assert r.get()[-1] == adds[-1]


def test_register_and_await(rdv):
  s = rdv.Server(2)
  addr = s.start()
  try:
    c0, c1 = rdv.Client(addr), rdv.Client(addr)
    c0.register(_meta(0))
    assert not s.reservations.done()
    c1.register(_meta(1))
    assert len(s.await_reservations(timeout=5)) == 2
    assert len(c0.await_reservations(timeout=5)) == 2
    c0.close()
    c1.close()
  finally:
    s.stop()


def test_await_timeout_and_error_abort(rdv):
  s = rdv.Server(2)
  s.start()
  try:
    with pytest.raises(TimeoutError):
      s.await_reservations(timeout=0.5)
    status = {"error": None}
    threading.Timer(0.2, status.__setitem__,
                    ("error", "boom on executor 1")).start()
    with pytest.raises(RuntimeError, match="boom on executor 1"):
      s.await_reservations(timeout=30, status=status)
  finally:
    s.stop()


def test_health_beats_and_stop(rdv):
  s = rdv.Server(1, heartbeat_interval=0.5)
  addr = s.start()
  try:
    c = rdv.Client(addr)
    c.register(_meta(0))
    beat = c._request({"type": "BEAT", "executor_id": 0, "progress": 7})
    assert isinstance(beat["server_time"], float)
    snap = c._request({"type": "HEALTH"})["data"]
    assert set(snap) == {"0"} and snap["0"]["state"] == "live"
    assert snap["0"]["progress"] == 7
    c._request({"type": "BEAT", "executor_id": 0, "bye": True})
    assert c._request({"type": "HEALTH"})["data"]["0"]["state"] == \
        "departed"
    c.request_stop()
    deadline = time.monotonic() + 10
    while not s.stop_requested.is_set() and time.monotonic() < deadline:
      time.sleep(0.02)
    assert s.stop_requested.is_set() and not s.done.is_set()
    c.close()
  finally:
    s.stop()


def test_port_pin_and_range(rdv):
  from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port
  port = get_free_port()
  with mock.patch.dict("os.environ", {rdv.ENV_SERVER_PORT: str(port)}):
    s = rdv.Server(1)
    assert s.start()[1] == port
    s.stop()
  lo = get_free_port()
  with mock.patch.dict("os.environ",
                       {rdv.ENV_SERVER_PORT: "%d-%d" % (lo, lo + 20)}):
    s, s2 = rdv.Server(1), rdv.Server(1)
    a, a2 = s.start(), s2.start()
    assert lo <= a[1] <= lo + 20 and lo <= a2[1] <= lo + 20
    assert a[1] != a2[1]
    s.stop()
    s2.stop()


@pytest.mark.parametrize("verb,item", [("OBS", "item 7"),
                                       ("SYNC", "item 10c, part 2"),
                                       ("GROUP", "item 10c, part 2"),
                                       ("SHREG", "item 8")])
def test_unported_verbs_answer_with_their_item(verb, item):
  s = port_rdv.Server(1)
  addr = s.start()
  try:
    c = port_rdv.Client(addr)
    resp = c._request({"type": verb})
    if verb == "OBS":
      # item 7 is ported: the verb is served, and without a driver sink
      # the delta is acknowledged and dropped, as in the JAX package
      assert resp["type"] == "OK" and resp["accepted"] is False
      assert "server_time" in resp
    elif verb in ("SYNC", "GROUP"):
      # item 10c, part 2 is ported: the verb goes to an attached sync
      # plane, and without one the reply is the JAX package's
      assert resp == {"type": "ERROR",
                      "error": "no sync plane attached for %s" % verb}
    elif verb == "SHREG":
      # item 8 is ported: the verb goes to an attached serving plane, and
      # without one the reply is the JAX package's "no serving plane"
      assert resp == {"type": "ERROR",
                      "error": "no serving plane attached for SHREG"}
    else:
      assert resp["type"] == "ERROR" and item in resp["error"]
    c.close()
  finally:
    s.stop()


@pytest.mark.parametrize("server_pkg,client_pkgs", [
    ("jax", ("torch", "jax")), ("torch", ("jax", "torch"))])
def test_clients_of_either_package_register_with_either_server(
    server_pkg, client_pkgs):
  """A port client registers with a JAX server and a JAX client with a
  port server; both servers hand back the same cluster_info."""
  metas = [_meta(0, pid=11, job_name="worker", task_index=0,
                 hub_addr=["127.0.0.1", 5000], tb_url=None, reclaimed=False,
                 restart=0),
           _meta(1, host="h1", pid=12, job_name="ps", task_index=0,
                 hub_addr=["10.0.0.2", 5001], tb_url="http://h1:6006",
                 reclaimed=True, restart=2)]
  s = RDV[server_pkg].Server(2, heartbeat_interval=0.5)
  port = s.start()[1]
  try:
    clients = [RDV[p].Client(("127.0.0.1", port)) for p in client_pkgs]
    for c, m in zip(clients, metas):
      c.register(m)
    infos = [c.await_reservations(timeout=10) for c in clients]
    assert infos[0] == infos[1] == metas
    # a heartbeat of the other package is a TIME exchange here too
    sender = RDV[client_pkgs[0]].HeartbeatSender(("127.0.0.1", port), 0,
                                                 interval=0.2).start()
    sender.stop()
    assert sender.clock.samples >= 2
    assert s.liveness.state(0) == "departed"
    for c in clients:
      c.close()
  finally:
    s.stop()


# -- feedhub ------------------------------------------------------------------

def test_feed_queue_fifo_backpressure_and_join():
  q = FeedQueue(maxsize=2)
  q.put(1)
  q.put_many([2])
  with pytest.raises(QueueFull):
    q.put(3, block=False)
  threading.Timer(0.2, q.get).start()
  q.put(3, block=True, timeout=5)        # unblocks when the consumer pops
  assert q.get_many(10) == [2, 3]
  assert not q.join(timeout=0.05)        # 3 items never acknowledged
  q.task_done(3)
  assert q.join(timeout=1)
  assert q.get_many(1, block=True, timeout=0.05) == []
  with pytest.raises(ValueError):
    q.task_done(1)


def test_hub_queues_and_kv_across_processes():
  hub = feedhub.start(b"secret", ["input", "error", "control"], mode="local",
                      qmax=2)
  try:
    assert hub.get("state") == "running"
    client = feedhub.connect(hub.addr, b"secret")
    client.get_queue("input").put_many([{"x": 1}, None])
    assert hub.get_queue("input").get_many(10) == [{"x": 1}, None]
    client.get_queue("error").put_many(["e%d" % i for i in range(10)])
    assert hub.get_queue("error").qsize() == 10    # never bounded
    client.set("state", "terminating")
    assert hub.get("state") == "terminating"
  finally:
    hub.shutdown()


def _write_hub_file(directory, addr):
  with open(os.path.join(directory, port_node.HUB_ADDR_FILE), "w") as f:
    f.write("%s:%d" % tuple(addr))


def test_stale_hub_reclaim(tmp_path):
  wd = str(tmp_path)
  assert port_node._reclaim_stale_hub(wd, b"k", 0) is False   # no hub yet
  live = feedhub.start(b"k", ["error"], mode="local")
  try:
    _write_hub_file(wd, live.addr)
    with pytest.raises(RuntimeError, match="live node"):
      port_node._reclaim_stale_hub(wd, b"k", 0)
    # another cluster's hub (another authkey) is foreign: reclaimed
    assert port_node._reclaim_stale_hub(wd, b"other", 0) is True
    live.set("state", "stopped")
    assert port_node._reclaim_stale_hub(wd, b"k", 0) is True
    deadline = time.monotonic() + 10      # the stale manager was reaped
    while live._manager._process.is_alive() and \
        time.monotonic() < deadline:
      time.sleep(0.05)
    assert not live._manager._process.is_alive()
  finally:
    live.shutdown()


# -- engine/local: the contract subset ----------------------------------------

def _slot_and_pid(it):
  return (list(it), os.environ.get("TOS_EXECUTOR_SLOT", "-"), os.getpid())


def _square_sum(it):
  return [sum(x * x for x in it)]


def _boom(it):
  list(it)
  raise ValueError("deliberate failure for testing")


def _boom_on_two(it):
  rows = list(it)
  if 2 in rows:
    raise ValueError("deliberate failure on partition with 2")
  return rows


def _sleep_then_slot(it):
  list(it)
  time.sleep(1.0)
  return os.environ["TOS_EXECUTOR_SLOT"]


def _write_marker(it):
  with open("marker.txt", "w") as f:
    f.write(str(list(it)[0]))
  return os.getcwd()


def _barrier_fn(it, ctx):
  task_id = list(it)[0]
  ctx.barrier()
  return (task_id, len(ctx.get_task_infos()))


@pytest.fixture(scope="module")
def engine():
  e = LocalEngine(num_executors=2)
  yield e
  e.stop()


def test_engine_routes_payloads(engine):
  assert sorted(r[0][0] for r in engine.run_on_executors(
      _slot_and_pid).wait(timeout=30)) == [0, 1]
  got = engine.run_on_executors(_slot_and_pid, num_tasks=2,
                                task_payloads=["a", "b"]).wait(timeout=30)
  assert [r[0] for r in got] == [["a"], ["b"]]
  assert engine.map_partitions([[1, 2], [3]], _square_sum,
                               timeout=30) == [5, 9]


def test_engine_error_carries_traceback_of_its_task(engine):
  with pytest.raises(RuntimeError, match="deliberate failure"):
    engine.run_on_executors(_boom).wait(timeout=30)
  job = engine.foreach_partition([[1], [2], [3]], _boom_on_two)
  with pytest.raises(RuntimeError, match="Traceback"):
    job.wait(timeout=30)
  assert job.errors[0] is None and job.errors[2] is None
  assert "partition with 2" in job.errors[1]


def test_engine_distinct_processes_and_isolated_workdirs(engine):
  results = engine.run_on_executors(_slot_and_pid).wait(timeout=30)
  assert sorted(r[1] for r in results) == ["0", "1"]
  pids = {r[2] for r in results}
  assert len(pids) == 2 and os.getpid() not in pids
  dirs = engine.run_on_executors(_write_marker).wait(timeout=30)
  assert len(set(dirs)) == 2
  for d in dirs:
    assert os.path.exists(os.path.join(d, "marker.txt"))
  with pytest.raises(ValueError, match="executors"):
    engine.run_on_executors(_slot_and_pid, num_tasks=3)


def test_engine_barrier_gang(engine):
  assert sorted(engine.barrier_run(_barrier_fn, timeout=60)) == \
      [(0, 2), (1, 2)]
  with pytest.raises(ValueError, match="barrier gang"):
    engine.barrier_run(_barrier_fn, num_tasks=3)


def test_engine_refuses_unpicklable_tasks_and_spark(engine):
  def closure(it):
    return list(it)
  with pytest.raises((pickle.PicklingError, AttributeError)):
    engine.run_on_executors(closure)
  with pytest.raises(NotImplementedError, match="item 11"):
    get_engine("spark")


def test_dead_executor_fails_task_and_respawns():
  e = LocalEngine(num_executors=1)
  try:
    victim = e._procs[0].pid
    job = e.run_on_executors(_sleep_then_slot, num_tasks=1)
    time.sleep(0.3)
    os.kill(victim, signal.SIGKILL)
    with pytest.raises(RuntimeError, match="ExecutorLost"):
      job.wait(timeout=30)
    assert is_executor_lost(job.errors[0])
    e.relaunch_task(job, 0, payload="again")
    assert job.wait(timeout=30)[0] == "0"
    assert e._procs[0].pid != victim
  finally:
    e.stop()


# -- utils/gpu_info: the allocation policy over fed nvidia-smi text ---------

def _smi_text(n):
  return "".join("%d, GPU-%08x, NVIDIA H100 80GB HBM3, 81559\n" % (i, i)
                 for i in range(n))


def test_parse_gpus():
  gpus = gpu_info.parse_gpus("\n" + _smi_text(2) + "\n")
  assert [(g.index, g.uuid, g.memory_total_mib) for g in gpus] == \
      [(0, "GPU-00000000", 81559), (1, "GPU-00000001", 81559)]
  assert gpus[0].name == "NVIDIA H100 80GB HBM3"
  with pytest.raises(ValueError, match="columns"):
    gpu_info.parse_gpus("0, GPU-0\n")


@pytest.mark.parametrize("cards,per_node,workers,want", [
    (1, 1, 1, ["0"]),
    (2, 1, 2, ["0", "1"]),
    (2, 2, 1, ["0,1"]),
    (8, 1, 8, [str(i) for i in range(8)]),
    (8, 2, 4, ["0,1", "2,3", "4,5", "6,7"]),
    (8, 2, 2, ["0,1", "2,3"]),
    (8, 4, 2, ["0,1,2,3", "4,5,6,7"]),
])
def test_cards_per_worker(cards, per_node, workers, want):
  n = len(gpu_info.parse_gpus(_smi_text(cards)))
  got = [gpu_info.chip_env_for_worker(per_node, i, workers, n)
         for i in range(workers)]
  assert [g["CUDA_VISIBLE_DEVICES"] for g in got] == want
  assert all(g["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID" for g in got)


@pytest.mark.parametrize("cards,per_node,index,workers", [
    (1, 2, 0, 1), (2, 1, 2, 3), (8, 2, 4, 5), (0, 1, 0, 1)])
def test_too_few_cards_raises_with_the_count(cards, per_node, index, workers):
  with pytest.raises(ValueError,
                     match=r"nvidia-smi counts %d card\(s\)" % cards):
    gpu_info.chip_env_for_worker(per_node, index, workers, cards)


def test_apply_chip_env_claims_once(monkeypatch):
  monkeypatch.delenv(gpu_info.ENV_CHIP_ENV_APPLIED, raising=False)
  monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
  monkeypatch.delenv("CUDA_DEVICE_ORDER", raising=False)
  gpu_info.apply_chip_env(gpu_info.chip_env_for_worker(1, 1, 2, 2))
  assert os.environ["CUDA_VISIBLE_DEVICES"] == "1"
  assert os.environ[gpu_info.ENV_CHIP_ENV_APPLIED] == "1"
  gpu_info.apply_chip_env({"CUDA_VISIBLE_DEVICES": "1"})   # same share: ok
  monkeypatch.setattr(gpu_info, "_cuda_initialized", lambda: True)
  with pytest.raises(RuntimeError, match="already initialized"):
    gpu_info.apply_chip_env({"CUDA_VISIBLE_DEVICES": "0"})


def test_query_gpus_runs_nvidia_smi(tmp_path, monkeypatch):
  monkeypatch.delenv(gpu_info.ENV_CHIP_ENV_APPLIED, raising=False)
  monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
  monkeypatch.delenv("CUDA_DEVICE_ORDER", raising=False)
  monkeypatch.setenv("PATH", str(tmp_path))
  with pytest.raises(RuntimeError, match=r"0 CUDA card\(s\)"):
    gpu_info.query_gpus()
  fake = tmp_path / "nvidia-smi"
  fake.write_text("#!/bin/sh\n[ \"$1\" = \"%s\" ] || exit 9\nprintf '%s'\n"
                  % (gpu_info.query_command()[1],
                     _smi_text(2).replace("\n", "\\n")))
  fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
  assert [g.index for g in gpu_info.query_gpus()] == [0, 1]
  env = gpu_info.allocate(1, 1, 2, gpu_info.query_gpus())
  assert env["CUDA_VISIBLE_DEVICES"] == "1"
