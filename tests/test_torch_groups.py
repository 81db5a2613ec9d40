"""The port's elastic multi-group training held against the JAX package's.

The contract subset of ``tests/test_groups.py``, each case written once and
run through both packages (``parallel/groups.py``, the rendezvous verbs,
``TOS_CHAOS_GROUP`` and the supervisor's resize): the wire codec and the
merge; the sync plane on a fake clock, where one message sequence into
both planes must give equal replies and equal payload bytes; the verbs over
a live server, with the reference's two-client test in a race-free form (both
members join before they sync, so a round's members are frozen at both)
run for 20 rounds, and the self-admit semantics pinned as they are; the
``GroupSet`` drives (converge, kill and re-admit, stall and self-re-admit,
the resharded restore) on the linear harness and on a 2-layer Transformer
with converted weights, losses and merged weights within 1e-6 (1e-5 for the
Transformer); an oversize payload; the chaos grammar; the supervisor's
resize on a stub; and one elastic ``cluster.run`` of the port on the CPU.
"""

import json
import os
import threading
import time
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu import cluster as jax_cluster
from tensorflowonspark_tpu.control import rendezvous as jax_rdv
from tensorflowonspark_tpu.parallel import groups as jax_groups
from tensorflowonspark_tpu.utils import chaos as jax_chaos
from tensorflowonspark_tpu.utils import checkpoint as jax_ckpt
from tensorflowonspark_tpu_torch import cluster as port_cluster
from tensorflowonspark_tpu_torch.control import rendezvous as port_rdv
from tensorflowonspark_tpu_torch.parallel import groups as port_groups
from tensorflowonspark_tpu_torch.utils import chaos as port_chaos
from tensorflowonspark_tpu_torch.utils import checkpoint as port_ckpt

import torch_groups_nodes as nodes

pytestmark = pytest.mark.chaos

PKGS = {
    "jax": types.SimpleNamespace(G=jax_groups, rdv=jax_rdv, chaos=jax_chaos,
                                 cluster=jax_cluster, ckpt=jax_ckpt),
    "torch": types.SimpleNamespace(G=port_groups, rdv=port_rdv,
                                   chaos=port_chaos, cluster=port_cluster,
                                   ckpt=port_ckpt),
}


@pytest.fixture(autouse=True)
def _fresh_chaos_counters():
  for p in PKGS.values():
    p.chaos.reset()
  yield
  for p in PKGS.values():
    p.chaos.reset()


def _leaf(arr):
  a = np.asarray(arr)
  return {"dtype": str(a.dtype), "shape": list(a.shape), "data": a.tobytes()}


def _leaf_np(rec):
  return np.frombuffer(rec["data"], dtype=rec["dtype"]).reshape(rec["shape"])


# -- the codec and the merge --------------------------------------------------


def _tree(pkg):
  tree = {"a": np.arange(6, dtype="float32").reshape(2, 3),
          "b": {"c": np.array(7, dtype="int32")}}
  if pkg == "torch":
    tree["a"] = torch.from_numpy(tree["a"])
  return tree


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_pack_unpack_roundtrip(pkg):
  G = PKGS[pkg].G
  src = _tree(pkg)
  dst = _tree(pkg)
  with torch.no_grad():
    if pkg == "torch":
      dst["a"].zero_()
  out = G.unpack_tree(G.pack_tree(src), dst)
  np.testing.assert_array_equal(np.asarray(out["a"]), np.asarray(src["a"]))
  np.testing.assert_array_equal(np.asarray(out["b"]["c"]), 7)
  # one wire format: the same leaves pack to the same bytes in both
  assert G.pack_tree(src) == PKGS["jax"].G.pack_tree(_tree("jax"))


def test_port_unpack_copies_in_place_keeping_dtype():
  w = torch.zeros(2, 3, dtype=torch.float64)
  tree = {"w": w}
  out = port_groups.unpack_tree(
      [_leaf(np.ones((2, 3), "float32"))], tree)
  assert out is tree and out["w"] is w and w.dtype == torch.float64
  np.testing.assert_array_equal(w.numpy(), 1.0)
  with pytest.raises(ValueError, match="shape"):
    port_groups.unpack_tree([_leaf(np.ones((3, 2), "float32"))], tree)


def test_merge_payloads_equal_bytes_across_packages():
  rng = np.random.default_rng(0)
  contribs = []
  for w in (1.0, 3.0, 0.0):
    contribs.append((w, [_leaf(rng.standard_normal((4, 5)).astype("float32")),
                         _leaf(rng.standard_normal(3)),
                         _leaf(np.array(int(w) + 3, "int32"))]))
  got = port_groups.merge_payloads(contribs)
  assert got == jax_groups.merge_payloads(contribs)
  # the float leaves in f64: (1*a + 3*b + c) / 4, as the reference sums
  # a zero weight as 1 but leaves the total as it is; the int leaf: first
  # wins
  a, b, c = (_leaf_np(contribs[i][1][0]).astype("float64") for i in range(3))
  want = (a + 3 * b + c) / 4
  np.testing.assert_array_equal(_leaf_np(got[0]), want.astype("float32"))
  assert int(_leaf_np(got[2])) == 4
  with pytest.raises(ValueError, match="nothing"):
    port_groups.merge_payloads([])


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_unpack_leaf_count_mismatch_raises(pkg):
  G = PKGS[pkg].G
  tree = {"a": np.zeros(2, "float32")}
  with pytest.raises(ValueError, match="leaves"):
    G.unpack_tree(G.pack_tree(tree) * 2, tree)


def test_bf16_leaf_is_averaged_in_the_port_first_wins_in_the_reference():
  a = torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
  b = torch.tensor([3.0, 6.0], dtype=torch.bfloat16)
  pa, pb = port_groups.pack_tree([a]), port_groups.pack_tree([b])
  assert pa[0]["dtype"] == "bfloat16" and len(pa[0]["data"]) == 4
  merged = port_groups.merge_payloads([(1.0, pa), (1.0, pb)])
  out = port_groups.unpack_tree(merged, [torch.zeros(2,
                                                     dtype=torch.bfloat16)])
  assert out[0].dtype == torch.bfloat16
  assert out[0].tolist() == [2.0, 4.0]
  # the reference's leaf of a JAX bf16 array: numpy sees the dtype as
  # kind 'V', so the merge keeps the first contribution
  ja = jax_groups.pack_tree([jnp.asarray([1.0, 2.0], jnp.bfloat16)])
  jb = jax_groups.pack_tree([jnp.asarray([3.0, 6.0], jnp.bfloat16)])
  assert ja[0]["data"] == pa[0]["data"]
  assert jax_groups.merge_payloads([(1.0, ja), (1.0, jb)])[0] == ja[0]


# -- the sync plane on a fake clock -------------------------------------------


def _p(v):
  return [_leaf(np.array([v], "float32"))]


def _round_completes(plane, clk):
  out = [plane.join(0), plane.join(1),
         plane.contribute(0, 1, _p(2.0), weight=1.0, step=4), plane.poll(1),
         plane.contribute(1, 1, _p(4.0), weight=1.0, step=4), plane.poll(1)]
  assert out[-1]["done"] and out[-1]["members"] == [0, 1]
  np.testing.assert_allclose(_leaf_np(out[-1]["payload"][0]), [3.0])
  assert plane.status()["step"] == 4
  return out


def _deadline_merges(plane, clk):
  out = [plane.join(0), plane.join(1),
         plane.contribute(0, 1, _p(2.0), step=4), plane.poll(1)]
  clk[0] = 6.0          # past the deadline the first contribution armed
  out.append(plane.poll(1))
  assert out[-1]["done"] and out[-1]["denominator"] == 1
  return out


def _miss_limit_evicts(plane, clk):
  out = [plane.join(0), plane.join(1)]
  for rnd in (1, 2):
    out.append(plane.contribute(0, rnd, _p(1.0), step=rnd))
    clk[0] += 6.0
    out.append(plane.poll(rnd))
    assert out[-1]["done"]
  assert 1 in plane.lost
  out.append(plane.contribute(1, 3, _p(9.0)))
  assert out[-1]["lost"] and not out[-1]["accepted"]
  out.append(plane.join(1))        # re-join: the catch-up payload
  assert out[-1]["payload"] is not None and 1 in plane.active
  return out


def _mid_round_join(plane, clk):
  out = [plane.join(0), plane.contribute(0, 1, _p(1.0)),
         plane.join(1), plane.poll(1)]
  assert out[-1]["done"] and out[-1]["members"] == [0]
  return out


def _seed_primes(plane, clk):
  plane.seed(12, _p(5.0))
  out = [plane.join(3)]
  assert out[-1]["step"] == 12
  np.testing.assert_allclose(_leaf_np(out[-1]["payload"][0]), [5.0])
  return out


def _self_admit(plane, clk):
  """The race of the reference's two-client test, made sequential: the
  first contributor admits itself and opens the round with need ==
  {itself}, so its own poll merges a round of one; the late contribution
  is accepted and does not change the merge."""
  out = [plane.contribute(0, 1, _p(2.0), weight=1.0, step=4), plane.poll(1)]
  assert out[-1]["done"] and out[-1]["members"] == [0]
  out += [plane.contribute(1, 1, _p(6.0), weight=3.0, step=4), plane.poll(1)]
  assert out[-2]["accepted"] and out[-1]["members"] == [0]
  np.testing.assert_allclose(_leaf_np(out[-1]["payload"][0]), [2.0])
  return out


def _handle_verbs(plane, clk):
  out = [plane.handle({"type": "GROUP", "action": "join", "group_id": 0}),
         plane.handle({"type": "SYNC", "group_id": 0, "round": 1,
                       "payload": _p(1.5), "weight": 2.0, "step": 3}),
         plane.handle({"type": "SYNCQ", "round": 1}),
         plane.handle({"type": "GROUP", "action": "lost", "group_id": 0,
                       "reason": "test"}),
         plane.handle({"type": "GROUP", "action": "state", "group_id": 0}),
         plane.handle({"type": "GROUP", "action": "leave", "group_id": 0}),
         plane.handle({"type": "GROUP", "action": "bogus"}),
         plane.handle({"type": "HEALTH"})]
  assert out[-2]["type"] == "ERROR" and out[-1]["type"] == "ERROR"
  return out


PLANE_CASES = {f.__name__.strip("_"): f for f in (
    _round_completes, _deadline_merges, _miss_limit_evicts, _mid_round_join,
    _seed_primes, _self_admit, _handle_verbs)}


@pytest.mark.parametrize("case", sorted(PLANE_CASES))
def test_sync_plane_matches_the_reference(case):
  records = {}
  for pkg in sorted(PKGS):
    clk = [0.0]
    plane = PKGS[pkg].G.SyncPlane(sync_timeout=5.0, miss_limit=2,
                                  time_fn=lambda: clk[0])
    replies = PLANE_CASES[case](plane, clk)
    records[pkg] = (replies, plane.status(), list(plane.events))
  assert records["torch"] == records["jax"]


# -- the verbs over a live server ---------------------------------------------


def test_port_wire_sync_merges_both_members_every_round():
  """The reference's two-client test without its race: both members join
  before they sync, so every round's members are frozen at {0, 1}; 20
  rounds, each merging both."""
  server = port_rdv.Server(1)
  server.start()
  rounds = 20
  try:
    port_groups.attach_sync_plane(server, sync_timeout=10.0)
    results = {0: [], 1: []}
    clients = {gid: port_groups.GroupSyncClient(server.addr, gid,
                                                request_timeout=5.0)
               for gid in (0, 1)}
    for c in clients.values():
      c.join()

    def member(gid, weight):
      for rnd in range(1, rounds + 1):
        tree = {"w": torch.tensor([2.0 + 4 * gid + rnd])}
        results[gid].append(clients[gid].sync(rnd, tree, weight=weight,
                                               step=4 * rnd, timeout=15.0))

    threads = [threading.Thread(target=member, args=(0, 1.0)),
               threading.Thread(target=member, args=(1, 3.0))]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=60)
    for c in clients.values():
      c.close()
    for gid in (0, 1):
      assert len(results[gid]) == rounds
      for rnd, (merged, members) in enumerate(results[gid], 1):
        assert members == [0, 1], (gid, rnd, members)
        # (1 * (2 + rnd) + 3 * (6 + rnd)) / 4 on both sides
        assert merged["w"].tolist() == [5.0 + rnd]
    status = server.sync_plane.status()
    assert status["rounds_completed"] == rounds
    assert status["step"] == 4 * rounds
  finally:
    server.stop()


@pytest.mark.parametrize("server_pkg", sorted(PKGS))
def test_self_admit_over_the_wire_as_the_reference(server_pkg):
  """contribute(0) then its poll merges a round of one (members [0]); a
  late contribute(1) is accepted and leaves the merge as it was. Clients
  of both packages, one a member, through either package's server."""
  server = PKGS[server_pkg].rdv.Server(1)
  server.start()
  try:
    PKGS[server_pkg].G.attach_sync_plane(server, sync_timeout=10.0)
    c0 = jax_groups.GroupSyncClient(server.addr, 0, request_timeout=5.0)
    c1 = port_groups.GroupSyncClient(server.addr, 1, request_timeout=5.0)
    merged0, members0 = c0.sync(1, {"w": np.array([2.0], "float32")},
                                weight=1.0, step=4, timeout=5.0)
    assert members0 == [0] and merged0["w"].tolist() == [2.0]
    merged1, members1 = c1.sync(1, {"w": torch.tensor([6.0])}, weight=3.0,
                                step=4, timeout=5.0)
    assert members1 == [0] and merged1["w"].tolist() == [2.0]
    assert server.sync_plane.status()["rounds_completed"] == 1
    c0.close()
    c1.close()
  finally:
    server.stop()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_sync_verbs_error_without_attached_plane(pkg):
  server = PKGS[pkg].rdv.Server(1)
  server.start()
  try:
    client = PKGS[pkg].rdv.Client(server.addr, timeout=5.0)
    for verb in ("SYNC", "SYNCQ", "GROUP"):
      resp = client._request({"type": verb, "action": "join",
                              "group_id": 0})
      assert resp == {"type": "ERROR",
                      "error": "no sync plane attached for %s" % verb}
    assert "groups" not in client._request({"type": "HEALTH"})
    client.close()
  finally:
    server.stop()


def test_port_plane_failure_is_an_error_reply_and_health_carries_groups():
  server = port_rdv.Server(1)
  server.start()
  try:
    plane = port_groups.attach_sync_plane(server, sync_timeout=5.0)
    assert port_groups.attach_sync_plane(server) is plane
    client = port_rdv.Client(server.addr, timeout=5.0)
    client._request({"type": "GROUP", "action": "join", "group_id": 2})
    health = client._request({"type": "HEALTH"})
    assert health["groups"] == plane.status()
    assert health["groups"]["active"] == [2]
    # a malformed message raises inside the plane: an ERROR reply, and
    # the serve loop lives on
    resp = client._request({"type": "SYNC", "round": 1})
    assert resp["type"] == "ERROR" and "group_id" in resp["error"]
    assert client._request({"type": "GROUP", "action": "state"})["ok"]
    client.close()
  finally:
    server.stop()


# -- GroupSet drives on the linear harness ------------------------------------


def _jax_build(dim=nodes.DIM, lr=nodes.LR):
  import optax
  from flax.training import train_state

  def build_fn(mesh):
    del mesh
    params = {"w": jnp.zeros((dim,), jnp.float32)}
    state = train_state.TrainState.create(apply_fn=None, params=params,
                                          tx=optax.sgd(lr))

    def loss_fn(p, b):
      return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    return state, loss_fn

  return build_fn


def _group_set(pkg, build=None, **kw):
  if pkg == "jax":
    return jax_groups.GroupSet(build or _jax_build(), nodes.batch_fn, **kw)
  return port_groups.GroupSet(build or nodes.build_linear, nodes.batch_fn,
                              device="cpu", **kw)


def _weights(pkg, state):
  if pkg == "jax":
    return {k: np.asarray(v) for k, v in state.params.items()}
  return {k: v.detach().cpu().numpy() for k, v in state.params.items()}


def _warm(gs):
  """Each group's loop called once on a copy of its state (the JAX loop
  compiles then; the port's loop copies the state and drops it), so no
  compile lands inside a round's deadline."""
  for g in gs.groups.values():
    g.loop(g.state, gs.batch_fn(g.group_id, 0))


def _record(pkg, gs):
  groups = {gid: {"exit": g.exit_reason, "steps": g.steps,
                  "losses": list(g.losses),
                  "w": _weights(pkg, g.state)}
            for gid, g in sorted(gs.groups.items())}
  status = gs.plane.status()
  syncs = [(e["group"], e["round"], e["denominator"]) for e in gs.events
           if e["event"] == "sync"]
  return {"groups": groups, "status": {k: v for k, v in status.items()
                                       if k != "sync_ms"},
          "kinds": sorted({e["event"] for e in gs.events}),
          "syncs": sorted(syncs), "lost": dict(gs.plane.lost)}


def _converge(pkg, monkeypatch, tmp_path):
  gs = _group_set(pkg, num_groups=2, sync_every=4, sync_timeout=15.0)
  try:
    _warm(gs)
    gs.run(16)
    assert gs.wait(timeout=120)
    for g in gs.groups.values():
      assert g.exit_reason == "completed" and g.steps == 16
    p0 = PKGS[pkg].G.pack_tree(gs.groups[0].state.params)
    p1 = PKGS[pkg].G.pack_tree(gs.groups[1].state.params)
    assert all(a["data"] == b["data"] for a, b in zip(p0, p1)), \
        "post-sync params must be bit-identical across groups"
    assert gs.plane.status()["rounds_completed"] == 4
    losses = gs.groups[0].losses
    assert losses[-1] < losses[0]
    return [_record(pkg, gs)]
  finally:
    gs.close()


def _kill_readmit(pkg, monkeypatch, tmp_path):
  monkeypatch.setenv("TOS_CHAOS_GROUP", "kill@1#2")
  gs = _group_set(pkg, num_groups=2, sync_every=4, sync_timeout=1.0,
                  miss_limit=2)
  try:
    _warm(gs)
    gs.run(24)
    assert gs.wait(timeout=120)
    assert gs.groups[1].exit_reason == "chaos-kill"
    assert gs.groups[0].exit_reason == "completed"
    assert gs.groups[0].steps == 24
    assert 1 in gs.plane.lost
    kinds = [e["event"] for e in gs.events]
    assert "group-killed" in kinds and "plane-lost" in kinds
    first = _record(pkg, gs)
    monkeypatch.delenv("TOS_CHAOS_GROUP")
    PKGS[pkg].chaos.reset()
    g = gs.readmit(1)
    assert g.steps >= 20
    assert gs.wait(timeout=120)
    assert gs.groups[1].exit_reason == "completed"
    assert gs.plane.status()["groups_active"] == 2
    return [first, _record(pkg, gs)]
  finally:
    gs.close()


def _stall_readmit(pkg, monkeypatch, tmp_path):
  monkeypatch.setenv("TOS_CHAOS_GROUP", "stall@1#1:2.0")
  gs = _group_set(pkg, num_groups=2, sync_every=4, sync_timeout=0.5,
                  miss_limit=1)
  try:
    _warm(gs)
    gs.run(8)
    assert gs.wait(timeout=120)
    for g in gs.groups.values():
      assert g.exit_reason == "completed" and g.steps == 8
    kinds = [e["event"] for e in gs.events]
    assert "plane-lost" in kinds and "group-readmitted" in kinds
    rec = _record(pkg, gs)
    # group 1 read its losses before the catch-up: its 4 steps of round 1
    assert len(rec["groups"][1]["losses"]) == 4
    return [rec]
  finally:
    gs.close()


def _reshard_restore(pkg, monkeypatch, tmp_path):
  ckdir = str(tmp_path / ("ck_" + pkg))
  gs = _group_set(pkg, num_groups=2, sync_every=4, sync_timeout=15.0)
  try:
    _warm(gs)
    gs.run(8)
    assert gs.wait(timeout=120)
    mgr = PKGS[pkg].ckpt.CheckpointManager(ckdir, save_interval_steps=1)
    assert gs.save(mgr, force=True)
    mgr.wait()
    assert mgr.manifest() == {
        "schema": 1, "kind": "groupset", "num_groups": 2,
        "groups": [0, 1], "step": 8, "sync_every": 4, "sync_round": 2}
    saved = PKGS[pkg].G.pack_tree(gs.groups[0].state.params)
    out = [_record(pkg, gs)]
  finally:
    gs.close()
  trajectories = {}
  for n in (3, 1):
    gs2 = _group_set(pkg, num_groups=n, sync_every=4, sync_timeout=15.0)
    try:
      mgr2 = PKGS[pkg].ckpt.CheckpointManager(ckdir, save_interval_steps=1)
      assert gs2.restore_or(mgr2) == 9
      for g in gs2.groups.values():
        assert g.steps == 8
        restored = PKGS[pkg].G.pack_tree(g.state.params)
        assert all(a["data"] == b["data"] for a, b in zip(saved, restored))
      gs2.run(12)
      assert gs2.wait(timeout=120)
      assert all(g.exit_reason == "completed" and g.steps == 12
                 for g in gs2.groups.values())
      trajectories[n] = list(gs2.groups[0].losses)
      out.append(_record(pkg, gs2))
    finally:
      gs2.close()
  assert trajectories[3] == trajectories[1]
  return out


def _assert_close(port, ref, tol, where=""):
  """The port's record against the reference's: exact where it is not a
  float, floats within ``tol``."""
  if isinstance(ref, dict):
    assert sorted(port) == sorted(ref), where
    for k in ref:
      _assert_close(port[k], ref[k], tol, "%s/%s" % (where, k))
  elif isinstance(ref, np.ndarray) or (isinstance(ref, list) and ref and
                                        isinstance(ref[0], float)):
    np.testing.assert_allclose(np.asarray(port, "float64"),
                               np.asarray(ref, "float64"), rtol=0,
                               atol=tol, err_msg=where)
  elif isinstance(ref, list):
    assert len(port) == len(ref), where
    for i, (a, b) in enumerate(zip(port, ref)):
      _assert_close(a, b, tol, "%s[%d]" % (where, i))
  else:
    assert port == ref, where


GROUPSET_CASES = {f.__name__.strip("_"): f for f in (
    _converge, _kill_readmit, _stall_readmit, _reshard_restore)}


@pytest.mark.parametrize("case", sorted(GROUPSET_CASES))
def test_group_set_matches_the_reference(case, monkeypatch, tmp_path):
  records = {pkg: GROUPSET_CASES[case](pkg, monkeypatch, tmp_path)
             for pkg in ("jax", "torch")}
  _assert_close(records["torch"], records["jax"], 1e-6)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_oversize_payload_ends_the_group_as_an_error(pkg, monkeypatch):
  """A payload past the frame raises ValueError at the send; the group's
  outer handler ends it as ``error: ...``, not as ``sync-failed``."""
  monkeypatch.setattr(PKGS[pkg].rdv, "MAX_MESSAGE_BYTES", 64)
  gs = _group_set(pkg, num_groups=1, sync_every=2, sync_timeout=5.0)
  try:
    gs.run(4)
    assert gs.wait(timeout=60)
    g = gs.groups[0]
    assert not g.alive and g.steps == 2
    assert g.exit_reason.startswith("error: refusing to send oversized "
                                    "rendezvous message")
    assert g.exit_reason.endswith("> 64)")
    assert [e["event"] for e in gs.events].count("group-error") == 1
  finally:
    gs.close()


# -- a 2-layer Transformer with converted weights -----------------------------

TFM = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
           max_seq_len=16)
TFM_B, TFM_S, TFM_LR = 4, 16, 0.1


def _tokens(gid, step):
  rng = np.random.default_rng(100 * gid + step)
  return rng.integers(0, TFM["vocab_size"], (TFM_B, TFM_S)).astype("int32")


def test_transformer_groups_match_the_reference():
  """Two groups of a 2-layer d_model 64 Transformer, SGD, synced every 2
  steps for 4: the port (plain versions on the CPU) from weights
  converted out of the JAX package's initial state, against the JAX
  package's GroupSet: losses and post-sync weights within 1e-5."""
  import optax
  from tensorflowonspark_tpu.models import transformer as jax_tfm
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.utils.params import (params_from_flax,
                                                        params_to_flax)
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False, **TFM)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, **TFM)
  init = jax_tfm.create_state(jax.random.PRNGKey(0), jcfg, seq_len=TFM_S,
                              tx=optax.sgd(TFM_LR))
  weights = params_from_flax(jax.tree.map(np.asarray, init.params), tcfg)

  def jax_build(mesh):
    def loss_fn(p, tokens):
      return jax_tfm.causal_lm_loss(init.apply_fn({"params": p}, tokens),
                                    tokens)
    return init, loss_fn

  def port_build(device):
    state = tfm.create_state(tcfg, weights, tx=optim.sgd(TFM_LR),
                             device=device)
    return state, lambda model, tokens: tfm.causal_lm_loss(model(tokens),
                                                           tokens)

  out = {}
  for pkg, build in (("jax", jax_build), ("torch", port_build)):
    gs = (jax_groups.GroupSet(build, _tokens, num_groups=2, sync_every=2,
                              sync_timeout=60.0) if pkg == "jax" else
          port_groups.GroupSet(build, _tokens, num_groups=2, sync_every=2,
                               sync_timeout=60.0, device="cpu"))
    try:
      gs.run(4)
      assert gs.wait(timeout=300)
      assert [g.exit_reason for g in gs.groups.values()] == ["completed"] * 2
      assert gs.plane.status()["rounds_completed"] == 2
      losses = [list(g.losses) for g in gs.groups.values()]
      if pkg == "jax":
        tree = jax.tree.map(np.asarray, gs.groups[1].state.params)
      else:
        tree = params_to_flax(gs.groups[1].state.model.numpy_params(), tcfg)
      p0 = PKGS[pkg].G.pack_tree(gs.groups[0].state.params)
      p1 = PKGS[pkg].G.pack_tree(gs.groups[1].state.params)
      assert all(a["data"] == b["data"] for a, b in zip(p0, p1))
      out[pkg] = (losses, tree)
    finally:
      gs.close()
  np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=0,
                             atol=1e-5)
  for (path, a), (_, b) in zip(
      jax.tree_util.tree_leaves_with_path(out["torch"][1]),
      jax.tree_util.tree_leaves_with_path(out["jax"][1])):
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=str(path))


def test_devices_per_group_clamps_to_the_one_device():
  gs = port_groups.GroupSet(nodes.build_linear, nodes.batch_fn, num_groups=1,
                            sync_every=0, devices_per_group=4, device="cpu")
  try:
    assert gs.devices_per_group == 1
    assert gs.groups[0].device == torch.device("cpu")
  finally:
    gs.close()


# -- the chaos grammar --------------------------------------------------------

GROUP_GRAMMAR = [
    ("kill@1#2", [0, 1, 1, 1]),
    ("kill#3,stall#1:0.2", [0, 1, 0, 1]),
    ("stall@0#2:0.5,kill@0#3", [0, 0, 1, 0, 0]),
    ("kill@2", [0, 1, 2, 2]),
    ("kill#1", [None, 3]),
]


@pytest.mark.parametrize("spec,calls", GROUP_GRAMMAR,
                         ids=[s for s, _ in GROUP_GRAMMAR])
def test_group_chaos_verdicts_match_the_reference(spec, calls, monkeypatch):
  monkeypatch.setenv("TOS_CHAOS_GROUP", spec)
  slept = []
  monkeypatch.setattr(time, "sleep", slept.append)
  out = {}
  for pkg in sorted(PKGS):
    del slept[:]
    PKGS[pkg].chaos.reset()
    out[pkg] = ([PKGS[pkg].chaos.group_fault(g) for g in calls], list(slept))
  assert out["torch"] == out["jax"]
  assert "kill" in out["torch"][0]


@pytest.mark.parametrize("spec", ["explode@1#2", "kill:3", "stall@1",
                                  "stall#x:1", "kill@a"])
def test_malformed_group_spec_raises_as_the_reference(spec, monkeypatch):
  monkeypatch.setenv("TOS_CHAOS_GROUP", spec)
  msgs = {}
  for pkg in sorted(PKGS):
    with pytest.raises(ValueError, match="malformed group spec") as e:
      PKGS[pkg].chaos.check_config()
    msgs[pkg] = str(e.value)
    PKGS[pkg].chaos.reset()
    with pytest.raises(ValueError, match="malformed group spec"):
      PKGS[pkg].chaos.group_fault(0)
  assert msgs["torch"] == msgs["jax"]


def test_disarmed_group_fault_is_a_noop(monkeypatch):
  monkeypatch.delenv("TOS_CHAOS_GROUP", raising=False)
  assert port_chaos.group_fault(5) is None
  assert jax_chaos.group_fault(5) is None


# -- the supervisor's resize on a stub ----------------------------------------


def _stub(pkg, server, meta):
  return PKGS[pkg].cluster.ClusterSupervisor(
      engine=None, server=server, node_job=None, cluster_meta=meta,
      cluster_info=[], engine_ids=[0, 1], tf_status={"error": None},
      max_restarts=2)


def _events(sup):
  return [{k: v for k, v in e.items() if k != "t"} for e in sup.events]


def _commit_shrink(pkg):
  server = PKGS[pkg].rdv.Server(2)
  plane = PKGS[pkg].G.attach_sync_plane(server, sync_timeout=5.0)
  plane.join(0)
  plane.join(1)
  sup = _stub(pkg, server, {"group_map": {0: 0, 1: 1}, "elastic": True})
  sup._commit_shrink(1, 1, attempts=2)
  assert 1 in plane.lost and sup.tf_status["error"] is None
  out = [_events(sup), dict(sup.tf_status), sorted(plane.lost)]
  sup._commit_shrink(0, 0, attempts=2)
  assert "all training groups lost" in sup.tf_status["error"]
  return out + [_events(sup), dict(sup.tf_status)]


def _recover_give_up(pkg):
  out = []
  for elastic in (True, False):
    server = PKGS[pkg].rdv.Server(2)
    plane = PKGS[pkg].G.attach_sync_plane(server, sync_timeout=5.0)
    plane.join(0)
    plane.join(1)
    meta = {"group_map": {"0": 0, "1": 1}, "elastic": elastic,
            "cluster_template": {"worker": [0, 1]}}
    sup = _stub(pkg, server, meta)
    sup._attempts[1] = sup.max_restarts        # budget already spent
    sup._recover(1)
    kinds = [e["kind"] for e in sup.events]
    if elastic:
      assert "resize-shrink" in kinds and "gave-up" not in kinds
      assert sup.tf_status["error"] is None
    else:
      assert "gave-up" in kinds and "resize-shrink" not in kinds
      assert "restart budget" in sup.tf_status["error"]
    out.append([_events(sup), dict(sup.tf_status), sorted(plane.lost)])
  return out


def _readmit(pkg):
  server = PKGS[pkg].rdv.Server(2, heartbeat_interval=0.1)
  PKGS[pkg].G.attach_sync_plane(server, sync_timeout=5.0)
  sup = _stub(pkg, server, {"group_map": {0: 0, 1: 1}, "elastic": True})
  sup._given_up.add(1)
  sup._attempts[1] = 2
  server.liveness.beat(1)
  assert 1 in server.liveness._confirmed
  sup.readmit(1)
  assert 1 not in sup._given_up and 1 not in sup._attempts
  assert 1 not in server.liveness._confirmed
  return [_events(sup), sup._group_of(1), sup._group_of(5)]


RESIZE_CASES = {f.__name__.strip("_"): f for f in (
    _commit_shrink, _recover_give_up, _readmit)}


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_supervisor_resize_matches_the_reference(case):
  assert RESIZE_CASES[case]("torch") == RESIZE_CASES[case]("jax")


# -- one elastic cluster.run of the port ---------------------------------------


def test_port_elastic_cluster_run_shrinks_past_a_killed_executor(
    tmp_path, monkeypatch):
  """``cluster.run(LocalEngine(2), ..., group_map={0: 0, 1: 1},
  elastic=True, max_restarts=0)``: executor 1 is SIGKILLed before its 3rd
  step; the supervisor commits the shrink (``resize-shrink``, group 1),
  executor 0 finishes every round after the first with denominator 1, and
  ``shutdown()`` does not raise."""
  from tensorflowonspark_tpu_torch.engine import LocalEngine
  monkeypatch.setenv("TOS_GROUP_SYNC_TIMEOUT", "20")
  out = str(tmp_path / "rec_%d.json")
  engine = LocalEngine(num_executors=2, env={
      "TOS_CHAOS_KILL": "group-step@1#3",
      "PYTHONPATH": os.pathsep.join(
          [os.path.dirname(os.path.abspath(__file__)),
           os.environ.get("PYTHONPATH", "")])})
  try:
    c = port_cluster.run(
        engine, nodes.elastic_main,
        {"group_map": {0: 0, 1: 1}, "steps": 8, "sync_every": 2,
         "sync_timeout": 60.0, "out": out},
        input_mode=port_cluster.InputMode.TENSORFLOW,
        group_map={0: 0, 1: 1}, elastic=True, max_restarts=0,
        heartbeat_interval=0.25, reservation_timeout=120)
    plane = c.server.sync_plane
    assert c.cluster_meta["group_map"] == {0: 0, 1: 1}
    assert c.cluster_meta["elastic"] is True
    c.shutdown(timeout=180)
    sup = c.supervisor
    shrink = [e for e in sup.events if e["kind"] == "resize-shrink"]
    assert len(shrink) == 1 and shrink[0]["group"] == 1
    assert shrink[0]["executor_id"] == 1 and shrink[0]["groups_active"] == 1
    with open(out % 0) as f:
      rec = json.load(f)
    assert rec["denominators"] == [2, 1, 1, 1]
    assert len(rec["losses"]) == 8 and rec["losses"][-1] < rec["losses"][0]
    assert not os.path.exists(out % 1)
    assert 1 in plane.lost and plane.status()["rounds_completed"] == 4
  finally:
    engine.stop()
