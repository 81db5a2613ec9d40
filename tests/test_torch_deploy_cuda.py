"""The registry, the deploy controller and cross-host serving on the card.

Marked ``cuda``: each test skips without a CUDA card (decided inside a
fixture). The file imports only PyTorch and the port, so it runs on the
card's machine: ``python -m pytest tests/test_torch_deploy_cuda.py -m cuda``.

- two ServingHost processes build a small bf16 model on the card from a
  registry; a fleet over them serves every request to the bare engine's
  bit, then a ``DeploymentController`` canaries and promotes v2 with 4/4
  parity against a bare engine on v2 and nothing shed;
- a fresh pair with ``TOS_CHAOS_HOST=decode@1#3:kill`` in host 1's env:
  host 1 dies by SIGKILL mid-decode, its replica is ejected and its
  requests replay on host 0 to the bit, nothing shed.
"""

import contextlib

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.control import rendezvous
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.serving import (
    DeploymentController, ModelRegistry, ServingEngine, ServingFleet,
    cfg_wire, remote, start_host_process)
from tensorflowonspark_tpu_torch.serving import fleet as fleet_mod
from tensorflowonspark_tpu_torch.utils import chaos
from tensorflowonspark_tpu_torch.utils.params import init_params

CFG = dict(vocab_size=256, num_layers=2, num_heads=4, d_model=128,
           d_ff=256, max_seq_len=256)
NEW = 16
OPTS = {"num_slots": 4, "horizon": 4, "max_new_tokens": NEW}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the hosts serve on it")
  cfg = tfm.TransformerConfig(**CFG)
  rng = np.random.default_rng(4)
  prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
             for n in rng.integers(5, 200, size=10)]
  root = str(tmp_path_factory.mktemp("registry"))
  reg = ModelRegistry(root)
  extra = {"model_cfg": cfg_wire(cfg), "serve_opts": OPTS}
  v1 = reg.publish(init_params(cfg, seed=3), step=1, extra=extra)
  v2 = reg.publish(init_params(cfg, seed=5), step=2, extra=extra)
  bare = {}
  for v in (v1, v2):
    params, _ = reg.get(v)
    with ServingEngine(params, cfg, **OPTS) as eng:
      bare[v] = [o.tolist() for o in eng.generate(prompts, timeout=300)]
  return cfg, reg, prompts, bare, (v1, v2)


@contextlib.contextmanager
def _hosts(root, env_by_host=None):
  server = rendezvous.Server(1)
  addr = server.start()
  plane = remote.attach_serving_plane(server)
  procs = [start_host_process(addr, hid, registry_root=root,
                              env=(env_by_host or {}).get(hid))
           for hid in range(2)]
  try:
    plane.await_hosts(2, timeout=300)
    yield addr, plane, procs
  finally:
    for hid in plane.host_ids():
      plane.enqueue(hid, {"op": "exit"})
    for p in procs:
      p.join(timeout=60)
      if p.is_alive():
        p.terminate()
    server.stop()


@pytest.fixture()
def no_chaos(monkeypatch):
  for name in (chaos.ENV_HOST, chaos.ENV_DEPLOY):
    monkeypatch.delenv(name, raising=False)
  chaos.reset()
  yield monkeypatch
  chaos.reset()


@pytest.mark.cuda
def test_two_hosts_serve_and_promote_to_the_bit(setup, no_chaos):
  cfg, reg, prompts, bare, (v1, v2) = setup
  engines = {}

  def reference_decode(params, prompt, budget):
    if id(params) not in engines:
      engines[id(params)] = (params,
                             ServingEngine(params, cfg, **OPTS).start())
    return engines[id(params)][1].generate([prompt], max_new_tokens=budget,
                                           timeout=300)[0]

  with _hosts(reg.root) as (addr, plane, _):
    fl = ServingFleet(remote.remote_engine_factory(plane, version=v1),
                      num_replicas=2,
                      health_probe=remote.wire_health_probe(addr)).start()
    try:
      for rid in fl.replica_states():
        fl.set_replica_version(rid, v1)
      outs = fl.generate(prompts, timeout=300)
      assert [o.tolist() for o in outs] == bare[v1]
      assert all(r.dispatches for r in fl._replicas.values())
      ctl = DeploymentController(
          fl, reg, lambda p, m: remote.remote_engine_factory(
              plane, version=m["version"]),
          reference_decode, [(p, NEW) for p in prompts[:4]],
          baseline_version=v1, traffic_slice=0.5, bake_seconds=0.0,
          spot_checks=4, swap_timeout=300.0)
      verdict = ctl.deploy(v2)
      assert verdict["ok"] and verdict["promoted"]
      assert verdict["parity"] == {"checked": 4, "mismatches": 0}
      outs = fl.generate(prompts, timeout=300)
      assert [o.tolist() for o in outs] == bare[v2]
      assert fl.served_versions() == {0: v2, 1: v2}
      assert fl.stats["shed"] == 0
    finally:
      fl.stop()
      for _, eng in engines.values():
        eng.stop()


@pytest.mark.cuda
def test_a_killed_host_fails_over_to_the_bit(setup, no_chaos):
  cfg, reg, prompts, bare, (v1, _) = setup
  env = {1: {chaos.ENV_HOST: "decode@1#3:kill"}}
  with _hosts(reg.root, env) as (addr, plane, procs):
    fl = ServingFleet(remote.remote_engine_factory(plane, version=v1),
                      num_replicas=2, poll_interval=0.02,
                      health_probe=remote.wire_health_probe(addr)).start()
    try:
      outs = fl.generate(prompts, timeout=300)
      states = fl.replica_states()
    finally:
      fl.stop()
    procs[1].join(timeout=60)
    assert procs[1].exitcode == -9
  assert [o.tolist() for o in outs] == bare[v1]
  assert states[1] == fleet_mod.EJECTED
  assert fl.stats["failovers"] >= 1 and fl.stats["shed"] == 0
  assert fl.stats["replay_mismatches"] == 0
