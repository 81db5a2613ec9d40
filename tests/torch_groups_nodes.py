"""What each executor of ``tests/test_torch_groups.py``'s elastic
``cluster.run`` runs, and the linear harness both packages' group tests
share.

A helper, not a test file: it imports PyTorch and the port only, so an
executor starts without loading JAX.
"""

import json
import time

import numpy as np
import torch

DIM, BATCH, LR = 8, 4, 0.05


def batch_fn(group_id, step, dim=DIM, batch=BATCH):
  """Deterministic data keyed by (group_id, step): the GroupSet's
  data-position contract (the reference test's harness)."""
  w_true = np.arange(dim, dtype="float32") / dim
  rng = np.random.RandomState(1000 * group_id + step)
  x = rng.rand(batch, dim).astype("float32")
  return {"x": x, "y": x @ w_true}


class Linear(torch.nn.Module):
  def __init__(self, dim=DIM):
    super().__init__()
    self.w = torch.nn.Parameter(torch.zeros(dim))


def linear_loss(model, b):
  return torch.mean((b["x"] @ model.w - b["y"]) ** 2)


def build_linear(device, dim=DIM, lr=LR):
  """The port's ``build_fn``: zero weights, SGD."""
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.train_state import TrainState
  return (TrainState.create(Linear(dim).to(device), optim.sgd(lr)),
          linear_loss)


def elastic_main(args, ctx):
  """One executor of an elastic group set: train the linear harness on
  the CPU as group ``args["group_map"][executor_id]``, syncing through
  the driver's plane every ``sync_every`` steps, with a ``kill_point``
  ("group-step") before each step; the record to ``args["out"] %
  executor_id``."""
  from tensorflowonspark_tpu_torch.parallel import groups as G
  from tensorflowonspark_tpu_torch.parallel import sharding
  from tensorflowonspark_tpu_torch.utils import chaos
  gid = int(args["group_map"][ctx.executor_id])
  state, loss_fn = build_linear("cpu")
  loop = sharding.make_train_loop(loss_fn, None, donate_state=False)
  client = G.GroupSyncClient(ctx.server_addr, gid, request_timeout=10.0)
  client.join()
  # a round's members are frozen when it opens: wait for the group set
  # to assemble, or the first member would merge its first round alone
  deadline = time.monotonic() + 60.0
  while client.state()["groups_active"] < len(args["group_map"]):
    if time.monotonic() > deadline:
      raise TimeoutError("the group set did not assemble within 60 s")
    time.sleep(0.02)
  every = args["sync_every"]
  rec = {"group": gid, "losses": [], "denominators": []}
  try:
    for step in range(args["steps"]):
      chaos.kill_point("group-step", ctx.executor_id)
      state, losses = loop(state, batch_fn(gid, step))
      rec["losses"].extend(losses.reshape(-1).tolist())
      if (step + 1) % every == 0:
        _, members = client.sync((step + 1) // every, state.params,
                                 weight=every, step=step + 1,
                                 timeout=args["sync_timeout"])
        rec["denominators"].append(len(members))
  finally:
    client.close()
  rec["w"] = state.params["w"].detach().tolist()
  with open(args["out"] % ctx.executor_id, "w") as f:
    json.dump(rec, f)
