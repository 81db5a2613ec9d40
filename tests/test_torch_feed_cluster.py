"""The slice on the CPU: the flagship trained and served through
``cluster.run(LocalEngine(1), ..., input_mode=InputMode.SPARK)``.

- ``c.train(parts)`` feeds a 2-layer, d_model-64 flagship in an executor
  over the shm ring (the per-step path, then slabs of ``unroll=2``); its
  losses equal to the bit those of the same steps in-process on the same
  rows (``tests/test_torch_train.py`` holds the port's step to the JAX
  step);
- ``c.inference(parts)`` over the hub queue returns one result per row, in
  partition order, equal to the in-process forward;
- (slow) a node killed after rows reached its hub but before it consumed
  them: the supervisor drains the dead hub, relaunches the node and
  requeues the rows, and the fed sum is conserved.

Main fns are module-level: the port sends them by pickle, by name.
"""

import itertools
import json
import os
import signal
import time

import numpy as np
import pytest

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.cluster import InputMode
from tensorflowonspark_tpu_torch.engine import LocalEngine

SEQ, VOCAB, BATCH, UNROLL = 32, 64, 2, 2
PER_STEP = 2        # per-step batches before the slabs


def _cfg():
  import torch
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  return tfm.TransformerConfig(vocab_size=VOCAB, num_layers=2, num_heads=4,
                               d_model=64, d_ff=128, max_seq_len=SEQ,
                               dtype=torch.float32)


def _rows(n, seed):
  rng = np.random.default_rng(seed)
  return [rng.integers(0, VOCAB, SEQ).astype(np.int32) for _ in range(n)]


def _train_pieces():
  import torch
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import sharding
  torch.set_num_threads(1)
  state = tfm.create_state(_cfg(), 0, device="cpu", tx=optim.make_optimizer(
      learning_rate=1e-3, clip_norm=1.0))

  def loss_fn(model, tokens):
    return tfm.causal_lm_loss(model(tokens), tokens)

  return (state, sharding.make_train_step(loss_fn),
          sharding.make_train_loop(loss_fn, unroll=UNROLL))


def _per_row(model, tokens):
  """(mean next-token loss, last-position argmax) per row."""
  import torch
  import torch.nn.functional as F
  with torch.no_grad():
    logits = model(torch.as_tensor(np.asarray(tokens)))
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, VOCAB),
                         torch.as_tensor(np.asarray(tokens))[:, 1:]
                         .reshape(-1).long(), reduction="none")
    loss = ce.reshape(len(tokens), -1).mean(1)
    top = logits[:, -1].argmax(-1)
  return [(float(a), int(b)) for a, b in zip(loss, top)]


def _model():
  import torch
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.utils.params import init_params
  torch.set_num_threads(1)
  return tfm.Transformer(_cfg(), init_params(_cfg(), seed=0), device="cpu")


# -- main fns -----------------------------------------------------------------

def _train_main(out, ctx):
  from tensorflowonspark_tpu_torch.data import readers
  state, step, loop = _train_pieces()
  feed = ctx.get_data_feed()
  losses = []
  for batch in readers.device_prefetch(
      itertools.islice(readers.feed_batches(feed, BATCH), PER_STEP),
      device="cpu"):
    state, loss = step(state, batch)
    losses.append(float(loss))
  for item in readers.slab_batches(feed, BATCH, unroll=UNROLL):
    state, got = loop(state, item)
    losses += [float(x) for x in got]
  with open(out, "w") as f:
    json.dump({"losses": losses, "stats": feed.stats,
               "channels": feed.channel_chunks()}, f)


def _infer_main(args, ctx):
  model = _model()
  feed = ctx.get_data_feed(train_mode=False)
  while not feed.should_stop():
    batch = feed.next_batch_arrays(4)
    if len(batch):
      feed.batch_results(_per_row(model, batch))


@pytest.fixture(scope="module")
def engine():
  e = LocalEngine(num_executors=1)
  yield e
  e.stop()


def test_train_through_the_feed_matches_in_process(engine, tmp_path):
  rows = _rows(12, seed=1)
  parts = [rows[i:i + 4] for i in range(0, 12, 4)]
  out = str(tmp_path / "losses.json")
  c = cluster.run(engine, _train_main, out, input_mode=InputMode.SPARK,
                  max_restarts=0, reservation_timeout=60)
  assert c.cluster_meta["feed_transport"] == "shm"
  c.train(parts, num_epochs=1)
  c.shutdown(timeout=300)
  assert c.supervisor.restarts == {}
  with open(out) as f:
    got = json.load(f)

  from tensorflowonspark_tpu_torch.data.readers import Slab
  import torch
  threads = torch.get_num_threads()
  try:
    state, step, loop = _train_pieces()
    want = []
    for i in range(PER_STEP):
      state, loss = step(state, np.stack(rows[i * BATCH:(i + 1) * BATCH]))
      want.append(float(loss))
    rest = np.stack(rows[PER_STEP * BATCH:])
    for k in range(0, len(rest), BATCH * UNROLL):
      state, losses = loop(state, Slab(rest[k:k + BATCH * UNROLL].reshape(
          UNROLL, BATCH, SEQ)))
      want += [float(x) for x in losses]
  finally:
    torch.set_num_threads(threads)
  assert len(want) == 6 and all(np.isfinite(want))
  assert got["losses"] == want                       # to the bit
  assert got["stats"]["columnar_chunks"] == got["stats"]["chunks"] == 3
  assert got["channels"]["ring"] >= 4 and got["channels"]["queue"] == 0


def test_inference_through_the_feed_matches_in_process(engine):
  rows = _rows(10, seed=2)
  parts = [rows[:4], rows[4:7], rows[7:]]
  c = cluster.run(engine, _infer_main, None, input_mode=InputMode.SPARK,
                  feed_transport="queue", max_restarts=0,
                  reservation_timeout=60)
  got = c.inference(parts)
  c.shutdown(timeout=300)
  import torch
  threads = torch.get_num_threads()
  try:
    model = _model()
    want = [r for p in parts for r in _per_row(model, p)]
  finally:
    torch.set_num_threads(threads)
  assert [tuple(r) for r in got] == want


# -- the supervisor's requeue (slow) ------------------------------------------

def _die_before_consuming(args, ctx):
  """First launch of executor 0: wait until rows reached this node's hub,
  then die without consuming them; every other node sums what it gets.
  Each first launch reports itself ready in its executor's directory."""
  feed = ctx.get_data_feed(train_mode=True)
  if not ctx.is_restart:
    with open("ready_%d.txt" % ctx.executor_id, "w") as f:
      f.write("ready")
  if ctx.executor_id == 0 and not ctx.is_restart:
    deadline = time.time() + 120
    while ctx.hub.get_queue("input").qsize() == 0 and time.time() < deadline:
      time.sleep(0.05)
    with open("victim_saw.txt", "w") as f:
      f.write(str(ctx.hub.get_queue("input").qsize()))
    os.kill(os.getpid(), signal.SIGKILL)
  total = 0
  while not feed.should_stop():
    for x in feed.next_batch(32):
      total += x
  with open("consumed_%d.txt" % os.getpid(), "w") as f:
    f.write(str(total))


@pytest.mark.slow
def test_kill_before_consume_requeues_the_rows(tmp_path):
  """The port's ``tests/test_chaos.py:416``: the supervisor drains the dead
  hub (unblocking its feeder), relaunches the node, and requeues the
  rescued rows; no row is lost. The hub queue transport: rows already on
  a ring are not rescued (at-most-once). Slow: it waits out a relaunch."""
  engine = LocalEngine(num_executors=2, workdir=str(tmp_path))
  try:
    c = cluster.run(engine, _die_before_consuming, None,
                    input_mode=InputMode.SPARK, feed_transport="queue",
                    heartbeat_interval=2.0, max_restarts=3,
                    restart_backoff=0.2, restart_backoff_cap=1.0,
                    reservation_timeout=60)
    # feed only once both nodes run their fn: a node still starting would
    # leave both partitions to the other, and the end of feed from
    # shutdown() would be all executor 0 ever saw
    for slot in range(2):
      ready = os.path.join(engine.executor_workdir(slot),
                           "ready_%d.txt" % slot)
      deadline = time.time() + 120
      while not os.path.exists(ready) and time.time() < deadline:
        time.sleep(0.05)
      assert os.path.exists(ready), "node %d never started its fn" % slot
    parts = [list(range(0, 40)), list(range(40, 80))]
    c.train(parts, num_epochs=1, feed_timeout=180)
    assert c.supervisor.wait_idle(timeout=120), "recovery never settled"
    c.shutdown(timeout=300)
    total = 0
    for slot in range(2):
      wd = engine.executor_workdir(slot)
      for name in os.listdir(wd):
        if name.startswith("consumed_"):
          with open(os.path.join(wd, name)) as f:
            total += int(f.read())
    assert total == sum(range(80))
    assert c.supervisor.restarts.get(0) == 1, c.supervisor.restarts
    # executor 0 died holding a whole partition: the requeue carried it
    with open(os.path.join(engine.executor_workdir(0), "victim_saw.txt")) as f:
      assert f.read() == "40"
  finally:
    engine.stop()
