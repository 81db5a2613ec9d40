"""The port's mesh and collectives against the JAX package's, on the CPU.

- ``build_mesh``: the same degrees and the same error messages as the
  reference's over 1, 2, 4 and 8 devices (the reference on
  ``jax.devices()[:n]``, the port over a stand-in group of n processes),
  pipeline and expert axes included, with each axis's ranks where the
  reference lays its devices.
- The collectives: in 2 gloo processes, ``psum_mean``, ``all_reduce``,
  ``all_gather``, ``reduce_scatter``, ``broadcast_from`` and
  ``global_norm`` equal the reference's inside ``shard_map`` over 2 CPU
  devices on the same per-shard inputs (f32; 1e-6 relative: a sum of two
  terms, in either order). ``sync_gradients``' buckets (a bucket size that
  splits a tensor's neighbours, mixed dtypes) and its counter.
- The train step's refusals, and ``shard_batch``'s blocks over the data
  axes and ``sequence``. The mesh axes' collectives, ring attention and
  the sharded train step against the JAX package are in
  ``tests/test_torch_spmd.py`` and ``tests/test_torch_ring.py``.
"""

import json
import multiprocessing as mp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tensorflowonspark_tpu.parallel import collectives as jax_coll
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu_torch.parallel import collectives
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.parallel import sharding
from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port

RTOL = 1e-6


class _Group(object):
  """A stand-in process group of ``n`` ranks."""

  def __init__(self, n, rank=0):
    self.n, self.r = n, rank

  def size(self):
    return self.n

  def rank(self):
    return self.r


# -- build_mesh ------------------------------------------------------------------

SPECS = [mesh_lib.MeshSpec(), mesh_lib.MeshSpec(data=1),
         mesh_lib.MeshSpec(data=2), mesh_lib.MeshSpec(data=3),
         mesh_lib.MeshSpec(data=8), mesh_lib.MeshSpec(data=-1, fsdp=2),
         mesh_lib.MeshSpec(data=1, fsdp=-1),
         mesh_lib.MeshSpec(data=-1, tensor=-1),
         mesh_lib.MeshSpec(data=-1, sequence=3),
         mesh_lib.MeshSpec(data=2, tensor=2),
         mesh_lib.MeshSpec(data=-1, pipeline=1, expert=1),
         mesh_lib.MeshSpec(data=-1, pipeline=2),
         mesh_lib.MeshSpec(data=2, expert=-1),
         mesh_lib.MeshSpec(data=1, pipeline=2, expert=2)]


def _ref_spec(spec):
  return jax_mesh.MeshSpec(**{a: getattr(spec, a) for a in (
      "data", "fsdp", "pipeline", "expert", "sequence", "tensor")})


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_build_mesh_matches_the_reference(spec, n):
  try:
    ref = jax_mesh.build_mesh(_ref_spec(spec), devices=jax.devices()[:n])
  except ValueError as e:
    with pytest.raises(ValueError) as got:
      mesh_lib.build_mesh(spec, group=_Group(n))
    assert str(got.value) == str(e)
    return
  shape = dict(ref.shape)
  mesh = mesh_lib.build_mesh(spec, group=_Group(n, rank=n - 1))
  assert dict(mesh.shape) == shape
  assert mesh.axis_names == tuple(ref.axis_names)
  assert mesh.rank == n - 1 and mesh.size == n
  assert mesh_lib.data_axes(mesh) == jax_mesh.data_axes(ref)
  for axes in (("data",), ("data", "fsdp"), ("tensor", "sequence"),
               ("pipeline",), ("expert",)):
    assert mesh_lib.axis_size(mesh, *axes) == jax_mesh.axis_size(ref, *axes)
  # the ranks of each axis's group are the devices the reference lays
  # along that axis through this rank's device (the CPU devices' ids
  # follow their order)
  ids = np.vectorize(lambda d: d.id)(ref.devices)
  at = [int(i) for i in np.argwhere(ids == n - 1)[0]]
  for k, axis in enumerate(ref.axis_names):
    line = list(at)
    line[k] = slice(None)
    want = [int(i) for i in ids[tuple(line)]]
    assert mesh.ranks(axis) == want, axis


def test_mesh_outside_a_group_is_one_process():
  mesh = mesh_lib.build_mesh()
  assert dict(mesh.shape)["data"] == 1 and mesh.rank == 0
  assert mesh.group("data") is None and mesh.group("tensor") is None
  # no group: every collective is the local value
  x = torch.arange(6.0).reshape(2, 3)
  for fn in (collectives.psum_mean, collectives.all_reduce,
             collectives.broadcast_from, collectives.reduce_scatter):
    assert torch.equal(fn(x, mesh), x)
  assert collectives.all_gather(x, mesh, tiled=False).shape == (1, 2, 3)
  grads = {"a": x}
  assert collectives.sync_gradients(grads, mesh) is grads
  assert collectives.all_processes_agree(False) is False
  with pytest.raises(KeyError, match="no axis"):
    mesh.group("model")


# -- the collectives in 2 gloo processes ---------------------------------------------

ROWS, COLS = 4, 6


def _global_input():
  return np.random.default_rng(11).standard_normal(
      (2 * ROWS, COLS)).astype(np.float32)


def _grad_tree():
  """Gradients of mixed dtypes: f32 neighbours of 400 and 256 bytes
  around a bf16 tensor, and an f64 one."""
  rng = np.random.default_rng(12)
  return {"w0": rng.standard_normal(100).astype(np.float32),
          "w1": rng.standard_normal((8, 8)).astype(np.float32),
          "h": rng.standard_normal(30).astype(np.float32),
          "b": rng.standard_normal(16).astype(np.float32),
          "d": rng.standard_normal(5).astype(np.float64)}


def _collective_rank(rank, port, out):
  import torch.distributed as dist
  torch.set_num_threads(1)
  dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                          rank=rank, world_size=2)
  try:
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=-1))
    x = torch.from_numpy(_global_input()[rank * ROWS:(rank + 1) * ROWS])
    res = {"psum_mean": collectives.psum_mean(x, mesh),
           "all_reduce": collectives.all_reduce(x, mesh),
           "all_gather_tiled": collectives.all_gather(x, mesh),
           "all_gather_stacked": collectives.all_gather(x, mesh, axis=1,
                                                        tiled=False),
           "reduce_scatter_0": collectives.reduce_scatter(x, mesh),
           "reduce_scatter_1": collectives.reduce_scatter(x, mesh, axis=1),
           "broadcast_0": collectives.broadcast_from(x, mesh),
           "broadcast_1": collectives.broadcast_from(x, mesh, src_index=1),
           "global_norm": collectives.global_norm({"x": x, "y": [2 * x]},
                                                  mesh, ("data",))}
    clipped, norm = collectives.clip_by_global_norm([x], 1.0, mesh, "data")
    res["clipped"] = clipped[0]
    assert torch.equal(x, torch.from_numpy(
        _global_input()[rank * ROWS:(rank + 1) * ROWS]))   # functional
    # gradient buckets: 300-byte buckets split w0 and w1 apart; bf16 and
    # f64 take buckets of their own
    grads = {k: torch.from_numpy(v * (rank + 1)) for k, v in
             _grad_tree().items()}
    grads["h"] = grads["h"].to(torch.bfloat16)
    collectives.reset_counts()
    synced = collectives.sync_gradients(dict(grads), mesh, bucket_bytes=300)
    counts = dict(collectives.COUNTS)
    summed = collectives.sync_gradients(list(grads.values()), mesh,
                                        mean=False, bucket_bytes=1 << 20)
    out_arrays = {k: v.float().numpy() for k, v in res.items()}
    out_arrays.update({"sync_" + k: v.float().numpy()
                       for k, v in synced.items()})
    out_arrays.update({"sum_%d" % i: v.float().numpy()
                       for i, v in enumerate(summed)})
    np.savez(out % rank, **out_arrays)
    with open((out % rank) + ".json", "w") as f:
      json.dump({"counts": counts, "norm": float(norm),
                 "agree_mixed": collectives.all_processes_agree(rank == 0),
                 "agree_all": collectives.all_processes_agree(True),
                 "keys": list(synced), "dtypes": {
                     k: str(v.dtype) for k, v in synced.items()}}, f)
  finally:
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
  out = str(tmp_path_factory.mktemp("coll") / "rank%d.npz")
  ctx = mp.get_context("spawn")
  port = get_free_port()
  procs = [ctx.Process(target=_collective_rank, args=(r, port, out))
           for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(timeout=120)
  assert [p.exitcode for p in procs] == [0, 0]
  got = []
  for r in range(2):
    with open((out % r) + ".json") as f:
      meta = json.load(f)
    got.append((dict(np.load(out % r)), meta))
  return got


def _ref_mesh():
  return jax_mesh.build_mesh(jax_mesh.MeshSpec(data=2),
                             devices=jax.devices()[:2])


def _per_shard(fn, out_spec=P("data")):
  """``fn`` over 2 shards of the global input inside the reference's
  ``shard_map``; the per-shard outputs, split back per rank."""
  mesh = _ref_mesh()
  run = jax_coll.shard_map_fn(fn, mesh, in_specs=(P("data"),),
                              out_specs=out_spec)
  out = np.asarray(jax.jit(run)(jnp.asarray(_global_input())))
  return np.split(out, 2, axis=0)


REFERENCE = {
    "psum_mean": lambda x: jax_coll.psum_mean(x, "data"),
    "all_reduce": lambda x: jax_coll.all_reduce(x, "data"),
    "all_gather_tiled": lambda x: jax_coll.all_gather(x, "data"),
    "all_gather_stacked": lambda x: jax_coll.all_gather(x, "data", axis=1,
                                                        tiled=False),
    "reduce_scatter_0": lambda x: jax_coll.reduce_scatter(x, "data"),
    "reduce_scatter_1": lambda x: jax_coll.reduce_scatter(x, "data", axis=1),
    "broadcast_0": lambda x: jax_coll.broadcast_from(x, "data"),
    "broadcast_1": lambda x: jax_coll.broadcast_from(x, "data", 1),
    "global_norm": lambda x: jnp.reshape(jax_coll.global_norm(
        {"x": x, "y": [2 * x]}, ("data",)), (1,)),
    "clipped": lambda x: jax_coll.clip_by_global_norm([x], 1.0,
                                                      ("data",))[0][0],
}


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_collective_matches_shard_map(two_ranks, name):
  want = _per_shard(REFERENCE[name])
  for rank, (arrays, _) in enumerate(two_ranks):
    got = arrays[name]
    np.testing.assert_allclose(got.reshape(want[rank].shape), want[rank],
                               rtol=RTOL, atol=1e-6,
                               err_msg="%s rank %d" % (name, rank))


def test_sync_gradients_buckets_and_counts(two_ranks):
  tree = _grad_tree()
  names = list(tree)
  shapes = [tree[k] for k in names]
  tensors = [torch.from_numpy(v) for v in shapes]
  tensors[names.index("h")] = tensors[names.index("h")].to(torch.bfloat16)
  buckets = collectives._buckets(tensors, 300)
  # reverse parameter order, one dtype each, w0 (400 B) alone
  assert buckets == [[4], [3], [2], [1], [0]], buckets
  assert collectives._buckets(tensors, 1 << 20) == [[4], [3], [2], [1, 0]]
  for rank, (arrays, meta) in enumerate(two_ranks):
    assert meta["keys"] == names
    assert meta["counts"]["sync_gradients"] == 1
    assert meta["counts"]["buckets"] == 5
    assert meta["counts"]["all_reduce"] == 5
    assert meta["counts"]["bucket_bytes"] == sum(
        t.numel() * t.element_size() for t in tensors)
    assert meta["dtypes"]["h"] == "torch.bfloat16"
    for i, k in enumerate(names):
      want = tree[k] * 1.5                 # mean of x and 2x
      tol = 1e-2 if k == "h" else RTOL
      np.testing.assert_allclose(arrays["sync_" + k], want, rtol=tol,
                                 atol=tol, err_msg=k)
      np.testing.assert_allclose(arrays["sum_%d" % i], tree[k] * 3,
                                 rtol=tol, atol=tol, err_msg=k)
    # every replicated result holds the same bits on both ranks
    for k in arrays:
      if not k.startswith(("reduce_scatter", "clipped")):
        assert np.array_equal(arrays[k], two_ranks[0][0][k]), k


def test_all_processes_agree_votes_across_ranks(two_ranks):
  for _, meta in two_ranks:
    assert meta["agree_mixed"] is False and meta["agree_all"] is True


# -- refusals -------------------------------------------------------------------------


def _mesh(**degrees):
  shape = dict({a: 1 for a in mesh_lib.CANONICAL_ORDER}, **degrees)
  return mesh_lib.Mesh(mesh_lib.CANONICAL_ORDER, shape, 0, _Group(2))


@pytest.mark.parametrize("axis", ["pipeline", "expert"])
def test_train_step_takes_the_pipeline_and_expert_axes(axis):
  """The step runs over a mesh with a pipeline or expert axis: nothing is
  cut over pipeline, and expert cuts the stacked experts' first
  dimension (the logical rule ``expert``), where it divides."""
  mesh = _mesh(**{axis: 2})
  assert sharding.make_train_step(lambda m, b: b, mesh) is not None
  assert sharding.make_train_loop(lambda m, b: b, mesh, unroll=2).unroll == 2
  want = ("expert" if axis == "expert" else None, None, None)
  assert sharding.logical_to_mesh(("expert", "embed", "mlp"), (4, 8, 16),
                                  mesh) == want
  assert sharding.logical_to_mesh(("expert", "embed", "mlp"), (3, 8, 16),
                                  mesh) == (None, None, None)
  assert sharding.shard_batch(np.arange(8).reshape(4, 2), mesh).shape == \
      (4, 2)


def test_shard_batch_takes_this_ranks_rows():
  from tensorflowonspark_tpu_torch.data.readers import Slab
  batch = np.arange(8 * 3).reshape(8, 3)
  for rank in range(2):
    mesh = mesh_lib.Mesh(mesh_lib.CANONICAL_ORDER,
                         dict({a: 1 for a in mesh_lib.CANONICAL_ORDER},
                              data=2), rank, _Group(2, rank))
    got = sharding.shard_batch({"t": batch, "u": (batch, batch)}, mesh)
    assert np.array_equal(got["t"], batch[rank * 4:(rank + 1) * 4])
    assert np.array_equal(got["u"][1], batch[rank * 4:(rank + 1) * 4])
    slab = np.stack([batch, batch + 100])
    got = sharding.shard_slab(Slab(slab), mesh)
    assert isinstance(got, Slab)
    assert np.array_equal(got.data, slab[:, rank * 4:(rank + 1) * 4])
  with pytest.raises(ValueError, match="7 rows does not divide"):
    sharding.shard_batch(np.zeros((7, 3)), _mesh(data=2))
  with pytest.raises(ValueError, match="3 rows does not divide"):
    sharding.shard_slab(np.zeros((2, 3, 4)), _mesh(data=2))
  # sequence: rank r of (data 2 x sequence 2) keeps rows r // 2 and
  # positions r % 2
  seq = np.arange(4 * 6).reshape(4, 6)
  for rank in range(4):
    mesh = mesh_lib.Mesh(mesh_lib.CANONICAL_ORDER, dict(
        {a: 1 for a in mesh_lib.CANONICAL_ORDER}, data=2, sequence=2), rank,
        _Group(4, rank))
    r, c = rank // 2, rank % 2
    got = sharding.shard_batch(seq, mesh, extra_axes=("sequence",))
    assert np.array_equal(got, seq[2 * r:2 * r + 2, 3 * c:3 * c + 3])
    got = sharding.shard_slab(np.stack([seq, -seq]), mesh, ("sequence",))
    assert np.array_equal(got[1], -seq[2 * r:2 * r + 2, 3 * c:3 * c + 3])
  with pytest.raises(ValueError, match="5 positions does not divide"):
    sharding.shard_batch(np.zeros((2, 5)), _mesh(sequence=2),
                         extra_axes=("sequence",))
