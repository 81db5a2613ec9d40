"""The PyTorch port imports nothing of JAX, flax, optax or the JAX package,
and its runtime nothing beyond the standard library, numpy and torch (no
msgpack, no cloudpickle)."""

import ast
import os
import subprocess
import sys
import textwrap

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PORT = os.path.join(ROOT, "tensorflowonspark_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "tensorflowonspark_tpu", "msgpack", "cloudpickle")


def _imported_roots(path):
  with open(path) as f:
    tree = ast.parse(f.read(), path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name.split(".")[0]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module.split(".")[0]


def test_port_sources_import_no_jax():
  files = [os.path.join(d, f) for d, _, fs in os.walk(PORT)
           for f in fs if f.endswith(".py")]
  assert len(files) >= 10
  scanned = {os.path.relpath(p, PORT) for p in files}
  # the data feed and the entry points are scanned with the rest
  for name in ("fs", "tfrecord", "example_codec", "schema", "dfutil",
               "readers"):
    assert os.path.join("data", name + ".py") in scanned, name
  assert os.path.join("examples", "train_gpt.py") in scanned
  # and so is the cluster runtime
  for name in ("cluster.py", "node.py", "datafeed.py", "control/_msgpack.py",
               "control/chunkcodec.py", "control/feedhub.py",
               "control/marker.py", "control/rendezvous.py",
               "control/shmring.py",
               "engine/base.py", "engine/local.py", "obs/metrics.py",
               "obs/quantiles.py", "obs/spans.py", "utils/gpu_info.py",
               "utils/hostinfo.py", "utils/paths.py",
               # and checkpoint, export and resume
               "utils/checkpoint.py", "utils/compat.py", "utils/chaos.py",
               "data/indexed.py",
               # and data parallelism across processes
               "parallel/mesh.py", "parallel/collectives.py",
               "parallel/sharding.py",
               # and the pipeline layer
               "pipeline.py", "inference_cli.py", "parallel/runner.py",
               "models/mnist.py", "examples/serve_gpt.py",
               "examples/mnist_pipeline.py",
               "examples/mnist_parallel_inference.py",
               # and the observability plane
               "obs/collector.py", "obs/export.py", "obs/slo.py",
               "obs/anomaly.py", "obs/device.py", "obs/profiler.py",
               "utils/profiler.py",
               # and the serving fleet
               "serving/fleet.py", "serving/engine.py", "serving/slots.py",
               # and the registry, the deploy controller and cross-host
               # serving
               "serving/registry.py", "serving/deploy.py",
               "serving/remote.py", "serving/host.py",
               # and the mesh axes: ring attention, the ring step's ops
               "parallel/ring_attention.py", "ops/flash_attention.py",
               "optim.py", "train_state.py",
               # and the pipeline and expert axes
               "parallel/expert_parallel.py",
               "parallel/pipeline_parallel.py",
               # and serving over a mesh
               "parallel/serving_group.py"):
    assert os.path.join(*name.split("/")) in scanned, name
  bad = sorted((os.path.relpath(p, ROOT), root) for p in files
               for root in _imported_roots(p) if root in FORBIDDEN)
  assert bad == []
  bad_smoke = [r for r in _imported_roots(os.path.join(ROOT, "chip_smoke.py"))
               if r in FORBIDDEN]
  assert bad_smoke == []
  # the gloo ranks of the pipeline and expert tests, and of the serving
  # mesh's, start without JAX
  for helper in ("torch_pp_ep_ranks.py", "torch_serving_mesh_ranks.py"):
    ranks = os.path.join(ROOT, "tests", helper)
    assert [r for r in _imported_roots(ranks) if r in FORBIDDEN] == [], \
        helper


def test_running_the_port_loads_no_jax_module():
  code = textwrap.dedent("""
      import sys
      import numpy as np
      import torch
      from tensorflowonspark_tpu_torch.models import transformer as tfm
      from tensorflowonspark_tpu_torch.serving import ServingEngine
      from tensorflowonspark_tpu_torch.utils.params import init_params
      cfg = tfm.TransformerConfig(vocab_size=32, num_layers=1, num_heads=2,
                                  d_model=16, d_ff=32, max_seq_len=32,
                                  dtype=torch.float32)
      eng = ServingEngine(init_params(cfg, 0), cfg, num_slots=2,
                          device="cpu").start()
      outs = eng.generate([np.arange(1, 6), np.arange(3, 20)],
                          max_new_tokens=4, timeout=60)
      eng.stop()
      assert [len(o) for o in outs] == [9, 21], outs
      # and through a 2-replica fleet
      from tensorflowonspark_tpu_torch.serving import ServingFleet
      with ServingFleet(lambda: ServingEngine(init_params(cfg, 0), cfg,
                                              num_slots=2, device="cpu"),
                        num_replicas=2) as fl:
        fouts = fl.generate([np.arange(1, 6), np.arange(3, 20)],
                            max_new_tokens=4, timeout=60)
      assert [o.tolist() for o in fouts] == [o.tolist() for o in outs]
      # one CPU train step through the training path
      from tensorflowonspark_tpu_torch import optim
      from tensorflowonspark_tpu_torch.parallel.sharding import (
          make_train_step)
      state = tfm.create_state(cfg, 0, tx=optim.make_optimizer(clip_norm=1.0),
                               device="cpu")
      step = make_train_step(
          lambda m, t: tfm.causal_lm_loss(m(t), t, z_loss=1e-4))
      state, loss = step(state, np.arange(16).reshape(2, 8) % 32)
      assert state.step == 1 and bool(torch.isfinite(loss)), loss
      # and one through the fused LN->matmul / GELU->matmul ops
      import dataclasses
      fused = dataclasses.replace(cfg, fuse_qkv=True, ln_matmul_impl="fused",
                                  act_matmul_impl="fused")
      state = tfm.create_state(fused, 0, device="cpu")
      state, loss = step(state, np.arange(16).reshape(2, 8) % 32)
      assert bool(torch.isfinite(loss)), loss
      # and one data-parallel step over a 1-rank gloo group
      import torch.distributed as dist
      from tensorflowonspark_tpu_torch.parallel import collectives, mesh
      from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port
      dist.init_process_group("gloo", rank=0, world_size=1,
                              init_method="tcp://127.0.0.1:%d"
                              % get_free_port())
      m = mesh.build_mesh(mesh.MeshSpec(data=-1))
      state, _ = tfm.create_sharded_state(cfg, 0, m, device="cpu")
      state, loss = make_train_step(
          lambda m, t: tfm.causal_lm_loss(m(t), t), m)(
              state, np.arange(16).reshape(2, 8) % 32)
      assert collectives.COUNTS["buckets"] >= 1, collectives.COUNTS
      # the mesh axes' modules: ring attention over the sequence axis and
      # shard_map_fn, on the 1-rank group
      from tensorflowonspark_tpu_torch.parallel import ring_attention
      x = torch.randn(1, 8, 2, 8)
      assert ring_attention.ring_attention(x, x, x, m, use_flash=True).shape \
          == x.shape
      assert collectives.shard_map_fn(lambda v: v * 2, m, collectives.P(
          "data"), collectives.P("data"))(x).shape == x.shape
      dist.destroy_process_group()
      loaded = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
                      or m.startswith("tensorflowonspark_tpu."))
      print("LOADED", loaded)
      assert loaded == [], loaded
  """)
  env = dict(os.environ, PYTHONPATH=ROOT)
  proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "LOADED []" in proc.stdout


def test_train_gpt_from_tfrecords_loads_no_jax_module(tmp_path):
  code = textwrap.dedent("""
      import sys
      from tensorflowonspark_tpu_torch.data import example_codec, tfrecord
      from tensorflowonspark_tpu_torch.examples import train_gpt
      with tfrecord.TFRecordWriter(sys.argv[1]) as w:
        for i in range(4):
          w.write(example_codec.encode_example(
              {"tokens": [(7 * i + j) % 32 for j in range(20)]}))
      losses = train_gpt.run(train_gpt.parse_args(
          ["--device", "cpu", "--data", sys.argv[1], "--layers", "1",
           "--d_model", "16", "--heads", "2", "--kv_heads", "1",
           "--seq_len", "16", "--vocab", "32", "--batch", "2",
           "--steps", "1"]))
      assert len(losses) == 1, losses
      loaded = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
                      or m.startswith("tensorflowonspark_tpu."))
      print("LOADED", loaded)
      assert loaded == [], loaded
  """)
  env = dict(os.environ, PYTHONPATH=ROOT, TFOS_TPU_FLASH_BWD="split")
  proc = subprocess.run([sys.executable, "-c", code,
                         str(tmp_path / "tokens.tfrecord")], cwd=ROOT,
                        env=env, capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "LOADED []" in proc.stdout and "step 0 loss" in proc.stdout


_CLUSTER_DRIVE = textwrap.dedent("""
    import json
    import sys

    from tensorflowonspark_tpu_torch import cluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack", "cloudpickle")


    def loaded():
      return sorted(m for m in sys.modules
                    if m.split(".")[0] in BANNED
                    or m.startswith("tensorflowonspark_tpu."))


    def main_fn(path, ctx):
      import torch
      from tensorflowonspark_tpu_torch.data import indexed
      from tensorflowonspark_tpu_torch.utils import chaos
      assert float(torch.ones(3).sum()) == 3.0
      # checkpoint, resume and export on the node
      mgr = ctx.checkpoint_manager("ck", save_interval_steps=1)
      assert mgr.save(0, {"w": torch.ones(2)})
      assert mgr.restore_or({"w": torch.zeros(2)})[1] == 1
      ctx.export_model({"w": torch.ones(2)}, "ex")
      chaos.kill_point("train-step", ctx.executor_id)
      assert indexed.permute_index(3, 10, 7) < 10
      with open(path, "w") as f:
        json.dump(loaded(), f)


    if __name__ == "__main__":
      engine = LocalEngine(num_executors=1)
      try:
        c = cluster.run(engine, main_fn, sys.argv[1],
                        input_mode=cluster.InputMode.TENSORFLOW,
                        reservation_timeout=60)
        c.shutdown(timeout=120)
      finally:
        engine.stop()
      print("DRIVER", json.dumps(loaded()))
      with open(sys.argv[1]) as f:
        print("EXECUTOR", f.read())
""")


def test_cluster_run_loads_no_jax_msgpack_or_cloudpickle(tmp_path):
  """cluster.run(LocalEngine(1), main_fn) on the CPU: neither the driver
  nor the executor running the main fn (which checkpoints, resumes and
  exports) loads jax, flax, the JAX package, msgpack or cloudpickle."""
  script = tmp_path / "drive.py"
  script.write_text(_CLUSTER_DRIVE)
  env = dict(os.environ, PYTHONPATH=ROOT)
  proc = subprocess.run([sys.executable, str(script),
                         str(tmp_path / "executor_modules.json")],
                        cwd=str(tmp_path), env=env, capture_output=True,
                        text=True, timeout=180)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "DRIVER []" in proc.stdout and "EXECUTOR []" in proc.stdout, \
      proc.stdout


_TRANSFORM_DRIVE = textwrap.dedent("""
    import json
    import sys

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import pipeline
    from tensorflowonspark_tpu_torch.data import dfutil
    from tensorflowonspark_tpu_torch.data.schema import parse_schema
    from tensorflowonspark_tpu_torch.engine import LocalEngine
    from tensorflowonspark_tpu_torch.models import transformer as tfm
    from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
    from tensorflowonspark_tpu_torch.utils.params import init_params

    BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack", "cloudpickle")


    def loaded():
      return sorted(m for m in sys.modules
                    if m.split(".")[0] in BANNED
                    or m.startswith("tensorflowonspark_tpu."))


    def mapped(pid):
      # the shared objects a process mapped: a follower that imported jax
      # (and so the JAX package) or msgpack maps their native libraries
      with open("/proc/%d/maps" % pid) as f:
        libs = {line.split()[-1] for line in f if ".so" in line}
      return {"torch": any("libtorch" in p for p in libs),
              "banned": sorted(p for p in libs if any(
                  "/%s/" % b in p for b in BANNED))}


    class Report(object):
      def __call__(self, it):
        from tensorflowonspark_tpu_torch.parallel import serving_group
        return [loaded(), [mapped(pid)
                           for pid in serving_group.follower_pids()]]


    if __name__ == "__main__":
      out = sys.argv[1]
      cfg = tfm.TransformerConfig(vocab_size=32, num_layers=1, num_heads=2,
                                  d_model=16, d_ff=32, max_seq_len=32,
                                  dtype=torch.float32)
      pipeline.export_bundle(init_params(cfg, 0),
                             tfm.make_serving_predict_fn(cfg, 3,
                                                         device="cpu"),
                             out + "/bundle")
      rows = [([1, 2, 3],), ([4, 5, 6],), ([7, 8],)]
      dfutil.save_as_tfrecords([rows], parse_schema(
          "struct<p:array<long>>"), out + "/data")
      parts, _ = dfutil.load_tfrecords(out + "/data", lazy=True)
      # and a bundle served over a mesh: the executor's serving group
      pipeline.export_bundle(init_params(cfg, 0), tfm.make_serving_predict_fn(
          cfg, 3, device="cpu", mesh_spec=mesh_lib.MeshSpec(data=-1,
                                                            tensor=2)),
          out + "/mesh_bundle")
      engine = LocalEngine(num_executors=1)
      try:
        model = pipeline.TFModel({"export_dir": out + "/bundle",
                                  "batch_size": 2})
        got = model.transform(engine, [[r for r in parts[0]()]])
        assert [len(r) for r in got] == [6, 6, 5], got
        model = pipeline.TFModel({"export_dir": out + "/mesh_bundle",
                                  "batch_size": 2})
        got = model.transform(engine, [rows[:2]])
        assert [len(r) for r in got] == [6, 6], got
        executor, followers = engine.run_on_executors(Report()).wait(
            timeout=60)[0]
      finally:
        engine.stop()
      assert len(followers) == 1 and followers[0]["torch"], followers
      print("DRIVER", json.dumps(loaded()))
      print("EXECUTOR", json.dumps(executor))
      print("FOLLOWER", json.dumps(followers[0]["banned"]))
""")


def test_transform_loads_no_jax_msgpack_or_cloudpickle(tmp_path):
  """A serving bundle exported, TFRecords written and read by the port's
  ``dfutil``, and ``TFModel.transform`` on a LocalEngine executor: neither
  the driver nor the executor loads jax, flax, the JAX package, msgpack
  or cloudpickle; nor does the follower a bundle served over a mesh
  spawns (its serving group's rank 1: no native library of theirs is
  mapped in it)."""
  script = tmp_path / "transform.py"
  script.write_text(_TRANSFORM_DRIVE)
  env = dict(os.environ, PYTHONPATH=ROOT)
  proc = subprocess.run([sys.executable, str(script), str(tmp_path)],
                        cwd=str(tmp_path), env=env, capture_output=True,
                        text=True, timeout=180)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "DRIVER []" in proc.stdout and "EXECUTOR []" in proc.stdout, \
      proc.stdout
  assert "FOLLOWER []" in proc.stdout, proc.stdout


_RING_DRIVE = textwrap.dedent("""
    import sys

    import numpy as np

    from tensorflowonspark_tpu_torch import node
    from tensorflowonspark_tpu_torch.control import feedhub, shmring
    from tensorflowonspark_tpu_torch.datafeed import DataFeed


    if __name__ == "__main__":
      hub = feedhub.start(b"k", ["input", "output", "error"])
      try:
        name = "/tos_boundary_%d" % id(hub)
        with shmring.ShmRing.create(name, capacity=1 << 20) as ring:
          hub.set("ring_name", name)
          channel = node.input_channel(hub)
          node.put_rows_chunk(channel, [np.arange(4) + i for i in range(6)])
          channel.put(None)
          feed = DataFeed(hub)
          assert feed.next_batch_arrays(8).shape == (6, 4)
          assert feed.channel_chunks()["ring"] == 2
      finally:
        hub.shutdown()
      with open("/proc/self/maps") as f:
        libs = sorted({line.split()[-1] for line in f if "shmring" in line})
      print("LIBS", libs)
      banned = ("jax", "jaxlib", "flax", "msgpack", "cloudpickle", "torch")
      print("LOADED", sorted(m for m in sys.modules
                             if m.split(".")[0] in banned
                             or m.startswith("tensorflowonspark_tpu.")))
""")


def test_shm_ring_loads_the_ports_own_library(tmp_path):
  """A feed over the port's shm ring maps the ring library the port built
  from its own ``native/shmring.cpp`` into ``build/shmring/``, never the
  JAX package's ``tensorflowonspark_tpu/data/_shmring_native.so``; the
  feed path loads no jax, msgpack, cloudpickle, or torch."""
  script = tmp_path / "ring.py"
  script.write_text(_RING_DRIVE)
  env = dict(os.environ, PYTHONPATH=ROOT)
  proc = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                        env=env, capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  libs = next(line for line in proc.stdout.splitlines()
              if line.startswith("LIBS"))
  build = os.path.join(os.path.realpath(ROOT), "build", "shmring",
                       "libshmring.")
  assert libs.count("libshmring.") == 1 and build in libs, libs
  assert "tensorflowonspark_tpu/" not in libs, libs
  assert "LOADED []" in proc.stdout, proc.stdout


_CODEC_DRIVE = textwrap.dedent("""
    import sys

    from tensorflowonspark_tpu_torch.data import dfutil, readers, schema

    if __name__ == "__main__":
      sch = schema.parse_schema("struct<tokens:array<long>>")
      paths = dfutil.save_as_tfrecords([[([1, 2, 3],)], [([4],)]], sch,
                                       sys.argv[1])
      rows = list(readers.read_tfrecord_examples(paths, schema=sch))
      assert rows == [([1, 2, 3],), ([4],)], rows
      with open("/proc/self/maps") as f:
        libs = sorted({line.split()[-1] for line in f if "tfrecord" in line})
      print("LIBS", libs)
      banned = ("jax", "jaxlib", "flax", "msgpack", "cloudpickle")
      print("LOADED", sorted(m for m in sys.modules
                             if m.split(".")[0] in banned
                             or m.startswith("tensorflowonspark_tpu.")))
""")


def test_tfrecord_codec_loads_the_ports_own_library(tmp_path):
  """TFRecords written and read through the port's data layer map the
  codec library the port built from its own ``native/tfrecord_codec.cpp``
  into ``build/tfrecord/``, never the JAX package's
  ``_tfrecord_native.so``; the path loads no jax, msgpack or
  cloudpickle."""
  script = tmp_path / "codec.py"
  script.write_text(_CODEC_DRIVE)
  env = dict(os.environ, PYTHONPATH=ROOT)
  proc = subprocess.run([sys.executable, str(script), str(tmp_path / "out")],
                        cwd=str(tmp_path), env=env, capture_output=True,
                        text=True, timeout=120)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  libs = next(line for line in proc.stdout.splitlines()
              if line.startswith("LIBS"))
  build = os.path.join(os.path.realpath(ROOT), "build", "tfrecord",
                       "libtfrecord.")
  assert libs.count("libtfrecord.") == 1 and build in libs, libs
  assert "_tfrecord_native" not in libs, libs
  assert "LOADED []" in proc.stdout, proc.stdout


# packages of finished attention kernels: a kernel of the port is written by
# hand, never a library call
KERNEL_PACKAGES = ("flash_attn", "flash_attn_interface", "xformers")


def _library_kernel_uses(path):
  """(line, what) for each call of ``scaled_dot_product_attention`` or
  ``torch.compile`` and each import of a package of finished kernels."""
  with open(path) as f:
    tree = ast.parse(f.read(), path)
  found = []
  for node in ast.walk(tree):
    if isinstance(node, ast.Attribute):
      if node.attr == "scaled_dot_product_attention":
        found.append((node.lineno, node.attr))
      elif (node.attr == "compile" and isinstance(node.value, ast.Name)
            and node.value.id == "torch"):
        found.append((node.lineno, "torch.compile"))
    elif (isinstance(node, ast.ImportFrom) and node.module
          and node.module.startswith("torch")):
      found += [(node.lineno, "import " + a.name) for a in node.names
                if a.name in ("scaled_dot_product_attention", "compile")]
  for root in _imported_roots(path):
    if root in KERNEL_PACKAGES:
      found.append((0, "import " + root))
  return found


def test_port_calls_no_library_attention_or_compiler():
  files = [os.path.join(d, f) for d, _, fs in os.walk(PORT)
           for f in fs if f.endswith(".py")]
  bad = {os.path.relpath(p, ROOT): uses for p in files
         for uses in [_library_kernel_uses(p)] if uses}
  assert bad == {}
  # the scan finds what it looks for: chip_smoke.py, which may, times
  # SDPA as the yardstick beside the kernels
  smoke = _library_kernel_uses(os.path.join(ROOT, "chip_smoke.py"))
  assert any(what == "scaled_dot_product_attention" for _, what in smoke)
  assert not any(what.startswith("import ") for _, what in smoke)
