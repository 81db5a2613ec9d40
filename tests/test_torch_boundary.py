"""The PyTorch port imports nothing of JAX, flax, optax or the JAX package."""

import ast
import os
import subprocess
import sys
import textwrap

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PORT = os.path.join(ROOT, "tensorflowonspark_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "tensorflowonspark_tpu")


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
  bad = sorted((os.path.relpath(p, ROOT), root) for p in files
               for root in _imported_roots(p) if root in FORBIDDEN)
  assert bad == []
  bad_smoke = [r for r in _imported_roots(os.path.join(ROOT, "chip_smoke.py"))
               if r in FORBIDDEN]
  assert bad_smoke == []


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
