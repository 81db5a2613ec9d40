"""The PyTorch port's pipeline layer on the CPU, held against the JAX
package: ``pipeline`` (Namespace, the params, bundles and signatures,
``TFEstimator.fit`` / ``TFModel.transform``, card placement),
``make_serving_predict_fn`` and sampled decoding, ``parallel.runner``,
``inference_cli`` and the port's serving and MNIST examples.

The engine-spawning tests share one ``LocalEngine(2)`` (module-scoped;
tier-1 runs each file on one worker), so the file starts two executors
once; the CLI and the examples start their own.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorflowonspark_tpu import pipeline as jax_pipeline
from tensorflowonspark_tpu.models import transformer as jax_tfm
from tensorflowonspark_tpu_torch import pipeline
from tensorflowonspark_tpu_torch.engine import LocalEngine
from tensorflowonspark_tpu_torch.models import transformer as tfm
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
from tensorflowonspark_tpu_torch.parallel import runner
from tensorflowonspark_tpu_torch.pipeline import Namespace, TFEstimator, TFModel
from tensorflowonspark_tpu_torch.utils import gpu_info
from tensorflowonspark_tpu_torch.utils.params import params_from_flax

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
W_TRUE = (3.14, 1.618)
SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
             max_seq_len=64)
STEPS = 6


@pytest.fixture(scope="module")
def engine():
  eng = LocalEngine(num_executors=2)
  yield eng
  eng.stop()


@pytest.fixture(scope="module")
def lm():
  """A 2-layer f32 LM in both packages, the port's weights carried over
  from the reference's flax tree."""
  jcfg = jax_tfm.TransformerConfig(dtype=jnp.float32, remat=False, **SMALL)
  tcfg = tfm.TransformerConfig(dtype=torch.float32, **SMALL)
  state = jax_tfm.create_state(jax.random.PRNGKey(0), jcfg, seq_len=8)
  params = params_from_flax(jax.tree.map(np.asarray, state.params), tcfg)
  return jcfg, state.params, tcfg, params


def _ragged(rows):
  col = np.empty(len(rows), object)
  col[:] = [list(r) for r in rows]
  return col


# -- Namespace and the params --------------------------------------------------


class TestNamespace:
  def test_from_dict_and_attr_access(self):
    ns = Namespace({"a": 1, "b": "x"})
    assert ns.a == 1 and ns["b"] == "x"
    ns.c = 3
    assert ns["c"] == 3

  def test_from_argparse(self):
    parsed = argparse.ArgumentParser().parse_args([])
    parsed.foo = 42
    assert Namespace(parsed).foo == 42

  def test_from_argv_list(self):
    assert Namespace(["--lr", "0.1"]).argv == ["--lr", "0.1"]

  def test_merge_args_params(self):
    for pkg in (jax_pipeline, pipeline):
      est = pkg.TFEstimator(linreg_train_fn, {"batch_size": 1,
                                              "keep": "yes"})
      est.setBatchSize(64).setEpochs(3)
      merged = est.merge_args_params(est.tf_args)
      assert merged.batch_size == 64      # param overrides arg
      assert merged.epochs == 3
      assert merged.keep == "yes"

  def test_param_defaults(self):
    m, ref = TFModel(), jax_pipeline.TFModel()
    assert m.getBatchSize() == 100
    assert m.getMasterNode() == "chief"
    names = sorted(n for n in dir(ref) if n.startswith(("get", "set")))
    assert sorted(n for n in dir(m) if n.startswith(("get", "set"))) == names
    assert {n: getattr(m, n)() for n in names if n.startswith("get")} == \
        {n: getattr(ref, n)() for n in names if n.startswith("get")}

  def test_namespace_pickles_by_name(self):
    ns = pickle.loads(pickle.dumps(Namespace({"a": 1})))
    assert isinstance(ns, Namespace) and ns.a == 1


# -- the serving predict fn, in process ----------------------------------------


class TestServingPredictFn:
  def test_rectangular_and_eos_equal_the_reference(self, lm):
    jcfg, jparams, tcfg, params = lm
    prompts = np.random.default_rng(0).integers(1, 64, (6, 8)).astype(
        np.int32)
    want = np.asarray(jax_tfm.make_serving_predict_fn(jcfg, STEPS)(
        jparams, {"input": prompts})["tokens"])
    got = tfm.make_serving_predict_fn(tcfg, STEPS, device="cpu")(
        params, {"input": prompts})["tokens"]
    assert got.dtype == np.int32 and got.shape == (6, 8 + STEPS)
    np.testing.assert_array_equal(got, want)
    eos = int(want[0, 10])
    want = np.asarray(jax_tfm.make_serving_predict_fn(
        jcfg, STEPS, eos_id=eos)(jparams, {"input": prompts})["tokens"])
    got = tfm.make_serving_predict_fn(tcfg, STEPS, eos_id=eos,
                                      device="cpu")(
                                          params, {"input": prompts})["tokens"]
    assert (got == eos).any()
    np.testing.assert_array_equal(got, want)

  def test_ragged_through_both_serving_engines(self, lm):
    jcfg, jparams, tcfg, params = lm
    rng = np.random.default_rng(1)
    rows = [rng.integers(1, 64, n).tolist() for n in (3, 9, 17, 5, 30)]
    want = np.asarray(jax_tfm.make_serving_predict_fn(
        jcfg, STEPS, num_slots=2)(jparams, {"input": _ragged(rows)})[
            "tokens"])
    fn = tfm.make_serving_predict_fn(tcfg, STEPS, num_slots=2,
                                     device="cpu")
    tfm.reset_serving_stats()
    got = fn(params, {"input": _ragged(rows)})["tokens"]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    again = fn(params, {"input": _ragged(rows)})["tokens"]
    np.testing.assert_array_equal(again, want)
    assert tfm.SERVING_STATS["engine_builds"] == 1
    assert tfm.SERVING_STATS["engine_hits"] == 1
    # equal-length rows of an object column are not ragged
    same = fn(params, {"input": _ragged([r[:3] for r in rows])})["tokens"]
    assert same.shape == (5, 3 + STEPS)
    with pytest.raises(ValueError, match="greedy-only"):
      tfm.make_serving_predict_fn(tcfg, 2, temperature=0.5, device="cpu")(
          params, {"input": _ragged(rows)})

  def test_weights_content_change_rebuilds_the_caches(self, lm):
    _, _, tcfg, params = lm
    fn = tfm.make_serving_predict_fn(tcfg, 2, num_slots=2, device="cpu")
    prompts = np.ones((2, 4), np.int32)
    a = fn(params, {"input": prompts})["tokens"]
    other = {k: v * 0.5 if k.endswith("embedding") else v
             for k, v in params.items()}
    b = fn(other, {"input": prompts})["tokens"]
    want = tfm.greedy_generate_kv(tfm.Transformer(tcfg, other, device="cpu"),
                                  prompts, 2).numpy()
    np.testing.assert_array_equal(b, want)
    np.testing.assert_array_equal(fn(params, {"input": prompts})["tokens"], a)

  def test_tensor_parallel_mesh_spec_raises_by_name(self, lm):
    """A ``MeshSpec(data=-1, tensor=2)`` predict fn, once refused by
    name, serves: this process starts a 2-rank serving group on its
    first serve and the tokens are one process's. Every degree 1 (the -1
    absorbs one process on the CPU) serves in this process alone."""
    from tensorflowonspark_tpu_torch.parallel import serving_group
    _, _, tcfg, params = lm
    prompts = np.random.RandomState(3).randint(0, 64, (3, 5)).astype("int32")
    want = tfm.greedy_generate_kv(tfm.Transformer(tcfg, params, device="cpu"),
                                  prompts, 2).numpy()
    fn = tfm.make_serving_predict_fn(
        tcfg, 2, mesh_spec=mesh_lib.MeshSpec(data=-1, tensor=2),
        device="cpu")
    try:
      got = fn(params, {"input": prompts})["tokens"]
      assert len(serving_group.follower_pids()) == 1
    finally:
      serving_group.shutdown_all()
    np.testing.assert_array_equal(got, want)
    one = tfm.make_serving_predict_fn(tcfg, 2, mesh_spec=mesh_lib.MeshSpec(),
                                      device="cpu")
    np.testing.assert_array_equal(one(params, {"input": prompts})["tokens"],
                                  want)
    assert serving_group.follower_pids() == []
    with pytest.raises(ValueError, match="not both"):
      tfm.make_serving_predict_fn(tcfg, 2, mesh=mesh_lib.build_mesh(),
                                  mesh_spec=mesh_lib.MeshSpec())

  def test_predict_fn_pickles_after_a_smoke_serve(self, lm):
    _, _, tcfg, params = lm
    fn = tfm.make_serving_predict_fn(tcfg, 2, num_slots=2, device="cpu")
    batch = {"input": np.ones((4, 4), np.int32)}
    out1 = fn(params, batch)
    fn(params, {"input": _ragged([[1, 2], [3, 4, 5]])})   # builds an engine
    blob = pickle.dumps(fn)
    assert len(blob) < 4096
    out2 = pickle.loads(blob)(params, batch)
    np.testing.assert_array_equal(out1["tokens"], out2["tokens"])

  def test_device_none_is_the_card(self, lm):
    if torch.cuda.is_available():
      pytest.skip("a card is present: device=None would use it")
    _, _, tcfg, params = lm
    with pytest.raises(RuntimeError, match="no CUDA device"):
      tfm.make_serving_predict_fn(tcfg, 2)(params,
                                           {"input": np.ones((1, 4))})


# -- sampled decoding ------------------------------------------------------------


class TestSampling:
  def test_top_k_1_is_greedy(self, lm):
    _, _, tcfg, params = lm
    model = tfm.Transformer(tcfg, params, device="cpu")
    prompts = np.random.default_rng(2).integers(1, 64, (4, 8))
    greedy = tfm.greedy_generate_kv(model, prompts, STEPS)
    sampled = tfm.greedy_generate_kv(model, prompts, STEPS, temperature=0.9,
                                     top_k=1,
                                     generator=torch.Generator().manual_seed(3))
    assert torch.equal(greedy, sampled)
    fn = tfm.make_serving_predict_fn(tcfg, STEPS, temperature=0.9, top_k=1,
                                     device="cpu")
    np.testing.assert_array_equal(
        fn(params, {"input": prompts})["tokens"], greedy.numpy())

  def test_same_seed_batch_and_call_count_repeat(self, lm):
    _, _, tcfg, params = lm
    batch = {"input": np.ones((4, 4), np.int32)}
    a = tfm.make_serving_predict_fn(tcfg, 8, temperature=1.0, seed=7,
                                    device="cpu")
    b = pickle.loads(pickle.dumps(a))
    first = [a(params, batch)["tokens"] for _ in range(2)]
    second = [b(params, batch)["tokens"] for _ in range(2)]
    for x, y in zip(first, second):
      np.testing.assert_array_equal(x, y)

  def test_sampled_serving_varies_across_calls(self, lm):
    """The twin of the reference's: repeated serves of one batch draw
    fresh streams, and greedy stays deterministic."""
    _, _, tcfg, params = lm
    batch = {"input": np.ones((4, 4), np.int32)}
    sampled = tfm.make_serving_predict_fn(tcfg, 8, temperature=1.0,
                                          device="cpu")
    a = sampled(params, batch)["tokens"]
    b = sampled(params, batch)["tokens"]
    assert not np.array_equal(a, b), "identical samples on repeated serves"
    greedy = tfm.make_serving_predict_fn(tcfg, 8, device="cpu")
    np.testing.assert_array_equal(greedy(params, batch)["tokens"],
                                  greedy(params, batch)["tokens"])

  def test_every_token_lies_in_its_steps_top_k(self, lm):
    """Replaying the sampled tokens through the same decode path gives the
    same logits, so each drawn token must be among its step's top k."""
    _, _, tcfg, params = lm
    model = tfm.Transformer(tcfg, params, device="cpu")
    prompts = np.random.default_rng(4).integers(1, 64, (8, 8))
    k, temp = 5, 1.5
    out = tfm.greedy_generate_kv(model, prompts, 12, temperature=temp,
                                 top_k=k,
                                 generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
      cache = model.init_cache(8)
      logits = model(torch.as_tensor(prompts), cache)[:, -1]
      for i in range(12):
        tok = out[:, 8 + i]
        scaled = logits / temp
        kth = torch.topk(scaled, k, dim=-1).values[:, -1]
        assert bool((scaled.gather(1, tok[:, None])[:, 0] >= kth).all()), i
        logits = model(tok[:, None], cache)[:, -1]

  def test_draw_frequencies_match_the_softmax(self, lm):
    """4096 draws at one position against ``softmax(logits / T)``: every
    token's frequency within 5 standard errors (+ 1e-3) of its
    probability."""
    _, _, tcfg, params = lm
    model = tfm.Transformer(tcfg, params, device="cpu")
    n, temp = 4096, 2.0
    prompt = np.random.default_rng(5).integers(1, 64, (1, 8))
    with torch.inference_mode():
      p = torch.softmax(model(torch.as_tensor(prompt))[0, -1] / temp,
                        -1).double().numpy()
    out = tfm.greedy_generate_kv(model, np.repeat(prompt, n, 0), 1,
                                 temperature=temp,
                                 generator=torch.Generator().manual_seed(11))
    freq = np.bincount(out[:, -1].numpy(), minlength=p.size) / n
    assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-3).all()
    assert (freq > 0).sum() > 10

  def test_sampling_guards_match_the_reference(self, lm):
    jcfg, jparams, tcfg, params = lm
    model = tfm.Transformer(tcfg, params, device="cpu")
    with pytest.raises(ValueError, match="explicit"):
      jax_tfm.greedy_generate_kv(jparams, jcfg, jnp.ones((1, 4), jnp.int32),
                                 2, temperature=0.7)
    with pytest.raises(ValueError, match="explicit"):
      tfm.greedy_generate_kv(model, np.ones((1, 4)), 2, temperature=0.7)
    with pytest.raises(ValueError, match=">= 0"):
      tfm.greedy_generate_kv(model, np.ones((1, 4)), 2, temperature=-1.0)


# -- TFEstimator.fit -> export_bundle -> TFModel.transform ------------------------


def linreg_predict(params, batch):
  return {"pred": np.asarray(batch["x"], "float32") @ params["w"]
          + params["b"]}


def linreg_train_fn(args, ctx):
  """Linear regression on fed data in torch; the chief exports."""
  feed = ctx.get_data_feed(train_mode=True,
                           input_mapping={"features": "x", "label": "y"})
  w = torch.zeros(2, requires_grad=True)
  b = torch.zeros((), requires_grad=True)
  while not feed.should_stop():
    batch = feed.next_batch(32)
    if len(batch["x"]) == 0:
      continue
    x = torch.as_tensor(np.asarray(batch["x"], np.float32))
    y = torch.as_tensor(np.asarray(batch["y"], np.float32)).reshape(-1)
    for _ in range(10):
      loss = ((x @ w + b - y) ** 2).mean()
      gw, gb = torch.autograd.grad(loss, (w, b))
      with torch.no_grad():
        w -= 0.1 * gw
        b -= 0.1 * gb
  if ctx.is_chief:
    pipeline.export_bundle({"w": w.detach().numpy(), "b": b.detach().numpy()},
                           linreg_predict, args["export_dir"], is_chief=True)


def _make_dataset(n=512, seed=0):
  rng = np.random.RandomState(seed)
  x = rng.rand(n, 2).astype("float32")
  y = x @ np.asarray(W_TRUE, "float32")
  return [([float(a), float(b)], float(t)) for (a, b), t in zip(x, y)]


class TestEstimatorModel:
  def test_fit_transform_regression(self, engine, tmp_path):
    """The reference's regression through the port's LocalEngine(2): the
    prediction on [1, 1] is 3.14 + 1.618 within 0.05."""
    export_dir = str(tmp_path / "export")
    rows = _make_dataset()
    est = TFEstimator(linreg_train_fn, {"export_dir": export_dir})
    est.setEpochs(30).setGraceSecs(1).setReservationTimeout(60)
    model = est.fit(engine, [rows[i::4] for i in range(4)])
    assert os.path.exists(os.path.join(export_dir, "predict.pkl"))

    model.setExportDir(export_dir) \
         .setInputMapping({"features": "x"}) \
         .setOutputMapping({"pred": "prediction"}) \
         .setBatchSize(16)
    test_rows = [([1.0, 1.0],), ([0.0, 0.0],), ([2.0, 0.0],)]
    preds = model.transform(engine, [test_rows])
    assert len(preds) == 3
    np.testing.assert_allclose(preds[0], sum(W_TRUE), atol=0.05)
    np.testing.assert_allclose(preds[1], 0.0, atol=0.05)
    np.testing.assert_allclose(preds[2], 2 * W_TRUE[0], atol=0.1)


class TestTransformerServing:
  def test_bundle_served_through_transform_equals_the_reference(
      self, engine, lm, tmp_path):
    """A serving bundle through ``TFModel.transform`` on the executors:
    the rectangular partitions (collected) and a ragged one (lazy) give
    the tokens of the reference's predict fn run in process."""
    jcfg, jparams, tcfg, params = lm
    export_dir = str(tmp_path / "lm_bundle")
    pipeline.export_bundle(
        params, tfm.make_serving_predict_fn(tcfg, STEPS, num_slots=2,
                                            device="cpu"), export_dir)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 64, 6).tolist() for _ in range(10)]
    want = np.asarray(jax_tfm.make_serving_predict_fn(jcfg, STEPS)(
        jparams, {"input": np.asarray(prompts, np.int32)})["tokens"])
    model = TFModel({"export_dir": export_dir, "batch_size": 5})
    rows = model.transform(engine, [[(p,) for p in prompts[:5]],
                                    [(p,) for p in prompts[5:]]])
    assert len(rows) == 10
    np.testing.assert_array_equal(np.asarray(rows), want)

    ragged = [rng.randint(0, 64, n).tolist() for n in (3, 11, 7, 20, 5, 9)]
    ref = jax_tfm.make_serving_predict_fn(jcfg, STEPS, num_slots=2)
    # each batch of 3 is padded to its own longest row
    want = [row.tolist() for i in (0, 3) for row in np.asarray(
        ref(jparams, {"input": _ragged(ragged[i:i + 3])})["tokens"])]
    stream = model.setBatchSize(3).transform(
        engine, [[(p,) for p in ragged]], collect=False)
    assert not isinstance(stream, list)
    assert list(stream) == want

  def test_mnist_pipeline_example_fits_and_transforms(self, engine,
                                                      tmp_path):
    """The port's ``examples/mnist_pipeline.py`` train fn and predict fn
    through ``fit`` and ``transform`` on the shared engine."""
    from tensorflowonspark_tpu_torch.examples import mnist_pipeline
    from tensorflowonspark_tpu_torch.models import mnist
    images, labels = mnist.synthetic_dataset(384)
    rows = list(zip(images.tolist(), labels.tolist()))
    export_dir = str(tmp_path / "mnist")
    est = TFEstimator(mnist_pipeline.train_fn, {
        "export_dir": export_dir, "batch_size": 16, "device": "cpu"})
    model = est.setEpochs(3).setGraceSecs(1).setReservationTimeout(60).fit(
        engine, [rows[i::4] for i in range(4)])
    model.setExportDir(export_dir).setInputMapping({"image": "x"}) \
         .setOutputMapping({"label": "prediction"})
    preds = model.transform(engine, [[(img,) for img, _ in rows[:64]]])
    acc = np.mean(np.asarray(preds) == labels[:64])
    assert acc > 0.9, acc


# -- the runner ---------------------------------------------------------------------


def _placement(args, ctx):
  return (ctx.executor_id, len(ctx.cluster_spec["worker"]), os.getpid(),
          tuple(ctx.cluster_spec["worker"]), args)


def _executor_id(args, ctx):
  return ctx.executor_id


class TestParallelRunner:
  def test_barrier_run_with_placement(self, engine):
    results = runner.run(engine, _placement, tf_args="a", num_tasks=2,
                         use_barrier=True, timeout=60)
    assert sorted(r[:2] for r in results) == [(0, 2), (1, 2)]
    assert len({r[2] for r in results}) == 2
    assert results[0][3] == results[1][3] and len(results[0][3]) == 2
    assert {r[4] for r in results} == {"a"}

  def test_non_barrier_run(self, engine):
    results = runner.run(engine, _executor_id, num_tasks=2,
                         use_barrier=False, timeout=60)
    assert sorted(results) == [0, 1]

  def test_barrier_oversubscription_raises(self, engine):
    with pytest.raises(ValueError, match="barrier gang"):
      runner.run(engine, _executor_id, num_tasks=4)


# -- the inference CLI ----------------------------------------------------------------


def scale_predict(params, batch):
  return {"pred": np.asarray(batch["x"], "float32") @ params["w"]}


class TestInferenceCLI:
  def test_end_to_end(self, tmp_path):
    from tensorflowonspark_tpu_torch import inference_cli
    from tensorflowonspark_tpu_torch.data import dfutil
    from tensorflowonspark_tpu_torch.data.schema import parse_schema
    export_dir = str(tmp_path / "model")
    pipeline.export_bundle({"w": np.asarray([1.0, 10.0], "float32")},
                           scale_predict, export_dir)
    data_dir = str(tmp_path / "data")
    dfutil.save_as_tfrecords([[([1.0, 2.0],), ([3.0, 4.0],)]],
                             parse_schema("struct<features:array<float>>"),
                             data_dir)
    out = str(tmp_path / "preds.jsonl")
    rc = inference_cli.main([
        "--export_dir", export_dir, "--input", data_dir,
        "--schema_hint", "struct<features:array<float>>",
        "--input_mapping", json.dumps({"features": "x"}),
        "--output_mapping", json.dumps({"pred": "y"}),
        "--output", out])
    assert rc == 0
    assert [json.loads(l)["y"] for l in open(out)] == [21.0, 43.0]

  def test_bad_mapping_and_output_errors(self, tmp_path):
    from tensorflowonspark_tpu_torch import inference_cli
    from tensorflowonspark_tpu_torch.data import dfutil
    from tensorflowonspark_tpu_torch.data.schema import parse_schema
    data_dir = str(tmp_path / "d")
    dfutil.save_as_tfrecords([[(1.0,)]], parse_schema("struct<a:float>"),
                             data_dir)
    base = ["--export_dir", str(tmp_path), "--input", data_dir,
            "--schema_hint", "struct<a:float>"]
    with pytest.raises(SystemExit, match="not in schema"):
      inference_cli.main(base + ["--input_mapping", json.dumps({"nope": "x"}),
                                 "--output", str(tmp_path / "o.jsonl")])
    with pytest.raises(SystemExit, match="does not exist"):
      inference_cli.main(base + ["--output", str(tmp_path / "no" / "o")])
    with pytest.raises(SystemExit, match="is a directory"):
      inference_cli.main(base + ["--output", data_dir])
    with pytest.raises(NotImplementedError, match="item 11"):
      inference_cli.main(base + ["--engine", "spark",
                                 "--output", str(tmp_path / "o.jsonl")])

  def test_python_dash_m_serves_a_bundle_by_its_signature(self, lm,
                                                          tmp_path):
    """``python -m tensorflowonspark_tpu_torch.inference_cli`` as a real
    subprocess over a serving bundle and prompts written as an ``int64``
    array column: the JSONL lines, named by the signature, equal the
    reference's in-process predict fn."""
    from tensorflowonspark_tpu_torch.data import dfutil
    from tensorflowonspark_tpu_torch.data.schema import parse_schema
    jcfg, jparams, tcfg, params = lm
    prompts = np.random.RandomState(3).randint(0, 64, (6, 5))
    export_dir = str(tmp_path / "model")
    pipeline.export_bundle(
        params, tfm.make_serving_predict_fn(tcfg, 3, device="cpu"),
        export_dir, example_batch={"prompt": prompts[:1]})
    assert pipeline.signature_output_names(export_dir) == ["tokens"]
    dfutil.save_as_tfrecords([[(p.tolist(),) for p in prompts]],
                             parse_schema("struct<prompt:array<long>>"),
                             str(tmp_path / "data"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out_path = str(tmp_path / "preds.jsonl")
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflowonspark_tpu_torch.inference_cli",
         "--export_dir", export_dir, "--input", str(tmp_path / "data"),
         "--output", out_path, "--batch_size", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(l) for l in open(out_path)]
    want = np.asarray(jax_tfm.make_serving_predict_fn(jcfg, 3)(
        jparams, {"input": prompts.astype(np.int32)})["tokens"])
    assert [sorted(l) for l in lines] == [["tokens"]] * 6
    np.testing.assert_array_equal([l["tokens"] for l in lines], want)


# -- bundles and signatures ------------------------------------------------------------


def two_outputs(params, batch):
  x = np.asarray(batch["x"], "float32")
  return {"pred": x @ params["w"], "conf": np.ones((len(x),), "float32")}


class _Scaler(object):
  def __init__(self, k):
    self.k = k

  def __call__(self, params, batch):
    return {"y": np.asarray(batch["x"]) * self.k}


class TestBundleSignature:
  def _export(self, tmp_path, pkg=pipeline):
    export_dir = str(tmp_path / ("m_%s" % pkg.__name__.split(".")[0]))
    pkg.export_bundle(
        {"w": np.asarray([1.0, 2.0], "float32")}, two_outputs, export_dir,
        example_batch={"x": np.zeros((1, 2), "float32")})
    return export_dir

  def test_signature_recorded_at_export_as_the_reference_records_it(
      self, tmp_path):
    export_dir = self._export(tmp_path)
    sig = pipeline.load_signature(export_dir)
    assert sig["inputs"] == ["x"]
    assert sorted(sig["outputs"]) == ["conf", "pred"]
    assert sig["outputs"]["pred"] == {"dtype": "float32", "shape": [None]}
    ref = self._export(tmp_path, jax_pipeline)
    with open(os.path.join(export_dir, "signature.json")) as a, \
        open(os.path.join(ref, "signature.json")) as b:
      assert a.read() == b.read()
    assert pipeline.signature_output_names(ref) == ["conf", "pred"]

  def test_transform_without_output_mapping_uses_signature(self, engine,
                                                           tmp_path):
    export_dir = self._export(tmp_path)
    model = pipeline.TFModel({"export_dir": export_dir,
                              "input_mapping": {"features": "x"},
                              "batch_size": 4})
    preds = model.transform(engine, [[([1.0, 1.0],), ([2.0, 0.0],)]])
    # columns ordered by the signature: (conf, pred)
    assert preds == [(1.0, 3.0), (1.0, 2.0)]

  def test_missing_signature_is_none(self, tmp_path):
    export_dir = str(tmp_path / "nosig")
    pipeline.export_bundle({"w": np.zeros(2)}, scale_predict, export_dir)
    assert pipeline.load_signature(export_dir) is None
    assert pipeline.signature_output_names(export_dir) is None
    params, fn = pipeline.load_bundle(export_dir)
    assert fn is scale_predict and np.array_equal(params["w"], np.zeros(2))

  def test_export_refuses_a_closure_or_a_lambda(self, tmp_path):
    def local(params, batch):
      return batch

    class Local(object):
      def __call__(self, params, batch):
        return batch

    for fn in (local, lambda p, b: b, Local()):
      with pytest.raises(ValueError, match="module-level function or an "
                                           "instance of a module-level class"):
        pipeline.export_bundle({"w": np.zeros(2)}, fn, str(tmp_path / "x"))
    assert not os.path.exists(tmp_path / "x")
    pipeline.export_bundle({"w": np.zeros(2)}, _Scaler(2.0),
                           str(tmp_path / "ok"))
    assert pipeline.load_bundle(str(tmp_path / "ok"))[1].k == 2.0


# -- card placement of transform tasks ---------------------------------------------------


def _fake_nvidia_smi(directory, cards):
  lines = "".join("%d, GPU-%d, NVIDIA H100 80GB HBM3, 81559\\n" % (i, i)
                  for i in range(cards))
  path = os.path.join(directory, "nvidia-smi")
  with open(path, "w") as f:
    f.write("#!/bin/sh\nprintf '%s'\n" % lines)
  os.chmod(path, 0o755)


class TestTransformChipAllocation:
  def _claims(self, monkeypatch, tmp_path, cards, chips, slots):
    _fake_nvidia_smi(str(tmp_path), cards)
    monkeypatch.setenv("PATH", str(tmp_path) + os.pathsep
                       + os.environ.get("PATH", ""))
    monkeypatch.delenv("TOS_TPU_TEST_MODE", raising=False)
    applied = []
    monkeypatch.setattr(gpu_info, "apply_chip_env",
                        lambda env: applied.append(dict(env)))
    for slot in slots:
      monkeypatch.delenv("TOS_CHIP_ENV_APPLIED", raising=False)
      monkeypatch.setenv("TOS_EXECUTOR_SLOT", str(slot))
      pipeline._allocate_transform_chips(chips)
    return [a["CUDA_VISIBLE_DEVICES"] for a in applied]

  def test_two_slots_claim_disjoint_cards(self, monkeypatch, tmp_path):
    assert self._claims(monkeypatch, tmp_path, 4, 2, [0, 1]) == ["0,1",
                                                                 "2,3"]

  def test_one_card_host_shares_card_0(self, monkeypatch, tmp_path):
    assert self._claims(monkeypatch, tmp_path, 1, 1, [0, 1]) == ["0", "0"]

  def test_noop_without_chips_or_in_test_mode(self, monkeypatch):
    applied = []
    monkeypatch.setattr(gpu_info, "apply_chip_env",
                        lambda env: applied.append(env))
    pipeline._allocate_transform_chips(0)
    monkeypatch.setenv("TOS_TPU_TEST_MODE", "1")
    pipeline._allocate_transform_chips(2)
    monkeypatch.delenv("TOS_TPU_TEST_MODE")
    monkeypatch.setenv("TOS_CHIP_ENV_APPLIED", "0")
    pipeline._allocate_transform_chips(2)
    assert applied == []

  def test_spark_taskcontext_slot(self, monkeypatch):
    sys.path.insert(0, HERE)
    import pyspark_stub
    monkeypatch.delenv("TOS_EXECUTOR_SLOT", raising=False)
    monkeypatch.setitem(sys.modules, "pyspark", pyspark_stub)
    pyspark_stub.TaskContext._local.ctx = pyspark_stub.TaskContext(3, 0)
    try:
      assert pipeline._transform_worker_slot() == 3
    finally:
      pyspark_stub.TaskContext._local.ctx = None
    assert pipeline._transform_worker_slot() == 0

  def test_slot_file_is_shared_with_the_reference(self, monkeypatch,
                                                  tmp_path):
    """Claims written by either package's ``_host_local_slot`` read in
    the other (the same JSON), dead claims are reclaimed, and a pid that
    holds a slot gets it back."""
    import tempfile
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    path = tmp_path / ("tos_transform_slots.%d" % os.getuid())
    dead = subprocess.Popen(["true"])
    dead.wait()
    other = subprocess.Popen(["sleep", "60"])
    try:
      path.write_text(json.dumps({"0": dead.pid, "1": other.pid}))
      assert pipeline._host_local_slot(3) == 0
      assert jax_pipeline._host_local_slot(3) == 0   # this pid's claim
      written = path.read_text()
      assert json.loads(written) == {"0": os.getpid(), "1": other.pid}
      path.write_text(json.dumps({"0": other.pid}))
      assert jax_pipeline._host_local_slot(2) == 1
      ref_written = path.read_text()
      path.write_text(json.dumps({"0": other.pid}))
      assert pipeline._host_local_slot(2) == 1
      assert path.read_text() == ref_written
      path.write_text(json.dumps({"0": other.pid, "1": other.pid}))
      assert pipeline._host_local_slot(2) is None
    finally:
      other.kill()
      other.wait()


# -- the serving example ----------------------------------------------------------------


def test_serve_gpt_example_on_the_cpu(tmp_path):
  """The port's ``examples/serve_gpt.py`` at small counts: every prompt
  served through ``transform(collect=False)`` as its own decode; and
  ``--tensor 2``, once refused by name, serves the same rows over each
  executor's 2-rank serving group."""
  from tensorflowonspark_tpu_torch.examples import serve_gpt
  common = ["--device", "cpu", "--prompts", "6", "--steps", "3"]
  served = serve_gpt.run(serve_gpt.parse_args(
      common + ["--export_dir", str(tmp_path / "b")]))
  assert len(served) == 6 and {len(r) for r in served} == {8 + 3}
  tensor = serve_gpt.run(serve_gpt.parse_args(
      common + ["--tensor", "2", "--export_dir", str(tmp_path / "t2")]))
  assert sorted(tensor) == sorted(served)
