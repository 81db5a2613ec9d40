#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, the CUDA toolkit (``nvcc``) and PyTorch built for CUDA, and
imports nothing of JAX or of the JAX package. Phases, each fatal on
failure:

1. the card: its name and power limit as ``nvidia-smi`` reports them;
2. build: every hand-written kernel from ``tensorflowonspark_tpu_torch/
   csrc/`` with ``nvcc`` (one process per source, started together);
   the ptxas spill bytes of each tensor-core instantiation (the bf16
   flash forward, fused backward, split dK/dV and split dQ at padded head
   widths 64 and 128, and the wgmma body of GELU->matmul and of
   LN->matmul; none may spill)
   and their ``HGMMA`` / ``HMMA`` / ``FFMA`` counts from ``cuobjdump
   -sass`` (each must show HGMMA);
3. kernels against their plain PyTorch versions on the card, at the
   shapes the serving and training paths give them, with times (CUDA
   events), the least time the card could take (``bound``) and one
   PyTorch library call computing the same function as a yardstick: the
   LayerNorm and flash-attention forwards, then their backwards (each run
   twice and required to give the same bits), then the fused LN->matmul
   and GELU->matmul products (their yardstick is the unfused pair of
   library calls; each case logs the body its dispatcher runs, bf16 with K
   and N multiples of 8 on wgmma, is run twice and must give the same
   bits; their device time from ``torch.profiler`` is taken at the end of
   6c, so that no profiler session precedes the serving run, where the
   profiled kernel's name must be that body's instantiated for the op's
   prologue; the LayerNorm kernels' device times, the backward's pass 1
   and pass 2 apart, and the yardstick's, are taken there too),
   LayerNorm rows wider than 8192 and fused products whose K and N are
   not multiples of 8; (3b) head dims other than 64 and 128: the
   forward, the fused backward and the split backward at head_dim 32 and
   96 (bf16 and f32; MHA, grouped, a window, a ragged offset block)
   against their plain versions, timed beside SDPA;
4. the serving main path at full width: the flagship
   ``TransformerConfig()`` (vocab 32000, 12 layers, 12 heads, d_model
   768, d_ff 3072, bf16) with random weights from a seed, served by
   ``ServingEngine(num_slots=8, horizon=4)``: 16 requests of 17-600
   prompt tokens, 32 new tokens each. The kernels' launch counts are
   zeroed just before and read just after, and must show both forward
   kernels on the path; then (4b) one decode dispatch and one 512-token
   prefill chunk under ``torch.profiler``: device-busy time against the
   host's wall clock, the top kernels and every port kernel's device time;
5. serving parity: the same model in f32 (TF32 off) — every engine
   output must equal the single-request ``greedy_generate_kv`` decode, or
   differ only at a genuine near-tie (top-2 logit gap under 1e-4);
6. the training main path at full width: the same model and weights
   (f32 master weights, bf16 compute, remat), ``make_optimizer(3e-4,
   clip_norm=1.0)``, one fixed 16 x 1024 token batch: 2 warm-up steps, 4
   ``make_train_step`` steps, then one ``make_train_loop(unroll=4)`` slab.
   Losses must be finite and fall, and each path must launch exactly 24
   flash forwards, 12 flash backwards, 49 LayerNorm forwards and 25
   LayerNorm backwards per optimizer step (and no fused product); prints
   tokens/s, ms per step, peak memory and one step under
   ``torch.profiler``; (6b) the grouped-KV configuration
   (``num_kv_heads=4``) takes a warm-up and 2 timed steps at 8 x 1024 and
   must launch the grouped flash backward 12 times per step; (6c) the
   all-fused flagship (``fuse_qkv`` + ``ln_matmul_impl="fused"`` +
   ``act_matmul_impl="fused"``, ``bench.py``'s ``b16_s1024_allfused``)
   runs like 6 with exactly 48 LN->matmul, 24 GELU->matmul, 24 flash
   forwards, 12 flash backwards and one LayerNorm forward and backward
   per step, beside 6's numbers; then its grouped-KV variant like 6b;
   [6b] also profiles one grouped step (the grouped flash backward's
   device time in a step);
   (6d) long-context grouped-KV training through the port's
   ``examples/train_gpt.py``: a handful of seeded TFRecord files of token
   rows are written with the port's writer under ``build/``, then the
   flagship with ``num_kv_heads=4`` at B1 x S16384 reads them through the
   FILES-mode pipeline and ``device_prefetch`` — a warm-up and 2 timed
   steps with exactly 24 flash forwards, 12 split dQ and 12 grouped split
   dK/dV backwards (the reference's plan rule sends this length to the
   split plan), no fused flash backward, 49 LayerNorm forwards and 25
   backwards per step, then one profiled step; (6e) the flagship MHA at
   B16 x S1024 like 6 under ``TFOS_TPU_FLASH_BWD=split`` (12 dQ + 12 dK/dV
   per step, no fused backward), beside 6's fused plan; (6f) the port's
   ``train_gpt`` at its default model flags (4 layers, d_model 256, 8
   heads: head_dim 32, seq 512, vocab 1024, batch 8) through its ``run``
   from seeded TFRecord files: finite losses and exactly 8 flash
   forwards, 4 fused flash backwards, 17 LayerNorm forwards and 9
   backwards per step; (6g) one request through ``ServingEngine`` at the
   JAX package's ``serve_gpt.py`` config (2 layers, 4 heads, 2 KV heads,
   d_model 128: head_dim 32), in bf16 with launch counts and in f32
   equal to ``greedy_generate_kv``;
7. training parity: one f32 step (TF32 off) of a 2-layer full-width model
   on 2 x 256 tokens, unfused and all-fused, and under the split plan MHA
   and grouped-KV, on the card with the kernels and on the CPU with the
   plain versions: the loss to 1e-4 relative, every gradient within 1e-3
   of its largest magnitude.

Phase 3 also holds the flash forward at the long-context shape B1 x
S16384 (Hk 4) against its plain version on three 512-row chunks (the
last included), and the split backward's dQ and dK/dV kernels against
their plain versions (each twice, bitwise) at 6's cases, a long grouped
window and the long-context shape, where they are also held against the
fused kernel and timed beside it; it ends with one line per redesigned
tensor-core kernel: ms, the factor over SDPA (forward), SDPA's whole
backward (the fused backward, dK/dV, dQ) or the ``F.gelu`` + matmul pair
(GELU->matmul), and the share of the bound. [3b] also runs the split
backward twice at each head dim and requires the same bits.

The last two lines of output are JSON: ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``. A copy of the measurements goes to
``chiprun_out/chip_smoke.json``.

``python3 chip_smoke.py --layer-norm-only`` runs phases 1, 2 and phase
3's LayerNorm forward and backward checks with their device times, and
prints them as one JSON line; like ``--serving-only``, a copy run from
another checkout's root measures that checkout's kernels.

``python3 chip_smoke.py --serving-only N`` runs phases 1, 2 and 4 alone:
the serving main path N times in one process, then the host time of one
flash-forward wrapper call at the prefill chunks' shapes and the wall time
of a 512-token prefill chunk; it prints them as one JSON line. A copy of
this script run from another checkout's root measures that checkout's
package the same way, so two trees can alternate in one chip call.
"""

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor cores
              "float32": 67e12}    # CUDA cores, no TF32
ELEMENTWISE_FLOPS = 67e12          # f32 arithmetic outside the tensor cores
LN_FLOPS_PER_ELEM = 8              # sum, centre, square, sum, scale x2, ...
LN_BWD_FLOPS_PER_ELEM = 20         # statistics, xhat, dy, two sums, dx, dw
SEED = 0


def log(*args):
  print(*args, flush=True)


def card_line():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      timeout=60, check=True)
  return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs=25, inner=10):
  """Median over ``runs`` CUDA-event windows of ``inner`` back-to-back
  calls, per call, after a warm-up."""
  import torch
  for _ in range(3):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(runs):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
      fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / inner)
  return statistics.median(times)


# -- phase 2: what the tensor-core kernels compiled to -----------------------

# (library, substring of the mangled name, what it is, instantiations): the
# bf16 kernels that run their products on the tensor cores, the flash
# kernels at a padded head width of 64 and 128, the GEMM with its GELU and
# its LayerNorm prologue
TENSOR_CORE_KERNELS = (
    ("flash_attention", "flash_fwd_kernel_wgmma", "flash forward bf16",
     ("64", "128")),
    ("flash_attention_bwd", "flash_bwd_kernel_wgmma", "fused backward bf16",
     ("64", "128")),
    ("flash_attention_bwd_split", "flash_bwd_dkv_kernel_wgmma",
     "split dK/dV bf16", ("64", "128")),
    ("flash_attention_bwd_split", "flash_bwd_dkv_gqa_kernel_wgmma",
     "split grouped dK/dV bf16", ("64", "128")),
    ("flash_attention_bwd_split", "flash_bwd_dq_kernel_wgmma",
     "split dQ bf16", ("64", "128")),
    ("act_matmul", "prologue_gemm_wgmma", "GELU->matmul bf16", ("kGelu",)),
    ("ln_matmul", "prologue_gemm_wgmma", "LN->matmul bf16", ("kLayerNorm",)))
SASS_OPS = ("HGMMA", "HMMA", "FFMA")


def _cuobjdump():
  found = shutil.which("cuobjdump")
  if found:
    return found
  nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
  return os.path.join(os.path.dirname(nvcc), "cuobjdump")


def _prologue(symbol):
  """The prologue a fused-product kernel's symbol (mangled, or demangled
  as the profiler names it) was instantiated for: "kGelu", "kLayerNorm",
  or None for a symbol that names neither (``Prologue`` is an enum:
  kLayerNorm is 0, kGelu 1)."""
  for name, code in (("kLayerNorm", "0"), ("kGelu", "1")):
    if name in symbol or "PrologueE" + code in symbol \
        or "Prologue)" + code in symbol:
      return name
  return None


def _instance(mangled):
  """The template argument a mangled tensor-core kernel was built for:
  its padded head width, or its GEMM prologue."""
  return _prologue(mangled) or ("128" if "ILi128E" in mangled else "64")


def _is(part, mangled):
  """``mangled`` is the kernel ``part`` names (the MHA dK/dV entry is a
  prefix of the grouped one's)."""
  return part in mangled and (part != "flash_bwd_dkv_kernel_wgmma"
                              or "gqa" not in mangled)


def sass_counts(_build):
  """HGMMA / HMMA / FFMA instructions in each tensor-core kernel's SASS
  (``cuobjdump -sass`` of the built library), one line per
  instantiation. Fails if one has no HGMMA: their products must run on
  wgmma."""
  out = {}
  for lib in sorted({k[0] for k in TENSOR_CORE_KERNELS}):
    text = subprocess.run(
        [_cuobjdump(), "-sass", str(_build.library_path(lib))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    func = None
    for line in text.splitlines():
      if "Function :" in line:
        func = line.split("Function :", 1)[1].strip()
        continue
      if func is None or "*/" not in line:
        continue
      ins = line.split("*/", 1)[1].strip()
      if ins.startswith("@"):
        ins = ins.split(None, 1)[1] if " " in ins else ""
      op = ins.split(" ", 1)[0].split(".", 1)[0]
      if op in SASS_OPS:
        slot = out.setdefault((lib, func), dict.fromkeys(SASS_OPS, 0))
        slot[op] += 1
  rows = []
  for lib, part, what, insts in TENSOR_CORE_KERNELS:
    funcs = sorted(f for (l, f) in out if l == lib and _is(part, f))
    if sorted(_instance(f) for f in funcs) != sorted(insts):
      raise AssertionError("%s (%s) in the SASS of %s: %s, want %s"
                           % (what, part, lib, [_instance(f) for f in funcs],
                              list(insts)))
    for f in funcs:
      c = out[(lib, f)]
      rows.append({"kernel": "%s<%s>" % (part, _instance(f)), "what": what,
                   **c})
      log("  sass %-36s HGMMA %4d  HMMA %4d  FFMA %5d"
          % (rows[-1]["kernel"], c["HGMMA"], c["HMMA"], c["FFMA"]))
      if c["HGMMA"] == 0:
        raise AssertionError("%s: no HGMMA in %s" % (what, f))
  return rows


def tensor_core_spills(build_log):
  """Spill bytes of each tensor-core kernel from the ptxas report; fails
  on any spill."""
  spills = {}
  for lib, part, what, _ in TENSOR_CORE_KERNELS:
    if lib not in build_log:
      log("  %s: loaded from an earlier build, no ptxas report" % lib)
      continue
    func = None
    for line in build_log[lib].splitlines():
      if "Function properties for" in line:
        func = line.split("Function properties for", 1)[1].strip()
      elif "spill stores" in line and func and _is(part, func):
        words = line.replace(",", " ").split()
        stores = int(words[words.index("spill") - 2])
        loads = int(words[words.index("loads") - 3])
        spills["%s<%s>" % (part, _instance(func))] = stores + loads
  log("  spill bytes of the tensor-core kernels: %s" % spills)
  want = sum(len(insts) for lib, _, _, insts in TENSOR_CORE_KERNELS
             if lib in build_log)
  if len(spills) < want:
    raise AssertionError("ptxas reported %d of the %d tensor-core kernels"
                         % (len(spills), want))
  bad = {k: v for k, v in spills.items() if v}
  if bad:
    raise AssertionError("tensor-core kernels spill registers: %s" % bad)
  return spills


# -- phase 3: kernels against their plain versions ---------------------------


# (rows, H, dtype, tol): rows 8 = one decode step of 8 slots, 512 = the
# largest prefill chunk, 16384 = the training batch; H 770 takes the
# kernel's unvectorised path, H 12288 and 9001 the block-per-row kernel
# (rows wider than 8192; 9001 also unvectorised).
# Tolerances: f32 sums in another order (1e-5); bf16 outputs may round
# one ulp apart (2e-2 at |y| <= 4).
LN_CASES = ((8, 768, "bfloat16", 2e-2), (512, 768, "bfloat16", 2e-2),
            (8, 768, "float32", 1e-5), (512, 768, "float32", 1e-5),
            (33, 770, "bfloat16", 2e-2), (16384, 768, "bfloat16", 2e-2),
            (256, 12288, "bfloat16", 2e-2), (64, 9001, "float32", 1e-5))
# (rows, H, dtype, tol): 16384 rows = the training batch B16 x S1024, and
# 16387 rows, not a multiple of the rows a block holds; H 770 takes the
# unvectorised path, H 12288 and 9001 the block-per-row kernel. dx: bf16
# output rounding (one ulp, 2^-8 relative) or f32 sums in another order;
# dw: f32 sums over the rows in another order in both dtypes.
LN_BWD_CASES = ((16384, 768, "bfloat16", 1e-2), (16384, 768, "float32", 1e-5),
                (16387, 768, "bfloat16", 1e-2), (33, 770, "bfloat16", 1e-2),
                (256, 12288, "bfloat16", 1e-2), (64, 9001, "float32", 1e-5))


def _ln_inputs(torch, cases, index, backward, device="cuda"):
  """x, w (and g for the backward) of ``cases[index]`` on ``device``, from
  a seed of their own."""
  rows, h, dt, _ = cases[index]
  dtype = getattr(torch, dt)
  g = torch.Generator(device=device).manual_seed(
      SEED + (40 if backward else 20) + index)
  x = (torch.randn(rows, h, device=device, generator=g) * 2 + 0.5).to(dtype)
  w = torch.rand(h, device=device, generator=g) + 0.5
  if not backward:
    return x, w
  return x, w, torch.randn(rows, h, device=device, generator=g).to(dtype)


def _ln_calls(ops, torch, F, index):
  """(kernel, plain version, yardstick) closures of LN_CASES[index]."""
  x, w = _ln_inputs(torch, LN_CASES, index, False)
  h, wl = x.shape[-1], w.to(x.dtype)
  return (lambda: ops.layer_norm(x, w),
          lambda: ops.layer_norm_reference(x, w),
          lambda: F.layer_norm(x, (h,), wl, None, 1e-6))


def _ln_bwd_calls(ops, torch, F, index):
  """(kernel, plain version, yardstick) closures of LN_BWD_CASES[index]:
  the yardstick is PyTorch's LayerNorm backward through autograd."""
  x, w, gy = _ln_inputs(torch, LN_BWD_CASES, index, True)
  xl = x.detach().clone().requires_grad_()
  wl = w.to(x.dtype).requires_grad_()
  yl = F.layer_norm(xl, (x.shape[-1],), wl, None, 1e-6)
  return (lambda: ops.layer_norm_bwd(x, w, gy),
          lambda: ops.layer_norm_bwd_reference(x, w, gy),
          lambda: torch.autograd.grad(yl, (xl, wl), gy, retain_graph=True))


def _bound(nbytes, flops):
  """(bound ms, what bounds it) of a kernel moving ``nbytes`` and doing
  ``flops`` f32 operations outside the tensor cores."""
  bound_b = nbytes / HBM_BYTES_PER_S * 1e3
  bound_o = flops / ELEMENTWISE_FLOPS * 1e3
  return max(bound_b, bound_o), "bytes" if bound_b >= bound_o else "operations"


def check_layer_norm(ops, torch, F):
  """The LayerNorm forward against its plain version at LN_CASES, timed
  by CUDA events beside ``F.layer_norm``; device times come later
  (:func:`layer_norm_device_ms`)."""
  rows_out, worst = [], 0.0
  for i, (rows, h, dt, tol) in enumerate(LN_CASES):
    fn, plain, lib = _ln_calls(ops, torch, F, i)
    got, want = fn(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
      raise AssertionError("layer_norm %s rows=%d H=%d: max abs err %.3g "
                           "over tol %g" % (dt, rows, h, err, tol))
    worst = max(worst, err)
    isz = got.element_size()
    bound, by = _bound(2 * rows * h * isz + h * 4,
                       LN_FLOPS_PER_ELEM * rows * h)
    row = {"rows": rows, "H": h, "dtype": dt, "max_abs_err": err,
           "ms": time_ms(fn), "plain_ms": time_ms(plain),
           "library_ms": time_ms(lib), "bound_ms": bound, "bound_by": by}
    rows_out.append(row)
    log("  layer_norm %-8s rows=%-4d H=%d err=%.3g ms=%.5f plain=%.5f "
        "lib=%.5f bound=%.5f" % (dt, rows, h, err, row["ms"],
                                 row["plain_ms"], row["library_ms"],
                                 row["bound_ms"]))
    del fn, plain, lib, got, want
  return rows_out, worst


def _visible_pairs(sq, sk, q_base, kv_base, window):
  """(q, k) pairs the causal (+ window) mask keeps: the work this run's
  inputs need."""
  total = 0
  for i in range(sq):
    qpos = q_base + i
    hi = min(sk, qpos - kv_base + 1)                  # keys with pos <= qpos
    lo = 0 if window is None else max(0, qpos - window + 1 - kv_base)
    total += max(0, hi - lo)
  return total


def check_flash(ops, torch, F):
  rows_out, worst = [], 0.0
  g = torch.Generator(device="cuda").manual_seed(SEED + 1)
  bf, f32 = torch.bfloat16, torch.float32
  # (name, B, Sq, Sk, H, Hk, D, q_base, kv_base, window, dtype): the
  # first prefill chunks of the main path (16/32/128/512), grouped KV, a window, a chunk at an
  # offset, rows that see no key, head_dim 128, and the f32 parity path
  cases = [("s16", 1, 16, 16, 12, 12, 64, 0, 0, None, bf),
           ("s32", 1, 32, 32, 12, 12, 64, 0, 0, None, bf),
           ("s128", 1, 128, 128, 12, 12, 64, 0, 0, None, bf),
           ("s512", 1, 512, 512, 12, 12, 64, 0, 0, None, bf),
           ("gqa_hk4", 1, 512, 512, 12, 4, 64, 0, 0, None, bf),
           ("window128", 1, 512, 512, 12, 12, 64, 0, 0, 128, bf),
           ("q_offset", 1, 256, 512, 12, 12, 64, 256, 0, None, bf),
           ("kv_ahead", 1, 128, 128, 12, 12, 64, 0, 64, None, bf),
           ("d128", 1, 256, 256, 6, 6, 128, 0, 0, None, bf),
           ("s512_f32", 1, 512, 512, 12, 12, 64, 0, 0, None, f32),
           ("train", 16, 1024, 1024, 12, 12, 64, 0, 0, None, bf)]
  for name, b, sq, sk, h, hk, d, qb, kb, win, dtype in cases:
    q = torch.randn(b, sq, h, d, device="cuda", generator=g).to(dtype)
    k = torch.randn(b, sk, hk, d, device="cuda", generator=g).to(dtype)
    v = torch.randn(b, sk, hk, d, device="cuda", generator=g).to(dtype)
    out, lse = ops.flash_attention_fwd(q, k, v, qb, kb, True, win)
    ro, rl = ops.flash_attention_reference(q, k, v, qb, kb, True, win)
    torch.cuda.synchronize()
    # bf16: outputs round to bf16 (one ulp ~ 8e-3 at |o| ~ 1); lse is f32
    # from identical inputs. f32: summation order only.
    otol, ltol = (2e-2, 1e-4) if dtype == bf else (2e-5, 2e-5)
    err = (out.float() - ro.float()).abs().max().item()
    lerr = (lse - rl).abs().max().item()
    if not (torch.allclose(out.float(), ro.float(), atol=otol, rtol=otol)
            and torch.allclose(lse, rl, atol=ltol, rtol=ltol)):
      raise AssertionError("flash %s: out err %.3g (tol %g), lse err %.3g "
                           "(tol %g)" % (name, err, otol, lerr, ltol))
    if name == "kv_ahead":
      dead = kb - qb
      if not ((lse[:, :, :dead] == -1e30).all()
              and (out[:, :dead] == 0).all()):
        raise AssertionError("flash kv_ahead: rows with no visible key must "
                             "give lse -1e30 and out 0")
    worst = max(worst, err, lerr)
    dt = "bfloat16" if dtype == bf else "float32"
    pairs = b * h * _visible_pairs(sq, sk, qb, kb, win)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + lse.numel() * 4
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_o = 4.0 * pairs * d / PEAK_FLOPS[dt] * 1e3
    lib = None
    if qb == 0 and kb == 0 and win is None and sq == sk:
      # the yardstick gets K/V already expanded to the query heads
      qt = q.transpose(1, 2)
      kt, vt = (t.repeat_interleave(h // hk, dim=2).transpose(1, 2)
                for t in (k, v))
      lib = time_ms(lambda: F.scaled_dot_product_attention(
          qt, kt, vt, is_causal=True), runs=7 if b > 1 else 25)
    row = {"case": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "Hk": hk, "D": d,
           "q_base": qb, "kv_base": kb, "window": win, "dtype": dt,
           "max_abs_err": max(err, lerr),
           "ms": time_ms(lambda: ops.flash_attention_fwd(q, k, v, qb, kb,
                                                         True, win)),
           "plain_ms": time_ms(lambda: ops.flash_attention_reference(
               q, k, v, qb, kb, True, win), runs=5 if b > 1 else 25,
                               inner=2 if b > 1 else 10),
           "library_ms": lib, "bound_ms": max(bound_b, bound_o),
           "bound_by": "bytes" if bound_b >= bound_o else "operations"}
    rows_out.append(row)
    log("  flash %-9s Sq=%-3d Sk=%-3d H=%-2d Hk=%-2d D=%-3d err=%.3g "
        "ms=%.4f plain=%.4f lib=%s bound=%.5f" % (
            name, sq, sk, h, hk, d, max(err, lerr), row["ms"],
            row["plain_ms"], "-" if lib is None else "%.4f" % lib,
            row["bound_ms"]))
  row = check_flash_long(ops, torch, F, g)
  rows_out.append(row)
  worst = max(worst, row["max_abs_err"])
  return rows_out, worst


# query-row chunks of the long case held against the plain version: the
# first, one in the middle and the last (the plain version is dense, a
# [B, H, Sq, Sk] f32 tensor: ~13 GB for the whole long case)
LONG_CHUNK = 512
# the long case's out error over the largest |out| of its chunk
LONG_OUT_REL = 1e-2


def check_flash_long(ops, torch, F, g):
  """The forward at the long-context training shape (B1 S16384 H12 Hk4
  D64 bf16): the kernel's rows [i0, i0 + 512) against the plain version of
  those rows (its own ``q_base``) for three chunks, the last included;
  times beside SDPA on K/V expanded to the query heads."""
  b, s, h, hk, d = LONG_B, LONG_S, 12, 4, 64
  bf = torch.bfloat16
  q = torch.randn(b, s, h, d, device="cuda", generator=g).to(bf)
  k = torch.randn(b, s, hk, d, device="cuda", generator=g).to(bf)
  v = torch.randn(b, s, hk, d, device="cuda", generator=g).to(bf)
  out, lse = ops.flash_attention_fwd(q, k, v, 0, 0, True, None)
  err, rel = 0.0, []
  chunks = (0, s // 2, s - LONG_CHUNK)
  for i0 in chunks:
    i1 = i0 + LONG_CHUNK
    ro, rl = ops.flash_attention_reference(q[:, i0:i1], k, v, q_base=i0)
    got, glse = out[:, i0:i1], lse[:, :, i0:i1]
    torch.cuda.synchronize()
    oerr = (got.float() - ro.float()).abs().max().item()
    lerr = (glse - rl).abs().max().item()
    # a row that sees n keys averages n random V rows: |out| ~ sqrt(e / n),
    # ~0.013 in the last chunk, under the flat 2e-2; so out is also held to
    # 1e-2 of the chunk's own largest |out| (bf16 rounds it to 2^-9)
    scale = ro.float().abs().max().item()
    rel.append(oerr / scale)
    if not (torch.allclose(got.float(), ro.float(), atol=2e-2, rtol=2e-2)
            and oerr <= LONG_OUT_REL * scale
            and torch.allclose(glse, rl, atol=1e-4, rtol=1e-4)):
      raise AssertionError(
          "flash long rows [%d, %d): out err %.3g (tol 2e-2 and %g x max "
          "|out| %.3g), lse err %.3g (tol 1e-4)"
          % (i0, i1, oerr, LONG_OUT_REL, scale, lerr))
    err = max(err, oerr, lerr)
  pairs = b * h * _visible_pairs(s, s, 0, 0, None)
  nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + lse.numel() * 4
  bound_b = nbytes / HBM_BYTES_PER_S * 1e3
  bound_o = 4.0 * pairs * d / PEAK_FLOPS["bfloat16"] * 1e3
  qt = q.transpose(1, 2)
  kt, vt = (t.repeat_interleave(h // hk, dim=2).transpose(1, 2)
            for t in (k, v))
  lib = time_ms(lambda: F.scaled_dot_product_attention(
      qt, kt, vt, is_causal=True), runs=5, inner=3)
  del qt, kt, vt
  row = {"case": "long", "B": b, "Sq": s, "Sk": s, "H": h, "Hk": hk, "D": d,
         "q_base": 0, "kv_base": 0, "window": None, "dtype": "bfloat16",
         "max_abs_err": err, "checked_rows": [[i0, i0 + LONG_CHUNK]
                                              for i0 in chunks],
         "out_err_over_max_out": rel,
         "ms": time_ms(lambda: ops.flash_attention_fwd(q, k, v, 0, 0, True,
                                                       None), runs=5, inner=3),
         # the plain version over one chunk of rows, times the chunks
         "plain_ms": time_ms(lambda: ops.flash_attention_reference(
             q[:, :LONG_CHUNK], k, v, q_base=0), runs=3, inner=1)
         * (s // LONG_CHUNK),
         "plain": "one %d-row chunk x %d" % (LONG_CHUNK, s // LONG_CHUNK),
         "library_ms": lib, "bound_ms": max(bound_b, bound_o),
         "bound_by": "bytes" if bound_b >= bound_o else "operations"}
  log("  flash long      B=%d S=%d H=%d Hk=%d D=%d err=%.3g (rows %s; out "
      "err / max |out| %s) ms=%.4f plain~%.2f lib=%.4f bound=%.5f" % (
          b, s, h, hk, d, err, row["checked_rows"],
          ", ".join("%.3g" % x for x in rel), row["ms"], row["plain_ms"],
          lib, row["bound_ms"]))
  del q, k, v, out, lse
  torch.cuda.empty_cache()
  return row


def _rel_check(what, got, want, tol):
  """Max |got - want| (f32), raising when it exceeds ``tol`` times the
  largest |want|: gradients sum many terms, so the tolerance scales with
  the tensor's own size."""
  err = (got.float() - want.float()).abs().max().item()
  scale = max(want.float().abs().max().item(), 1e-30)
  if err > tol * scale:
    raise AssertionError("%s: max abs err %.3g over %g x max |ref| %.3g"
                         % (what, err, tol, scale))
  return err


def check_layer_norm_bwd(ops, torch, F):
  """The LayerNorm backward against its plain version at LN_BWD_CASES,
  twice and bitwise equal, timed by CUDA events beside PyTorch's LayerNorm
  backward; device times come later (:func:`layer_norm_device_ms`)."""
  rows_out, worst = [], 0.0
  for i, (rows, h, dt, tol) in enumerate(LN_BWD_CASES):
    fn, plain, lib = _ln_bwd_calls(ops, torch, F, i)
    (dx, dw), (rdx, rdw) = fn(), plain()
    torch.cuda.synchronize()
    err = max(_rel_check("layer_norm_bwd dx %s rows=%d H=%d" % (dt, rows, h),
                         dx, rdx, tol),
              _rel_check("layer_norm_bwd dw %s rows=%d H=%d" % (dt, rows, h),
                         dw, rdw, 1e-5))
    dx2, dw2 = fn()
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
      raise AssertionError("layer_norm_bwd rows=%d H=%d: two runs differ"
                           % (rows, h))
    worst = max(worst, err)
    isz = dx.element_size()
    bound, by = _bound(3 * rows * h * isz + 2 * h * 4,    # x, g, dx; w, dw
                       LN_BWD_FLOPS_PER_ELEM * rows * h)
    row = {"rows": rows, "H": h, "dtype": dt, "max_abs_err": err,
           "ms": time_ms(fn), "plain_ms": time_ms(plain, runs=10),
           "library_ms": time_ms(lib), "bound_ms": bound, "bound_by": by}
    rows_out.append(row)
    log("  layer_norm_bwd %-8s rows=%-5d H=%d err=%.3g ms=%.5f plain=%.5f "
        "lib=%.5f bound=%.5f deterministic" % (
            dt, rows, h, err, row["ms"], row["plain_ms"], row["library_ms"],
            row["bound_ms"]))
    del fn, plain, lib, dx, dw, rdx, rdw, dx2, dw2
  return rows_out, worst


def layer_norm_device_ms(ops, torch, F, ln_rows, lnb_rows):
  """The device time per call of each LayerNorm case, the port's kernels
  (the backward split by kernel: pass 1 and pass 2) and the yardstick's,
  from torch.profiler, into the rows of :func:`check_layer_norm` and
  :func:`check_layer_norm_bwd`; and the host's share of the CUDA-event
  time (``ms`` over ``device_ms``). Like :func:`fused_device_ms`, run
  after the serving phases."""
  for what, rows_out, calls in (("layer_norm", ln_rows, _ln_calls),
                                ("layer_norm_bwd", lnb_rows, _ln_bwd_calls)):
    for i, row in enumerate(rows_out):
      fn, _, lib = calls(ops, torch, F, i)
      per = {}
      row["device_ms"] = device_ms(torch, fn, per_kernel=per)
      row["device_ms_by_kernel"] = {k.split("(")[0][:80]: v
                                    for k, v in per.items()}
      row["library_device_ms"] = device_ms(torch, lib)
      del fn, lib
      if row["device_ms"] is None:
        log("  %s %s rows=%d H=%d: device time not measured (the profiler "
            "recorded no kernel in 3 sessions)" % (what, row["dtype"],
                                                  row["rows"], row["H"]))
        continue
      log("  %s %-8s rows=%-5d H=%-5d device=%.5f ms (events %.5f, %.0f%% "
          "of bound) lib device=%s | %s" % (
              what, row["dtype"], row["rows"], row["H"], row["device_ms"],
              row["ms"], 100.0 * row["bound_ms"] / row["device_ms"],
              "%.5f" % row["library_device_ms"]
              if row["library_device_ms"] is not None else "not measured",
              ", ".join("%s %.5f" % kv for kv in
                        row["device_ms_by_kernel"].items())))


def check_flash_bwd(ops, torch, F):
  rows_out, worst = [], 0.0
  g = torch.Generator(device="cuda").manual_seed(SEED + 6)
  bf, f32 = torch.bfloat16, torch.float32
  # (name, B, Sq, Sk, H, Hk, D, q_base, kv_base, window, lse cotangent,
  # dtype): the training shape (B16 S1024, 12 heads), the GQA training
  # shape (B8, Hk 4), a window, an offset block with an lse cotangent,
  # rows that see no key, head_dim 128, and f32
  cases = [("train", 16, 1024, 1024, 12, 12, 64, 0, 0, None, False, bf),
           ("gqa_hk4", 8, 1024, 1024, 12, 4, 64, 0, 0, None, False, bf),
           ("window128", 4, 1024, 1024, 12, 12, 64, 0, 0, 128, False, bf),
           ("offset_lse", 2, 512, 1024, 12, 4, 64, 512, 0, None, True, bf),
           ("kv_ahead", 2, 256, 256, 12, 12, 64, 0, 64, None, True, bf),
           ("d128", 2, 512, 512, 6, 6, 128, 0, 0, None, False, bf),
           ("train_f32", 4, 1024, 1024, 12, 12, 64, 0, 0, None, False, f32)]
  for name, b, sq, sk, h, hk, d, qb, kb, win, with_lse, dtype in cases:
    mk = lambda *shape: torch.randn(*shape, device="cuda",  # noqa: E731
                                    generator=g).to(dtype)
    q, k, v = mk(b, sq, h, d), mk(b, sk, hk, d), mk(b, sk, hk, d)
    go = mk(b, sq, h, d)
    out, lse = ops.flash_attention_fwd(q, k, v, qb, kb, True, win)
    gl = None
    if with_lse:
      gl = torch.randn(b, h, sq, device="cuda", generator=g)
      gl = torch.where(lse <= -1e29, 0.0, gl)
    got = ops.flash_attention_bwd(q, k, v, out, lse, go, gl, qb, kb, True, win)
    want = ops.flash_attention_bwd_reference(q, k, v, out, lse, go, gl, qb, kb,
                                             True, win)
    torch.cuda.synchronize()
    # bf16: outputs round to bf16 (2^-8 relative); f32: sums over up to
    # 1024 rows or keys in another order
    tol = 1e-2 if dtype == bf else 1e-4
    err = max(_rel_check("flash_bwd %s d%s" % (name, t), a, r, tol)
              for t, a, r in zip("qkv", got, want))
    again = ops.flash_attention_bwd(q, k, v, out, lse, go, gl, qb, kb, True,
                                    win)
    if not all(torch.equal(a, r) for a, r in zip(got, again)):
      raise AssertionError("flash_bwd %s: two runs differ" % name)
    if name == "kv_ahead" and not (got[0][:, :kb - qb] == 0).all():
      raise AssertionError("flash_bwd kv_ahead: rows with no visible key "
                           "must get dq 0")
    worst = max(worst, err)
    dt = "bfloat16" if dtype == bf else "float32"
    pairs = b * h * _visible_pairs(sq, sk, qb, kb, win)
    isz = q.element_size()
    nbytes = (3 * q.numel() + 2 * k.numel()) * isz \
        + (2 if with_lse else 1) * lse.numel() * 4 \
        + (q.numel() + 2 * k.numel()) * isz     # dq, dk, dv
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_o = 10.0 * pairs * d / PEAK_FLOPS[dt] * 1e3
    lib = None
    if qb == 0 and kb == 0 and win is None and sq == sk:
      # the yardstick: SDPA's backward alone, K/V expanded to the heads
      qt = q.transpose(1, 2).detach().requires_grad_()
      kt, vt = (t.repeat_interleave(h // hk, dim=2).transpose(1, 2)
                .detach().requires_grad_() for t in (k, v))
      ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
      gt = go.transpose(1, 2)
      lib = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), gt,
                                                retain_graph=True),
                    runs=7, inner=3)
    row = {"case": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "Hk": hk, "D": d,
           "q_base": qb, "kv_base": kb, "window": win, "lse_cotangent":
           with_lse, "dtype": dt, "max_abs_err": err,
           "ms": time_ms(lambda: ops.flash_attention_bwd(
               q, k, v, out, lse, go, gl, qb, kb, True, win), runs=7, inner=3),
           "plain_ms": time_ms(lambda: ops.flash_attention_bwd_reference(
               q, k, v, out, lse, go, gl, qb, kb, True, win), runs=3, inner=2),
           "library_ms": lib, "bound_ms": max(bound_b, bound_o),
           "bound_by": "bytes" if bound_b >= bound_o else "operations"}
    rows_out.append(row)
    log("  flash_bwd %-10s B=%-2d Sq=%-4d Sk=%-4d H=%-2d Hk=%-2d D=%-3d "
        "err=%.3g ms=%.4f plain=%.4f lib=%s bound=%.5f deterministic" % (
            name, b, sq, sk, h, hk, d, err, row["ms"], row["plain_ms"],
            "-" if lib is None else "%.4f" % lib, row["bound_ms"]))
    del q, k, v, go, out, lse, got, want, again
  return rows_out, worst


def check_flash_bwd_split(ops, torch, F):
  """The split backward's dQ and dK/dV kernels against their plain
  versions, twice each (bitwise), and against the fused kernel, with
  times. Returns one row per (case, kernel)."""
  fa = sys.modules["tensorflowonspark_tpu_torch.ops.flash_attention"]
  rows_out, worst = [], {"dq": 0.0, "dkv": 0.0}
  g = torch.Generator(device="cuda").manual_seed(SEED + 7)
  bf, f32 = torch.bfloat16, torch.float32
  # check_flash_bwd's cases, a long grouped window (the reference's own
  # gate case, tools/mosaic_gate.py:159) and the long-context training
  # shape, where the reference's plan rule takes the split plan
  cases = [("train", 16, 1024, 1024, 12, 12, 64, 0, 0, None, False, bf),
           ("gqa_hk4", 8, 1024, 1024, 12, 4, 64, 0, 0, None, False, bf),
           ("window128", 4, 1024, 1024, 12, 12, 64, 0, 0, 128, False, bf),
           ("offset_lse", 2, 512, 1024, 12, 4, 64, 512, 0, None, True, bf),
           ("kv_ahead", 2, 256, 256, 12, 12, 64, 0, 64, None, True, bf),
           ("d128", 2, 512, 512, 6, 6, 128, 0, 0, None, False, bf),
           ("train_f32", 4, 1024, 1024, 12, 12, 64, 0, 0, None, False, f32),
           ("gqa_long_window", 1, 4096, 4096, 12, 4, 64, 0, 0, 1024, False,
            bf),
           ("long", LONG_B, LONG_S, LONG_S, 12, 4, 64, 0, 0, None, False, bf)]
  for name, b, sq, sk, h, hk, d, qb, kb, win, with_lse, dtype in cases:
    long = name == "long"
    mk = lambda *shape: torch.randn(*shape, device="cuda",  # noqa: E731
                                    generator=g).to(dtype)
    q, k, v = mk(b, sq, h, d), mk(b, sk, hk, d), mk(b, sk, hk, d)
    go = mk(b, sq, h, d)
    out, lse = ops.flash_attention_fwd(q, k, v, qb, kb, True, win)
    gl = None
    if with_lse:
      gl = torch.randn(b, h, sq, device="cuda", generator=g)
      gl = torch.where(lse <= -1e29, 0.0, gl)
    args = (q, k, v, out, lse, go, gl, qb, kb, True, win)
    got = ops.flash_attention_bwd(*args, bwd="split")
    again = ops.flash_attention_bwd(*args, bwd="split")
    fused = fa._fused_bwd(*args)
    delta = fa._bwd_delta(out, go, gl)
    plain_dq = ops.flash_attention_bwd_dq_reference(q, k, v, go, lse, delta,
                                                    qb, kb, True, win)
    plain_dkv = ops.flash_attention_bwd_dkv_reference(q, k, v, go, lse,
                                                      delta, qb, kb, True, win)
    torch.cuda.synchronize()
    if not all(torch.equal(a, r) for a, r in zip(got, again)):
      raise AssertionError("flash_bwd_split %s: two runs differ" % name)
    # bf16: outputs round to bf16 (2^-8 relative); f32: sums over up to
    # 16384 rows or keys in another order
    tol = 1e-2 if dtype == bf else 1e-4
    err = {"dq": _rel_check("flash_bwd_split %s dq" % name, got[0],
                            plain_dq, tol),
           "dkv": max(_rel_check("flash_bwd_split %s d%s" % (name, t), a, r,
                                 tol)
                      for t, a, r in zip("kv", got[1:], plain_dkv))}
    fused_err = max(_rel_check("flash_bwd_split %s d%s vs fused" % (name, t),
                               a, r, tol)
                    for t, a, r in zip("qkv", got, fused))
    if name == "kv_ahead" and not (got[0][:, :kb - qb] == 0).all():
      raise AssertionError("flash_bwd_split kv_ahead: rows with no visible "
                           "key must get dq 0")
    for kern in err:
      worst[kern] = max(worst[kern], err[kern])
    dt = "bfloat16" if dtype == bf else "float32"
    pairs = b * h * _visible_pairs(sq, sk, qb, kb, win)
    isz = q.element_size()
    # each kernel reads q, dO, k, v once and lse, Delta (f32) once
    read = (2 * q.numel() + 2 * k.numel()) * isz + 2 * lse.numel() * 4
    written = {"dq": q.numel() * isz, "dkv": 2 * k.numel() * isz}
    flops = {"dq": 6.0 * pairs * d, "dkv": 8.0 * pairs * d}
    runs, inner, plain_runs = (3, 1, 1) if long else (7, 3, 3)
    lib = None
    if qb == 0 and kb == 0 and win is None and sq == sk:
      # SDPA's backward computes (dQ, dK, dV) together, K/V expanded
      qt = q.transpose(1, 2).detach().requires_grad_()
      kt, vt = (t.repeat_interleave(h // hk, dim=2).transpose(1, 2)
                .detach().requires_grad_() for t in (k, v))
      ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
      gt = go.transpose(1, 2)
      lib = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), gt,
                                                retain_graph=True),
                    runs=runs, inner=inner)
      del qt, kt, vt, ot, gt
    ms = {"dq": time_ms(lambda: ops.flash_attention_bwd_dq(
              q, k, v, go, lse, delta, qb, kb, True, win), runs=runs,
                        inner=inner),
          "dkv": time_ms(lambda: ops.flash_attention_bwd_dkv(
              q, k, v, go, lse, delta, qb, kb, True, win), runs=runs,
                         inner=inner)}
    plain_ms = {"dq": time_ms(lambda: ops.flash_attention_bwd_dq_reference(
                    q, k, v, go, lse, delta, qb, kb, True, win),
                              runs=plain_runs, inner=1),
                "dkv": time_ms(lambda: ops.flash_attention_bwd_dkv_reference(
                    q, k, v, go, lse, delta, qb, kb, True, win),
                               runs=plain_runs, inner=1)}
    # the fused kernel on the same inputs (one CTA per query head: ~0.5 s
    # a call at the long shape, so few repeats there)
    fused_ms = time_ms(lambda: fa._fused_bwd(*args), runs=2 if long else runs,
                       inner=1 if long else inner)
    # the fused kernel's bound on the same inputs: 5 products per pair, q,
    # dO, k, v, lse, Delta read and dq, dk, dv written once
    fused_bound = max((read + written["dq"] + written["dkv"])
                      / HBM_BYTES_PER_S,
                      10.0 * pairs * d / PEAK_FLOPS[dt]) * 1e3
    for kern in ("dq", "dkv"):
      bound_b = (read + written[kern]) / HBM_BYTES_PER_S * 1e3
      bound_o = flops[kern] / PEAK_FLOPS[dt] * 1e3
      rows_out.append({
          "case": name, "kernel": kern, "B": b, "Sq": sq, "Sk": sk, "H": h,
          "Hk": hk, "D": d, "q_base": qb, "kv_base": kb, "window": win,
          "lse_cotangent": with_lse, "dtype": dt, "max_abs_err": err[kern],
          "vs_fused_max_rel_err": fused_err, "ms": ms[kern],
          "plain_ms": plain_ms[kern], "bound_ms": max(bound_b, bound_o),
          "bound_by": "bytes" if bound_b >= bound_o else "operations",
          "library_ms": None, "library_whole_bwd_ms": lib,
          "library": "none computes %s alone; SDPA's backward computes "
                     "(dQ, dK, dV) together (library_whole_bwd_ms, beside "
                     "split_pair_ms)" % ("dQ" if kern == "dq" else "dK/dV"),
          "split_pair_ms": ms["dq"] + ms["dkv"], "fused_ms": fused_ms,
          "fused_bound_ms": fused_bound})
    log("  flash_bwd_split %-15s B=%-2d Sq=%-5d H=%-2d Hk=%-2d D=%-3d err "
        "dq %.3g dkv %.3g (vs fused %.3g) ms dq %.4f dkv %.4f = %.4f, fused "
        "%.4f, plain %.3f+%.3f, SDPA bwd %s, bound %.5f+%.5f deterministic"
        % (name, b, sq, h, hk, d, err["dq"], err["dkv"], fused_err, ms["dq"],
           ms["dkv"], ms["dq"] + ms["dkv"], fused_ms, plain_ms["dq"],
           plain_ms["dkv"], "-" if lib is None else "%.4f" % lib,
           rows_out[-2]["bound_ms"], rows_out[-1]["bound_ms"]))
    del q, k, v, go, out, lse, got, again, fused, delta, plain_dq, plain_dkv
    torch.cuda.empty_cache()
  return rows_out, worst


# (name, B, Sq, Sk, H, Hk, D, q_base, kv_base, window, dtype): head dims
# the kernels pad inside (32 in a 64-wide tile, 96 in a 128-wide one):
# train_gpt's defaults (d_model 256, 8 heads, seq 512, batch 8), a grouped
# window, a wider model's 96, a ragged offset block (Sq != Sk), and f32
HEAD_DIM_CASES = (
    ("d32_train_gpt", 8, 512, 512, 8, 8, 32, 0, 0, None, "bfloat16"),
    ("d32_gqa_window", 2, 1024, 1024, 8, 2, 32, 0, 0, 256, "bfloat16"),
    ("d96", 4, 1024, 1024, 8, 8, 96, 0, 0, None, "bfloat16"),
    ("d96_gqa_ragged", 2, 300, 700, 8, 4, 96, 400, 0, None, "bfloat16"),
    ("d32_f32", 2, 256, 256, 4, 2, 32, 0, 0, None, "float32"),
    ("d96_f32", 2, 256, 300, 4, 4, 96, 44, 0, 64, "float32"))


def check_head_dims(ops, torch, F):
  """The forward, the fused backward (twice, bitwise) and the split
  backward at head_dim 32 and 96 against their plain versions (the
  backward plans also against each other), timed beside SDPA's forward
  and backward where SDPA computes the same function."""
  rows_out, worst = [], {"fwd": 0.0, "bwd": 0.0, "split": 0.0}
  g = torch.Generator(device="cuda").manual_seed(SEED + 12)
  for name, b, sq, sk, h, hk, d, qb, kb, win, dt in HEAD_DIM_CASES:
    dtype = getattr(torch, dt)
    mk = lambda *shape: torch.randn(*shape, device="cuda",  # noqa: E731
                                    generator=g).to(dtype)
    q, k, v, go = mk(b, sq, h, d), mk(b, sk, hk, d), mk(b, sk, hk, d), \
        mk(b, sq, h, d)
    out, lse = ops.flash_attention_fwd(q, k, v, qb, kb, True, win)
    ro, rl = ops.flash_attention_reference(q, k, v, qb, kb, True, win)
    args = (q, k, v, out, lse, go, None, qb, kb, True, win)
    fused = ops.flash_attention_bwd(*args, bwd="fused")
    again = ops.flash_attention_bwd(*args, bwd="fused")
    split = ops.flash_attention_bwd(*args, bwd="split")
    split_again = ops.flash_attention_bwd(*args, bwd="split")
    want = ops.flash_attention_bwd_reference(*args)
    torch.cuda.synchronize()
    bf = dt == "bfloat16"
    otol, ltol = (2e-2, 1e-4) if bf else (2e-5, 2e-5)
    ferr = (out.float() - ro.float()).abs().max().item()
    lerr = (lse - rl).abs().max().item()
    if not (torch.allclose(out.float(), ro.float(), atol=otol, rtol=otol)
            and torch.allclose(lse, rl, atol=ltol, rtol=ltol)):
      raise AssertionError("head_dim %s forward: out err %.3g (tol %g), lse "
                           "err %.3g (tol %g)" % (name, ferr, otol, lerr,
                                                  ltol))
    if not all(torch.equal(x, y) for x, y in zip(fused, again)):
      raise AssertionError("head_dim %s fused backward: two runs differ"
                           % name)
    if not all(torch.equal(x, y) for x, y in zip(split, split_again)):
      raise AssertionError("head_dim %s split backward: two runs differ"
                           % name)
    # bf16: outputs round to bf16 (2^-8 relative); f32: sums in another order
    tol = 1e-2 if bf else 1e-4
    berr = max(_rel_check("head_dim %s fused d%s" % (name, t), x, r, tol)
               for t, x, r in zip("qkv", fused, want))
    serr = max(max(_rel_check("head_dim %s split d%s" % (name, t), x, r,
                              tol),
                   _rel_check("head_dim %s split d%s vs fused" % (name, t),
                              x, f, tol))
               for t, x, r, f in zip("qkv", split, want, fused))
    worst["fwd"] = max(worst["fwd"], ferr, lerr)
    worst["bwd"] = max(worst["bwd"], berr)
    worst["split"] = max(worst["split"], serr)
    pairs = b * h * _visible_pairs(sq, sk, qb, kb, win)
    isz = q.element_size()
    fwd_bytes = (2 * q.numel() + k.numel() + v.numel()) * isz + lse.numel() * 4
    bwd_bytes = (5 * q.numel() + 4 * k.numel()) * isz + lse.numel() * 4
    fwd_bound = max(fwd_bytes / HBM_BYTES_PER_S,
                    4.0 * pairs * d / PEAK_FLOPS[dt]) * 1e3
    bwd_bound = max(bwd_bytes / HBM_BYTES_PER_S,
                    10.0 * pairs * d / PEAK_FLOPS[dt]) * 1e3
    lib_fwd = lib_bwd = None
    if qb == 0 and kb == 0 and win is None and sq == sk:
      qt = q.transpose(1, 2).detach().requires_grad_()
      kt, vt = (t.repeat_interleave(h // hk, dim=2).transpose(1, 2)
                .detach().requires_grad_() for t in (k, v))
      lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
          qt, kt, vt, is_causal=True), runs=7, inner=3)
      ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
      gt = go.transpose(1, 2)
      lib_bwd = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), gt,
                                                    retain_graph=True),
                        runs=7, inner=3)
      del qt, kt, vt, ot, gt
    row = {"case": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "Hk": hk, "D": d,
           "q_base": qb, "kv_base": kb, "window": win, "dtype": dt,
           "fwd_max_abs_err": max(ferr, lerr), "bwd_max_abs_err": berr,
           "split_max_abs_err": serr,
           "fwd_ms": time_ms(lambda: ops.flash_attention_fwd(
               q, k, v, qb, kb, True, win), runs=7, inner=3),
           "fused_bwd_ms": time_ms(lambda: ops.flash_attention_bwd(
               *args, bwd="fused"), runs=7, inner=3),
           "split_bwd_ms": time_ms(lambda: ops.flash_attention_bwd(
               *args, bwd="split"), runs=7, inner=3),
           "plain_fwd_ms": time_ms(lambda: ops.flash_attention_reference(
               q, k, v, qb, kb, True, win), runs=3, inner=1),
           "plain_bwd_ms": time_ms(lambda: ops.flash_attention_bwd_reference(
               *args), runs=3, inner=1),
           "fwd_bound_ms": fwd_bound, "bwd_bound_ms": bwd_bound,
           "library_fwd_ms": lib_fwd, "library_bwd_ms": lib_bwd}
    rows_out.append(row)
    log("  head_dim %-15s B=%d Sq=%-4d Sk=%-4d H=%d Hk=%d D=%-3d %s err fwd "
        "%.3g fused %.3g split %.3g; ms fwd %.4f fused %.4f split %.4f "
        "(SDPA fwd %s bwd %s; bound fwd %.5f bwd %.5f) deterministic"
        % (name, b, sq, sk, h, hk, d, dt, max(ferr, lerr), berr, serr,
           row["fwd_ms"], row["fused_bwd_ms"], row["split_bwd_ms"],
           "-" if lib_fwd is None else "%.4f" % lib_fwd,
           "-" if lib_bwd is None else "%.4f" % lib_bwd, fwd_bound,
           bwd_bound))
    del q, k, v, go, out, lse, ro, rl, fused, again, split, split_again, want
  torch.cuda.empty_cache()
  return rows_out, worst


def pick(table, **kw):
  """The row of ``table`` whose fields equal ``kw``."""
  return next(r for r in table if all(r[k] == v for k, v in kw.items()))


def device_ms(torch, fn, calls=5, per_kernel=None):
  """Device time per call of ``fn`` (every kernel it launches), from
  torch.profiler over ``calls`` calls after a warm-up; each kernel's name
  and device ms per call go into the dict ``per_kernel`` when one is
  given. A session in which the profiler records no kernel at all (it
  sometimes drops a short session's device activity) is taken again, up
  to 3 times; None if none recorded one."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  for _ in range(3):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      for _ in range(calls):
        fn()
      torch.cuda.synchronize()
    rows = _kernel_rows(torch, prof)
    total = sum(r[1] for r in rows)
    if total > 0:
      if per_kernel is not None:
        per_kernel.update((r[0], r[1] / calls) for r in rows)
      return total / calls
  return None


# (op, case, rows, K, N, dtype): the training shapes (B16 x S1024 rows:
# fused QKV 768 -> 2304, its grouped width 1280, MLP up 768 -> 3072, down
# 3072 -> 768), train_gpt's (4096 rows, d_model 256: QKV 768, up 1024), f32
# at the parity phase's rows, and ragged rows into N 1280 plus ragged
# rows/K/N against the 128 x 256 x 64 tiles, rows whose mean is large
# against their spread (x = 100 + N(0, 1): a prologue that drops the
# centred subtraction loses their digits), K 64 (one K step: the time a
# CTA spends outside its K loop, filling the ring and writing its tile),
# and K and N that are not multiples of 8 (rows off a 16-byte boundary:
# element loads)
FUSED_CASES = (("ln_matmul", "qkv", 16384, 768, 2304, "bfloat16"),
               ("ln_matmul", "qkv_gqa", 16384, 768, 1280, "bfloat16"),
               ("ln_matmul", "up", 16384, 768, 3072, "bfloat16"),
               ("ln_matmul", "gpt_up", 4096, 256, 1024, "bfloat16"),
               ("ln_matmul", "qkv_f32", 512, 768, 2304, "float32"),
               ("ln_matmul", "ragged33", 33, 768, 1280, "bfloat16"),
               ("ln_matmul", "ragged_kn", 100, 776, 200, "bfloat16"),
               ("ln_matmul", "large_mean", 512, 768, 2304, "bfloat16"),
               ("ln_matmul", "k64", 16384, 64, 2304, "bfloat16"),
               ("gelu_matmul", "down", 16384, 3072, 768, "bfloat16"),
               ("gelu_matmul", "down_f32", 512, 3072, 768, "float32"),
               ("gelu_matmul", "ragged33", 33, 768, 1280, "bfloat16"),
               ("gelu_matmul", "ragged_kn", 100, 776, 200, "bfloat16"),
               ("ln_matmul", "k_n_odd", 100, 771, 203, "bfloat16"),
               ("gelu_matmul", "k_n_odd", 100, 771, 203, "bfloat16"),
               ("ln_matmul", "k_n_odd_f32", 33, 301, 131, "float32"))


def _fused_calls(ops, torch, F, index):
  """(kernel, plain version, yardstick) closures over case ``index``'s
  inputs, made from a seed of their own."""
  op, case, rows, k, n, dt = FUSED_CASES[index]
  dtype = getattr(torch, dt)
  g = torch.Generator(device="cuda").manual_seed(SEED + 8 + index)
  scale, shift = (1.0, 100.0) if case == "large_mean" else (2.0, 0.5)
  x = (torch.randn(rows, k, device="cuda", generator=g) * scale
       + shift).to(dtype)
  W = (torch.randn(k, n, device="cuda", generator=g) / k ** 0.5).to(dtype)
  if op == "ln_matmul":
    w = torch.rand(k, device="cuda", generator=g) + 0.5
    wl = w.to(dtype)
    return (lambda: ops.ln_matmul(x, w, W),
            lambda: ops.ln_matmul_reference(x, w, W),
            lambda: F.layer_norm(x, (k,), wl, None, 1e-6) @ W)
  return (lambda: ops.gelu_matmul(x, W),
          lambda: ops.gelu_matmul_reference(x, W),
          lambda: F.gelu(x, approximate="tanh") @ W)


def _fused_module(op):
  """The port's module of fused product ``op`` (the package re-exports the
  function under the module's name)."""
  return sys.modules["tensorflowonspark_tpu_torch.ops." + (
      "ln_matmul" if op == "ln_matmul" else "act_matmul")]


def check_fused_matmul(ops, torch, F):
  """ln_matmul and gelu_matmul against their plain versions. The
  yardstick is the unfused pair of PyTorch calls (``F.layer_norm`` or
  ``F.gelu``, then ``torch.matmul``): no single library call computes the
  fused function. Device times come later (:func:`fused_device_ms`)."""
  rows_out, worst = [], 0.0
  for i, (op, case, rows, k, n, dt) in enumerate(FUSED_CASES):
    fn, plain, lib = _fused_calls(ops, torch, F, i)
    # the body the kernel's dispatcher runs
    body = _fused_module(op).kernel_body(k, n, getattr(torch, dt))
    got, want = fn(), plain()
    torch.cuda.synchronize()
    # bf16: outputs may round one ulp apart (f32 sums in another order);
    # f32: summation order only. Both relative to the output's scale.
    tol = 2e-2 if dt == "bfloat16" else 1e-5
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if err > tol * scale:
      raise AssertionError("%s %s: max abs err %.3g over %g x max |ref| %.3g"
                           % (op, case, err, tol, scale))
    worst = max(worst, err)
    if not torch.equal(got, fn()):
      raise AssertionError("%s %s: two runs differ" % (op, case))
    # share of outputs whose bits differ from the plain version's
    differ = (got != want).float().mean().item()
    isz = got.element_size()
    nbytes = (rows * k + k * n + rows * n) * isz + (k * 4 if op == "ln_matmul"
                                                    else 0)
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_o = 2.0 * rows * k * n / PEAK_FLOPS[dt] * 1e3
    row = {"op": op, "case": case, "rows": rows, "K": k, "N": n, "dtype": dt,
           "body": body, "max_abs_err": err, "max_abs_ref": scale,
           "differ": differ, "ms": time_ms(fn),
           "plain_ms": time_ms(plain, runs=7 if rows > 1000 else 25),
           "library_ms": time_ms(lib),
           "library": ("F.layer_norm + torch.matmul" if op == "ln_matmul"
                       else "F.gelu + torch.matmul") + " (two calls)",
           "bound_ms": max(bound_b, bound_o),
           "bound_by": "bytes" if bound_b >= bound_o else "operations"}
    rows_out.append(row)
    log("  %-11s %-9s %-8s %-5s rows=%-5d K=%-4d N=%-4d err=%.3g "
        "differ=%.2e ms=%.4f plain=%.4f lib(2 calls)=%.4f bound=%.5f"
        % (op, case, dt, body, rows, k, n, err, differ, row["ms"],
           row["plain_ms"], row["library_ms"], row["bound_ms"]))
    del fn, plain, lib, got, want
  return rows_out, worst


def _ran_instance(names, body, prologue):
  """The fused-product kernels among the profiler's ``names``, and whether
  one of them is ``body``'s kernel instantiated for ``prologue``."""
  symbol = {"wgmma": "prologue_gemm_wgmma", "wmma": "prologue_gemm_bf16",
            "f32": "prologue_gemm_f32"}[body]
  ran = sorted({n for n in names if "prologue_gemm" in n})
  return ran, any(symbol in n and _prologue(n) == prologue for n in ran)


def fused_device_ms(ops, torch, F, rows_out):
  """Each fused case's device time under torch.profiler, into its row of
  :func:`check_fused_matmul`. Run after the serving phases: the
  profiler's first session is left where the serving path had it, after
  the timed serving run."""
  for i, row in enumerate(rows_out):
    fn = _fused_calls(ops, torch, F, i)[0]
    per = {}
    row["device_ms"] = device_ms(torch, fn, per_kernel=per)
    row["device_ms_by_kernel"] = {k.split("(")[0][:80]: v
                                  for k, v in per.items()}
    del fn
    # the profiler names the body that ran: it must be the one the
    # dispatcher gives these widths, instantiated for this op's prologue
    want = "kLayerNorm" if row["op"] == "ln_matmul" else "kGelu"
    ran, ok = _ran_instance(per, row["body"], want)
    row["kernels_seen"] = ran
    if ran and not ok:
      raise AssertionError("%s %s: expected the %s body for %s, the profiler "
                           "saw %s" % (row["op"], row["case"], row["body"],
                                       want, ran))
    if row["device_ms"] is None:
      row["tflops"] = None
      log("  %-11s %-9s %-8s device time not measured: the profiler "
          "recorded no kernel in 3 sessions" % (row["op"], row["case"],
                                                row["dtype"]))
      continue
    row["tflops"] = 2.0 * row["rows"] * row["K"] * row["N"] / \
        row["device_ms"] / 1e9
    log("  %-11s %-9s %-8s device=%.4f ms (%.1f TFLOP/s), ran %s"
        % (row["op"], row["case"], row["dtype"], row["device_ms"],
           row["tflops"], ", ".join(
               "%s<%s> %.4f" % (n.split("<")[0].split("::")[-1],
                                _prologue(n), per[n]) for n in ran)))


# -- phases 4 and 5: the serving path ----------------------------------------

MAIN_LENGTHS = (600, 517, 512, 470, 300, 260, 200, 150, 128, 97, 64, 45, 33,
                32, 20, 17)
MAIN_NEW = 32
PARITY_LENGTHS = (600, 300, 130, 97, 40, 33, 17, 5)
PARITY_NEW = 16


def _prompts(lengths, vocab, seed):
  import numpy as np
  rng = np.random.default_rng(seed)
  return [rng.integers(1, vocab, size=n) for n in lengths]


def serve_main_path(torch, ops, tfm, ServingEngine, slots, params, cfg,
                    device=None):
  eng = ServingEngine(params, cfg, num_slots=8, horizon=4,
                      max_new_tokens=MAIN_NEW, device=device).start()
  try:
    # warm-up: cuBLAS handles, allocator pools, first launches
    eng.generate(_prompts((40, 130), cfg.vocab_size, SEED + 7),
                 max_new_tokens=4, timeout=600)
    prompts = _prompts(MAIN_LENGTHS, cfg.vocab_size, SEED + 2)
    before = dict(eng.stats)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.monotonic()
    rids = [eng.submit(p) for p in prompts]
    handles = [eng.request(r) for r in rids]
    outs = [eng.result(r, timeout=600) for r in rids]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
  finally:
    eng.stop()                     # joins the loop: no forward runs after
  launches = dict(ops.LAUNCHES)
  after = dict(eng.stats)
  for p, o in zip(prompts, outs):
    if len(o) != len(p) + MAIN_NEW or not (o[:len(p)] == p).all():
      raise AssertionError("request of %d tokens returned %d tokens"
                           % (len(p), len(o)))
    if o.min() < 0 or o.max() >= cfg.vocab_size:
      raise AssertionError("token ids out of the vocabulary")
  steps = after["steps"] - before["steps"]
  chunks = sum(len(slots.chunk_plan(len(p), eng.buckets)) for p in prompts)
  per_forward = 2 * cfg.num_layers + 1
  want_ln = per_forward * (chunks + steps)
  want_flash = cfg.num_layers * len(prompts)
  if launches["layer_norm"] != want_ln:
    raise AssertionError("layer_norm launched %d times, the path needs %d "
                         "(25 per forward x %d forwards)"
                         % (launches["layer_norm"], want_ln, chunks + steps))
  if launches["flash_attention_fwd"] != want_flash:
    raise AssertionError("flash attention launched %d times, the path needs "
                         "%d (12 layers x %d fresh prefills)"
                         % (launches["flash_attention_fwd"], want_flash,
                            len(prompts)))
  with torch.inference_mode():
    logits = eng.model(torch.as_tensor(prompts[-1][None]))
  if not torch.isfinite(logits).all():
    raise AssertionError("non-finite logits at full width")
  ttft = sorted(h.ttft * 1e3 for h in handles)
  generated = sum(len(o) - len(p) for p, o in zip(prompts, outs))
  decode_s = after["decode_s"] - before["decode_s"]
  res = {"requests": len(prompts), "generated_tokens": generated,
         "wall_s": wall, "tokens_per_s": generated / wall,
         "ttft_ms_p50": statistics.median(ttft),
         "ttft_ms_p99": ttft[min(len(ttft) - 1,
                                 int(math.ceil(0.99 * len(ttft))) - 1)],
         "decode_steps": steps, "decode_ms_per_step": decode_s / steps * 1e3,
         "prefill_chunks": chunks, "launches": launches,
         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
  log("  served %d requests, %d tokens in %.3f s: %.1f tok/s, TTFT p50 %.1f "
      "ms p99 %.1f ms, %.3f ms/decode step, launches %s" % (
          len(prompts), generated, wall, res["tokens_per_s"],
          res["ttft_ms_p50"], res["ttft_ms_p99"], res["decode_ms_per_step"],
          launches))
  return res, eng.model


def _kernel_rows(torch, prof):
  """(name, device ms) per kernel the profiler saw, largest first."""
  cuda = torch.autograd.DeviceType.CUDA
  rows = []
  for evt in prof.key_averages():
    if getattr(evt, "device_type", None) != cuda:
      continue
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
      us = getattr(evt, "self_cuda_time_total", 0)
    rows.append((evt.key, us / 1e3, evt.count))
  return sorted(rows, key=lambda r: -r[1])


# (substring of a device symbol, the port kernel whose wrapper launches it);
# the fused products share one template, told apart by its prologue. The
# Delta pre-pass (both backward plans) counts apart; the fused backward's
# kernels count as flash_attention_bwd in MHA and grouped steps alike
_PORT_SYMBOLS = (("ln_matmul_stats_kernel", "ln_matmul"),
                 ("flash_fwd_kernel", "flash_attention_fwd"),
                 ("flash_bwd_dq_kernel", "flash_attention_bwd_dq"),
                 ("flash_bwd_dkv_kernel", "flash_attention_bwd_dkv"),
                 ("flash_bwd_dkv_gqa_kernel", "flash_attention_bwd_dkv_gqa"),
                 ("flash_bwd_delta_kernel", "flash_attention_bwd_delta"),
                 ("flash_bwd", "flash_attention_bwd"),
                 ("layer_norm_fwd_kernel", "layer_norm"),
                 ("layer_norm_bwd_kernel", "layer_norm_bwd"),
                 ("layer_norm_bwd_wide_kernel", "layer_norm_bwd"),
                 ("layer_norm_dw_kernel", "layer_norm_bwd"))


def _port_kernel(symbol):
  """The port kernel whose wrapper launches device symbol ``symbol``, or
  None for a symbol of no port kernel."""
  if "prologue_gemm" in symbol:
    return "gelu_matmul" if _prologue(symbol) == "kGelu" else "ln_matmul"
  return next((name for part, name in _PORT_SYMBOLS if part in symbol), None)


def port_kernel_ms(rows):
  """Device ms and kernel launches per port kernel, summed over every
  symbol the profiler saw (not only the top rows)."""
  out = {}
  for key, ms, count in rows:
    name = _port_kernel(key)
    if name is not None:
      slot = out.setdefault(name, {"device_ms": 0.0, "kernels": 0})
      slot["device_ms"] += ms
      slot["kernels"] += count
  return out


def _log_port_kernels(per):
  for name, v in sorted(per.items()):
    log("    port %-20s %9.3f ms device, %d kernel launches"
        % (name, v["device_ms"], v["kernels"]))


def profile_serving(torch, slots, model):
  """Where one decode dispatch (8 live slots, horizon 4) and one
  512-token prefill chunk spend their time: device-busy ms from
  torch.profiler against the host wall clock, and the top kernels."""
  import numpy as np
  from torch.profiler import ProfilerActivity, profile
  cfg = model.cfg
  dec = slots.SlotDecoder(model, 8)
  prompts = _prompts(MAIN_LENGTHS[:8], cfg.vocab_size, SEED + 4)
  slabs = dec.init_slabs()
  for i, p in enumerate(prompts):
    row, _ = dec.prefill(p)
    dec.insert(slabs, row, i)
  last = np.ones(8, np.int64)
  active = np.ones(8, bool)
  budget = np.full(8, 1000, np.int64)
  long_prompt = prompts[2][:512]
  phases = {"decode_h4": lambda: dec.step_many(slabs, last, active, budget,
                                               4),
            "prefill_512": lambda: dec.prefill(long_prompt)}
  out = {}
  for name, fn in phases.items():
    fn()                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t0 = time.monotonic()
      fn()
      torch.cuda.synchronize()
      wall_ms = (time.monotonic() - t0) * 1e3
    rows = _kernel_rows(torch, prof)
    busy = sum(r[1] for r in rows)
    out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                 "kernel_launches": sum(r[2] for r in rows),
                 "top": [{"kernel": k[:90], "ms": ms, "count": n}
                         for k, ms, n in rows[:8]],
                 "port_kernels": port_kernel_ms(rows)}
    log("  %s: wall %.2f ms, device busy %.2f ms (idle %.0f%%), %d kernel "
        "launches" % (name, wall_ms, busy,
                      100.0 * (1 - busy / wall_ms) if wall_ms else 0.0,
                      out[name]["kernel_launches"]))
    for r in out[name]["top"]:
      log("    %8.3f ms x%-5d %s" % (r["ms"], r["count"], r["kernel"]))
    _log_port_kernels(out[name]["port_kernels"])
  return out


def serve_parity_f32(torch, tfm, ServingEngine, params, cfg, device=None):
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  prompts = _prompts(PARITY_LENGTHS, cfg.vocab_size, SEED + 3)
  eng = ServingEngine(params, cfg, num_slots=8, horizon=4,
                      device=device).start()
  try:
    outs = eng.generate(prompts, max_new_tokens=PARITY_NEW, timeout=600)
  finally:
    eng.stop()
  model, exact, ties = eng.model, 0, []
  for p, out in zip(prompts, outs):
    ref = tfm.greedy_generate_kv(model, p[None], PARITY_NEW).cpu().numpy()[0]
    if (ref == out).all():
      exact += 1
      continue
    pos = int(next(i for i in range(len(ref)) if ref[i] != out[i]))
    with torch.inference_mode():
      logits = model(torch.as_tensor(ref[None, :pos]))[0, -1]
    top2 = torch.topk(logits, 2).values
    gap = float(top2[0] - top2[1])
    log("  prompt %d: first difference at position %d, top-2 gap %.3g"
        % (len(p), pos, gap))
    if gap >= 1e-4:
      raise AssertionError("engine output differs from greedy_generate_kv "
                           "at position %d of a %d-token prompt (top-2 gap "
                           "%.3g: not a near-tie)" % (pos, len(p), gap))
    ties.append({"prompt_len": len(p), "position": pos, "gap": gap})
  log("  f32 parity: %d/%d requests token-identical, %d near-ties"
      % (exact, len(prompts), len(ties)))
  return {"requests": len(prompts), "identical": exact, "near_ties": ties}


# -- phases 6, 6b, 6c and 7: the training path --------------------------------

TRAIN_B, TRAIN_S = 16, 1024        # bench.py's batch x sequence
GQA_B = 8
WANT_PER_STEP = {"flash_attention_fwd": 24, "flash_attention_bwd": 12,
                 "layer_norm": 49, "layer_norm_bwd": 25,
                 "flash_attention_bwd_gqa": 0, "flash_attention_bwd_dq": 0,
                 "flash_attention_bwd_dkv": 0,
                 "flash_attention_bwd_dkv_gqa": 0, "ln_matmul": 0,
                 "gelu_matmul": 0}
# TFOS_TPU_FLASH_BWD=split: the dQ and dK/dV kernels replace the fused one
WANT_SPLIT_PER_STEP = dict(WANT_PER_STEP, flash_attention_bwd=0,
                           flash_attention_bwd_dq=12,
                           flash_attention_bwd_dkv=12)
# the long-context grouped-KV slice (train_gpt.py --kv_heads 4 --seq_len
# 16384 --batch 1): the reference's plan rule takes the split plan there
LONG_B, LONG_S = 1, 16384
LONG_ARGS = ["--layers", "12", "--d_model", "768", "--heads", "12",
             "--kv_heads", "4", "--seq_len", str(LONG_S), "--vocab", "32000",
             "--batch", str(LONG_B)]
WANT_LONG_PER_STEP = dict(WANT_PER_STEP, flash_attention_bwd=0,
                          flash_attention_bwd_dq=12,
                          flash_attention_bwd_dkv_gqa=12)
# bench.py's b16_s1024_allfused / train_gpt.py --fused: ln1 + QKV and ln2 +
# up as LN->matmul, GELU + down as GELU->matmul; only ln_f stays a LayerNorm
ALL_FUSED = dict(fuse_qkv=True, ln_matmul_impl="fused",
                 act_matmul_impl="fused")
WANT_FUSED_PER_STEP = dict(WANT_PER_STEP, layer_norm=1, layer_norm_bwd=1,
                           ln_matmul=48, gelu_matmul=24)


def _synthetic_batch(batch, seq, vocab):
  """train_gpt.py's synthetic stream: one fixed batch, repeated."""
  import numpy as np
  return np.random.RandomState(SEED).randint(0, vocab, (batch, seq)).astype(
      "int32")


def _lm_loss(tfm):
  return lambda model, tokens: tfm.causal_lm_loss(model(tokens), tokens)


def _per_step_launches(launches, steps, want, what):
  per = {}
  for name, n in want.items():
    if launches[name] != n * steps:
      raise AssertionError("%s: %s launched %d times in %d steps, the path "
                           "needs %d per step" % (what, name, launches[name],
                                                  steps, n))
    per[name] = launches[name] / steps
  return per


def profile_train_step(torch, step, state, batch):
  """One optimizer step under torch.profiler: device-busy ms against the
  host's wall clock, the top kernels and every port kernel's device ms."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.monotonic()
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
  rows = _kernel_rows(torch, prof)
  busy = sum(r[1] for r in rows)
  res = {"wall_ms": wall_ms, "device_busy_ms": busy,
         "kernel_launches": sum(r[2] for r in rows),
         "top": [{"kernel": k[:90], "ms": ms, "count": n}
                 for k, ms, n in rows[:12]],
         "port_kernels": port_kernel_ms(rows)}
  log("  profiled step: wall %.2f ms, device busy %.2f ms (idle %.0f%%), %d "
      "kernel launches" % (wall_ms, busy, 100.0 * (1 - busy / wall_ms),
                           res["kernel_launches"]))
  for r in res["top"]:
    log("    %8.3f ms x%-5d %s" % (r["ms"], r["count"], r["kernel"]))
  _log_port_kernels(res["port_kernels"])
  return state, float(loss), res


def train_main_path(torch, ops, tfm, optim, sharding, Slab, params, cfg,
                    want):
  """Warm-up, 4 ``make_train_step`` steps, one ``make_train_loop(unroll=
  4)`` slab and one profiled step of ``cfg`` at B16 x S1024, with exact
  launch counts per step (``want``) on both paths."""
  import numpy as np
  state = tfm.create_state(cfg, params, tx=optim.make_optimizer(
      learning_rate=3e-4, clip_norm=1.0))
  batch = _synthetic_batch(TRAIN_B, TRAIN_S, cfg.vocab_size)
  loss_fn = _lm_loss(tfm)
  step = sharding.make_train_step(loss_fn)
  loop = sharding.make_train_loop(loss_fn, unroll=4)
  losses = []
  for _ in range(2):                               # warm-up
    state, loss = step(state, batch)
    losses.append(float(loss))
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  ops.reset_launches()
  t0 = time.monotonic()
  step_losses = []
  for _ in range(4):
    state, loss = step(state, batch)
    step_losses.append(loss)
  torch.cuda.synchronize()
  wall_step = time.monotonic() - t0
  per_step = _per_step_launches(dict(ops.LAUNCHES), 4, want, "per-step path")
  losses += [float(x) for x in step_losses]
  ops.reset_launches()
  t0 = time.monotonic()
  state, loop_losses = loop(state, Slab(np.stack([batch] * 4)))
  torch.cuda.synchronize()
  wall_loop = time.monotonic() - t0
  per_loop = _per_step_launches(dict(ops.LAUNCHES), 4, want, "fused loop")
  losses += loop_losses.tolist()
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  if not all(math.isfinite(x) for x in losses):
    raise AssertionError("non-finite training loss: %s" % losses)
  if not losses[-1] < losses[0]:
    raise AssertionError("training loss did not fall: %s" % losses)
  state, prof_loss, prof = profile_train_step(torch, step, state, batch)
  tokens = TRAIN_B * TRAIN_S * 4
  res = {"batch": TRAIN_B, "seq": TRAIN_S, "losses": losses + [prof_loss],
         "per_step": {"wall_s": wall_step, "ms_per_step": wall_step / 4 * 1e3,
                      "tokens_per_s": tokens / wall_step,
                      "launches_per_step": per_step},
         "fused_loop": {"wall_s": wall_loop, "ms_per_step": wall_loop / 4 * 1e3,
                        "tokens_per_s": tokens / wall_loop,
                        "launches_per_step": per_loop},
         "peak_mem_gib": peak, "profile": prof}
  log("  losses %s" % " ".join("%.4f" % x for x in res["losses"]))
  log("  per-step: %.1f ms/step, %.0f tokens/s; fused loop (unroll 4): %.1f "
      "ms/step, %.0f tokens/s; peak memory %.2f GiB" % (
          res["per_step"]["ms_per_step"], res["per_step"]["tokens_per_s"],
          res["fused_loop"]["ms_per_step"], res["fused_loop"]["tokens_per_s"],
          peak))
  log("  launches per step (both paths): %s" % per_step)
  return res


def train_gqa(torch, ops, tfm, optim, sharding, init_params, want, **kw):
  """The grouped-KV configuration (``num_kv_heads=4``, plus ``kw``) at
  B8 x S1024: one warm-up step, then 2 timed steps with exact launch
  counts, then one profiled step (the grouped fused backward's device
  time: its kernels are the only flash backward there)."""
  cfg = tfm.TransformerConfig(num_kv_heads=4, **kw)
  state = tfm.create_state(cfg, init_params(cfg, seed=SEED),
                           tx=optim.make_optimizer(learning_rate=3e-4,
                                                   clip_norm=1.0))
  batch = _synthetic_batch(GQA_B, TRAIN_S, cfg.vocab_size)
  step = sharding.make_train_step(_lm_loss(tfm))
  state, first = step(state, batch)                # warm-up
  torch.cuda.synchronize()
  ops.reset_launches()
  t0 = time.monotonic()
  losses = []
  for _ in range(2):
    state, loss = step(state, batch)
    losses.append(loss)
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  want = dict(want, flash_attention_bwd=0, flash_attention_bwd_gqa=12)
  per = _per_step_launches(dict(ops.LAUNCHES), 2, want, "GQA training")
  losses = [float(first)] + [float(x) for x in losses]
  if not all(math.isfinite(x) for x in losses):
    raise AssertionError("non-finite GQA training loss: %s" % losses)
  log("  GQA (Hk 4) B%d: losses %s, %.1f ms/step (after a warm-up step), "
      "launches per step %s" % (GQA_B, losses, wall / 2 * 1e3, per))
  state, prof_loss, prof = profile_train_step(torch, step, state, batch)
  kernels = prof["port_kernels"]
  if "flash_attention_bwd" in kernels:
    kernels["flash_attention_bwd_gqa"] = kernels.pop("flash_attention_bwd")
  return {"batch": GQA_B, "losses": losses + [prof_loss],
          "ms_per_step": wall / 2 * 1e3,
          "tokens_per_s": GQA_B * TRAIN_S * 2 / wall,
          "launches_per_step": per, "profile": prof}


@contextlib.contextmanager
def flash_bwd_env(mode):
  """``TFOS_TPU_FLASH_BWD`` set to ``mode`` inside the block, as the
  reference's executors read it (``scripts/submit_train.sh``)."""
  before = os.environ.get("TFOS_TPU_FLASH_BWD")
  os.environ["TFOS_TPU_FLASH_BWD"] = mode
  try:
    yield
  finally:
    if before is None:
      os.environ.pop("TFOS_TPU_FLASH_BWD", None)
    else:
      os.environ["TFOS_TPU_FLASH_BWD"] = before


def write_token_files(directory, vocab, seq, files=4, rows=4):
  """``files`` TFRecord files of ``rows`` seeded token rows each (schema
  ``struct<tokens:array<long>>``, lengths ``seq`` down to ``seq - 60``,
  so the collate pads some), written with the port's writer into a fresh
  ``directory``. Returns the glob pattern."""
  import numpy as np
  from tensorflowonspark_tpu_torch.data import example_codec, tfrecord
  shutil.rmtree(directory, ignore_errors=True)
  os.makedirs(directory)
  rng = np.random.default_rng(SEED + 9)
  for f in range(files):
    with tfrecord.TFRecordWriter(
        os.path.join(directory, "part-%05d.tfrecord" % f)) as w:
      for _ in range(rows):
        n = seq - int(rng.integers(0, 61))
        w.write(example_codec.encode_example(
            {"tokens": rng.integers(0, vocab, n).tolist()}))
  return os.path.join(directory, "part-*.tfrecord")


def train_long_gqa(torch, ops, sharding, readers, train_gpt):
  """Long-context grouped-KV training through the port's train_gpt: its
  config, state, loss and TFRecord batch stream, one batch staged ahead by
  ``device_prefetch``; a warm-up step, 2 timed steps with exact launch
  counts, then one profiled step."""
  t0 = time.monotonic()
  pattern = write_token_files(os.path.join(HERE, "build", "chip_smoke_tokens"),
                              32000, LONG_S)
  write_s = time.monotonic() - t0
  args = train_gpt.parse_args(LONG_ARGS + ["--data", pattern, "--steps", "4"])
  cfg = train_gpt.make_config(args)
  state = train_gpt.make_state(args, cfg)
  step = sharding.make_train_step(train_gpt.make_loss_fn(args))
  t0 = time.monotonic()
  batches = readers.device_prefetch(train_gpt.batch_stream(args), size=2)
  state, first = step(state, next(batches))          # warm-up
  torch.cuda.synchronize()
  warm_s = time.monotonic() - t0
  torch.cuda.reset_peak_memory_stats()
  ops.reset_launches()
  t0 = time.monotonic()
  losses = []
  for _ in range(2):
    state, loss = step(state, next(batches))
    losses.append(loss)
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  per = _per_step_launches(dict(ops.LAUNCHES), 2, WANT_LONG_PER_STEP,
                           "long-context GQA training")
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  state, prof_loss, prof = profile_train_step(torch, step, state,
                                              next(batches))
  losses = [float(first)] + [float(x) for x in losses] + [prof_loss]
  if not all(math.isfinite(x) for x in losses):
    raise AssertionError("non-finite long-context training loss: %s"
                         % losses)
  tokens = LONG_B * LONG_S * 2
  res = {"batch": LONG_B, "seq": LONG_S, "num_kv_heads": cfg.num_kv_heads,
         "data": pattern, "write_s": write_s,
         "first_step_s_with_data": warm_s, "losses": losses,
         "ms_per_step": wall / 2 * 1e3, "tokens_per_s": tokens / wall,
         "launches_per_step": per, "peak_mem_gib": peak, "profile": prof}
  log("  TFRecords written in %.1f s; warm-up step (reader start included) "
      "%.1f s; losses %s" % (write_s, warm_s,
                             " ".join("%.4f" % x for x in losses)))
  log("  B%d x S%d Hk %d: %.1f ms/step, %.0f tokens/s, peak memory %.2f GiB, "
      "launches per step %s" % (LONG_B, LONG_S, cfg.num_kv_heads,
                                res["ms_per_step"], res["tokens_per_s"],
                                peak, per))
  return res


# train_gpt.py's default model flags (4 layers, d_model 256, 8 heads:
# head_dim 32, seq 512, vocab 1024, batch 8): 2 flash forwards per layer
# (forward and remat recompute), one fused backward, 4 LayerNorm forwards
# per layer (2 and their recompute) + ln_f, 2 backwards + ln_f's
GPT_DEFAULT_STEPS = 5


def _want_per_layer(layers):
  return dict(WANT_PER_STEP, flash_attention_fwd=2 * layers,
              flash_attention_bwd=layers, layer_norm=4 * layers + 1,
              layer_norm_bwd=2 * layers + 1)


def train_gpt_defaults(torch, ops, train_gpt):
  """The port's train_gpt at its default model flags through its ``run``,
  batches from seeded TFRecord files: finite losses, exact launch counts
  per step (the fused backward at head_dim 32 among them)."""
  args = train_gpt.parse_args(["--steps", str(GPT_DEFAULT_STEPS)])
  pattern = write_token_files(
      os.path.join(HERE, "build", "chip_smoke_gpt_tokens"), args.vocab,
      args.seq_len)
  args = train_gpt.parse_args(["--data", pattern, "--steps",
                               str(GPT_DEFAULT_STEPS)])
  cfg = train_gpt.make_config(args)
  torch.cuda.synchronize()
  ops.reset_launches()
  t0 = time.monotonic()
  losses = train_gpt.run(args)
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  per = _per_step_launches(dict(ops.LAUNCHES), GPT_DEFAULT_STEPS,
                           _want_per_layer(cfg.num_layers),
                           "train_gpt default flags")
  if len(losses) != GPT_DEFAULT_STEPS or not all(
      math.isfinite(x) for x in losses):
    raise AssertionError("train_gpt default flags: losses %s" % losses)
  res = {"layers": cfg.num_layers, "d_model": cfg.d_model,
         "heads": cfg.num_heads, "head_dim": cfg.head_dim,
         "seq": args.seq_len, "batch": args.batch, "vocab": args.vocab,
         "steps": GPT_DEFAULT_STEPS, "losses": losses,
         "wall_s_with_first_step": wall, "launches_per_step": per}
  log("  %d layers, d_model %d, %d heads (head_dim %d), B%d x S%d: losses %s"
      "; %d steps in %.2f s (first step and reader start included); "
      "launches per step %s" % (cfg.num_layers, cfg.d_model, cfg.num_heads,
                                cfg.head_dim, args.batch, args.seq_len,
                                " ".join("%.4f" % x for x in losses),
                                GPT_DEFAULT_STEPS, wall, per))
  return res


# the JAX package's examples/transformer/serve_gpt.py config: head_dim 32,
# 2 KV heads
SERVE_GPT_CFG = dict(vocab_size=256, num_layers=2, num_heads=4,
                     num_kv_heads=2, d_model=128, d_ff=256, max_seq_len=64)


def serve_gpt_config(torch, ops, tfm, ServingEngine, init_params):
  """One request through ServingEngine at serve_gpt's config: in bf16 with
  the flash forward's launches counted, and in f32 (TF32 off) equal to the
  single-request greedy_generate_kv decode."""
  import numpy as np
  prompt = np.random.default_rng(SEED + 13).integers(1, 256, size=20)
  res = {}
  for dt in ("bfloat16", "float32"):
    cfg = tfm.TransformerConfig(dtype=getattr(torch, dt), remat=False,
                                **SERVE_GPT_CFG)
    eng = ServingEngine(init_params(cfg, seed=SEED), cfg, num_slots=2,
                        horizon=4).start()
    try:
      ops.reset_launches()
      out = eng.generate([prompt], max_new_tokens=16, timeout=600)[0]
      torch.cuda.synchronize()
      launches = dict(ops.LAUNCHES)
    finally:
      eng.stop()
    if len(out) != len(prompt) + 16 or not (out[:len(prompt)] == prompt).all() \
        or out.min() < 0 or out.max() >= cfg.vocab_size:
      raise AssertionError("serve_gpt config %s: bad output %s" % (dt, out))
    if launches["flash_attention_fwd"] != cfg.num_layers:
      raise AssertionError("serve_gpt config %s: flash forward launched %d "
                           "times, one prefill of %d layers needs %d"
                           % (dt, launches["flash_attention_fwd"],
                              cfg.num_layers, cfg.num_layers))
    if dt == "float32":
      ref = tfm.greedy_generate_kv(eng.model, prompt[None], 16)
      ref = ref.cpu().numpy()[0]
      if not (ref == out).all():
        raise AssertionError("serve_gpt config f32: engine %s vs "
                             "greedy_generate_kv %s" % (out, ref))
    res[dt] = {"prompt_len": len(prompt), "tokens": out.tolist(),
               "launches": {k: v for k, v in launches.items() if v}}
    log("  serve_gpt config %s (head_dim %d, Hk %d): %d tokens out, "
        "launches %s%s" % (dt, cfg.head_dim, cfg.num_kv_heads, len(out),
                           res[dt]["launches"],
                           ", equal to greedy_generate_kv" if dt == "float32"
                           else ""))
  return res


def train_parity_f32(torch, tfm, init_params, **kw):
  """One step's loss and gradients of a 2-layer full-width f32 model
  (``TransformerConfig(**kw)``) on a 2 x 256 batch: the card with the
  kernels against the CPU with the plain versions, from the same weights
  (TF32 off)."""
  cfg = tfm.TransformerConfig(dtype=torch.float32, num_layers=2, **kw)
  params = init_params(cfg, seed=SEED)
  tokens = torch.from_numpy(_synthetic_batch(2, 256, cfg.vocab_size))
  out = {}
  for where in ("cuda", "cpu"):
    model = tfm.Transformer(cfg, params, device=None if where == "cuda"
                            else "cpu", trainable=True)
    loss = tfm.causal_lm_loss(model(tokens), tokens.to(model.device))
    names, weights = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, weights)
    out[where] = (float(loss.detach()), {n: g.detach().cpu()
                                for n, g in zip(names, grads)})
  (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
  rel = abs(lc - lh) / abs(lh)
  if rel > 1e-4:
    raise AssertionError("f32 training loss: card %.7f vs CPU %.7f (rel "
                         "%.3g > 1e-4)" % (lc, lh, rel))
  worst, worst_name = 0.0, None
  for name, want in gh.items():
    err = (gc[name] - want).abs().max().item()
    ratio = err / max(want.abs().max().item(), 1e-30)
    if ratio > 1e-3:
      raise AssertionError("f32 gradient %s: card vs CPU max abs err %.3g is "
                           "%.3g of its max |value| (> 1e-3)"
                           % (name, err, ratio))
    if ratio >= worst:
      worst, worst_name = ratio, name
  log("  f32 training parity: loss card %.7f CPU %.7f (rel %.2g); worst "
      "gradient %s at %.3g of its max |value|, over %d tensors"
      % (lc, lh, rel, worst_name, worst, len(gh)))
  return {"loss_card": lc, "loss_cpu": lh, "loss_rel_diff": rel,
          "worst_grad": worst_name, "worst_grad_rel": worst,
          "tensors": len(gh)}


def serving_only(torch, ops, tfm, ServingEngine, slots, init_params,
                 repeats):
  """The serving main path ``repeats`` times, then the host side of the
  prefill: microseconds from entering to leaving one flash-forward wrapper
  call (no synchronise inside; the median of 200) at the first chunk sizes
  16 and 512, and the wall ms of a whole 512-token prefill chunk (median of
  10, synchronised)."""
  cfg = tfm.TransformerConfig()
  params = init_params(cfg, seed=SEED)
  runs = []
  for _ in range(repeats):
    res, model = serve_main_path(torch, ops, tfm, ServingEngine, slots,
                                 params, cfg)
    runs.append({k: res[k] for k in ("tokens_per_s", "ttft_ms_p50",
                                     "ttft_ms_p99", "decode_ms_per_step")})
  g = torch.Generator(device="cuda").manual_seed(SEED + 11)
  host_us = {}
  for s in (16, 512):
    q, k, v = (torch.randn(1, s, cfg.num_heads, cfg.head_dim, device="cuda",
                           generator=g).to(torch.bfloat16) for _ in range(3))
    for _ in range(10):
      ops.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    times = []
    for _ in range(200):
      t0 = time.perf_counter()
      ops.flash_attention_fwd(q, k, v)
      times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    host_us["S%d" % s] = statistics.median(times)
  dec = slots.SlotDecoder(model, 8)
  prompt = _prompts((512,), cfg.vocab_size, SEED + 4)[0]
  walls = []
  with torch.inference_mode():
    for _ in range(12):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      dec.prefill(prompt)
      torch.cuda.synchronize()
      walls.append((time.perf_counter() - t0) * 1e3)
  out = {"runs": runs, "flash_fwd_host_us": host_us,
         "prefill_512_wall_ms": statistics.median(walls[2:]),
         "tokens_per_s": [r["tokens_per_s"] for r in runs]}
  log("  tokens/s %s; flash fwd host us %s; 512-token prefill chunk wall "
      "%.2f ms" % (", ".join("%.1f" % x for x in out["tokens_per_s"]),
                   ", ".join("%s %.1f" % kv for kv in host_us.items()),
                   out["prefill_512_wall_ms"]))
  log(json.dumps({"serving_only": out}))
  return 0


def layer_norm_only(torch, ops, F):
  """Phase 3's LayerNorm forward and backward checks, then their device
  times; prints them as one JSON line."""
  ln_rows, _ = check_layer_norm(ops, torch, F)
  lnb_rows, _ = check_layer_norm_bwd(ops, torch, F)
  layer_norm_device_ms(ops, torch, F, ln_rows, lnb_rows)
  log(json.dumps({"layer_norm_only": {"layer_norm": ln_rows,
                                      "layer_norm_bwd": lnb_rows}}))
  return 0


def main(argv):
  repeats, ln_only = 0, argv == ["--layer-norm-only"]
  if argv[:1] == ["--serving-only"] and len(argv) == 2:
    repeats = int(argv[1])
  elif argv and not ln_only:
    log("usage: python3 chip_smoke.py [--serving-only N | "
        "--layer-norm-only]")
    return 2
  try:
    import torch
    import torch.nn.functional as F
  except ImportError as e:
    log("chip_smoke: FAIL: PyTorch is not importable: %s" % e)
    return 2
  if not torch.cuda.is_available():
    log("chip_smoke: FAIL: no CUDA device (torch.cuda.is_available() is "
        "False)")
    return 2
  sys.path.insert(0, HERE)
  try:
    from tensorflowonspark_tpu_torch import ops, optim
    from tensorflowonspark_tpu_torch.data import readers
    from tensorflowonspark_tpu_torch.data.readers import Slab
    from tensorflowonspark_tpu_torch.examples import train_gpt
    from tensorflowonspark_tpu_torch.models import transformer as tfm
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.parallel import sharding
    from tensorflowonspark_tpu_torch.serving import ServingEngine, slots
    from tensorflowonspark_tpu_torch.utils.params import init_params
  except ImportError as e:
    log("chip_smoke: FAIL: the port is not next to chip_smoke.py: %s" % e)
    return 2
  t_start = time.monotonic()
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  log("[1] card")
  card = card_line()
  log(card)
  log("  torch %s, CUDA %s, %s x%d" % (
      torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
      torch.cuda.device_count()))

  log("[2] build")
  t0 = time.monotonic()
  build_s = _build.build_all()
  log("  built %s in %.1f s wall" % (
      ", ".join("%s %.1fs" % kv for kv in build_s.items()),
      time.monotonic() - t0))
  for name, text in sorted(_build.BUILD_LOG.items()):
    for line in text.splitlines():
      # register use, spills, and wgmma products ptxas had to serialize
      if "Used" in line or "spill" in line or "Performance Loss" in line:
        log("  ptxas %s: %s" % (name, line.strip()))
  if repeats:
    log("[4] serving main path x%d, then the prefill's host time" % repeats)
    return serving_only(torch, ops, tfm, ServingEngine, slots, init_params,
                        repeats)
  if ln_only:
    log("[3] the LayerNorm kernels alone, with device times")
    return layer_norm_only(torch, ops, F)
  spills = tensor_core_spills(_build.BUILD_LOG)
  sass = sass_counts(_build)

  log("[3] kernels against their plain versions")
  ln_rows, ln_err = check_layer_norm(ops, torch, F)
  fa_rows, fa_err = check_flash(ops, torch, F)
  lnb_rows, lnb_err = check_layer_norm_bwd(ops, torch, F)
  fab_rows, fab_err = check_flash_bwd(ops, torch, F)
  split_rows, split_err = check_flash_bwd_split(ops, torch, F)
  fm_rows, fm_err = check_fused_matmul(ops, torch, F)
  torch.cuda.empty_cache()
  for what, row, lib, yard in (
      ("flash fwd B16 S1024", pick(fa_rows, case="train"), "library_ms",
       "SDPA"),
      ("flash fwd B1 S16384 Hk4", pick(fa_rows, case="long"), "library_ms",
       "SDPA"),
      ("fused bwd B16 S1024", pick(fab_rows, case="train"), "library_ms",
       "SDPA bwd"),
      ("fused bwd B8 S1024 Hk4", pick(fab_rows, case="gqa_hk4"),
       "library_ms", "SDPA bwd"),
      ("split dK/dV B16 S1024", pick(split_rows, case="train", kernel="dkv"),
       "library_whole_bwd_ms", "SDPA whole bwd"),
      ("split dK/dV B1 S16384 Hk4", pick(split_rows, case="long",
                                         kernel="dkv"),
       "library_whole_bwd_ms", "SDPA whole bwd"),
      ("split dQ B16 S1024", pick(split_rows, case="train", kernel="dq"),
       "library_whole_bwd_ms", "SDPA whole bwd"),
      ("split dQ B1 S16384 Hk4", pick(split_rows, case="long", kernel="dq"),
       "library_whole_bwd_ms", "SDPA whole bwd"),
      ("GELU->matmul 16384x3072x768", pick(fm_rows, op="gelu_matmul",
                                           case="down"),
       "library_ms", "F.gelu + matmul"),
      ("LN->matmul 16384x768x2304", pick(fm_rows, op="ln_matmul",
                                         case="qkv"),
       "library_ms", "F.layer_norm + matmul"),
      ("LN->matmul 16384x768x3072", pick(fm_rows, op="ln_matmul", case="up"),
       "library_ms", "F.layer_norm + matmul"),
      ("LN bwd 16384x768", pick(lnb_rows, rows=16384, dtype="bfloat16"),
       "library_ms", "LayerNorm bwd")):
    log("  %-26s %.4f ms = %.2f x %s (%.4f ms), %.1f%% of bound"
        % (what, row["ms"], row["ms"] / row[lib], yard, row[lib],
           100.0 * row["bound_ms"] / row["ms"]))

  log("[3b] head dims 32 and 96: forward, fused and split backward")
  hd_rows, hd_err = check_head_dims(ops, torch, F)

  log("[4] main path: full-width ServingEngine, bf16")
  t0 = time.monotonic()
  cfg = tfm.TransformerConfig()
  params = init_params(cfg, seed=SEED)
  log("  weights from seed %d in %.1f s" % (SEED, time.monotonic() - t0))
  main_res, model = serve_main_path(torch, ops, tfm, ServingEngine, slots,
                                    params, cfg)

  log("[4b] where the main path's time goes (torch.profiler)")
  with torch.inference_mode():
    prof_res = profile_serving(torch, slots, model)
  del model

  log("[5] parity: full width, f32, engine vs greedy_generate_kv")
  parity = serve_parity_f32(torch, tfm, ServingEngine, params,
                            tfm.TransformerConfig(dtype=torch.float32))
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.cuda.empty_cache()

  log("[6] main path: full-width training, bf16, B%d x S%d"
      % (TRAIN_B, TRAIN_S))
  train_res = train_main_path(torch, ops, tfm, optim, sharding, Slab, params,
                              cfg, WANT_PER_STEP)
  torch.cuda.empty_cache()

  log("[6b] grouped-KV training: num_kv_heads 4, full width and depth")
  gqa_res = train_gqa(torch, ops, tfm, optim, sharding, init_params,
                      WANT_PER_STEP)
  torch.cuda.empty_cache()

  log("[6c] all-fused training (fuse_qkv + ln_matmul + gelu_matmul), bf16, "
      "B%d x S%d" % (TRAIN_B, TRAIN_S))
  fcfg = tfm.TransformerConfig(**ALL_FUSED)
  fused_res = train_main_path(torch, ops, tfm, optim, sharding, Slab,
                              init_params(fcfg, seed=SEED), fcfg,
                              WANT_FUSED_PER_STEP)
  for path in ("per_step", "fused_loop"):
    log("  %-10s unfused [6] %.1f ms/step %.0f tokens/s | all-fused %.1f "
        "ms/step %.0f tokens/s" % (
            path, train_res[path]["ms_per_step"],
            train_res[path]["tokens_per_s"], fused_res[path]["ms_per_step"],
            fused_res[path]["tokens_per_s"]))
  log("  peak memory: unfused %.2f GiB, all-fused %.2f GiB"
      % (train_res["peak_mem_gib"], fused_res["peak_mem_gib"]))
  torch.cuda.empty_cache()
  fgqa_res = train_gqa(torch, ops, tfm, optim, sharding, init_params,
                       WANT_FUSED_PER_STEP, **ALL_FUSED)
  torch.cuda.empty_cache()
  log("  device time of phase 3's fused products and LayerNorm kernels "
      "(torch.profiler)")
  fused_device_ms(ops, torch, F, fm_rows)
  layer_norm_device_ms(ops, torch, F, ln_rows, lnb_rows)
  torch.cuda.empty_cache()

  log("[6d] long-context grouped-KV training from TFRecords: train_gpt "
      "--kv_heads 4 --seq_len %d --batch %d, bf16" % (LONG_S, LONG_B))
  long_res = train_long_gqa(torch, ops, sharding, readers, train_gpt)
  torch.cuda.empty_cache()

  log("[6e] the flagship MHA under TFOS_TPU_FLASH_BWD=split, B%d x S%d"
      % (TRAIN_B, TRAIN_S))
  with flash_bwd_env("split"):
    split_res = train_main_path(torch, ops, tfm, optim, sharding, Slab,
                                params, cfg, WANT_SPLIT_PER_STEP)
  for path in ("per_step", "fused_loop"):
    log("  %-10s fused plan [6] %.1f ms/step | split plan %.1f ms/step"
        % (path, train_res[path]["ms_per_step"],
           split_res[path]["ms_per_step"]))
  torch.cuda.empty_cache()

  log("[6f] train_gpt at its default model flags (head_dim 32) from "
      "TFRecords")
  gpt_res = train_gpt_defaults(torch, ops, train_gpt)
  torch.cuda.empty_cache()

  log("[6g] one request at serve_gpt's config (head_dim 32, 2 KV heads)")
  serve_gpt_res = serve_gpt_config(torch, ops, tfm, ServingEngine,
                                   init_params)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.cuda.empty_cache()

  log("[7] parity: f32 training step, card kernels vs CPU plain versions")
  train_parity = train_parity_f32(torch, tfm, init_params)
  fused_parity = train_parity_f32(torch, tfm, init_params, **ALL_FUSED)
  with flash_bwd_env("split"):
    split_parity = train_parity_f32(torch, tfm, init_params)
    split_gqa_parity = train_parity_f32(torch, tfm, init_params,
                                        num_kv_heads=4)

  def launches(res, steps, name):
    return int(res["launches_per_step"][name] * steps)

  def entry(name, source, replaces, by_path, err, row, **extra):
    return dict({"name": name, "route": "cuda",
                 "source": "tensorflowonspark_tpu_torch/csrc/" + source,
                 "replaces": "tensorflowonspark_tpu/ops/" + replaces,
                 "launches": max(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": err, "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"]}, **extra)

  serve_l = main_res["launches"]
  step_l = {n: int(v * 4) for n, v in
            train_res["per_step"]["launches_per_step"].items()}
  fused_l = {n: int(v * 4) for n, v in
             fused_res["per_step"]["launches_per_step"].items()}
  split_l = {n: int(v * 4) for n, v in
             split_res["per_step"]["launches_per_step"].items()}
  fa_train, fa_long = pick(fa_rows, case="train"), pick(fa_rows, case="long")
  kernels = [
      entry("flash_attention_fwd", "flash_attention.cu",
            "flash_attention.py:124",
            {"serve": serve_l["flash_attention_fwd"],
             "train_4_steps": step_l["flash_attention_fwd"],
             "train_fused_4_steps": fused_l["flash_attention_fwd"],
             "train_long_gqa_2_steps": launches(long_res, 2,
                                                "flash_attention_fwd"),
             "train_gpt_defaults_%d_steps" % GPT_DEFAULT_STEPS: launches(
                 gpt_res, GPT_DEFAULT_STEPS, "flash_attention_fwd"),
             "serve_gpt_config_bf16": serve_gpt_res["bfloat16"]["launches"][
                 "flash_attention_fwd"]},
            max(fa_err, hd_err["fwd"]), pick(fa_rows, case="s512"),
            design="wgmma+tma", head_dims="8..128 (d % 8 == 0)",
            train={k: fa_train[k] for k in ("ms", "plain_ms", "library_ms",
                                            "bound_ms")},
            long={k: fa_long[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms")}),
      entry("layer_norm", "layer_norm.cu", "layer_norm.py:33",
            {"serve": serve_l["layer_norm"],
             "train_4_steps": step_l["layer_norm"],
             "train_fused_4_steps": fused_l["layer_norm"],
             "train_gpt_defaults_%d_steps" % GPT_DEFAULT_STEPS: launches(
                 gpt_res, GPT_DEFAULT_STEPS, "layer_norm")},
            ln_err, pick(ln_rows, rows=512, dtype="bfloat16"),
            train={k: pick(ln_rows, rows=16384)[k]
                   for k in ("ms", "device_ms", "library_ms", "bound_ms")}),
      entry("flash_attention_bwd", "flash_attention_bwd.cu",
            "flash_attention.py:232",
            {"train_4_steps": step_l["flash_attention_bwd"],
             "train_fused_4_steps": fused_l["flash_attention_bwd"],
             "train_gpt_defaults_%d_steps" % GPT_DEFAULT_STEPS: launches(
                 gpt_res, GPT_DEFAULT_STEPS, "flash_attention_bwd")},
            max(fab_err, hd_err["bwd"]), pick(fab_rows, case="train"),
            design="wgmma+tma", head_dims="8..128 (d % 8 == 0)"),
      entry("flash_attention_bwd_gqa", "flash_attention_bwd.cu",
            "flash_attention.py:332",
            {"train_gqa_2_steps": launches(gqa_res, 2,
                                           "flash_attention_bwd_gqa"),
             "train_fused_gqa_2_steps": launches(fgqa_res, 2,
                                                 "flash_attention_bwd_gqa")},
            max(fab_err, hd_err["bwd"]), pick(fab_rows, case="gqa_hk4"),
            design="wgmma+tma", head_dims="8..128 (d % 8 == 0)"),
      entry("layer_norm_bwd", "layer_norm.cu", "layer_norm.py:40",
            {"train_4_steps": step_l["layer_norm_bwd"],
             "train_fused_4_steps": fused_l["layer_norm_bwd"],
             "train_gpt_defaults_%d_steps" % GPT_DEFAULT_STEPS: launches(
                 gpt_res, GPT_DEFAULT_STEPS, "layer_norm_bwd")},
            lnb_err, pick(lnb_rows, rows=16384, dtype="bfloat16"),
            design="row in registers, grid from the SM count"),
      entry("ln_matmul", "ln_matmul.cu", "ln_matmul.py:31",
            {"train_fused_4_steps": fused_l["ln_matmul"],
             "train_fused_gqa_2_steps": launches(fgqa_res, 2, "ln_matmul")},
            fm_err, pick(fm_rows, op="ln_matmul", case="qkv"),
            library="F.layer_norm + torch.matmul (two calls)",
            design="wgmma+tma (bf16, h and n multiples of 8; WMMA for "
                   "other widths) + prologue_gemm_wgmma.cuh, LayerNorm in "
                   "registers"),
      entry("gelu_matmul", "act_matmul.cu", "act_matmul.py:55",
            {"train_fused_4_steps": fused_l["gelu_matmul"],
             "train_fused_gqa_2_steps": launches(fgqa_res, 2, "gelu_matmul")},
            fm_err, pick(fm_rows, op="gelu_matmul", case="down"),
            library="F.gelu + torch.matmul (two calls)",
            design="wgmma+tma (bf16, f and n multiples of 8; WMMA for "
                   "other widths) + prologue_gemm_wgmma.cuh"),
  ]
  # the split kernels: no single PyTorch call computes dQ or dK/dV alone;
  # SDPA's whole backward stands beside the pair's time
  for kern, name, replaces, by_path, case in (
      ("dq", "flash_attention_bwd_dq", "flash_attention.py:166",
       {"train_long_gqa_2_steps": launches(long_res, 2,
                                           "flash_attention_bwd_dq"),
        "train_split_4_steps": split_l["flash_attention_bwd_dq"]}, "long"),
      ("dkv", "flash_attention_bwd_dkv", "flash_attention.py:197",
       {"train_split_4_steps": split_l["flash_attention_bwd_dkv"]}, "train"),
      ("dkv", "flash_attention_bwd_dkv_gqa", "flash_attention.py:281",
       {"train_long_gqa_2_steps": launches(long_res, 2,
                                           "flash_attention_bwd_dkv_gqa")},
       "long")):
    row = pick(split_rows, case=case, kernel=kern)
    kernels.append(entry(
        name, "flash_attention_bwd_split.cu", replaces, by_path,
        max(split_err[kern], hd_err["split"]), row, design="wgmma+tma",
        head_dims="8..128 (d % 8 == 0)", library=row["library"],
        library_whole_bwd_ms=row["library_whole_bwd_ms"],
        split_pair_ms=row["split_pair_ms"], fused_ms=row["fused_ms"],
        shape="B%d S%d H%d Hk%d D%d" % (row["B"], row["Sq"], row["H"],
                                        row["Hk"], row["D"])))
  record = {"card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s,
            "sass_counts": sass, "tensor_core_spill_bytes": spills,
            "layer_norm": ln_rows, "flash_attention": fa_rows,
            "layer_norm_bwd": lnb_rows, "flash_attention_bwd": fab_rows,
            "flash_attention_bwd_split": split_rows, "fused_matmul": fm_rows,
            "head_dims": hd_rows, "train_gpt_defaults": gpt_res,
            "serve_gpt_config": serve_gpt_res,
            "main_path": main_res, "profile": prof_res,
            "parity_f32": parity, "train": train_res, "train_gqa": gqa_res,
            "train_fused": fused_res, "train_fused_gqa": fgqa_res,
            "train_long_gqa": long_res, "train_split": split_res,
            "train_parity_f32": train_parity,
            "train_fused_parity_f32": fused_parity,
            "train_split_parity_f32": split_parity,
            "train_split_gqa_parity_f32": split_gqa_parity,
            "total_s": time.monotonic() - t_start}
  out_dir = os.path.join(HERE, "chiprun_out")
  os.makedirs(out_dir, exist_ok=True)
  with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
    json.dump(record, f, indent=1)
  log("  total %.1f s" % record["total_s"])
  log(card)
  log(json.dumps({"kernels": kernels}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
