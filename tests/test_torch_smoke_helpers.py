"""``chip_smoke.py``'s helpers: its bound arithmetic against the port's
plain mask, and the names it reads kernels by.

Every share of bound the smoke run reports for a flash kernel divides by the
visible (q, k) pairs ``chip_smoke._visible_pairs`` counts. Here that count
must equal the pairs the plain version's causal (+ window) mask keeps
(``ops/flash_attention.py`` ``_keep_mask``), at small shapes with offsets,
ragged lengths and windows. Importing ``chip_smoke`` needs no card: it
imports only the standard library until ``main`` runs.
"""

import importlib

import pytest

import chip_smoke

fa = importlib.import_module("tensorflowonspark_tpu_torch.ops.flash_attention")

# (Sq, Sk, q_base, kv_base, window): square causal, ragged Sq != Sk with the
# queries offset past the keys (a prefill chunk, offset_lse), keys ahead of
# some queries (kv_ahead) and of every query, windows alone and offset
VISIBLE_CASES = [(64, 64, 0, 0, None), (100, 250, 150, 0, None),
                 (512, 1024, 512, 0, None), (160, 160, 0, 32, None),
                 (16, 16, 0, 100, None), (200, 200, 0, 0, 24),
                 (300, 700, 400, 0, 64), (130, 150, 0, 0, 1),
                 (256, 256, 0, 64, 128)]


@pytest.mark.parametrize("sq,sk,q_base,kv_base,window", VISIBLE_CASES)
def test_visible_pairs_equal_the_plain_mask(sq, sk, q_base, kv_base, window):
  keep = fa._keep_mask(sq, sk, q_base, kv_base, window, "cpu")
  assert chip_smoke._visible_pairs(sq, sk, q_base, kv_base, window) == \
      int(keep.sum())


# (symbol, prologue): mangled names as ptxas and cuobjdump print them, and
# demangled ones as the profiler does, of both instantiations of the wgmma
# body and of the WMMA and f32 bodies; and symbols of no fused product
PROLOGUE_CASES = [
    ("_ZN3tos8pgemm_wg19prologue_gemm_wgmmaILNS_5pgemm8PrologueE0EEEv14CUtensorMap_st",
     "kLayerNorm"),
    ("_ZN3tos8pgemm_wg19prologue_gemm_wgmmaILNS_5pgemm8PrologueE1EEEv14CUtensorMap_st",
     "kGelu"),
    ("void tos::pgemm_wg::prologue_gemm_wgmma<(tos::pgemm::Prologue)0>"
     "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float2 const*, "
     "__nv_bfloat16*, int, int, int)", "kLayerNorm"),
    ("void tos::pgemm_wg::prologue_gemm_wgmma<(tos::pgemm::Prologue)1>"
     "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float2 const*, "
     "__nv_bfloat16*, int, int, int)", "kGelu"),
    ("void tos::pgemm::prologue_gemm_bf16<(tos::pgemm::Prologue)0>(...)",
     "kLayerNorm"),
    ("void tos::pgemm::prologue_gemm_f32<(tos::pgemm::Prologue)1, true>(...)",
     "kGelu"),
    ("void tos::pgemm::ln_matmul_stats_kernel<__nv_bfloat16, 8>(...)", None),
    ("_ZN3tos4fwd22flash_fwd_kernel_wgmmaILi64EEEvv", None),
]


@pytest.mark.parametrize("symbol,prologue", PROLOGUE_CASES)
def test_prologue_names_the_instantiation(symbol, prologue):
  assert chip_smoke._prologue(symbol) == prologue
  if symbol.startswith("_Z") and prologue:
    assert chip_smoke._instance(symbol) == prologue


@pytest.mark.parametrize("mangled,width", [
    ("_ZN3tos4fwd22flash_fwd_kernel_wgmmaILi64EEEvv", "64"),
    ("_ZN3tos4fwd22flash_fwd_kernel_wgmmaILi128EEEvv", "128")])
def test_instance_of_a_flash_kernel_is_its_width(mangled, width):
  assert chip_smoke._instance(mangled) == width


@pytest.mark.parametrize("symbol,kernel", [
    (PROLOGUE_CASES[2][0], "ln_matmul"), (PROLOGUE_CASES[3][0], "gelu_matmul"),
    (PROLOGUE_CASES[4][0], "ln_matmul"), (PROLOGUE_CASES[5][0], "gelu_matmul"),
    (PROLOGUE_CASES[6][0], "ln_matmul"),
    ("void (anonymous namespace)::layer_norm_bwd_kernel<__nv_bfloat16, 8, 3>"
     "(...)", "layer_norm_bwd"),
    ("void (anonymous namespace)::layer_norm_bwd_wide_kernel<float, 1>(...)",
     "layer_norm_bwd"),
    ("(anonymous namespace)::layer_norm_dw_kernel(float const*, float*, int, "
     "int)", "layer_norm_bwd"),
    ("void (anonymous namespace)::layer_norm_fwd_kernel<__nv_bfloat16, 8>"
     "(...)", "layer_norm"),
    ("ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_stages_64x3_nn", None)])
def test_port_kernel_of_a_device_symbol(symbol, kernel):
  assert chip_smoke._port_kernel(symbol) == kernel


@pytest.mark.parametrize("names,body,prologue,ok", [
    ([PROLOGUE_CASES[2][0], "ln_matmul_stats_kernel"], "wgmma", "kLayerNorm",
     True),
    ([PROLOGUE_CASES[3][0]], "wgmma", "kLayerNorm", False),
    ([PROLOGUE_CASES[4][0]], "wgmma", "kLayerNorm", False),
    ([PROLOGUE_CASES[4][0]], "wmma", "kLayerNorm", True),
    ([PROLOGUE_CASES[5][0]], "f32", "kGelu", True)])
def test_ran_instance_wants_the_body_and_the_prologue(names, body, prologue,
                                                      ok):
  ran, seen = chip_smoke._ran_instance(names, body, prologue)
  assert seen == ok
  assert ran == sorted(n for n in names if "prologue_gemm" in n)


@pytest.mark.parametrize("nbytes,flops,by", [
    (75.5e6, 20 * 16384 * 768, "bytes"), (1e3, 1e12, "operations")])
def test_bound_is_the_larger_of_bytes_and_operations(nbytes, flops, by):
  ms, what = chip_smoke._bound(nbytes, flops)
  assert what == by
  assert ms == max(nbytes / chip_smoke.HBM_BYTES_PER_S,
                   flops / chip_smoke.ELEMENTWISE_FLOPS) * 1e3


@pytest.mark.parametrize("op", ["ln_matmul", "gelu_matmul"])
def test_fused_module_has_the_body_rule(op):
  mod = chip_smoke._fused_module(op)
  assert mod.__name__.endswith("ln_matmul" if op == "ln_matmul"
                               else "act_matmul")
  assert callable(mod.kernel_body)


@pytest.mark.parametrize("backward", [False, True])
def test_ln_inputs_follow_their_case(backward):
  import torch
  cases = chip_smoke.LN_BWD_CASES if backward else chip_smoke.LN_CASES
  for i, (rows, h, dt, _) in enumerate(cases[:3]):
    got = chip_smoke._ln_inputs(torch, cases, i, backward, device="cpu")
    assert len(got) == (3 if backward else 2)
    x, w = got[0], got[1]
    assert x.shape == (rows, h) and x.dtype == getattr(torch, dt)
    assert w.shape == (h,) and w.dtype == torch.float32
    if backward:
      assert got[2].shape == x.shape and got[2].dtype == x.dtype
    again = chip_smoke._ln_inputs(torch, cases, i, backward, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# -- [6l]: the data-parallel phase's bookkeeping --------------------------------


def test_dp_reassemble_puts_rank0s_rows_first():
  import numpy as np
  rows = [np.full(3, i, np.int32) for i in range(10)]
  ids = [[[0, 1], [4, 5]], [[8, 9], [2, 3]]]
  got = chip_smoke.dp_reassemble(ids, rows)
  assert [b[:, 0].tolist() for b in got] == [[0, 1, 8, 9], [4, 5, 2, 3]]
  with pytest.raises(AssertionError, match="steps"):
    chip_smoke.dp_reassemble([[[0]], []], rows)


@pytest.mark.parametrize("parts,per,steps", [([96, 88], 8, 11),
                                             ([12, 8], 4, 2),
                                             ([8, 12], 4, 2),
                                             ([16, 16], 8, 2)])
def test_dp_vote_passed_counts_the_shortest_partitions_batches(parts, per,
                                                               steps):
  got = chip_smoke.dp_vote_passed(parts, per)
  assert [len(r) for r in got] == [steps, steps]
  # each rank trains the first full batches of its own partition, in order
  assert got[0][0] == list(range(per))
  assert got[1][0] == list(range(parts[0], parts[0] + per))
  assert all(len(b) == per for r in got for b in r)
  # the tier-1 twin: 12 and 8 rows at 4 train ids 0-7 and 12-19
  if parts == [12, 8]:
    assert sum(i for r in got for b in r for i in b) == \
        sum(range(8)) + sum(range(12, 20))


def test_dp_max_rel():
  assert chip_smoke.dp_max_rel([1.0, 2.002], [1.0, 2.0]) == \
      pytest.approx(1e-3)
  with pytest.raises(AssertionError, match="losses"):
    chip_smoke.dp_max_rel([1.0], [1.0, 2.0])
