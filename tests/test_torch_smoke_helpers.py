"""``chip_smoke.py``'s bound arithmetic against the port's plain mask.

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
