"""Hand-written Hopper kernels for the hot ops, and the rule that picks them.

The counterpart of ``tensorflowonspark_tpu/ops/__init__.py``, where the
JAX package chooses between a Pallas kernel and its interpret mode. Here
the tensor's device decides, and nothing else:

* a CUDA tensor goes to the hand-written kernel (``csrc/*.cu``, built by
  :mod:`._build`), or the call raises — there is no fallback on the card;
* a CPU tensor goes to the kernel's plain PyTorch version (the
  ``*_reference`` function beside each wrapper), which is how the CPU
  tests run the same code paths.

Each kernel keeps a plain-integer launch count in :data:`LAUNCHES`, bumped
by its wrapper where it launches the kernel and nowhere else, so a run can
show that its main path went through the kernels. The backward kernels
count apart from the forward ones. The fused flash backward counts under
``flash_attention_bwd`` (Hk == H) or ``flash_attention_bwd_gqa``; the
split plan counts its dQ kernel under ``flash_attention_bwd_dq`` and its
dK/dV kernel under ``flash_attention_bwd_dkv`` (Hk == H) or
``flash_attention_bwd_dkv_gqa``. The
fused products ``ln_matmul`` and ``gelu_matmul`` count their forward
kernels; their backwards are plain PyTorch, as the reference's are plain
XLA.
"""

import threading
from typing import Dict

import torch

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"layer_norm": 0, "layer_norm_bwd": 0,
                             "flash_attention_fwd": 0,
                             "flash_attention_bwd": 0,
                             "flash_attention_bwd_gqa": 0,
                             "flash_attention_bwd_dq": 0,
                             "flash_attention_bwd_dkv": 0,
                             "flash_attention_bwd_dkv_gqa": 0,
                             "ln_matmul": 0, "gelu_matmul": 0}
_LAUNCH_LOCK = threading.Lock()


def on_card(*tensors: torch.Tensor) -> bool:
  """True when every tensor lies on a CUDA device (run the kernel),
  False when every one lies on the CPU (run the plain version). Mixed or
  other devices raise."""
  kinds = {t.device.type for t in tensors}
  if kinds == {"cuda"}:
    if len({t.device for t in tensors}) != 1:
      raise ValueError("kernel inputs lie on different CUDA devices: %s"
                       % sorted(str(t.device) for t in tensors))
    return True
  if kinds == {"cpu"}:
    return False
  raise ValueError("kernel inputs must all be on CUDA or all on the CPU, "
                   "got %s" % sorted(kinds))


def count_launch(name: str) -> None:
  # locked: the replicas of a serving fleet launch from a loop thread each
  with _LAUNCH_LOCK:
    LAUNCHES[name] += 1


def reset_launches() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


from tensorflowonspark_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_block, flash_attention_bwd,
    flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq, flash_attention_bwd_dq_reference,
    flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_reference, merge_partials)
from tensorflowonspark_tpu_torch.ops.layer_norm import (  # noqa: E402
    layer_norm, layer_norm_bwd, layer_norm_bwd_reference,
    layer_norm_reference)
from tensorflowonspark_tpu_torch.ops.ln_matmul import (  # noqa: E402
    ln_matmul, ln_matmul_bwd, ln_matmul_reference, ln_matmul_sharded)
from tensorflowonspark_tpu_torch.ops.act_matmul import (  # noqa: E402
    gelu_matmul, gelu_matmul_bwd, gelu_matmul_reference, gelu_matmul_sharded)

__all__ = ["LAUNCHES", "on_card", "count_launch", "reset_launches",
           "flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_block", "merge_partials",
           "flash_attention_reference", "flash_attention_bwd_reference",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference",
           "layer_norm", "layer_norm_bwd", "layer_norm_reference",
           "layer_norm_bwd_reference", "ln_matmul",
           "ln_matmul_bwd", "ln_matmul_reference", "ln_matmul_sharded",
           "gelu_matmul", "gelu_matmul_bwd", "gelu_matmul_reference",
           "gelu_matmul_sharded"]
