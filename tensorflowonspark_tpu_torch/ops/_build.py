"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The counterpart of Mosaic lowering in the JAX package: each kernel source
is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library with
a plain C interface, loaded with :mod:`ctypes`. Libraries land in
``build/torch_kernels/`` at the root of the checkout, named
``lib<kernel>.<digest>.so`` where the digest hashes the kernel's source,
every shared header (``csrc/*.cuh``) and the compiler flags — an edited
source or header builds anew, an unchanged one loads what is there.
Nothing here runs at import: the first wrapper call on a CUDA tensor
builds (or loads) its kernel.

There is no fallback. A missing ``nvcc``, a failed compile or a failed
load raises, and the wrapper that asked raises with it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

from tensorflowonspark_tpu_torch.obs import device as obs_device

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_split", "layer_norm", "ln_matmul", "act_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: the C interface's dtype codes (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_COMPILE_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: compiler output (ptxas register / shared-memory report) per kernel
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  default = "/usr/local/cuda/bin/nvcc"
  if os.path.exists(default):
    return default
  raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                     "%s at first use and need the CUDA toolkit" % CSRC)


def _source(name: str) -> Path:
  if name not in KERNELS:
    raise ValueError("unknown kernel %r (have %s)" % (name, ", ".join(KERNELS)))
  return CSRC / (name + ".cu")


def library_path(name: str) -> Path:
  """Where ``name``'s library lives for the current sources and flags."""
  h = hashlib.sha256()
  for part in (_source(name), *sorted(CSRC.glob("*.cuh"))):
    h.update(part.name.encode())
    h.update(part.read_bytes())
  h.update(" ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / ("lib%s.%s.so" % (name, h.hexdigest()[:16]))


def _start(name: str):
  """Launch one nvcc into a temporary file; returns (process, tmp, final)."""
  out = library_path(name)
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
  cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
         str(_source(name))]
  proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
  return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> None:
  try:
    log, _ = proc.communicate(timeout=_COMPILE_TIMEOUT_S)
  except subprocess.TimeoutExpired:
    proc.kill()
    proc.communicate()
    raise RuntimeError("nvcc timed out after %ds on %s"
                       % (_COMPILE_TIMEOUT_S, _source(name)))
  BUILD_LOG[name] = log
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError("nvcc failed (%d) on %s:\n%s"
                       % (proc.returncode, _source(name), log))
  os.replace(tmp, out)           # atomic: a concurrent build never sees half


def build_all() -> Dict[str, float]:
  """Build every kernel not yet built, one ``nvcc`` per source, all
  started together. Returns the seconds each build took (0.0 for a
  library already on disk). Raises on the first failed build."""
  started, secs = {}, {}
  for name in KERNELS:
    if library_path(name).exists():
      secs[name] = 0.0
      obs_device.note_build("kernel." + name, 0.0, cached=True)
    else:
      started[name] = (time.monotonic(),) + _start(name)
  errors = []
  for name, (t0, proc, tmp, out) in started.items():
    try:
      _finish(name, proc, tmp, out)
    except RuntimeError as e:
      errors.append(e)
    secs[name] = time.monotonic() - t0
    obs_device.note_build("kernel." + name, secs[name], cached=False)
  if errors:
    raise errors[0]
  return secs


def load(name: str) -> ctypes.CDLL:
  """The loaded library for kernel ``name``, building it on first use."""
  with _lock:
    lib = _libs.get(name)
    if lib is not None:
      return lib
    path = library_path(name)
    t0, cached = time.monotonic(), path.exists()
    if not cached:
      _finish(name, *_start(name))
    # the port's compile event (obs.device): nvcc at first use
    obs_device.note_build("kernel." + name, time.monotonic() - t0, cached)
    lib = ctypes.CDLL(str(path))
    lib.tos_error_string.argtypes = [ctypes.c_int]
    lib.tos_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
  """Raise when a C entry point returned a CUDA error code."""
  if rc != 0:
    msg = lib.tos_error_string(rc).decode(errors="replace")
    raise RuntimeError("%s: CUDA error %d (%s)" % (what, rc, msg))


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
  """PyTorch's current stream on ``t``'s device, as a C pointer."""
  return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
  return ctypes.c_void_p(t.data_ptr())


def aligned(t: torch.Tensor) -> torch.Tensor:
  """``t`` contiguous and 16-byte aligned (the kernels' vector loads and
  TMA copies)."""
  t = t.contiguous()
  return t if t.data_ptr() % 16 == 0 else t.clone()
