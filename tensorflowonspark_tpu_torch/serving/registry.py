"""Versioned model registry: the durable seam between train and serve.

The port's copy of ``tensorflowonspark_tpu/serving/registry.py``, on the
same on-disk layout and marker schema. A trainer publishes params + a
manifest (step, lineage, content fingerprint) as an atomic,
monotonically numbered version; the serving side polls ``latest()`` /
``watch()`` and drives each new version through the canary state machine
(``serving.deploy``).

Publish is torn-write-proof by the same commit-marker protocol as
checkpoints (``utils.checkpoint.atomic_write_json``): the version's params
file is written and fsynced first, then the marker commits it. A
publisher killed at any point leaves either a complete marked version or
an unmarked (invisible) directory; ``latest()`` resolves to the previous
marked version, never to a tear.

Retention is ref-counted: a fleet mid-canary pins the versions it serves
via ``acquire``/``release``, and ``gc()`` never deletes a pinned version,
the newest live version, or a quarantined one (quarantine is the
post-mortem record). Quarantine (``serving.deploy`` rollback) stamps a
structured verdict next to the version and hides it from ``latest()``, so
a watcher can never re-deploy a version that already failed VERIFY.

Layout under ``root``::

    v-000007/
      params.npz        # flattened leaf arrays (path-keyed)
      .commit.json      # the marker: version/step/fingerprint/lineage
      .quarantine.json  # only after a rollback: the structured verdict

Params are the port's flat ``{name: ndarray | Tensor}`` dict (or nested
dicts of them, keyed by ``/``-joined paths). Tensors are stored as numpy
arrays on the host; numpy has no bfloat16, so a bf16 leaf is stored as
float32, which is exact. The fingerprint is the port's own
``params_fingerprint`` over the stored arrays, so a version published by
the JAX package does not verify here, nor one of the port's there.
"""

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from tensorflowonspark_tpu_torch.utils.checkpoint import (
    atomic_write_json, params_fingerprint)

logger = logging.getLogger(__name__)

#: default number of non-quarantined versions ``gc()`` keeps (newest N).
ENV_REGISTRY_KEEP = "TOS_REGISTRY_KEEP"
#: ``watch()`` poll interval in seconds.
ENV_REGISTRY_POLL = "TOS_REGISTRY_POLL"

_DIR_FMT = "v-%06d"
_DIR_PREFIX = "v-"
_MARKER = ".commit.json"
_QUARANTINE = ".quarantine.json"
_PARAMS = "params.npz"

_DEFAULT_KEEP = 3
_DEFAULT_POLL = 0.1


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
  """Nested dict of leaves → {'a/b/c': leaf}; a flat dict stays as it
  is. '/' in a key would corrupt the path encoding, so it is refused."""
  out = {}
  if not isinstance(tree, dict):
    raise TypeError("registry params must be a dict of arrays, got %s"
                    % type(tree).__name__)
  for k, v in tree.items():
    k = str(k)
    if "/" in k:
      raise ValueError("registry params key %r contains '/'" % k)
    path = prefix + k
    if isinstance(v, dict):
      out.update(_flatten(v, path + "/"))
    else:
      out[path] = v
  return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
  out: Dict[str, Any] = {}
  for path, v in flat.items():
    parts = path.split("/")
    node = out
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = v
  return out


def _host_array(v) -> np.ndarray:
  """A leaf as a host numpy array (bf16 tensors as exact float32)."""
  if torch.is_tensor(v):
    t = v.detach().cpu()
    if t.dtype == torch.bfloat16:
      t = t.float()
    return t.numpy()
  return np.asarray(v)


class ModelRegistry(object):
  """Filesystem model registry with atomic publish and ref-counted GC.

  Thread-safe; cheap to construct (a reader needs only the root path).
  Several processes may read one registry; publish assumes a single
  writer (the chief trainer, as for checkpoints).
  """

  def __init__(self, root: str, keep: Optional[int] = None):
    self.root = str(root)
    os.makedirs(self.root, exist_ok=True)
    if keep is None:
      keep = int(os.environ.get(ENV_REGISTRY_KEEP, _DEFAULT_KEEP))
    self.keep = max(1, int(keep))
    self._lock = threading.Lock()
    self._refs: Dict[int, int] = {}

  # -- paths -----------------------------------------------------------------

  def _dir(self, version: int) -> str:
    return os.path.join(self.root, _DIR_FMT % version)

  def _marker_path(self, version: int) -> str:
    return os.path.join(self._dir(version), _MARKER)

  def _quarantine_path(self, version: int) -> str:
    return os.path.join(self._dir(version), _QUARANTINE)

  # -- publish ---------------------------------------------------------------

  def publish(self, params: Any, step: int, lineage: Optional[dict] = None,
              extra: Optional[dict] = None) -> int:
    """Publish ``params`` as the next version; returns the version number.

    Params bytes are written and fsynced, then the marker commits the
    version atomically. The manifest records the content fingerprint, so
    a reader (and VERIFY in the deploy controller) detects corruption at
    rest before a request is routed at the version.
    """
    version = (self._newest_dir() or 0) + 1
    vdir = self._dir(version)
    os.makedirs(vdir, exist_ok=True)
    arrays = {k: _host_array(v) for k, v in _flatten(params).items()}
    ppath = os.path.join(vdir, _PARAMS)
    with open(ppath, "wb") as f:
      np.savez(f, **arrays)
      f.flush()
      os.fsync(f.fileno())
    manifest = {
        "version": version,
        "step": int(step),
        "fingerprint": params_fingerprint(_unflatten(arrays)),
        "lineage": dict(lineage or {}),
        "published_at": time.time(),
    }
    if extra:
      manifest["extra"] = dict(extra)
    atomic_write_json(self._marker_path(version), manifest)
    logger.info("registry published version %d (step %d)", version, step)
    return version

  def publish_on_checkpoint(self, manager: Any,
                            get_params: Optional[Callable] = None,
                            lineage: Optional[dict] = None) -> None:
    """Attach this registry to a ``CheckpointManager``: every committed
    checkpoint is published as a serving candidate on the save cadence.
    ``get_params`` extracts the params from the saved train state
    (default: ``state.params``, or the state itself for a bare dict)."""
    def _hook(step, state, manifest):
      params = (get_params(state) if get_params is not None
                else getattr(state, "params", state))
      lin = dict(lineage or {})
      lin.setdefault("checkpoint_dir", getattr(manager, "directory", None))
      if manifest:
        lin.setdefault("checkpoint_manifest", manifest)
      self.publish(params, step=step, lineage=lin)
    manager.publish_hook = _hook

  # -- read side -------------------------------------------------------------

  def _all_dirs(self) -> List[int]:
    vs = []
    try:
      names = os.listdir(self.root)
    except OSError:
      return []
    for name in names:
      if name.startswith(_DIR_PREFIX):
        try:
          vs.append(int(name[len(_DIR_PREFIX):]))
        except ValueError:
          continue
    return vs

  def _newest_dir(self) -> Optional[int]:
    """Highest version directory number, marked or not: the publish
    counter must never reuse a torn version's number."""
    vs = self._all_dirs()
    return max(vs) if vs else None

  def versions(self, include_quarantined: bool = False) -> List[int]:
    """Ascending committed versions (marker present and parseable). A
    version whose publish tore does not exist here."""
    out = []
    for v in sorted(set(self._all_dirs())):
      if self._manifest_or_none(v) is None:
        continue
      if not include_quarantined and self.is_quarantined(v):
        continue
      out.append(v)
    return out

  def _manifest_or_none(self, version: int) -> Optional[dict]:
    try:
      with open(self._marker_path(version)) as f:
        return json.load(f)
    except (OSError, ValueError):
      return None

  def latest(self) -> Optional[int]:
    """Newest committed, non-quarantined version, or None."""
    vs = self.versions()
    return vs[-1] if vs else None

  def manifest(self, version: int) -> dict:
    rec = self._manifest_or_none(version)
    if rec is None:
      raise FileNotFoundError("registry version %d in %s has no commit "
                              "marker (torn or missing publish)"
                              % (version, self.root))
    return rec

  def get(self, version: int, verify: bool = True):
    """(params, manifest) for a committed version; params as numpy
    arrays. ``verify=True`` recomputes the content fingerprint against
    the manifest: corruption at rest raises ``ValueError`` here instead
    of serving wrong logits."""
    manifest = self.manifest(version)
    with np.load(os.path.join(self._dir(version), _PARAMS)) as z:
      params = _unflatten({k: z[k] for k in z.files})
    if verify:
      fp = params_fingerprint(params)
      if fp != manifest.get("fingerprint"):
        raise ValueError(
            "registry version %d params fingerprint %s != manifest %s "
            "(corrupt at rest)" % (version, fp, manifest.get("fingerprint")))
    return params, manifest

  def watch(self, timeout: float, last_seen: Optional[int] = None,
            poll: Optional[float] = None) -> Optional[int]:
    """Block until a version newer than ``last_seen`` commits; returns
    it, or None on timeout. The deploy controller's main wait."""
    if poll is None:
      poll = float(os.environ.get(ENV_REGISTRY_POLL, _DEFAULT_POLL))
    deadline = time.monotonic() + timeout
    while True:
      cur = self.latest()
      if cur is not None and (last_seen is None or cur > last_seen):
        return cur
      if time.monotonic() >= deadline:
        return None
      time.sleep(min(poll, max(0.0, deadline - time.monotonic())))

  # -- quarantine ------------------------------------------------------------

  def quarantine(self, version: int, verdict: Optional[dict] = None) -> None:
    """Mark a version failed (rollback): hidden from ``latest()`` and
    ``watch()`` for good, kept on disk with the structured verdict as the
    post-mortem record. Atomic (same marker protocol)."""
    atomic_write_json(self._quarantine_path(version), {
        "version": int(version),
        "verdict": dict(verdict or {}),
        "quarantined_at": time.time(),
    })
    logger.warning("registry version %d quarantined: %s", version,
                   (verdict or {}).get("reason", "unspecified"))

  def is_quarantined(self, version: int) -> bool:
    return os.path.exists(self._quarantine_path(version))

  def quarantine_record(self, version: int) -> Optional[dict]:
    try:
      with open(self._quarantine_path(version)) as f:
        return json.load(f)
    except (OSError, ValueError):
      return None

  # -- ref-counted retention -------------------------------------------------

  def acquire(self, version: int) -> None:
    """Pin a version against GC (a fleet serving or canarying it)."""
    with self._lock:
      self._refs[version] = self._refs.get(version, 0) + 1

  def release(self, version: int) -> None:
    with self._lock:
      n = self._refs.get(version, 0) - 1
      if n <= 0:
        self._refs.pop(version, None)
      else:
        self._refs[version] = n

  def refcount(self, version: int) -> int:
    with self._lock:
      return self._refs.get(version, 0)

  def gc(self, keep: Optional[int] = None) -> List[int]:
    """Delete old versions beyond the newest ``keep`` live ones; returns
    the versions removed. Never deletes a version some fleet still serves
    (refcount > 0), the newest live version, a quarantined version, or an
    unmarked directory (it may be a publish in flight)."""
    import shutil
    keep = self.keep if keep is None else max(1, int(keep))
    live = self.versions()
    removed = []
    if not live:
      return removed
    newest = live[-1]
    candidates = live[:-keep] if len(live) > keep else []
    for v in candidates:
      if v == newest or self.refcount(v) > 0:
        continue
      try:
        shutil.rmtree(self._dir(v))
        removed.append(v)
      except OSError as e:  # tosa: ignore[TOS004] - GC is best-effort
        # pruning must never fail a publish or a deploy; the version
        # stays and the next gc() pass retries it
        logger.warning("registry gc of version %d failed: %s", v, e)
    if removed:
      logger.info("registry gc removed versions %s", removed)
    return removed
