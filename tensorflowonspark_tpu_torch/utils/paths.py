"""Filesystem path normalization for heterogeneous storage schemes.

The port's copy of ``tensorflowonspark_tpu/utils/paths.py``. Capability
parity with TensorFlowOnSpark's ``TFNode.hdfs_path`` (``TFNode.py:32-67``),
which normalized user
paths against the cluster default filesystem across 10 Hadoop schemes. The TPU
build targets GCS-first storage but keeps the same semantics: absolute scheme
URIs pass through, relative paths are anchored at the default FS + working dir.
"""

import logging

logger = logging.getLogger(__name__)

# schemes that pass through untouched
_PASSTHROUGH = ("gs://", "hdfs://", "viewfs://", "file://", "s3://", "s3a://",
                "s3n://", "maprfs://", "swift://", "wasb://", "abfs://")


def absolute_path(path: str, default_fs: str = "file://",
                  working_dir: str = ".") -> str:
  """Convert a possibly-relative ``path`` to an absolute URI.

  Args:
    path: user path; may carry an explicit scheme, be absolute, or relative.
    default_fs: cluster default filesystem URI (e.g. ``gs://bucket`` or
      ``file://``).
    working_dir: current working directory used to anchor relative local paths.
  """
  if any(path.startswith(s) for s in _PASSTHROUGH):
    return path
  if path.startswith("/"):
    # absolute path on the default FS
    if default_fs.startswith("file://"):
      return "file://" + path
    return default_fs.rstrip("/") + path
  # relative path
  if default_fs.startswith("file://"):
    import os
    return "file://" + os.path.join(os.path.abspath(working_dir), path)
  return default_fs.rstrip("/") + "/" + path


def strip_scheme(path: str) -> str:
  """Drop a ``file://`` scheme so the path can be used with local IO."""
  if path.startswith("file://"):
    return path[len("file://"):]
  return path


def is_remote_uri(path: str) -> bool:
  """True for non-local scheme URIs (gs://, hdfs://, s3://, ...)."""
  return any(path.startswith(s) for s in _PASSTHROUGH if s != "file://")


def for_io(path: str) -> str:
  """Normalize a storage target for IO libraries (orbax/tensorstore).

  Remote scheme URIs pass through untouched — orbax handles ``gs://`` etc.
  natively, and ``os.path.abspath`` would mangle them into bogus local
  paths. Local paths (with or without ``file://``) become absolute.
  """
  if is_remote_uri(path):
    return path
  import os
  return os.path.abspath(strip_scheme(path))


def join(path: str, *parts: str) -> str:
  """Scheme-aware join: ``/`` for remote URIs, ``os.path.join`` locally."""
  if is_remote_uri(path):
    return "/".join([path.rstrip("/")] + list(parts))
  import os
  return os.path.join(path, *parts)
