"""File IO for local and remote storage: one open/glob surface.

The port's copy of ``tensorflowonspark_tpu/data/fs.py``. Any ``scheme://``
URI but ``file://`` goes through fsspec (gcsfs for ``gs://``, and s3, hdfs,
memory, ... whatever the environment provides), imported at first use;
plain paths and ``file://`` URIs stay on builtin IO. Where fsspec is not
installed, a remote path raises ``ImportError`` naming it: nothing falls
back to a local path.

Remote files stream: fsspec's file objects buffer remote blocks, so the
TFRecord framing reads record at a time without downloading whole files.
"""

import glob as _glob
import os
import re
import shutil

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def is_remote(path: str) -> bool:
  """True when ``path`` names a non-local filesystem: any ``scheme://``
  URI except ``file://`` (fsspec resolves the backend, so no allowlist)."""
  return (isinstance(path, str) and bool(_SCHEME_RE.match(path))
          and not path.startswith("file://"))


def strip_scheme(path: str) -> str:
  """Drop a ``file://`` scheme so the path can be used with local IO."""
  return path[len("file://"):] if path.startswith("file://") else path


def join(path: str, *parts: str) -> str:
  """Scheme-aware join: ``/`` for remote URIs, ``os.path.join`` locally."""
  if is_remote(path):
    return "/".join([path.rstrip("/")] + list(parts))
  return os.path.join(path, *parts)


def _url_to_fs(path: str):
  try:
    import fsspec
  except ImportError as e:
    raise ImportError(
        "remote storage (%r) needs the fsspec package, which is not "
        "installed" % path.split("://", 1)[0]) from e
  return fsspec.core.url_to_fs(path)


def open_file(path: str, mode: str = "rb"):
  """Open ``path`` for streamed IO; remote schemes go through fsspec
  (the parent directory is made first for a write, where the backend has
  directories)."""
  if is_remote(path):
    rfs, rpath = _url_to_fs(path)
    if "w" in mode or "a" in mode:
      parent = rpath.rsplit("/", 1)[0] if "/" in rpath else ""
      if parent:
        try:
          rfs.makedirs(parent, exist_ok=True)
        except (OSError, NotImplementedError):
          pass   # an object store has no directories; the open decides
    return rfs.open(rpath, mode)
  return open(strip_scheme(path), mode)


def glob_files(pattern: str):
  """Expand a glob pattern into concrete paths, keeping the scheme:
  remote patterns give fully-qualified URIs, so readers route back
  through fsspec; local ones behave as ``glob.glob``."""
  if is_remote(pattern):
    rfs, rpattern = _url_to_fs(pattern)
    return [rfs.unstrip_protocol(p) for p in rfs.glob(rpattern)]
  return _glob.glob(strip_scheme(pattern))


def file_size(path: str) -> int:
  """Size in bytes (a remote backend is asked, nothing is downloaded)."""
  if is_remote(path):
    rfs, rpath = _url_to_fs(path)
    return int(rfs.size(rpath))
  return os.path.getsize(strip_scheme(path))


def exists(path: str) -> bool:
  if is_remote(path):
    rfs, rpath = _url_to_fs(path)
    return rfs.exists(rpath)
  return os.path.exists(strip_scheme(path))


def isdir(path: str) -> bool:
  if is_remote(path):
    rfs, rpath = _url_to_fs(path)
    return rfs.isdir(rpath)
  return os.path.isdir(strip_scheme(path))


def makedirs(path: str, exist_ok: bool = True) -> None:
  if is_remote(path):
    rfs, rpath = _url_to_fs(path)
    rfs.makedirs(rpath, exist_ok=exist_ok)
    return
  os.makedirs(strip_scheme(path), exist_ok=exist_ok)


def listdir(path: str):
  """Names (not full paths) under ``path``, sorted."""
  if is_remote(path):
    rfs, rpath = _url_to_fs(path)
    return sorted(p.rstrip("/").rsplit("/", 1)[-1]
                  for p in rfs.ls(rpath, detail=False))
  return sorted(os.listdir(strip_scheme(path)))


def remove_tree(path: str) -> None:
  """Delete the directory ``path`` and everything under it."""
  if is_remote(path):
    rfs, rpath = _url_to_fs(path)
    rfs.rm(rpath, recursive=True)
    return
  shutil.rmtree(strip_scheme(path))
