"""Local file IO for the data feed: one open/glob surface.

Counterpart of the local-path part of ``tensorflowonspark_tpu/data/fs.py``
(:func:`is_remote`, :func:`open_file`, :func:`file_size`,
:func:`glob_files`). The reference
routes any ``scheme://`` URI through fsspec; the port keeps plain paths and
``file://`` URIs on builtin IO and refuses a remote scheme by name, since
the machines it runs on carry no fsspec.
"""

import glob as _glob
import os
import re

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def is_remote(path: str) -> bool:
  """True when ``path`` names a non-local filesystem: any ``scheme://``
  URI except ``file://``."""
  return (isinstance(path, str) and bool(_SCHEME_RE.match(path))
          and not path.startswith("file://"))


def strip_scheme(path: str) -> str:
  """Drop a ``file://`` scheme so the path can be used with local IO."""
  return path[len("file://"):] if path.startswith("file://") else path


def _refuse_remote(path: str) -> None:
  if is_remote(path):
    raise NotImplementedError(
        "remote storage (%r) is not ported to PyTorch yet: the port reads "
        "local paths and file:// URIs only (no fsspec)"
        % path.split("://", 1)[0])


def open_file(path: str, mode: str = "rb"):
  """Open a local ``path`` (or ``file://`` URI) for streamed IO."""
  _refuse_remote(path)
  return open(strip_scheme(path), mode)


def file_size(path: str) -> int:
  """Size in bytes of a local ``path`` (or ``file://`` URI)."""
  _refuse_remote(path)
  return os.path.getsize(strip_scheme(path))


def glob_files(pattern: str):
  """Expand a local glob pattern into concrete paths, as ``glob.glob``."""
  _refuse_remote(pattern)
  return _glob.glob(strip_scheme(pattern))
