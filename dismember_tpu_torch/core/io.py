"""Path abstraction for local and remote storage.

Copy of ``dismember_tpu/core/io.py``: plain paths use the local filesystem;
a URL (``gs://``, any fsspec-registered scheme) resolves through fsspec when
it is installed.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import IO, Iterator


def is_remote(path: str) -> bool:
    return "://" in path and not path.startswith("file://")


def open_file(path: str, mode: str = "rb", encoding: str | None = None) -> IO:
    """Open a local or remote path (fsspec for URL schemes)."""
    if is_remote(path):
        try:
            import fsspec
        except ImportError as e:  # pragma: no cover - env without fsspec
            raise ImportError(
                f"remote path {path!r} requires fsspec (install gcsfs for gs://)"
            ) from e
        return fsspec.open(path, mode, encoding=encoding).open()
    if "w" in mode or "a" in mode:
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
    if "b" in mode:
        return open(path, mode)
    return open(path, mode, encoding=encoding)


@contextlib.contextmanager
def stage_in(path: str) -> Iterator[str]:
    """Yield a LOCAL filesystem path holding ``path``'s contents (remote
    paths are downloaded to a temporary file for the block)."""
    if not is_remote(path):
        yield path
        return
    suffix = os.path.splitext(path)[1]
    fd, tmp = tempfile.mkstemp(suffix=suffix)
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            f.write(read_bytes(path))
        yield tmp
    finally:
        os.unlink(tmp)


@contextlib.contextmanager
def stage_out(path: str) -> Iterator[str]:
    """Yield a LOCAL filesystem path; on exit, upload it to ``path`` (local
    paths pass through with their parent directories created)."""
    if not is_remote(path):
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        yield path
        return
    suffix = os.path.splitext(path)[1]
    fd, tmp = tempfile.mkstemp(suffix=suffix)
    os.close(fd)
    try:
        yield tmp
        with open(tmp, "rb") as f:
            write_bytes(path, f.read())
    finally:
        os.unlink(tmp)


def read_bytes(path: str) -> bytes:
    with open_file(path, "rb") as f:
        return f.read()


def write_bytes(path: str, data: bytes) -> None:
    with open_file(path, "wb") as f:
        f.write(data)


def exists(path: str) -> bool:
    if is_remote(path):
        try:
            import fsspec

            fs, p = fsspec.core.url_to_fs(path)
            return fs.exists(p)
        except ImportError:
            return False
    return os.path.exists(path)
