"""Filesystem seam: every IO path in gdmix-tpu resolves through this module.

The reference runs on a *shared* store (HDFS) and reaches it transparently
through tf.io.gfile — batched avro writes go through a local file and are
copied up (/root/reference/gdmix-trainer/src/gdmix/util/io_utils.py:299-334),
and globbing lists the parent directory once instead of issuing one namenode
RPC per candidate (io_utils.py:378-392). A multi-host production run needs the
same transparency for GCS/HDFS: this module is the single indirection every
reader/writer, the multi-host model exchange, and the input sharding go
through, so a remote scheme plugs in without touching call sites.

Path routing: `scheme://...` paths dispatch to the filesystem registered for
`scheme`; everything else is the local OS filesystem (zero overhead — direct
os/builtins calls). Built-in schemes:

  mem://   — an in-process shared in-memory store (the fake remote used by
             single-process tests; also handy as a scratch fabric)
  fakefs:// — a file-BACKED fake remote rooted at $GDMIX_FAKEFS_ROOT: the
             store multiple real processes share, so multi-host remote
             exchanges are testable end-to-end (MemFS is per-process).
             Commit-on-close semantics like a real object store: writers
             land atomically, readers never observe partial objects.
  (any fsspec scheme) — lazily bridged via `fsspec.filesystem(scheme)` when
             the fsspec driver is importable (gs, s3, hdfs, http, ...), so
             real object stores work wherever their drivers are installed.

Native code (the C++ avro/tfrecord codecs) and mmap readers need REAL local
paths; `local_input()` / `atomic_output()` implement the reference's
copy-through-local contract for them: remote reads download to a NamedTemporary
file, remote writes write locally then upload on close. For local paths both
are free (no copy; atomic_output writes a sibling temp file and os.replace()s
it — an atomicity upgrade over the reference).
"""
from __future__ import annotations

import contextlib
import fnmatch
import io as _pyio
import os
import posixpath
import shutil
import tempfile
import threading
from typing import Dict, IO, Iterator, List, Optional, Tuple

__all__ = [
    "FileSystem", "LocalFS", "MemFS", "DirFS", "register_filesystem", "get_fs",
    "open", "exists", "isdir", "isfile", "listdir", "makedirs", "glob",
    "remove", "local_input", "atomic_output", "copy", "is_local",
    "upload_dir", "download_dir",
]

_builtin_open = open


def _split_scheme(path: str) -> Tuple[Optional[str], str]:
    """('mem', 'mem://x/y') for scheme paths, (None, path) for local ones.
    Windows drive letters and bare '://'-less paths are local."""
    i = path.find("://")
    if i <= 1:  # -1 not found; 0/1 can't be a scheme (e.g. 'C://')
        return None, path
    scheme = path[:i]
    if not scheme.isalnum():
        return None, path
    return scheme, path


class FileSystem:
    """Minimal filesystem interface the IO layer needs. Paths arrive in full
    `scheme://...` form (implementations strip their own prefix)."""

    def open(self, path: str, mode: str = "r", **kw) -> IO:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def isdir(self, path: str) -> bool:
        raise NotImplementedError

    def isfile(self, path: str) -> bool:
        return self.exists(path) and not self.isdir(path)

    def listdir(self, path: str) -> List[str]:
        """Base names (one RPC — glob() builds on this, io_utils.py:378-392)."""
        raise NotImplementedError

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        raise NotImplementedError

    def remove(self, path: str) -> None:
        raise NotImplementedError

    def glob(self, pattern: str) -> List[str]:
        """Low-RPC glob: ONE listdir of the parent + client-side fnmatch
        (the reference's namenode-storm-avoiding low_rpc_call_glob,
        io_utils.py:378-392). Pattern wildcards only in the basename."""
        directory, base = posixpath.split(pattern)
        try:
            names = self.listdir(directory)
        except (FileNotFoundError, NotADirectoryError):
            return []
        return sorted(posixpath.join(directory, n) for n in names
                      if fnmatch.fnmatch(n, base))

    # copy-through-local seam (native codecs need real local paths)
    def copy_to_local(self, path: str, local_path: str) -> None:
        with self.open(path, "rb") as src, \
                _builtin_open(local_path, "wb") as dst:
            shutil.copyfileobj(src, dst)

    def copy_from_local(self, local_path: str, path: str) -> None:
        with _builtin_open(local_path, "rb") as src, \
                self.open(path, "wb") as dst:
            shutil.copyfileobj(src, dst)


class LocalFS(FileSystem):
    def open(self, path, mode="r", **kw):
        return _builtin_open(path, mode, **kw)

    def exists(self, path):
        return os.path.exists(path)

    def isdir(self, path):
        return os.path.isdir(path)

    def isfile(self, path):
        return os.path.isfile(path)

    def listdir(self, path):
        return os.listdir(path)

    def makedirs(self, path, exist_ok=True):
        os.makedirs(path, exist_ok=exist_ok)

    def remove(self, path):
        os.remove(path)

    def glob(self, pattern):
        directory, base = os.path.split(pattern)
        try:
            names = os.listdir(directory or ".")
        except (FileNotFoundError, NotADirectoryError):
            return []
        return sorted(os.path.join(directory, n) for n in names
                      if fnmatch.fnmatch(n, base))

    def copy_to_local(self, path, local_path):
        if os.path.abspath(path) != os.path.abspath(local_path):
            shutil.copyfile(path, local_path)

    def copy_from_local(self, local_path, path):
        if os.path.abspath(path) != os.path.abspath(local_path):
            shutil.copyfile(local_path, path)


class _MemWriter(_pyio.BytesIO):
    def __init__(self, fs: "MemFS", key: str, append: bool):
        super().__init__()
        self._fs, self._key = fs, key
        if append and key in fs._files:
            self.write(fs._files[key])

    def close(self):
        if not self.closed:
            with self._fs._lock:
                self._fs._files[self._key] = self.getvalue()
                self._fs.write_count += 1
        super().close()


class MemFS(FileSystem):
    """In-process shared in-memory store — the fake remote scheme for tests
    (and the seam's reference implementation). Tracks RPC-ish op counts so
    tests can assert the low-RPC glob contract."""

    def __init__(self):
        self._files: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.list_count = 0
        self.write_count = 0

    def _key(self, path: str) -> str:
        _, p = _split_scheme(path)
        return posixpath.normpath(p[p.find("://") + 3:]).lstrip("/")

    def open(self, path, mode="r", **kw):
        key = self._key(path)
        binary = "b" in mode
        if "+" in mode:
            # a read branch would hand back a throwaway snapshot and silently
            # drop writes; refuse rather than lose data (LocalFS honors r+)
            raise ValueError(f"MemFS does not support update modes: {mode!r}")
        if "w" in mode or "a" in mode or "x" in mode:
            w = _MemWriter(self, key, append="a" in mode)
            return w if binary else _pyio.TextIOWrapper(w, **kw)
        if key not in self._files:
            raise FileNotFoundError(path)
        r = _pyio.BytesIO(self._files[key])
        return r if binary else _pyio.TextIOWrapper(r, **kw)

    def exists(self, path):
        key = self._key(path)
        pfx = key + "/"
        return key in self._files or any(k.startswith(pfx)
                                         for k in self._files)

    def isdir(self, path):
        pfx = self._key(path) + "/"
        return any(k.startswith(pfx) for k in self._files)

    def isfile(self, path):
        return self._key(path) in self._files

    def listdir(self, path):
        self.list_count += 1
        pfx = self._key(path) + "/"
        names = {k[len(pfx):].split("/", 1)[0]
                 for k in self._files if k.startswith(pfx)}
        if not names:  # object-store semantics: empty dirs don't exist
            raise FileNotFoundError(path)
        return sorted(names)

    def makedirs(self, path, exist_ok=True):
        pass  # object-store semantics: directories are implicit

    def remove(self, path):
        key = self._key(path)
        with self._lock:
            if key not in self._files:
                raise FileNotFoundError(path)
            del self._files[key]


class _DirWriter:
    """Write-to-temp-then-rename file wrapper: the object lands atomically at
    close — readers in OTHER processes never observe a partial object,
    matching real object-store commit-on-close semantics."""

    def __init__(self, real_path: str, append: bool, binary: bool, **kw):
        os.makedirs(os.path.dirname(real_path) or ".", exist_ok=True)
        fd, self._tmp = tempfile.mkstemp(
            dir=os.path.dirname(real_path) or ".", suffix=".part~")
        os.close(fd)
        self._dest = real_path
        mode = ("ab" if append else "wb") if binary \
            else ("a" if append else "w")
        if append and os.path.exists(real_path):
            shutil.copyfile(real_path, self._tmp)
        self._f = _builtin_open(self._tmp, mode, **kw)
        self.closed = False

    def __getattr__(self, name):
        return getattr(self._f, name)

    def close(self):
        if self.closed:
            return
        self.closed = True
        self._f.close()
        os.replace(self._tmp, self._dest)

    def discard(self):
        """Abort: nothing lands."""
        if self.closed:
            return
        self.closed = True
        self._f.close()
        with contextlib.suppress(OSError):
            os.unlink(self._tmp)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.discard()
        else:
            self.close()

    def __del__(self):
        with contextlib.suppress(Exception):
            if not self.closed:
                self.discard()


class DirFS(FileSystem):
    """File-backed fake remote: `fakefs://x/y` maps to `<root>/x/y` on the
    local filesystem, but through the full remote-scheme code path (scheme
    dispatch, copy-through-local, low-RPC glob, commit-on-close writes).
    Because the backing store is a real shared directory, MULTIPLE processes
    see one namespace — the piece MemFS (per-process dict) cannot provide —
    making the multi-host model-exchange/score-write contract of the
    reference's shared store (/root/reference/README.md:22) testable with
    real processes."""

    def __init__(self, root: str):
        self._root = os.path.abspath(root)
        os.makedirs(self._root, exist_ok=True)

    def _real(self, path: str) -> str:
        _, p = _split_scheme(path)
        key = posixpath.normpath(p[p.find("://") + 3:]).lstrip("/")
        if key.startswith(".."):
            raise ValueError(f"path escapes the store root: {path}")
        return os.path.join(self._root, key)

    def open(self, path, mode="r", **kw):
        real = self._real(path)
        if "+" in mode:
            raise ValueError(f"DirFS does not support update modes: {mode!r}")
        if "w" in mode or "a" in mode or "x" in mode:
            if "x" in mode and os.path.exists(real):
                raise FileExistsError(path)
            return _DirWriter(real, append="a" in mode,
                              binary="b" in mode, **kw)
        if not os.path.isfile(real):
            raise FileNotFoundError(path)
        return _builtin_open(real, mode, **kw)

    def exists(self, path):
        return os.path.exists(self._real(path))

    def isdir(self, path):
        return os.path.isdir(self._real(path))

    def isfile(self, path):
        return os.path.isfile(self._real(path))

    def listdir(self, path):
        names = [n for n in os.listdir(self._real(path))
                 if not n.endswith(".part~")]
        if not names:  # object-store semantics: empty dirs don't exist
            raise FileNotFoundError(path)
        return sorted(names)

    def makedirs(self, path, exist_ok=True):
        pass  # object-store semantics: directories are implicit

    def remove(self, path):
        os.remove(self._real(path))

    def copy_to_local(self, path, local_path):
        shutil.copyfile(self._real(path), local_path)

    def copy_from_local(self, local_path, path):
        real = self._real(path)
        os.makedirs(os.path.dirname(real) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(real) or ".",
                                   suffix=".part~")
        os.close(fd)
        shutil.copyfile(local_path, tmp)
        os.replace(tmp, real)  # atomic landing


_registry: Dict[str, FileSystem] = {}
_local = LocalFS()
_registry_lock = threading.Lock()


def register_filesystem(scheme: str, fs: FileSystem) -> None:
    with _registry_lock:
        _registry[scheme] = fs


class _FsspecFS(FileSystem):
    """Bridge any installed fsspec driver (gs://, s3://, hdfs://, ...)."""

    def __init__(self, scheme: str):
        import fsspec
        self._fs = fsspec.filesystem(scheme)
        self._scheme = scheme

    def open(self, path, mode="r", **kw):
        return self._fs.open(path, mode, **kw)

    def exists(self, path):
        return self._fs.exists(path)

    def isdir(self, path):
        return self._fs.isdir(path)

    def isfile(self, path):
        return self._fs.isfile(path)

    def listdir(self, path):
        base = path.split("://", 1)[1]
        return sorted(posixpath.basename(p.rstrip("/"))
                      for p in self._fs.ls(base, detail=False))

    def makedirs(self, path, exist_ok=True):
        self._fs.makedirs(path, exist_ok=exist_ok)

    def remove(self, path):
        self._fs.rm(path)

    def copy_to_local(self, path, local_path):
        self._fs.get_file(path, local_path)

    def copy_from_local(self, local_path, path):
        self._fs.put_file(local_path, path)


def get_fs(path) -> Tuple[FileSystem, str]:
    """Resolve a path to (filesystem, path). Local paths hit LocalFS with no
    registry lookup; unknown schemes lazily bridge through fsspec."""
    path = os.fspath(path)
    scheme, _ = _split_scheme(path)
    if scheme is None:
        return _local, path
    fs = _registry.get(scheme)
    if scheme == "fakefs" and fs is not None:
        # the backing root is an env var: rebuild when it changes (a cached
        # instance would silently keep writing to the old root)
        root = os.environ.get("GDMIX_FAKEFS_ROOT")
        if root and os.path.abspath(root) != getattr(fs, "_root", None):
            with _registry_lock:
                # drop the stale instance so the construction below (which
                # re-reads the registry under the lock) actually rebuilds
                if _registry.get(scheme) is fs:
                    del _registry[scheme]
            fs = None
    if fs is None:
        with _registry_lock:  # lose the construction race, not the instance
            fs = _registry.get(scheme)
            if fs is None:
                if scheme == "mem":
                    fs = MemFS()
                elif scheme == "fakefs":
                    root = os.environ.get("GDMIX_FAKEFS_ROOT")
                    if not root:
                        raise ValueError(
                            "fakefs:// paths need GDMIX_FAKEFS_ROOT to point "
                            "at the shared backing directory")
                    fs = DirFS(root)
                else:
                    fs = _FsspecFS(scheme)  # raises for unknown schemes
                _registry[scheme] = fs
    return fs, path


# ------------------------------------------------------- module-level API --
# Drop-in call-site replacements: for local paths each is a direct os call.

def open(path: str, mode: str = "r", **kw) -> IO:  # noqa: A001 (shadows)
    fs, p = get_fs(path)
    return fs.open(p, mode, **kw)


def exists(path: str) -> bool:
    fs, p = get_fs(path)
    return fs.exists(p)


def isdir(path: str) -> bool:
    fs, p = get_fs(path)
    return fs.isdir(p)


def isfile(path: str) -> bool:
    fs, p = get_fs(path)
    return fs.isfile(p)


def listdir(path: str) -> List[str]:
    fs, p = get_fs(path)
    return fs.listdir(p)


def makedirs(path: str, exist_ok: bool = True) -> None:
    fs, p = get_fs(path)
    fs.makedirs(p, exist_ok=exist_ok)


def glob(pattern: str) -> List[str]:
    fs, p = get_fs(pattern)
    return fs.glob(p)


def remove(path: str) -> None:
    fs, p = get_fs(path)
    fs.remove(p)


def is_local(path: str) -> bool:
    """True when `path` resolves to the local OS filesystem (no scheme)."""
    return get_fs(path)[0] is _local


def upload_dir(local_dir: str, remote_dir: str) -> None:
    """Recursively copy a local directory tree to a (remote) destination —
    the write half of copy-through-local for DIRECTORY artifacts (e.g. a
    versioned orbax checkpoint), ≡ io_utils.py:299-334 at dir granularity."""
    for root, _, files in os.walk(local_dir):
        rel = os.path.relpath(root, local_dir)
        for f in files:
            dst = posixpath.join(remote_dir, *([] if rel == "." else
                                               rel.split(os.sep)), f)
            copy(os.path.join(root, f), dst)


def download_dir(remote_dir: str, local_dir: str) -> None:
    """Recursively copy a (remote) directory tree to a local one."""
    base = remote_dir.rstrip("/")
    for f in find_files(base):
        rel = f[len(base) + 1:]
        dst = os.path.join(local_dir, *rel.split("/"))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        copy(f, dst)


def find_files(path: str, suffix: str = "") -> List[str]:
    """All files under `path`, recursively, ending in `suffix` and not
    hidden — the recursive-score-dir walk (Spark reads partitionId=N
    subdirectories recursively too), routed through the seam."""
    fs_, p = get_fs(path)
    if fs_ is _local:
        out = []
        for root, _, files in os.walk(p):
            out.extend(os.path.join(root, f) for f in files
                       if f.endswith(suffix) and not f.startswith("."))
        return sorted(out)
    out = []
    stack = [p.rstrip("/")]
    while stack:
        d = stack.pop()
        try:
            names = fs_.listdir(d)
        except (FileNotFoundError, NotADirectoryError):
            continue
        for n in names:
            if n.startswith("."):
                continue
            full = d + "/" + n
            if fs_.isdir(full):
                stack.append(full)
            elif full.endswith(suffix):
                out.append(full)
    return sorted(out)


def copy(src: str, dst: str) -> None:
    """Cross-filesystem copy (streams through memory for remote↔remote)."""
    sfs, sp = get_fs(src)
    dfs, dp = get_fs(dst)
    if sfs is _local:
        dfs.copy_from_local(sp, dp)
    elif dfs is _local:
        sfs.copy_to_local(sp, dp)
    else:
        with sfs.open(sp, "rb") as f, dfs.open(dp, "wb") as g:
            shutil.copyfileobj(f, g)


@contextlib.contextmanager
def local_input(path: str) -> Iterator[str]:
    """Yield a REAL local path for `path` (native codecs / mmap need one).
    Remote files download to a NamedTemporaryFile for the duration — the
    read half of the reference's copy-through-local contract
    (io_utils.py:299-334). Local paths are yielded as-is (no copy)."""
    fs, p = get_fs(path)
    if fs is _local:
        yield p
        return
    suffix = posixpath.splitext(p)[1]
    tmp = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    tmp.close()
    try:
        fs.copy_to_local(p, tmp.name)
        yield tmp.name
    finally:
        os.unlink(tmp.name)


@contextlib.contextmanager
def atomic_output(path: str) -> Iterator[str]:
    """Yield a REAL local path to write; on successful exit the file lands at
    `path` — uploaded for remote schemes (write-local-then-copy, reference
    io_utils.py:299-334), os.replace()d for local ones (atomic visibility:
    readers never observe a half-written file). On error nothing lands."""
    fs, p = get_fs(path)
    if fs is _local:
        d = os.path.dirname(p) or "."
        os.makedirs(d, exist_ok=True)
        tmp = tempfile.NamedTemporaryFile(dir=d, delete=False,
                                          suffix=".tmp~")
        tmp.close()
        try:
            yield tmp.name
            os.replace(tmp.name, p)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp.name)
            raise
        return
    tmp = tempfile.NamedTemporaryFile(delete=False,
                                      suffix=posixpath.splitext(p)[1])
    tmp.close()
    try:
        yield tmp.name
        fs.copy_from_local(tmp.name, p)
    finally:
        with contextlib.suppress(OSError):
            os.unlink(tmp.name)
