"""Clean-room TFRecord container codec.

TFRecord framing (as consumed by the reference's tf.data pipelines,
/root/reference/gdmix-trainer/src/gdmix/io/input_data_pipeline.py:203): each record is

    uint64 length (little endian)
    uint32 masked_crc32c(length bytes)
    byte   data[length]
    uint32 masked_crc32c(data)

with masked_crc = rotr32(crc32c(x), 15) + 0xa282ead8. GZIP (.gz) and ZLIB (.deflate)
stream compression are supported, matching the reference's suffix sniffing
(input_data_pipeline.py:63-85).

A C++ fast path (gdmix_tpu.native) is used automatically when built; this pure-Python
implementation is the always-available fallback and the reference for its tests.
"""
from __future__ import annotations

import gzip
import os
import struct
import zlib

from gdmix_tpu.io import fs
from typing import Iterable, Iterator, List, Optional

_MASK_DELTA = 0xA282EAD8

# --- crc32c (Castagnoli), table-driven --------------------------------------

_CRC_TABLE: List[int] = []


def _build_table() -> None:
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# --- compression sniffing ----------------------------------------------------

GZIP_SUFFIX = ".gz"
ZLIB_SUFFIX = ".deflate"


def compression_of(filename: str) -> str:
    """Return '', 'GZIP' or 'ZLIB' based on the file suffix (reference semantics)."""
    if filename.endswith(GZIP_SUFFIX):
        return "GZIP"
    if filename.endswith(ZLIB_SUFFIX):
        return "ZLIB"
    return ""


class _OwnedGzipFile(gzip.GzipFile):
    """Read-side GzipFile that closes the underlying fs file object too.
    gzip.GzipFile(fileobj=...) deliberately leaves the fileobj open."""

    def close(self):
        raw = self.fileobj
        try:
            super().close()
        finally:
            if raw is not None:
                raw.close()


class _OwnedGzipWriter(gzip.GzipFile):
    """Write-side GzipFile with atomic-ish failure semantics: remote stores
    commit bytes only when THEIR file object closes, so closing the raw
    object unconditionally would land a TRUNCATED gzip file whenever the
    body or the trailer flush raises. Here the raw object is closed (and the
    write committed) only on the success path; on any failure the partial
    target is discarded instead — nothing lands, matching atomic_output
    elsewhere."""

    def __init__(self, path: str, fileobj):
        super().__init__(fileobj=fileobj, mode="wb")
        self._path = path
        self._abort = False

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._abort = True
        return super().__exit__(exc_type, exc, tb)

    def _discard(self, raw):
        import contextlib
        if hasattr(raw, "discard"):
            # abort API (e.g. DirFS._DirWriter): nothing lands, atomically
            with contextlib.suppress(Exception):
                raw.discard()
            return
        # stores that commit on close: close then best-effort delete so no
        # truncated object stays visible (a small window, unavoidable
        # without an abort API)
        with contextlib.suppress(Exception):
            raw.close()
        with contextlib.suppress(Exception):
            fs.remove(self._path)

    def close(self):
        raw = self.fileobj
        if raw is None:  # already closed
            super().close()
            return
        if self._abort:
            self.fileobj = None  # skip the trailer flush entirely
            super().close()
            self._discard(raw)
            return
        try:
            super().close()  # flush the gzip trailer into raw's buffer
        except BaseException:
            self._abort = True
            self._discard(raw)
            raise
        raw.close()  # success: commit


def _open_read(path: str, compression: Optional[str]):
    comp = compression_of(path) if compression is None else compression
    if comp == "GZIP":
        return _OwnedGzipFile(fileobj=fs.open(path, "rb"), mode="rb")
    if comp == "ZLIB":
        with fs.open(path, "rb") as f:
            raw = f.read()
        import io as _io
        return _io.BytesIO(zlib.decompress(raw))
    return fs.open(path, "rb")


class _ZlibWriter:
    def __init__(self, path: str):
        self._f = fs.open(path, "wb")
        self._c = zlib.compressobj()

    def write(self, data: bytes) -> None:
        self._f.write(self._c.compress(data))

    def close(self) -> None:
        self._f.write(self._c.flush())
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _open_write(path: str, compression: Optional[str]):
    comp = compression_of(path) if compression is None else compression
    if comp == "GZIP":
        return _OwnedGzipWriter(path, fs.open(path, "wb"))
    if comp == "ZLIB":
        return _ZlibWriter(path)
    return fs.open(path, "wb")


# --- record iteration / writing ----------------------------------------------

def read_tfrecords(path: str, compression: Optional[str] = None,
                   verify_crc: bool = False) -> Iterator[bytes]:
    """Yield the raw payload bytes of every record in a TFRecord file."""
    with _open_read(path, compression) as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise ValueError(f"Truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", head[:8])
            if verify_crc:
                (lcrc,) = struct.unpack("<I", head[8:12])
                if masked_crc32c(head[:8]) != lcrc:
                    raise ValueError(f"Corrupt TFRecord length crc in {path}")
            payload = f.read(length)
            if len(payload) < length:
                raise ValueError(f"Truncated TFRecord payload in {path}")
            tail = f.read(4)
            if verify_crc:
                (dcrc,) = struct.unpack("<I", tail)
                if masked_crc32c(payload) != dcrc:
                    raise ValueError(f"Corrupt TFRecord data crc in {path}")
            yield payload


def read_tfrecord_frames(path: str, compression: Optional[str] = None
                         ) -> Iterator[bytes]:
    """Yield each record's RAW FRAME (length header + crcs + payload),
    streamed with bounded memory — a chunker can concatenate frames into a
    valid TFRecord buffer (for the native whole-buffer parser) without
    re-computing crcs."""
    with _open_read(path, compression) as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise ValueError(f"Truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", head[:8])
            rest = f.read(length + 4)
            if len(rest) < length + 4:
                raise ValueError(f"Truncated TFRecord payload in {path}")
            yield head + rest


def write_tfrecords(path: str, payloads: Iterable[bytes],
                    compression: Optional[str] = None) -> int:
    """Write raw payloads as a TFRecord file. Returns the record count."""
    n = 0
    with _open_write(path, compression) as f:
        for payload in payloads:
            head = struct.pack("<Q", len(payload))
            f.write(head)
            f.write(struct.pack("<I", masked_crc32c(head)))
            f.write(payload)
            f.write(struct.pack("<I", masked_crc32c(payload)))
            n += 1
    return n


def list_tfrecord_files(path_or_files, glob_pattern: str = "*.tfrecord*") -> List[str]:
    """Expand a dir / file / list into a sorted list of TFRecord files."""
    import fnmatch
    if isinstance(path_or_files, (list, tuple)):
        return list(path_or_files)
    if fs.isdir(path_or_files):
        files = sorted(
            os.path.join(path_or_files, f)
            for f in fs.listdir(path_or_files)
            if fnmatch.fnmatch(f, glob_pattern) and not f.startswith(".")
        )
        return files
    return [path_or_files]
