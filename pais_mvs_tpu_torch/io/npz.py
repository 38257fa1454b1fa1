"""``savez_deflated``: the file ``np.savez_compressed`` writes, its deflate
spread over the host's cores.

The file is of the same kind: a zip with one ``<key>.npy`` member per
array, in the order given, each deflated at zlib's default level 6, so
``np.load`` and any zip reader read it as they read ``savez_compressed``'s.
What differs is how a member's deflate stream is made. Its raw ``.npy``
bytes (the header ``np.lib.format`` writes, then the array's bytes in C
order, or Fortran order as ``np.save`` keeps it) are cut into ``BLOCK``
byte blocks, and one shared thread pool deflates every block of every
member at once. Each block is a raw deflate primed with the ``WINDOW``
bytes of its member before it (``zdict``: the window a single stream
would have there), ended by ``Z_SYNC_FLUSH`` (an empty stored block, byte
aligned and not final), the member's last one by ``Z_FINISH``. The blocks
concatenated are one valid deflate stream (pigz's method), a few bytes a
block longer than a single stream's. zlib releases the interpreter lock
while it deflates and while it computes a CRC-32, so the pool's threads
run on as many cores.

The pool's width is the number of cores this process may run on, capped
at ``MAX_THREADS``; it is made at the first call in each process. The
call returns only when the whole zip is written to ``fh``, and a
worker's error is raised before anything is written.
"""

from __future__ import annotations

import io
import os
import struct
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

BLOCK = 256 * 1024          # bytes of raw .npy a worker deflates at once
WINDOW = 32 * 1024          # deflate's window: the dictionary a block gets
LEVEL = 6                   # zlib's default, which savez_compressed uses
MAX_THREADS = 16
ZIP64_LIMIT = (1 << 31) - 1  # zipfile's: larger sizes and offsets go zip64

_LOCAL = struct.Struct("<IHHHHHIIIHH")
_CENTRAL = struct.Struct("<IHHHHHHIIIHHHHHII")
_END = struct.Struct("<IHHHHIIH")
_END64 = struct.Struct("<IQHHIIQQQQ")
_LOCATOR64 = struct.Struct("<IIQI")
_ZIP64_EXTRA = 0x0001

_pool: Optional[Tuple[int, int, ThreadPoolExecutor]] = None  # pid, width
_pool_lock = threading.Lock()


def _executor() -> Tuple[int, ThreadPoolExecutor]:
    """This process's pool and its width (a forked child makes its own)."""
    global _pool
    pid = os.getpid()
    with _pool_lock:
        if _pool is None or _pool[0] != pid:
            if hasattr(os, "sched_getaffinity"):
                cores = len(os.sched_getaffinity(0))
            else:
                cores = os.cpu_count() or 1
            width = max(1, min(MAX_THREADS, cores))
            _pool = (pid, width, ThreadPoolExecutor(
                width, thread_name_prefix="deflate"))
        return _pool[1], _pool[2]


def threads() -> int:
    """The width of the pool that deflates the blocks."""
    return _executor()[0]


def _npy_parts(arr: np.ndarray) -> Tuple[bytes, memoryview]:
    """An array's ``.npy`` as ``np.save`` writes it: the header, and a
    byte view of the data (no copy where the array is contiguous)."""
    if arr.dtype.hasobject:
        raise ValueError("savez_deflated writes no object arrays")
    d = np.lib.format.header_data_from_array_1_0(arr)
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(head, d)
    data = arr.T if d["fortran_order"] else np.ascontiguousarray(arr)
    return head.getvalue(), memoryview(data.reshape(-1).view(np.uint8))


def _slice(head: bytes, data: memoryview, s: int, e: int) -> List:
    """Bytes [s, e) of a member whose raw bytes are ``head + data``."""
    h = len(head)
    if e <= h:
        return [head[s:e]]
    if s >= h:
        return [data[s - h:e - h]]
    return [head[s:], data[:e - h]]


def _deflate(parts: List, zdict: Optional[bytes], last: bool) -> bytes:
    """One block's raw deflate, primed with ``zdict``."""
    if zdict:
        c = zlib.compressobj(LEVEL, zlib.DEFLATED, -zlib.MAX_WBITS,
                             zdict=zdict)
    else:
        c = zlib.compressobj(LEVEL, zlib.DEFLATED, -zlib.MAX_WBITS)
    out = [c.compress(p) for p in parts]
    out.append(c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH))
    return b"".join(out)


def _crc(head: bytes, data: memoryview) -> int:
    return zlib.crc32(data, zlib.crc32(head))


def _dos_time(t: float) -> Tuple[int, int]:
    y, mo, d, h, mi, s = time.localtime(t)[:6]
    return h << 11 | mi << 5 | s // 2, (y - 1980) << 9 | mo << 5 | d


def savez_deflated(fh, **arrays) -> Tuple[int, int]:
    """Write ``arrays`` to the open binary file ``fh`` as
    ``np.savez_compressed(fh, **arrays)`` does. Returns the raw ``.npy``
    bytes deflated and the number of blocks they were cut into."""
    pool = _executor()[1]
    members = []
    futures = []
    try:
        for key, val in arrays.items():
            head, data = _npy_parts(np.asanyarray(val))
            size = len(head) + len(data)
            crc = pool.submit(_crc, head, data)
            blocks = []
            for s in range(0, size, BLOCK):     # size > 0: the header
                e = min(s + BLOCK, size)
                w = max(0, s - WINDOW)
                zdict = b"".join(bytes(p) for p in _slice(head, data, w, s)) \
                    if s else None
                blocks.append(pool.submit(_deflate, _slice(head, data, s, e),
                                          zdict, e == size))
            futures += [crc, *blocks]
            members.append((key + ".npy", size, crc, blocks))
        done = [(name, size, crc.result(), [b.result() for b in blocks])
                for name, size, crc, blocks in members]
    except BaseException:
        for f in futures:
            f.cancel()
        raise
    dostime, dosdate = _dos_time(time.time())
    central = []
    offset = 0
    for name, size, crc, blocks in done:
        csize = sum(len(b) for b in blocks)
        fname = name.encode("ascii")
        big = size > ZIP64_LIMIT or csize > ZIP64_LIMIT
        extra = struct.pack("<HHQQ", _ZIP64_EXTRA, 16, size, csize) \
            if big else b""
        need = 45 if big else 20
        fh.write(_LOCAL.pack(
            0x04034B50, need, 0, zlib.DEFLATED, dostime, dosdate, crc,
            0xFFFFFFFF if big else csize, 0xFFFFFFFF if big else size,
            len(fname), len(extra)))
        fh.write(fname)
        fh.write(extra)
        for b in blocks:
            fh.write(b)
        central.append((fname, crc, csize, size, offset))
        offset += _LOCAL.size + len(fname) + len(extra) + csize
    cd_start = offset
    for fname, crc, csize, size, at in central:
        wide = [(v, v > ZIP64_LIMIT) for v in (size, csize, at)]
        extra = b"".join(struct.pack("<Q", v) for v, over in wide if over)
        if extra:
            extra = struct.pack("<HH", _ZIP64_EXTRA, len(extra)) + extra
        need = 45 if extra else 20
        (usz, csz, off) = (0xFFFFFFFF if over else v for v, over in wide)
        rec = _CENTRAL.pack(
            0x02014B50, 3 << 8 | need, need, 0, zlib.DEFLATED, dostime,
            dosdate, crc, csz, usz, len(fname), len(extra), 0, 0, 0,
            0o600 << 16, off)
        fh.write(rec)
        fh.write(fname)
        fh.write(extra)
        offset += len(rec) + len(fname) + len(extra)
    cd_size = offset - cd_start
    n = len(central)
    if n > 0xFFFF or cd_size > ZIP64_LIMIT or cd_start > ZIP64_LIMIT:
        fh.write(_END64.pack(0x06064B50, _END64.size - 12, 45, 45, 0, 0,
                             n, n, cd_size, cd_start))
        fh.write(_LOCATOR64.pack(0x07064B50, 0, offset, 1))
    fh.write(_END.pack(0x06054B50, 0, 0, min(n, 0xFFFF), min(n, 0xFFFF),
                       min(cd_size, 0xFFFFFFFF), min(cd_start, 0xFFFFFFFF),
                       0))
    return sum(m[1] for m in done), sum(len(m[3]) for m in done)
