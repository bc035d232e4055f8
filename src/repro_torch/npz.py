"""Zero-copy reads of an uncompressed ``.npz`` (what ``np.savez`` writes).

:func:`mmap_views` maps the file once and hands out each member as a
read-only ndarray over the mapping, its offset taken from the zip
directory: no per-member crc32 pass and no copy, as ``np.load`` pays. The
SGB cache (``data/sgb_cache.py``) and the checkpoint manager
(``checkpoint/manager.py``) read their archives through it.
"""
from __future__ import annotations

import ast
import mmap
import struct
import zipfile
from typing import Dict, Optional

import numpy as np


def mmap_views(path) -> Optional[Dict[str, np.ndarray]]:
    """``{member: read-only ndarray}`` backed by one mapping of ``path``
    (the arrays keep it alive through their ``.base``), or ``None`` when
    the file is not a plain npz of stored (uncompressed) members."""
    out: Dict[str, np.ndarray] = {}
    try:
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            with zipfile.ZipFile(f) as zf:
                for info in zf.infolist():
                    if info.compress_type != zipfile.ZIP_STORED:
                        return None
                    ho = info.header_offset
                    if mm[ho: ho + 4] != b"PK\x03\x04":
                        return None
                    # local header: 30 fixed bytes + name + extra (the
                    # extra field differs from the central directory's —
                    # numpy pads it to 64-byte-align the array data)
                    nlen, elen = struct.unpack("<HH", mm[ho + 26: ho + 30])
                    npy = ho + 30 + nlen + elen
                    if mm[npy: npy + 6] != b"\x93NUMPY":
                        return None
                    major = mm[npy + 6]
                    if major == 1:
                        (hlen,) = struct.unpack("<H", mm[npy + 8: npy + 10])
                        hoff = npy + 10
                    else:
                        (hlen,) = struct.unpack("<I", mm[npy + 8: npy + 12])
                        hoff = npy + 12
                    hdr = ast.literal_eval(bytes(mm[hoff: hoff + hlen]).decode("latin1"))
                    dt = np.dtype(hdr["descr"])
                    shape = hdr["shape"]
                    count = int(np.prod(shape)) if shape else 1
                    name = info.filename
                    if name.endswith(".npy"):
                        name = name[:-4]
                    out[name] = np.frombuffer(mm, dtype=dt, count=count, offset=hoff + hlen).reshape(
                        shape, order="F" if hdr.get("fortran_order") else "C")
    except Exception:
        return None
    return out
