"""Minimal MRC2014 micrograph I/O (pure numpy; the port's own copy of
``repic_tpu.utils.mrc``).

A self-contained reader/writer for the MRC2014 subset cryo-EM
micrographs use: modes 0/1/2/6/12, an optional extended header,
little- or big-endian as the machine stamp declares.  Host I/O stays
numpy; arrays become tensors in the picker's layers.
"""

import os
import struct
from typing import NamedTuple

import numpy as np

from repic_tpu_torch.runtime.atomic import atomic_write

# data-type codes (MRC2014 "mode" word)
MODE_DTYPES = {
    0: np.dtype(np.int8),
    1: np.dtype(np.int16),
    2: np.dtype(np.float32),
    6: np.dtype(np.uint16),
    12: np.dtype(np.float16),
}

HEADER_BYTES = 1024


class MrcHeader(NamedTuple):
    nx: int
    ny: int
    nz: int
    mode: int
    nsymbt: int  # extended-header length in bytes
    little_endian: bool


class MrcError(ValueError):
    pass


def read_header(path: str) -> MrcHeader:
    with open(path, "rb") as f:
        raw = f.read(HEADER_BYTES)
    if len(raw) < HEADER_BYTES:
        raise MrcError(f"{path}: truncated MRC header")
    # Machine stamp (bytes 212-215) declares endianness; 0x44 = LE,
    # 0x11 = BE.  Fall back to sanity-checking the LE mode word for
    # files with a zeroed stamp.
    stamp = raw[212]
    if stamp == 0x44:
        le = True
    elif stamp == 0x11:
        le = False
    else:
        le = struct.unpack_from("<i", raw, 12)[0] in MODE_DTYPES
    end = "<" if le else ">"
    nx, ny, nz, mode = struct.unpack_from(end + "4i", raw, 0)
    nsymbt = struct.unpack_from(end + "i", raw, 92)[0]
    if mode not in MODE_DTYPES:
        raise MrcError(f"{path}: unsupported MRC mode {mode}")
    if min(nx, ny, nz) <= 0 or nx > 1 << 20 or ny > 1 << 20:
        raise MrcError(f"{path}: implausible dims {(nx, ny, nz)}")
    return MrcHeader(nx, ny, nz, mode, nsymbt, le)


def read_mrc(path: str, dtype=None) -> np.ndarray:
    """Read an MRC file into a ``(nz, ny, nx)`` array, squeezed to
    ``(ny, nx)`` for single-frame micrographs."""
    h = read_header(path)
    dt = MODE_DTYPES[h.mode].newbyteorder("<" if h.little_endian else ">")
    count = h.nx * h.ny * h.nz
    expected = HEADER_BYTES + h.nsymbt + count * dt.itemsize
    if os.path.getsize(path) < expected:
        raise MrcError(f"{path}: file shorter than header promises")
    data = np.fromfile(
        path, dtype=dt, count=count, offset=HEADER_BYTES + h.nsymbt
    )
    data = data.reshape(h.nz, h.ny, h.nx)
    if h.nz == 1:
        data = data[0]
    if dtype is not None:
        data = data.astype(dtype)
    return data


def write_mrc(path: str, data: np.ndarray) -> None:
    """Write a float32 (mode 2) MRC2014 file."""
    data = np.asarray(data, dtype="<f4")
    if data.ndim == 2:
        data = data[None]
    nz, ny, nx = data.shape
    header = np.zeros(256, dtype="<i4")
    header[0:3] = (nx, ny, nz)
    header[3] = 2  # mode
    header[7:10] = (nx, ny, nz)  # mx, my, mz
    header[10:13] = np.asarray(
        [nx, ny, nz], np.float32
    ).view(np.int32)  # cell dims (1 px = 1 A)
    header[13:16] = np.asarray([90.0] * 3, np.float32).view(np.int32)
    header[16:19] = (1, 2, 3)  # axis order
    stats = np.asarray(
        [data.min(), data.max(), data.mean()], np.float32
    )
    header[19:22] = stats.view(np.int32)
    header[52] = int.from_bytes(b"MAP ", "little")
    header[53] = 0x00004444  # little-endian machine stamp
    with atomic_write(path, "wb") as f:
        f.write(header.tobytes())
        f.write(data.tobytes())


def is_single_frame_micrograph(path: str) -> bool:
    """True if ``path`` parses as a 2-D (nz == 1) MRC image: the
    validity test ``build_subsets`` applies when scanning a directory."""
    try:
        return read_header(path).nz == 1
    except (MrcError, OSError, IsADirectoryError):
        return False
