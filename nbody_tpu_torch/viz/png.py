"""Minimal dependency-free PNG writer (and APNG-free GIF fallback is not
needed — PNG frames + an MP4/GIF assembler script suffice).

The base image has no imageio/Pillow guarantee, so frames are written with a
hand-rolled PNG encoder (zlib is stdlib).  A native C++ encoder with the same
wire format lives in ``native/`` for the high-rate streaming path.

A copy of ``nbody_tpu/viz/png.py`` (numpy only): the port runs where JAX
is not installed, and importing anything under ``nbody_tpu`` imports
JAX.  ``tests/test_torch_viz.py`` holds its output to the
original's byte for byte.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode an (H, W, 3) uint8 array as PNG bytes."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"expected (H,W,3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    # Filter byte 0 (None) per scanline.
    raw = np.empty((h, 1 + w * 3), dtype=np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = rgb.reshape(h, w * 3)
    idat = zlib.compress(raw.tobytes(), compress_level)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray, compress_level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb, compress_level))


def read_png_size(path: str) -> "tuple[int, int]":
    """(width, height) from a PNG header — for tests."""
    with open(path, "rb") as f:
        sig = f.read(8)
        if sig != b"\x89PNG\r\n\x1a\n":
            raise ValueError("not a PNG")
        f.read(8)  # IHDR length+tag
        w, h = struct.unpack(">II", f.read(8))
    return w, h
