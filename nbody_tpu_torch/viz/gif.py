"""Minimal dependency-free animated GIF writer.

Completes the headless replacement of the reference's interactive window
(simulation_visualization.cpp): PNG frames for stills, GIF for motion.  The
renderer's colors live on the green->red mass gradient over black
(fragment shader semantics, .cpp:46-56), so a 256-entry palette of
black + that gradient represents frames exactly.

A copy of ``nbody_tpu/viz/gif.py`` (numpy only): the port runs where JAX
is not installed, and importing anything under ``nbody_tpu`` imports
JAX.  ``tests/test_torch_viz.py`` holds its output to the
original's byte for byte.
"""

from __future__ import annotations

import struct
from typing import Iterable, Sequence

import numpy as np


def _palette() -> np.ndarray:
    """Entry 0 = black; entries 1..255 = green->red lerp."""
    pal = np.zeros((256, 3), dtype=np.uint8)
    w = np.linspace(0.0, 1.0, 255)
    pal[1:, 0] = (w * 255 + 0.5).astype(np.uint8)
    pal[1:, 1] = ((1.0 - w) * 255 + 0.5).astype(np.uint8)
    return pal


def _quantize(rgb: np.ndarray) -> np.ndarray:
    """Map renderer frames onto the palette: black -> 0, else by red/weight."""
    lit = rgb.sum(axis=-1) > 0
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    w = np.where(r + g > 0, r / np.maximum(r + g, 1.0), 0.0)
    idx = (1 + w * 254 + 0.5).astype(np.uint8)
    return np.where(lit, idx, 0).astype(np.uint8)


def _lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """Standard GIF LZW, 8-bit codes."""
    clear = 1 << min_code_size
    end = clear + 1
    table = {bytes([i]): i for i in range(clear)}
    next_code = end + 1
    code_size = min_code_size + 1

    out = bytearray()
    cur = 0
    nbits = 0

    def emit(code, size):
        nonlocal cur, nbits
        cur |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(cur & 0xFF)
            cur >>= 8
            nbits -= 8

    emit(clear, code_size)
    prefix = b""
    for b in indices.tobytes():
        probe = prefix + bytes([b])
        if probe in table:
            prefix = probe
            continue
        emit(table[prefix], code_size)
        table[probe] = next_code
        next_code += 1
        if next_code > (1 << code_size):
            if code_size < 12:
                code_size += 1
            else:
                emit(clear, code_size)
                table = {bytes([i]): i for i in range(clear)}
                next_code = end + 1
                code_size = min_code_size + 1
        prefix = bytes([b])
    if prefix:
        emit(table[prefix], code_size)
    emit(end, code_size)
    if nbits:
        out.append(cur & 0xFF)
    return bytes(out)


def write_gif(path: str, frames: "Iterable[np.ndarray] | Sequence",
              delay_cs: int = 4, loop: bool = True) -> int:
    """Write (H,W,3) uint8 frames as an animated GIF. Returns frame count."""
    frames = list(frames)
    if not frames:
        raise ValueError("no frames")
    h, w = np.asarray(frames[0]).shape[:2]
    pal = _palette()
    with open(path, "wb") as f:
        f.write(b"GIF89a")
        f.write(struct.pack("<HHBBB", w, h, 0xF7, 0, 0))  # GCT, 256 colors
        f.write(pal.tobytes())
        if loop:
            f.write(b"\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00")
        for frame in frames:
            frame = np.asarray(frame)
            if frame.shape[:2] != (h, w):
                raise ValueError("frame size mismatch")
            f.write(struct.pack("<BBHB", 0x21, 0xF9, 4, 0))
            f.write(struct.pack("<HBB", delay_cs, 0, 0))
            f.write(struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0))
            f.write(b"\x08")  # LZW min code size
            data = _lzw_encode(_quantize(frame))
            for s in range(0, len(data), 255):
                chunk = data[s:s + 255]
                f.write(bytes([len(chunk)]) + chunk)
            f.write(b"\x00")
        f.write(b"\x3B")
    return len(frames)
