"""Video export: MJPEG-in-AVI writer (pure stdlib container, PIL JPEG
frames; raw-BGR fallback when PIL is absent).

The reference's "watch it evolve" UX is the GLFW window redrawn every
step (``simulation_visualization.cpp:165-169``, ``main.cpp:129-133``);
the headless equivalents here are the live HTTP viewer (online) and this
writer (offline): one seekable video file instead of thousands of PNGs.
MJPEG-in-AVI is chosen because it needs no codec dependency — JPEG comes
from PIL (in the base image) and the AVI RIFF container is ~100 lines of
struct-packing — and plays everywhere (VLC/ffmpeg/browsers-via-convert).

Frames stream to disk as they arrive (O(one frame) memory); the RIFF
sizes and the ``idx1`` seek index are patched on ``close()``.

A copy of ``nbody_tpu/viz/avi.py`` (numpy only): the port runs where JAX
is not installed, and importing anything under ``nbody_tpu`` imports
JAX.  ``tests/test_torch_viz.py`` holds its output to the
original's byte for byte.
"""

from __future__ import annotations

import io
import struct
from typing import Optional

import numpy as np


def _jpeg_encode(rgb: np.ndarray, quality: int) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rgb, "RGB").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _dib_encode(rgb: np.ndarray) -> bytes:
    # Uncompressed DIB: bottom-up rows, BGR order, rows padded to 4 bytes.
    h, w, _ = rgb.shape
    bgr = rgb[::-1, :, ::-1]
    row = np.zeros((h, (w * 3 + 3) // 4 * 4), np.uint8)
    row[:, :w * 3] = bgr.reshape(h, w * 3)
    return row.tobytes()


def _pil_available() -> bool:
    try:
        import PIL  # noqa: F401
        return True
    except ImportError:
        return False


class AviWriter:
    """Streaming AVI writer; ``add(frame)`` per (H, W, 3) uint8 frame."""

    def __init__(self, path: str, width: int, height: int, fps: int = 25,
                 quality: int = 85, codec: Optional[str] = None):
        if codec is None:
            codec = "MJPG" if _pil_available() else "DIB "
        if codec not in ("MJPG", "DIB "):
            raise ValueError(f"codec must be 'MJPG' or 'DIB ', got {codec!r}")
        self.path, self.w, self.h = path, width, height
        self.fps, self.quality, self.codec = fps, quality, codec
        # AVI stream chunk suffix: 'dc' = compressed video, 'db' =
        # uncompressed DIB — strict demuxers key frame handling off it.
        self._chunk_id = b"00dc" if codec == "MJPG" else b"00db"
        self._f = open(path, "wb")
        self._idx: "list[tuple[int, int]]" = []   # (offset-in-movi, size)
        self._max_chunk = 0
        self._write_headers(n_frames=0, max_chunk=0)   # patched on close
        self._movi_start = self._f.tell()
        self._f.write(b"LIST\0\0\0\0movi")

    # -- container plumbing -------------------------------------------------

    def _write_headers(self, n_frames: int, max_chunk: int) -> None:
        f = self._f
        f.seek(0)
        compression = (struct.unpack("<I", self.codec.encode())[0]
                       if self.codec == "MJPG" else 0)
        avih = struct.pack(
            "<14I", int(1e6 / self.fps), max_chunk * self.fps, 0,
            0x10,                       # AVIF_HASINDEX
            n_frames, 0, 1, max_chunk, self.w, self.h, 0, 0, 0, 0)
        strh = struct.pack(
            "<4s4sI2H6IiI4H", b"vids", self.codec.encode(),
            0, 0, 0,                    # dwFlags, wPriority, wLanguage
            0, 1, self.fps,             # dwInitialFrames, dwScale, dwRate
            0, n_frames, max_chunk,     # dwStart, dwLength, dwSuggestedBuf
            -1, 0,                      # dwQuality (default), dwSampleSize
            0, 0, self.w, self.h)       # rcFrame
        strf = struct.pack(
            "<I2i2H6i", 40, self.w, self.h, 1, 24, compression,
            self.h * ((self.w * 3 + 3) // 4 * 4), 0, 0, 0, 0)
        strl = (b"LIST" + struct.pack("<I", 4 + 8 + len(strh) + 8 + len(strf))
                + b"strl"
                + b"strh" + struct.pack("<I", len(strh)) + strh
                + b"strf" + struct.pack("<I", len(strf)) + strf)
        hdrl = (b"LIST" + struct.pack("<I", 4 + 8 + len(avih) + len(strl))
                + b"hdrl"
                + b"avih" + struct.pack("<I", len(avih)) + avih + strl)
        f.write(b"RIFF\0\0\0\0AVI " + hdrl)

    def add(self, frame) -> None:
        rgb = np.asarray(frame, dtype=np.uint8)
        if rgb.shape != (self.h, self.w, 3):
            raise ValueError(
                f"frame shape {rgb.shape} != ({self.h}, {self.w}, 3)")
        data = (_jpeg_encode(rgb, self.quality) if self.codec == "MJPG"
                else _dib_encode(rgb))
        off = self._f.tell() - self._movi_start - 8   # from 'movi' fourcc
        self._f.write(self._chunk_id + struct.pack("<I", len(data)) + data)
        if len(data) % 2:
            self._f.write(b"\0")
        self._idx.append((off, len(data)))
        self._max_chunk = max(self._max_chunk, len(data) + 8)

    def close(self) -> None:
        if self._f is None:
            return
        f = self._f
        movi_size = f.tell() - self._movi_start - 8
        f.write(b"idx1" + struct.pack("<I", 16 * len(self._idx)))
        for off, size in self._idx:
            f.write(self._chunk_id + struct.pack("<3I", 0x10, off, size))
        total = f.tell()
        f.seek(self._movi_start + 4)
        f.write(struct.pack("<I", movi_size))
        self._write_headers(len(self._idx), self._max_chunk)
        f.seek(4)
        f.write(struct.pack("<I", total - 8))
        f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_avi(path: str, frames, fps: int = 25, quality: int = 85,
              codec: Optional[str] = None) -> int:
    """Write an iterable of (H, W, 3) uint8 frames to ``path``; returns the
    frame count.  Frames are consumed one at a time (streaming-friendly:
    pass a generator or a ``LazySnapshots``-backed renderer)."""
    it = iter(frames)
    try:
        first = np.asarray(next(it), dtype=np.uint8)
    except StopIteration:
        raise ValueError("write_avi needs at least one frame")
    h, w, _ = first.shape
    with AviWriter(path, w, h, fps=fps, quality=quality, codec=codec) as av:
        av.add(first)
        for fr in it:
            av.add(fr)
        n = len(av._idx)
    return n


class AviStreamer:
    """``frame_streamer`` sink writing an MJPEG AVI DURING the run — the
    third live-output option beside PNG frames (``FrameStreamer``) and
    the HTTP viewer (``LiveViewer``); composable with both through
    ``TeeStreamer``.  Long runs get one seekable video file instead of
    thousands of PNGs (``nbody run --viz-avi out.avi``)."""

    def __init__(self, path: str, width: int, height: int, fps: int = 25,
                 quality: int = 85):
        self._writer = AviWriter(path, width, height, fps=fps,
                                 quality=quality)
        self.frames_written = 0

    def submit(self, idx: int, frame) -> None:
        self._writer.add(np.asarray(frame))
        self.frames_written += 1

    def close(self) -> None:
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
