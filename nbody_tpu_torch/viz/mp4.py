"""Video export: MJPEG-in-MP4 writer (pure stdlib ISO-BMFF container,
PIL JPEG frames).

Same role as ``viz/avi.py`` — the offline replacement for the
reference's GLFW live window (``simulation_visualization.cpp:165-169``,
``main.cpp:129-133``): one seekable video file instead of thousands of
PNGs.  The MP4 container is the more universal target (browsers play it
natively, which AVI is not guaranteed); the codec is the same
dependency-free Motion-JPEG, written the way ffmpeg writes MJPEG into
MP4: an ``mp4v`` visual sample entry whose ``esds`` declares
objectTypeIndication 0x6C (ISO/IEC 10918-1 JPEG), every sample a
standalone JPEG (all sync — no ``stss`` box needed).

Frames stream to disk as they arrive (O(one frame) memory): ``ftyp``
then an ``mdat`` whose size is patched on ``close()``, with the ``moov``
index written last.  Unlike AVI there is no raw-pixel fallback codec
players accept, so this writer requires PIL (present in the base image);
``viz/video.py`` routes to the AVI/DIB path when PIL is absent.

A copy of ``nbody_tpu/viz/mp4.py`` (numpy only): the port runs where JAX
is not installed, and importing anything under ``nbody_tpu`` imports
JAX.  ``tests/test_torch_viz.py`` holds its output to the
original's byte for byte.
"""

from __future__ import annotations

import struct

import numpy as np

from .avi import _jpeg_encode


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _full(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(typ, struct.pack(">I", (version << 24) | flags) + payload)


# Unity transform matrix (16.16 / 2.30 fixed point), shared by mvhd/tkhd.
_MATRIX = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _descr(tag: int, payload: bytes) -> bytes:
    """MPEG-4 descriptor with minimal (single-byte) length encoding."""
    assert len(payload) < 128
    return bytes([tag, len(payload)]) + payload


def _esds() -> bytes:
    """Elementary-stream descriptor declaring JPEG video (OTI 0x6C)."""
    dcd = _descr(0x04, bytes([0x6C,          # objectTypeIndication: JPEG
                              0x11])         # streamType 4 (visual) | reserved
                 + b"\0\0\0"                  # bufferSizeDB
                 + struct.pack(">2I", 0, 0))  # max/avg bitrate (unknown)
    es = _descr(0x03, struct.pack(">HB", 1, 0) + dcd + _descr(0x06, b"\x02"))
    return _full(b"esds", 0, 0, es)


def _sample_entry(w: int, h: int) -> bytes:
    name = b"nbody_tpu mjpeg"
    return _box(
        b"mp4v",
        b"\0" * 6 + struct.pack(">H", 1)      # reserved, data_reference_index
        + b"\0" * 16                          # pre_defined/reserved
        + struct.pack(">2H", w, h)
        + struct.pack(">2I", 0x00480000, 0x00480000)   # 72 dpi
        + b"\0" * 4 + struct.pack(">H", 1)    # reserved, frame_count
        + bytes([len(name)]) + name.ljust(31, b"\0")   # compressorname
        + struct.pack(">Hh", 24, -1)          # depth, pre_defined
        + _esds())


class Mp4Writer:
    """Streaming MP4 writer; ``add(frame)`` per (H, W, 3) uint8 frame.

    Drop-in API twin of ``AviWriter`` (``add``/``close``/context
    manager); one video track, timescale = fps, one sample per frame.
    """

    def __init__(self, path: str, width: int, height: int, fps: int = 25,
                 quality: int = 85):
        self.path, self.w, self.h = path, width, height
        self.fps, self.quality = fps, quality
        self._f = open(path, "wb")
        self._f.write(_box(b"ftyp", b"isom" + struct.pack(">I", 0x200)
                           + b"isomiso2mp41"))
        self._mdat_off = self._f.tell()
        self._f.write(struct.pack(">I", 8) + b"mdat")  # size patched on close
        self._sizes: "list[int]" = []
        self._offsets: "list[int]" = []                # absolute file offsets

    def add(self, frame) -> None:
        rgb = np.asarray(frame, dtype=np.uint8)
        if rgb.shape != (self.h, self.w, 3):
            raise ValueError(
                f"frame shape {rgb.shape} != ({self.h}, {self.w}, 3)")
        data = _jpeg_encode(rgb, self.quality)
        # 32-bit container fields (mdat size, stco offsets): reject the
        # frame that would overflow them NOW, not after hours of frames
        # have streamed (close() would otherwise die in struct.pack and
        # leave a corrupt file; ADVICE r3).
        end = self._f.tell() + len(data)
        if end - self._mdat_off >= 1 << 32 or end >= 1 << 32:
            raise OverflowError(
                f"MP4 mdat/stco fields are 32-bit; adding this frame would "
                f"push the file past 4 GiB ({end} bytes). Close this file "
                f"and continue in a new one.")
        self._offsets.append(self._f.tell())
        self._f.write(data)
        self._sizes.append(len(data))

    # -- container plumbing -------------------------------------------------

    def _stbl(self) -> bytes:
        n = len(self._sizes)
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1)
                     + _sample_entry(self.w, self.h))
        stts = _full(b"stts", 0, 0,
                     struct.pack(">I", 1 if n else 0)
                     + (struct.pack(">2I", n, 1) if n else b""))
        stsc = _full(b"stsc", 0, 0,
                     struct.pack(">I", 1 if n else 0)
                     + (struct.pack(">3I", 1, 1, 1) if n else b""))
        stsz = _full(b"stsz", 0, 0, struct.pack(">2I", 0, n)
                     + struct.pack(f">{n}I", *self._sizes))
        if self._offsets and self._offsets[-1] >= 1 << 32:
            raise OverflowError("MP4 stco offsets exceed 32 bits; "
                                "file too large for this writer")
        stco = _full(b"stco", 0, 0, struct.pack(">I", n)
                     + struct.pack(f">{n}I", *self._offsets))
        return _box(b"stbl", stsd + stts + stsc + stsz + stco)

    def _moov(self) -> bytes:
        n, ts = len(self._sizes), self.fps
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">4I", 0, 0, ts, n)
                     + struct.pack(">iH", 0x10000, 0x100) + b"\0" * 10
                     + _MATRIX + b"\0" * 24 + struct.pack(">I", 2))
        tkhd = _full(b"tkhd", 0, 3,              # enabled | in_movie
                     struct.pack(">2I", 0, 0) + struct.pack(">I", 1)
                     + b"\0" * 4 + struct.pack(">I", n) + b"\0" * 8
                     + struct.pack(">4H", 0, 0, 0, 0) + _MATRIX
                     + struct.pack(">2I", self.w << 16, self.h << 16))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(">4I", 0, 0, ts, n)
                     + struct.pack(">2H", 0x55C4, 0))       # lang 'und'
        hdlr = _full(b"hdlr", 0, 0, b"\0" * 4 + b"vide" + b"\0" * 12
                     + b"VideoHandler\0")
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1)
                                   + _full(b"url ", 0, 1, b"")))
        minf = _box(b"minf", _full(b"vmhd", 0, 1, b"\0" * 8)
                    + dinf + self._stbl())
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        return _box(b"moov", mvhd + _box(b"trak", tkhd + mdia))

    def close(self) -> None:
        if self._f is None:
            return
        f, self._f = self._f, None
        mdat_end = f.tell()
        if mdat_end - self._mdat_off >= 1 << 32:
            # add() pre-checks every frame, so this is a belt-and-braces
            # guard; raise the same typed error rather than an opaque
            # struct.error from pack (ADVICE r3).
            f.close()
            raise OverflowError(
                "MP4 mdat size exceeds 32 bits; file too large for this "
                "writer")
        f.write(self._moov())
        f.seek(self._mdat_off)
        f.write(struct.pack(">I", mdat_end - self._mdat_off))
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_mp4(path: str, frames, fps: int = 25, quality: int = 85) -> int:
    """Write an iterable of (H, W, 3) uint8 frames to ``path``; returns
    the frame count.  Streaming-friendly twin of ``write_avi``."""
    it = iter(frames)
    try:
        first = np.asarray(next(it), dtype=np.uint8)
    except StopIteration:
        raise ValueError("write_mp4 needs at least one frame")
    h, w, _ = first.shape
    with Mp4Writer(path, w, h, fps=fps, quality=quality) as mp:
        mp.add(first)
        for fr in it:
            mp.add(fr)
        n = len(mp._sizes)
    return n


class Mp4Streamer:
    """``frame_streamer`` sink writing an MJPEG MP4 DURING the run —
    API twin of ``AviStreamer`` (``nbody run --viz-avi out.mp4`` routes
    here by extension via ``viz/video.py``)."""

    def __init__(self, path: str, width: int, height: int, fps: int = 25,
                 quality: int = 85):
        self._writer = Mp4Writer(path, width, height, fps=fps,
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
