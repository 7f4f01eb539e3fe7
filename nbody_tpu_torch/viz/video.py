"""Video container dispatch: pick the MP4 or AVI writer by extension.

One user-facing surface for offline video export (the reference's
"watch it evolve" UX, ``simulation_visualization.cpp:165-169``):
``.mp4``/``.m4v`` paths get the ISO-BMFF MJPEG writer (``viz/mp4.py``),
anything else the RIFF AVI writer (``viz/avi.py``).  MP4 requires PIL
for JPEG encoding; without PIL only AVI (raw-DIB codec) can be written,
and asking for an ``.mp4`` path raises with that explanation rather
than silently producing an unplayable file.

A copy of ``nbody_tpu/viz/video.py`` (numpy only): the port runs where JAX
is not installed, and importing anything under ``nbody_tpu`` imports
JAX.  ``tests/test_torch_viz.py`` holds it to the original.
"""

from __future__ import annotations

from .avi import AviStreamer, AviWriter, _pil_available


def _is_mp4(path: str) -> bool:
    return path.lower().endswith((".mp4", ".m4v"))


def _require_pil(path: str) -> None:
    if not _pil_available():
        raise RuntimeError(
            f"{path}: MP4 export needs PIL for JPEG encoding (MP4 has no "
            "raw-pixel codec players accept); install Pillow or use an "
            ".avi path (raw-DIB fallback)")


def video_writer(path: str, width: int, height: int, fps: int = 25,
                 quality: int = 85):
    """``Mp4Writer`` or ``AviWriter`` by extension; same add/close API."""
    if _is_mp4(path):
        _require_pil(path)
        from .mp4 import Mp4Writer
        return Mp4Writer(path, width, height, fps=fps, quality=quality)
    return AviWriter(path, width, height, fps=fps, quality=quality)


def video_streamer(path: str, width: int, height: int, fps: int = 25,
                   quality: int = 85):
    """``Mp4Streamer`` or ``AviStreamer`` by extension (run-time sink)."""
    if _is_mp4(path):
        _require_pil(path)
        from .mp4 import Mp4Streamer
        return Mp4Streamer(path, width, height, fps=fps, quality=quality)
    return AviStreamer(path, width, height, fps=fps, quality=quality)
