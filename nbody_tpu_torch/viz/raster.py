"""Device-side point rasterizer, the port of ``nbody_tpu/viz/raster.py``:
the headless stand-in for the reference's OpenGL pipeline
(``simulation_visualization.cpp``).

The reference draws bodies as GL_POINTS from a CUDA<->GL interop buffer, so
positions never leave the device (``simulation_visualization.cpp:172-223``);
its vertex shader maps positions to NDC by dividing by +/-MAX_VIEW and mass
to a [0,1] weight (``.cpp:27-37``), and its fragment shader lerps green to
red by that weight (``.cpp:46-56``).  Here the splat runs on the state's
device as plain PyTorch (the JAX package's is ``jnp`` scatter outside any
Pallas kernel): a projection, then a scatter-amax into an ``(H*W + 1,)``
buffer whose last slot takes the bodies that land outside.  Only the small
``(H, W)`` uint8 map leaves the device; ``colorize`` makes RGB on the host.

The pixel contract is the JAX package's, bit for bit
(``tests/test_torch_viz.py``): ``u = (x - cu) / max_view`` with true
division, ``px = int((u + 1) * 0.5 * (W - 1))``,
``py = int((1 - (v + 1) * 0.5) * (H - 1))``,
``w8 = uint8(weight * 254 + 1.5)`` with ``weight = clip((m - min) /
(max - min), 0, 1)``; the largest weight wins a pixel, and zero-mass ghosts
and bodies outside +/-1 never draw.  The scalars are 0-dim tensors on the
state's device, as JAX's traced scalars are: on CUDA, dividing by a Python
float may become a multiply by its reciprocal, which moves pixels at the
edges.  ``max_view``, ``cu`` and ``cv`` change from call to call with
nothing rebuilt.  ``render_weights_flat`` takes flat ``(3N,)`` positions
and renders their ``(N, 3)`` view: the same pixels, with no panel scan
(the JAX package's panels keep huge N out of the TPU's tiled copies).
"""

from __future__ import annotations

import numpy as np
import torch

# Defaults matching simulation_visualization.h:8-9 and constants.h:15-23
DEFAULT_WIDTH = 800
DEFAULT_HEIGHT = 600


def render_weights(pos: torch.Tensor, mass: torch.Tensor,
                   min_mass: float, max_mass: float, max_view: float,
                   width: int = DEFAULT_WIDTH, height: int = DEFAULT_HEIGHT,
                   view_axis: int = 2,
                   cu: float = 0.0, cv: float = 0.0) -> torch.Tensor:
    """Rasterize bodies to a packed ``(H, W)`` uint8 weight map on
    ``pos``'s device: 0 is background, 1..255 the quantized mass weight
    (the fragment shader's lerp parameter).  One byte a pixel; ``colorize``
    gives the RGB pixels exactly.  Where several bodies land on one pixel
    the largest weight wins (deterministic, unlike GL's last write)."""
    dev, dt = pos.device, pos.dtype

    def scalar(x):
        return torch.full((), x, dtype=dt, device=dev)

    axes = [a for a in range(3) if a != view_axis]
    mv, lo = scalar(max_view), scalar(min_mass)
    u = (pos[:, axes[0]] - scalar(cu)) / mv   # NDC x in [-1, 1]
    v = (pos[:, axes[1]] - scalar(cv)) / mv   # NDC y
    weight = torch.clamp((mass - lo) / (scalar(max_mass) - lo), 0.0, 1.0)
    px = ((u + 1.0) * 0.5 * (width - 1)).to(torch.int32)
    py = ((1.0 - (v + 1.0) * 0.5) * (height - 1)).to(torch.int32)
    inside = ((u >= -1.0) & (u <= 1.0) & (v >= -1.0) & (v <= 1.0)
              & (mass > 0.0))
    sink = width * height
    idx = torch.where(inside, py * width + px, sink).to(torch.int64)
    # 1 + w*254 keeps any real body above the 0 background sentinel.  The
    # scatter runs in int32: CUDA's scatter-amax may not take uint8.
    w8 = (weight * 254.0 + 1.5).to(torch.uint8).to(torch.int32)
    splat = torch.zeros(sink + 1, dtype=torch.int32, device=dev)
    splat.scatter_reduce_(0, idx, torch.where(inside, w8, 0), "amax")
    return splat[:-1].to(torch.uint8).reshape(height, width)


def render_weights_flat(pos_flat: torch.Tensor, mass: torch.Tensor,
                        min_mass: float, max_mass: float, max_view: float,
                        width: int = DEFAULT_WIDTH,
                        height: int = DEFAULT_HEIGHT, view_axis: int = 2,
                        cu: float = 0.0, cv: float = 0.0) -> torch.Tensor:
    """``render_weights`` of flat row-major ``(3N,)`` positions."""
    return render_weights(pos_flat.view(-1, 3), mass, min_mass, max_mass,
                          max_view, width, height, view_axis, cu, cv)


def _weight_lut() -> np.ndarray:
    """(256, 3) uint8 LUT: index 0 = background (black), 1..255 = the
    fragment shader's mix(green, red, w) (simulation_visualization.cpp:46-56)
    with w = (k-1)/254."""
    k = np.arange(256, dtype=np.float32)
    w = np.clip((k - 1.0) / 254.0, 0.0, 1.0)
    lut = np.stack([w, 1.0 - w, np.zeros_like(w)], axis=-1)
    lut = (lut * 255.0 + 0.5).astype(np.uint8)
    lut[0] = 0
    return lut


_LUT = _weight_lut()


def colorize(weights) -> np.ndarray:
    """Host-side (H, W) uint8 weight map -> (H, W, 3) uint8 RGB."""
    if isinstance(weights, torch.Tensor):
        weights = weights.cpu().numpy()
    return _LUT[np.asarray(weights)]


def render_frame(pos: torch.Tensor, mass: torch.Tensor,
                 min_mass: float, max_mass: float, max_view: float,
                 width: int = DEFAULT_WIDTH, height: int = DEFAULT_HEIGHT,
                 view_axis: int = 2,
                 cu: float = 0.0, cv: float = 0.0) -> torch.Tensor:
    """Rasterize bodies to an (H, W, 3) uint8 RGB frame on ``pos``'s
    device: ``colorize(render_weights(...))``'s pixels, colorized by the
    same LUT on the device."""
    w8 = render_weights(pos, mass, min_mass, max_mass, max_view,
                        width, height, view_axis, cu, cv)
    return torch.from_numpy(_LUT).to(pos.device)[w8.long()]
