"""Initial conditions, as in ``nbody_tpu/models/init.py``: the uniform box
of the reference (positions uniform per axis in [-max_pos, max_pos],
masses uniform in [min_mass, max_mass], velocities and accelerations
zero) and the structured presets of ``--init``: a cold Plummer sphere,
a Plummer sphere in virial equilibrium, a cold rotating disk and two
virialised Plummer spheres on a collision course.

Determinism comes from an explicit ``torch.Generator`` on the state's
device, seeded with ``cfg.seed`` when none is passed.  Its numbers are not
``jax.random``'s, so each preset is split into its draws (``*_draws``,
the uniform and normal samples, on the device) and a deterministic
transform of them (``*_from_draws``); a test feeds a transform the draws
that ``jax.random`` made and compares with the JAX maker.  The transforms
compute in float32, as the JAX makers do, and cast to ``cfg.dtype``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import SimConfig
from ..utils.device import require_device
from .state import FlatState, SimState, flat_from_state


def _generator(cfg: SimConfig, generator: Optional[torch.Generator]
               ) -> Tuple[torch.device, torch.Generator]:
    device = require_device(cfg.device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    return device, generator


def _uniform(shape, lo: float, hi: float, generator, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        lo, hi, generator=generator)


def _normal(shape, generator, device) -> torch.Tensor:
    return torch.randn(shape, dtype=torch.float32, device=device,
                       generator=generator)


def init_state(cfg: SimConfig,
               generator: Optional[torch.Generator] = None) -> SimState:
    """The reference's uniform box."""
    device, generator = _generator(cfg, generator)
    n, dtype = cfg.n_bodies, cfg.torch_dtype
    pos = _uniform((n, 3), -cfg.max_pos, cfg.max_pos, generator,
                   device).to(dtype)
    mass = _uniform((n,), cfg.min_mass, cfg.max_mass, generator,
                    device).to(dtype)
    zeros = torch.zeros((n, 3), dtype=dtype, device=device)
    return SimState(pos=pos, vel=zeros, acc=zeros.clone(), mass=mass)


def init_state_flat(cfg: SimConfig,
                    generator: Optional[torch.Generator] = None) -> FlatState:
    """The uniform box as a ``FlatState`` (``(3N,)`` pos / vel / acc):
    the views of ``init_state``'s tensors, so the same seed gives the
    same bodies in either layout.  Float32 only, as in the JAX package
    (the flat mode drives the float32 pair-symmetric kernels)."""
    if cfg.dtype != "float32":
        raise ValueError(f"flat-state mode is float32-only (the kernels); "
                         f"got dtype={cfg.dtype!r}")
    return flat_from_state(init_state(cfg, generator))


class PlummerDraws(NamedTuple):
    """The samples of a cold Plummer sphere: ``u`` uniform in [1e-6, 1 -
    1e-6) for the radius, ``normal`` (N, 3) standard normals for the
    direction, ``mass`` uniform in [min_mass, max_mass)."""

    u: torch.Tensor
    normal: torch.Tensor
    mass: torch.Tensor


def plummer_draws(cfg: SimConfig, generator: torch.Generator,
                  device) -> PlummerDraws:
    n = cfg.n_bodies
    return PlummerDraws(
        u=_uniform((n,), 1e-6, 1.0 - 1e-6, generator, device),
        normal=_normal((n, 3), generator, device),
        mass=_uniform((n,), cfg.min_mass, cfg.max_mass, generator, device))


def _isotropic_directions(normal: torch.Tensor) -> torch.Tensor:
    return normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True)


def plummer_from_draws(d: PlummerDraws, a: float,
                       dtype: torch.dtype) -> SimState:
    """Inverse-CDF sampling of the Plummer cumulative mass profile:
    ``r = a / sqrt(u^(-2/3) - 1)`` along an isotropic direction; at rest."""
    r = a / torch.sqrt(d.u ** (-2.0 / 3.0) - 1.0)
    pos = (r[:, None] * _isotropic_directions(d.normal)).to(dtype)
    zeros = torch.zeros_like(pos)
    return SimState(pos=pos, vel=zeros, acc=zeros.clone(),
                    mass=d.mass.to(dtype))


def plummer_state(cfg: SimConfig,
                  generator: Optional[torch.Generator] = None,
                  scale_radius: Optional[float] = None) -> SimState:
    """A cold Plummer sphere of scale radius ``max_pos / 10`` (by default):
    a structured start that collapses, unlike the virialised one."""
    device, generator = _generator(cfg, generator)
    a = scale_radius if scale_radius is not None else cfg.max_pos / 10.0
    return plummer_from_draws(plummer_draws(cfg, generator, device), a,
                              cfg.torch_dtype)


# The inverse CDF of q = v / v_esc under the isotropic Plummer
# distribution function, f(q) dq ~ q^2 (1 - q^2)^(7/2) dq (Aarseth, Henon
# & Wielen 1974), tabulated at 513 points, as the JAX package does.
_Q_POINTS = 513


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for ascending ``xp``: ``searchsorted``
    and a linear blend, ``fp``'s ends outside ``xp``."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.shape[0] - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    blend = f0 + (x - x0) / torch.where(dx == 0, 1.0, dx) * (f1 - f0)
    out = torch.where(dx == 0, f1, blend)
    return torch.where(x < xp[0], fp[0], torch.where(x > xp[-1], fp[-1],
                                                     out))


def _speed_table(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cdf, q): the 513-point table, float32 as in the JAX package."""
    q = torch.linspace(0.0, 1.0, _Q_POINTS, dtype=torch.float32,
                       device=device)
    cdf = torch.cumsum(q ** 2 * (1.0 - q ** 2) ** 3.5, dim=0)
    return cdf / cdf[-1], q


def _plummer_speed_fraction(u: torch.Tensor) -> torch.Tensor:
    """q = v / v_esc for uniform draws ``u`` in [0, 1), by the table."""
    return _interp(u, *_speed_table(u.device))


class VirialDraws(NamedTuple):
    """The samples of a virialised Plummer sphere: the cold sphere's,
    ``uq`` uniform in [0, 1) for the speed fraction, ``vnormal`` (N, 3)
    standard normals for the velocity direction."""

    base: PlummerDraws
    uq: torch.Tensor
    vnormal: torch.Tensor


def plummer_virial_draws(cfg: SimConfig, generator: torch.Generator,
                         device) -> VirialDraws:
    n = cfg.n_bodies
    base = plummer_draws(cfg, generator, device)
    return VirialDraws(base=base, uq=_uniform((n,), 0.0, 1.0, generator,
                                              device),
                       vnormal=_normal((n, 3), generator, device))


def plummer_virial_from_draws(d: VirialDraws, a: float,
                              dtype: torch.dtype) -> SimState:
    """Positions as ``plummer_from_draws``; speeds ``q v_esc(r)`` with
    ``v_esc = sqrt(2 M_tot / sqrt(r^2 + a^2))`` (no G), isotropic; then
    the bulk drift removed (the sample has O(1/sqrt(N)) net momentum)."""
    base = plummer_from_draws(d.base, a, dtype)
    m_tot = torch.sum(base.mass)
    r = torch.linalg.vector_norm(base.pos, dim=-1)
    v_esc = torch.sqrt(2.0 * m_tot / torch.sqrt(r * r + a * a))
    speed = _plummer_speed_fraction(d.uq) * v_esc
    vel = (speed[:, None] * _isotropic_directions(d.vnormal)).to(dtype)
    vel = vel - torch.sum(base.mass[:, None] * vel, dim=0) / m_tot
    return base._replace(vel=vel)


def plummer_virial_state(cfg: SimConfig,
                         generator: Optional[torch.Generator] = None,
                         scale_radius: Optional[float] = None) -> SimState:
    """A Plummer sphere in virial equilibrium (speeds from the exact
    isotropic distribution function): statistically stationary, the
    backdrop for long-horizon integrator studies."""
    device, generator = _generator(cfg, generator)
    a = scale_radius if scale_radius is not None else cfg.max_pos / 10.0
    return plummer_virial_from_draws(
        plummer_virial_draws(cfg, generator, device), a, cfg.torch_dtype)


class DiskDraws(NamedTuple):
    """The samples of the disk: ``u`` uniform in [1e-4, 1) for the radius,
    ``phi`` uniform in [0, 2 pi), ``z`` standard normals for the height,
    ``mass`` uniform in [min_mass, max_mass)."""

    u: torch.Tensor
    phi: torch.Tensor
    z: torch.Tensor
    mass: torch.Tensor


def disk_draws(cfg: SimConfig, generator: torch.Generator,
               device) -> DiskDraws:
    n = cfg.n_bodies
    return DiskDraws(
        u=_uniform((n,), 1e-4, 1.0, generator, device),
        phi=_uniform((n,), 0.0, 2.0 * math.pi, generator, device),
        z=_normal((n,), generator, device),
        mass=_uniform((n,), cfg.min_mass, cfg.max_mass, generator, device))


def disk_from_draws(d: DiskDraws, a: float, thickness: float,
                    dtype: torch.dtype) -> SimState:
    """Uniform surface density over radius ``a`` (``r = a sqrt(u)``),
    Gaussian height of sigma ``thickness a``, on near-circular orbits:
    ``v_c = sqrt(M_tot (r/a)^2 / r)``, the enclosed mass of the uniform
    disk treated spherically."""
    r = a * torch.sqrt(d.u)
    pos = torch.stack([r * torch.cos(d.phi), r * torch.sin(d.phi),
                       thickness * a * d.z], dim=-1).to(dtype)
    mass = d.mass.to(dtype)
    v_c = torch.sqrt(torch.sum(mass) * d.u / r)
    vel = torch.stack([-v_c * torch.sin(d.phi), v_c * torch.cos(d.phi),
                       torch.zeros_like(v_c)], dim=-1).to(dtype)
    return SimState(pos=pos, vel=vel, acc=torch.zeros_like(pos), mass=mass)


def disk_state(cfg: SimConfig, generator: Optional[torch.Generator] = None,
               scale_radius: Optional[float] = None,
               thickness: float = 0.05) -> SimState:
    """A cold rotating disk of radius ``max_pos / 4`` (by default) in the
    xy-plane; it shears into rings and spirals within a few rotations."""
    device, generator = _generator(cfg, generator)
    a = scale_radius if scale_radius is not None else cfg.max_pos / 4.0
    return disk_from_draws(disk_draws(cfg, generator, device), a, thickness,
                           cfg.torch_dtype)


def collision_draws(cfg: SimConfig, generator: torch.Generator,
                    device) -> Tuple[VirialDraws, VirialDraws]:
    """The two clusters' draws: ``n // 2`` bodies, then ``n - n // 2``."""
    n1 = cfg.n_bodies // 2
    return (plummer_virial_draws(cfg.replace(n_bodies=n1), generator,
                                 device),
            plummer_virial_draws(cfg.replace(n_bodies=cfg.n_bodies - n1),
                                 generator, device))


def collision_from_draws(d1: VirialDraws, d2: VirialDraws, a: float,
                         separation: float, impact_parameter: float,
                         approach_fraction: float,
                         dtype: torch.dtype) -> SimState:
    """Two virialised spheres centred at -/+ (separation / 2,
    impact_parameter / 2, 0), approaching at ``approach_fraction`` of the
    mutual parabolic speed ``sqrt(2 M_tot / separation)``, split so that
    ``m1 v1 = m2 v2``: the total momentum is zero by construction."""
    s1 = plummer_virial_from_draws(d1, a, dtype)
    s2 = plummer_virial_from_draws(d2, a, dtype)
    d, b = separation, impact_parameter
    off1 = s1.pos.new_tensor([-d / 2.0, -b / 2.0, 0.0])
    off2 = s2.pos.new_tensor([+d / 2.0, +b / 2.0, 0.0])
    m1, m2 = torch.sum(s1.mass), torch.sum(s2.mass)
    m_tot = m1 + m2
    v = approach_fraction * torch.sqrt(2.0 * m_tot / d)
    zero = torch.zeros_like(v)
    v1 = torch.stack([v * m2 / m_tot, zero, zero]).to(dtype)
    v2 = torch.stack([-v * m1 / m_tot, zero, zero]).to(dtype)
    pos = torch.cat([s1.pos + off1, s2.pos + off2])
    return SimState(pos=pos, vel=torch.cat([s1.vel + v1, s2.vel + v2]),
                    acc=torch.zeros_like(pos),
                    mass=torch.cat([s1.mass, s2.mass]))


def collision_state(cfg: SimConfig,
                    generator: Optional[torch.Generator] = None,
                    separation: Optional[float] = None,
                    impact_parameter: Optional[float] = None,
                    approach_fraction: float = 0.5) -> SimState:
    """Two virialised Plummer spheres (scale radius ``a = max_pos / 10``)
    on a collision course: ``separation`` 8a and ``impact_parameter`` a
    by default.  The classic merger demo."""
    device, generator = _generator(cfg, generator)
    a = cfg.max_pos / 10.0
    d1, d2 = collision_draws(cfg, generator, device)
    return collision_from_draws(
        d1, d2, a, separation if separation is not None else 8.0 * a,
        impact_parameter if impact_parameter is not None else a,
        approach_fraction, cfg.torch_dtype)


# ``--init``'s registry; "uniform" is left to the callers (``Simulation``
# makes it itself), as in the JAX package.
INIT_MAKERS = {
    "plummer": plummer_state,
    "plummer-virial": plummer_virial_state,
    "disk": disk_state,
    "collision": collision_state,
}
