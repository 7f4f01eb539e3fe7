"""Checkpoint / resume and trajectory NPZ files, as
``nbody_tpu/io/checkpoint.py`` writes them.

The keys are the JAX package's (``pos``, ``vel``, ``acc``, ``mass``,
``step``, ``config_json``; ``snapshots`` or streamed ``snap_NNNNNN`` /
``vel_NNNNNN`` entries with ``mass``, ``snap_every``, ``n_snaps``), so a
file written by either package loads in the other.  The port's
``config_json`` adds ``device``, which the JAX loader ignores as an unknown
field.  The huge-N fields of a config (``flat_state``, ``prog_cap``) are
carried both ways.  A flat ``(3N,)`` state is stored as ``(N, 3)``, as the
JAX package stores it, and ``load_checkpoint(flat=True)`` returns a
``FlatState`` of ``(3N,)`` views.

bfloat16 arrays are stored as the JAX package stores them: NumPy has no
bfloat16, so ``np.asarray`` of a JAX bf16 array gives 2-byte records that
``np.savez`` writes as ``|V2``.  The port writes the same bytes under the
same dtype, and reads ``|V2`` arrays back as bfloat16, so a bf16 run
resumes from either package's file.  (The JAX loader cannot read them:
``jnp.asarray`` refuses ``|V2``.)

Not ported: the Orbax adapter (``save_checkpoint_orbax`` /
``load_checkpoint_orbax``), which belongs to the JAX ecosystem (the card's
host has no ``orbax``); the NPZ file carries what it gives: the whole
state with its step and config, written atomically and resumed by either
package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..models.state import SimState, flat_from_state

# NumPy's record dtype for a bfloat16 array, as np.savez writes JAX's.
_BF16_RECORD = np.dtype("V2")


def _host(arr) -> np.ndarray:
    """Tensor or array -> host array; a bfloat16 tensor becomes its 2-byte
    records (``|V2``), the bytes the JAX package writes."""
    if not hasattr(arr, "detach"):
        return np.asarray(arr)
    t = arr.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def _host_n3(arr) -> np.ndarray:
    """Tensor or array -> host (N, 3); flat (3N,) arrays reshape."""
    a = _host(arr)
    return a.reshape(-1, 3) if a.ndim == 1 else a


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A stored array -> tensor; ``|V2`` records are bfloat16."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return t.to(device=device, dtype=dtype or torch.bfloat16)
    return torch.tensor(a, dtype=dtype, device=device)


def _config_bytes(cfg: SimConfig) -> np.ndarray:
    return np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(),
                         dtype=np.uint8)


def config_from_json(raw_bytes) -> SimConfig:
    """A ``SimConfig`` from a stored ``config_json``: unknown fields are
    dropped, as the JAX loader drops them."""
    raw = json.loads(bytes(np.asarray(raw_bytes).tobytes()).decode())
    known = {f.name for f in dataclasses.fields(SimConfig)}
    return SimConfig(**{k: v for k, v in raw.items() if k in known})


def save_checkpoint(path: str, state, step: int,
                    cfg: Optional[SimConfig] = None) -> None:
    """Atomic NPZ checkpoint write (tmp file + rename)."""
    payload = {
        "pos": _host_n3(state.pos),
        "vel": _host_n3(state.vel),
        "acc": _host_n3(state.acc),
        "mass": _host(state.mass),
        "step": np.asarray(step, dtype=np.int64),
    }
    if cfg is not None:
        payload["config_json"] = _config_bytes(cfg)
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, dtype: Optional[torch.dtype] = None,
                    device="cuda", flat: bool = False
                    ) -> Tuple[SimState, int, Optional[SimConfig]]:
    """Load (state, step, config-or-None) from an NPZ checkpoint onto
    ``device``.  ``dtype=None`` keeps the stored precision; ``flat=True``
    returns a ``FlatState`` (the ``(3N,)`` views of the loaded tensors)."""
    with np.load(path) as z:
        state = SimState(*(_tensor(z[k], dtype, device)
                           for k in ("pos", "vel", "acc", "mass")))
        if flat:
            state = flat_from_state(state)
        step = int(z["step"])
        cfg = (config_from_json(z["config_json"])
               if "config_json" in z.files else None)
    return state, step, cfg


def load_checkpoint_meta(path: str
                         ) -> Tuple[int, Optional[SimConfig], int]:
    """Read (step, config-or-None, n_bodies) without loading the state:
    n_bodies comes from the npy header of the ``mass`` entry."""
    with np.load(path) as z:
        step = int(z["step"])
        try:
            with z.zip.open("mass.npy") as f:
                version = np.lib.format.read_magic(f)
                reader = {(1, 0): np.lib.format.read_array_header_1_0,
                          (2, 0): np.lib.format.read_array_header_2_0}[
                              version]
                shape, _, _ = reader(f)
            n = int(shape[0])
        except (KeyError, AttributeError, ValueError, OSError):
            n = int(z["mass"].shape[0])   # unknown layout: full read
        cfg = (config_from_json(z["config_json"])
               if "config_json" in z.files else None)
    return step, cfg, n


def save_trajectory(path: str, snapshots, snap_every: int,
                    cfg: Optional[SimConfig] = None, mass=None,
                    vel_snapshots=None) -> None:
    """NPZ trajectory export (positions over time, optionally velocities;
    ``mass`` for the mass-to-colour rendering)."""
    payload = {"snapshots": _host(snapshots),
               "snap_every": np.asarray(snap_every, dtype=np.int64)}
    if vel_snapshots is not None:
        payload["vel_snapshots"] = _host(vel_snapshots)
    if mass is not None:
        payload["mass"] = _host(mass)
    if cfg is not None:
        payload["config_json"] = _config_bytes(cfg)
    np.savez_compressed(path, **payload)


class TrajectoryWriter:
    """Incremental trajectory writer: snapshots spill to the NPZ (zip) one
    entry at a time, so host memory stays O(one snapshot).

    Writes ``snap_000000 ... snap_{k}`` (and ``vel_...`` when given), plus
    ``mass`` / ``snap_every`` / ``n_snaps`` / ``config_json`` on close.
    Atomic: assembles in a tmp file, renamed into place on close; a
    failure inside the ``with`` block leaves an earlier file untouched."""

    def __init__(self, path: str, snap_every: int,
                 cfg: Optional[SimConfig] = None, mass=None,
                 compress: bool = True):
        import zipfile
        self._path = path
        self._snap_every = snap_every
        self._cfg = cfg
        self._mass = None if mass is None else _host(mass)
        self.n_snaps = 0
        directory = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(directory, exist_ok=True)
        fd, self._tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
        os.close(fd)
        self._zf = zipfile.ZipFile(
            self._tmp, "w",
            zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED)

    def _write_entry(self, name: str, arr: np.ndarray) -> None:
        with self._zf.open(name + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, np.ascontiguousarray(arr))

    def append(self, pos, vel=None) -> None:
        """Append one position snapshot (and its velocities when given;
        every snapshot of one trajectory with vel or none)."""
        self._write_entry(f"snap_{self.n_snaps:06d}", _host_n3(pos))
        if vel is not None:
            self._write_entry(f"vel_{self.n_snaps:06d}", _host_n3(vel))
        self.n_snaps += 1

    def close(self) -> None:
        if self._zf is None:
            return
        try:
            if self._mass is not None:
                self._write_entry("mass", self._mass)
            self._write_entry(
                "snap_every", np.asarray(self._snap_every, dtype=np.int64))
            self._write_entry(
                "n_snaps", np.asarray(self.n_snaps, dtype=np.int64))
            if self._cfg is not None:
                self._write_entry("config_json", _config_bytes(self._cfg))
            self._zf.close()
            self._zf = None
            os.replace(self._tmp, self._path)
        except BaseException:
            self.discard()
            raise

    def discard(self) -> None:
        """Close and remove the tmp file without committing."""
        if self._zf is not None:
            self._zf.close()
            self._zf = None
        if os.path.exists(self._tmp):
            os.unlink(self._tmp)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.discard()
        else:
            self.close()


class LazySnapshots:
    """Sequence view over a streamed trajectory NPZ: snapshots load from
    the zip one at a time.  ``prefix`` selects ``snap_`` (positions) or
    ``vel_`` (velocities)."""

    def __init__(self, npz, n_snaps: int, prefix: str = "snap_"):
        self._z = npz
        self._n = n_snaps
        self._prefix = prefix
        self.shape = ((n_snaps,) + tuple(npz[f"{prefix}000000"].shape)
                      if n_snaps else (0, 0, 3))

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, k: int) -> np.ndarray:
        if not -self._n <= k < self._n:
            raise IndexError(k)
        return self._z[f"{self._prefix}{k % self._n:06d}"]

    def __iter__(self):
        for k in range(self._n):
            yield self[k]


def load_trajectory(path: str):
    """Load a trajectory NPZ -> (snapshots, mass-or-None, snap_every)."""
    snaps, _, mass, snap_every, _ = load_trajectory_full(path)
    return snaps, mass, snap_every


def load_trajectory_full(path: str):
    """Load a trajectory NPZ -> ``(snapshots, vel_snapshots-or-None,
    mass-or-None, snap_every, cfg-or-None)``.  Monolithic ``snapshots``
    load eagerly; streamed entries return ``LazySnapshots`` views that
    keep the zip open."""
    z = np.load(path)
    mass = z["mass"] if "mass" in z.files else None
    snap_every = (int(np.ravel(z["snap_every"])[0])
                  if "snap_every" in z.files else 1)
    cfg = (config_from_json(z["config_json"])
           if "config_json" in z.files else None)
    if "snapshots" in z.files:
        snaps = z["snapshots"]
        vel = z["vel_snapshots"] if "vel_snapshots" in z.files else None
        z.close()
        return snaps, vel, mass, snap_every, cfg
    # Count snap_NNNNNN entries only, not the snap_every metadata.
    n = (int(np.ravel(z["n_snaps"])[0]) if "n_snaps" in z.files
         else sum(1 for f in z.files
                  if f.startswith("snap_") and f[5:].isdigit()))
    n_vel = sum(1 for f in z.files
                if f.startswith("vel_") and f[4:].isdigit())
    vel = LazySnapshots(z, n, prefix="vel_") if n_vel == n and n else None
    return LazySnapshots(z, n), vel, mass, snap_every, cfg
