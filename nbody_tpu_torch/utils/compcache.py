"""The build root: where the port's compiled libraries live, as
``nbody_tpu/utils/compcache.py`` sets where JAX keeps its compiled
executables.

The port compiles at first use: ``ops/_build.py`` runs ``nvcc`` on each
``csrc/<name>.cu`` and ``oracle/native.py`` runs ``g++`` on
``native/nbody_native.cpp``.  Each library goes to
``<root>/<hash>/lib<name>.so``, the hash covering the sources and the
flags, so a build is reused by every later process that asks for the same
bytes.

``NBODY_COMPCACHE`` picks the root as it picks JAX's cache directory: a
directory puts the builds there (for installs whose package directory is
read-only), and ``off`` (or ``0``, ``none``, ``disable``, ``disabled``)
builds into a fresh temporary directory of this process, removed at exit,
so nothing is reused.  Unset, the root is ``build/nbody_tpu_torch/``
beside the package, which the repository's ``.gitignore`` lists; this
differs from JAX's ``~/.cache`` default by design, so that a checkout
builds into itself and nothing around it.  The CLI and
``bench_lib.run_benchmark`` call ``enable_compilation_cache`` where the
JAX package does; any other caller gets the same root from
``build_root`` at its first build.

Every build follows one rule (``staging`` / ``publish``): the compiler
writes into a temporary directory beside the target and the finished file
is moved into place with ``os.replace``, so a process that looks at the
target sees no library or a whole one, however many processes build it
at once.
"""

from __future__ import annotations

import atexit
import os
import pathlib
import shutil
import tempfile
from typing import Optional

DEFAULT_ROOT = (pathlib.Path(__file__).resolve().parent.parent.parent
                / "build" / "nbody_tpu_torch")
OFF = ("off", "0", "none", "disable", "disabled")

_root: Optional[pathlib.Path] = None
# This process's temporary root under NBODY_COMPCACHE=off, by pid (a
# forked child makes its own).
_scratch: "dict[int, pathlib.Path]" = {}


def _process_scratch() -> pathlib.Path:
    pid = os.getpid()
    if pid not in _scratch:
        path = pathlib.Path(tempfile.mkdtemp(prefix="nbody_tpu_torch_build_"))
        _scratch[pid] = path
        atexit.register(lambda: os.getpid() == pid
                        and shutil.rmtree(path, ignore_errors=True))
    return _scratch[pid]


def enable_compilation_cache(path: "str | os.PathLike | None" = None
                             ) -> Optional[str]:
    """Set the build root from ``path``, else ``NBODY_COMPCACHE``, else
    the default, and return it; ``NBODY_COMPCACHE=off`` wins over
    ``path``, as in the JAX package.  Never raises: a directory that
    cannot be made leaves the root as it was and returns None (the first
    build then reports the error)."""
    global _root
    env = os.environ.get("NBODY_COMPCACHE", "")
    try:
        if env.lower() in OFF:
            root = _process_scratch()
        else:
            root = pathlib.Path(os.path.expanduser(
                str(path or env or DEFAULT_ROOT))).resolve()
            root.mkdir(parents=True, exist_ok=True)
    except Exception:
        return None
    _root = root
    return str(root)


def build_root() -> pathlib.Path:
    """The root builds go to: the one ``enable_compilation_cache`` set,
    or, before any call, the one it would set now."""
    if _root is None:
        enable_compilation_cache()
    return _root if _root is not None else DEFAULT_ROOT


def staging(target: pathlib.Path) -> pathlib.Path:
    """A fresh temporary directory beside ``target`` (made with its
    parents) for the compiler to write ``target.name`` into."""
    target.parent.mkdir(parents=True, exist_ok=True)
    return pathlib.Path(tempfile.mkdtemp(dir=target.parent))


def publish(tmp: pathlib.Path, target: pathlib.Path) -> None:
    """Move the finished ``tmp / target.name`` onto ``target`` in one
    step and remove ``tmp``."""
    os.replace(tmp / target.name, target)
    shutil.rmtree(tmp, ignore_errors=True)
