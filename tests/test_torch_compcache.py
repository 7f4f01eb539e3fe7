"""The port's build root (``nbody_tpu_torch/utils/compcache.py``): the JAX
package's three cases of ``tests/test_compcache.py`` (the default, ``off``
and a directory) against the port, where the root is where the CUDA
libraries (``ops/_build.py``) and the native oracle (``oracle/native.py``)
are built; and the native build itself, which g++ can run here (nvcc
cannot): into the root, never under ``native/``, and whole when several
processes build it at once.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from nbody_tpu.utils.compcache import enable_compilation_cache as jax_enable
from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.oracle import native
from nbody_tpu_torch.utils import compcache

REPO = pathlib.Path(__file__).resolve().parent.parent
NATIVE_DIR = REPO / "native"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Each test resolves the root anew and loads its own native build;
    the process's root and library are restored afterwards."""
    monkeypatch.setattr(compcache, "_root", None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def _native_listing():
    return sorted((p.name, p.stat().st_mtime_ns)
                  for p in NATIVE_DIR.iterdir())


def test_default_root_is_the_ignored_build_dir(monkeypatch):
    monkeypatch.delenv("NBODY_COMPCACHE", raising=False)
    out = compcache.enable_compilation_cache()
    assert out == str(REPO / "build" / "nbody_tpu_torch")
    assert compcache.build_root() == compcache.DEFAULT_ROOT
    assert os.path.isdir(out)
    assert _build.library_path("pe").parent.parent == pathlib.Path(out)
    assert native.library_path().parent.parent == pathlib.Path(out)
    ignored = subprocess.run(["git", "check-ignore", "-q", out], cwd=REPO)
    assert ignored.returncode == 0, "the default build root is not ignored"


@pytest.mark.parametrize("word", ["off", "0", "none", "disable",
                                  "disabled", "OFF"])
def test_env_off_builds_into_a_fresh_process_dir(monkeypatch, word):
    monkeypatch.setenv("NBODY_COMPCACHE", word)
    assert jax_enable() is None             # the JAX package: caching off
    out = compcache.enable_compilation_cache()
    assert out is not None and os.path.isdir(out)
    assert pathlib.Path(out) != compcache.DEFAULT_ROOT
    assert not pathlib.Path(out).is_relative_to(REPO)
    # One directory for the whole process, whatever asks for the root;
    # off wins over an explicit path, as in the JAX package.
    assert compcache.enable_compilation_cache() == out
    assert compcache.enable_compilation_cache("/elsewhere") == out
    assert compcache.build_root() == pathlib.Path(out)
    assert _build.library_path("forces_sym").is_relative_to(out)
    assert _build.library_path("forces_sym").name == "libforces_sym.so"


def test_env_off_dir_differs_from_process_to_process(monkeypatch):
    monkeypatch.setenv("NBODY_COMPCACHE", "off")
    code = ("from nbody_tpu_torch.utils import compcache; "
            "print(compcache.build_root())")
    roots = [subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, check=True)
             .stdout.strip() for _ in range(2)]
    assert roots[0] != roots[1]
    # Removed when the process exits: nothing is left to reuse.
    assert not any(os.path.exists(r) for r in roots)


def test_env_path_is_used(tmp_path, monkeypatch):
    target = tmp_path / "from_env"
    monkeypatch.setenv("NBODY_COMPCACHE", str(target))
    assert compcache.enable_compilation_cache() == str(target)
    assert target.is_dir()
    assert compcache.build_root() == target
    assert _build.library_path("pe").is_relative_to(target)


def test_explicit_path_wins_over_env(tmp_path, monkeypatch):
    monkeypatch.setenv("NBODY_COMPCACHE", str(tmp_path / "env"))
    target = tmp_path / "arg"
    assert compcache.enable_compilation_cache(target) == str(target)
    assert compcache.build_root() == target


def test_unmakeable_root_returns_none_and_keeps_the_root(tmp_path,
                                                         monkeypatch):
    monkeypatch.delenv("NBODY_COMPCACHE", raising=False)
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert compcache.enable_compilation_cache(blocker / "sub") is None
    assert compcache.build_root() == compcache.DEFAULT_ROOT


def test_native_builds_into_the_root_not_native(tmp_path, monkeypatch):
    monkeypatch.setenv("NBODY_COMPCACHE", str(tmp_path))
    before = _native_listing()
    assert native.available()
    lib = native.built_library()
    assert lib.is_relative_to(tmp_path) and lib.name == "libnbody_native.so"
    assert lib == native.library_path(True) or lib == native.library_path(
        False)
    assert _native_listing() == before, "the build wrote under native/"
    # No temporary directory is left beside the library.
    assert [p.name for p in lib.parent.iterdir()] == [lib.name]
    pos = np.random.default_rng(3).standard_normal((64, 3))
    mass = np.full(64, 1.0 / 64)
    acc = native.native_forces(pos, mass, 0.002)
    assert acc.shape == (64, 3) and np.isfinite(acc).all()


def test_native_key_covers_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setenv("NBODY_COMPCACHE", str(tmp_path))
    assert native.library_path(True) != native.library_path(False)
    copy = tmp_path / "nbody_native.cpp"
    copy.write_bytes(native.SOURCE.read_bytes() + b"\n// edited\n")
    first = native.library_path(True)
    monkeypatch.setattr(native, "SOURCE", copy)
    assert native.library_path(True) != first


def test_concurrent_native_builds_each_load_a_whole_library(tmp_path):
    """Six processes build the same library into one empty root at once
    (the xdist workers of a test run): every one loads a whole library
    and computes the same forces."""
    code = (
        "import numpy as np\n"
        "from nbody_tpu_torch.oracle import native\n"
        "pos = np.random.default_rng(5).standard_normal((96, 3))\n"
        "acc = native.native_forces(pos, np.full(96, 0.01), 0.002)\n"
        "print(native.built_library(), float(acc.sum()), acc.tobytes().hex()"
        "[:64])\n")
    env = {**os.environ, "NBODY_COMPCACHE": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1, lines
    lib = pathlib.Path(lines.pop().split()[0])
    assert [q.name for q in lib.parent.iterdir()] == [lib.name]
