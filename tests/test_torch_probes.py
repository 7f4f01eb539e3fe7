"""The platform probes of ``scripts/r3_platbug.py`` and
``scripts/r8_mosaic_rules.py`` on the port (``nbody_tpu_torch/ops/
probes.py``, ``csrc/probes.cu``) against the JAX scripts' own kernel
bodies.

The scripts' ``main`` cannot be called here: they build with
``interpret=False`` and r3 appends to a file of the repository.  So each
body is restated below from its script, with its file and line, and run
through ``pl.pallas_call(..., interpret=True)`` at the script's shapes, as
the JAX package's tests run its kernels on the CPU.  On the CPU the
port's wrappers take their plain versions, which the probe scripts hold
the kernels to bit for bit on the card (``chip_smoke.py`` runs them).  Held: the r3 sums within 1e-6 of
a column's sum of |x| (JAX's block sum is XLA's reduction, in another
order than the kernel's fixed tree), the copies exactly, 2a exactly on
rows 0-2 with NaN on rows 3-7 on both sides (interpret mode leaves the
rows the body never writes as NaN), and probe 4, whose remote copy raises
outside a mesh in interpret mode, against the array its body defines
(out = x).
"""

import subprocess
import sys
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nbody_tpu_torch.ops import probes

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The r3 sums against JAX's, per column: 1e-6 of the column's sum of |x|
# (float32 sums of 16,384 terms in two orders differ by a few ulps of the
# running sum).
R3_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


# -- r3: scripts/r3_platbug.py's bodies, N = 16384, U = 2048

N, U = probes.R3_N, probes.R3_U


def _pack8_jnp(x):
    """r3_platbug.py:53-58 ``pack8_jnp``."""
    hi = x.astype(jnp.bfloat16)
    lo = (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return jnp.concatenate(
        [hi, lo, jnp.ones((x.shape[0], 1), jnp.bfloat16),
         jnp.zeros((x.shape[0], 1), jnp.bfloat16)], axis=1)


def _red_kernel(pack_ref, out_ref):
    """r3_platbug.py:69-75 ``red_kernel``."""
    j = pl.program_id(0)

    @pl.when(j == 0)
    def _():
        out_ref[:] = jnp.zeros_like(out_ref)
    out_ref[:] += jnp.sum(pack_ref[:].astype(jnp.float32), axis=0,
                          keepdims=True)


def _derive_kernel(pos_ref, out_ref):
    """r3_platbug.py:91-103 ``derive_kernel``."""
    j = pl.program_id(0)

    @pl.when(j == 0)
    def _():
        out_ref[:] = jnp.zeros_like(out_ref)
    x = pos_ref[:]
    hi = x.astype(jnp.bfloat16)
    lo = (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    pack = jnp.concatenate(
        [hi, lo, jnp.ones((U, 1), jnp.bfloat16),
         jnp.zeros((U, 1), jnp.bfloat16)], axis=1)
    out_ref[:] += jnp.sum(pack.astype(jnp.float32), axis=0, keepdims=True)


def _r3_call(kernel, width):
    """r3_platbug.py:77-88 and :105-116, in interpret mode."""
    return pl.pallas_call(
        kernel,
        grid=(N // U,),
        in_specs=[pl.BlockSpec((U, width), lambda j: (j, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 8), lambda j: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, 8), jnp.float32),
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",)),
        interpret=True,
    )


@pytest.fixture(scope="module")
def r3_system():
    pos = probes.r3_positions()
    pack_jax = np.array(jax.jit(_pack8_jnp)(jnp.asarray(pos)
                                            * jnp.float32(1.0)))
    return pos, pack_jax


def _scale(pack: np.ndarray) -> np.ndarray:
    return np.abs(pack.astype(np.float64)).sum(axis=0)


def test_pack8_bits_are_jaxs(r3_system):
    """The port's pack (``pack8``, torch's ``to(torch.bfloat16)``) has
    JAX's bits (``astype(bfloat16)``): hi and lo both rounded to nearest
    even."""
    pos, pack_jax = r3_system
    pack = probes.pack8(torch.from_numpy(pos))
    assert torch.equal(pack.view(torch.int16),
                       torch.from_numpy(pack_jax.view(np.int16)))
    # Not truncation: some component rounds up.
    hi = pack[:, :3].float().numpy()
    assert (np.abs(hi) > np.abs(pos)).any()


def test_pack_sum_matches_red_kernel(r3_system):
    pos, pack_jax = r3_system
    want = np.asarray(_r3_call(_red_kernel, 8)(jnp.asarray(pack_jax)))[0]
    got = probes.pack_sum(probes.pack8(torch.from_numpy(pos))).numpy()
    np.testing.assert_array_less(np.abs(got - want),
                                 R3_TOL * _scale(pack_jax) + 1e-30)
    assert got[6] == want[6] == N and got[7] == want[7] == 0


def test_derive_pack_sum_matches_derive_kernel(r3_system):
    pos, pack_jax = r3_system
    want = np.asarray(_r3_call(_derive_kernel, 3)(jnp.asarray(pos)))[0]
    got = probes.derive_pack_sum(torch.from_numpy(pos)).numpy()
    np.testing.assert_array_less(np.abs(got - want),
                                 R3_TOL * _scale(pack_jax) + 1e-30)


def _kernel_order_sum(pack: np.ndarray) -> np.ndarray:
    """csrc/probes.cu's order, element by element in float32: thread t of
    a block sums rows t, t + 256, ..., the tree adds sum t + s into sum t
    for t < s, s = 128 .. 1, and the blocks add in order from zero."""
    x = pack.astype(np.float32)
    u, t_n = U, probes.PROBE_THREADS
    out = np.zeros(8, np.float32)
    for b in range(x.shape[0] // u):
        tree = np.zeros((t_n, 8), np.float32)
        for t in range(t_n):
            for r in range(b * u + t, (b + 1) * u, t_n):
                tree[t] = tree[t] + x[r]
        s = t_n // 2
        while s:
            for t in range(s):
                tree[t] = tree[t] + tree[t + s]
            s //= 2
        out = out + tree[0]
    return out


@pytest.mark.parametrize("n", [U, 2 * U, N])
def test_plain_versions_keep_the_kernels_order(n):
    """``pack_sum_plain`` and ``derive_pack_sum_plain`` are the kernel's
    sums bit for bit: its order restated one add at a time, on one block,
    two, and the script's eight."""
    pos = probes.r3_positions(n, seed=n)
    pack = probes.pack8(torch.from_numpy(pos))
    want = _kernel_order_sum(pack.float().numpy())
    assert np.array_equal(probes.pack_sum_plain(pack).numpy(), want)
    assert np.array_equal(
        probes.derive_pack_sum_plain(torch.from_numpy(pos)).numpy(), want)


def test_run_r3_on_the_cpu():
    """``run_r3``'s record: the three variants bit-equal, each equal to its
    plain version, within the JAX script's 1e-3 of float64, clean."""
    lines = []
    rec = probes.run_r3("cpu", log=lines.append)
    assert rec["ok"] and rec["verdict"] == "clean" and rec["bit_equal"]
    assert rec["dev_vs_host_absdiff"] == 0.0
    assert max(rec["max_rel"].values()) <= probes.R3_REL_GATE
    assert rec["sums"][6:] == [N, 0.0]
    assert any(line.startswith("VERDICT: premade-operand ingestion CLEAN")
               for line in lines)


@pytest.mark.parametrize("n", [0, 1000, 3 * U // 2])
def test_r3_refuses_ragged_blocks(n):
    """N must be whole blocks of U rows, as the script's grid is."""
    with pytest.raises(ValueError, match="positive multiple of U = 2048"):
        probes.pack_sum(probes.pack8(torch.zeros(n, 3)))
    with pytest.raises(ValueError, match="positive multiple of U = 2048"):
        probes.derive_pack_sum(torch.zeros(n, 3))


def test_r3_refuses_other_inputs():
    with pytest.raises(ValueError, match="bfloat16"):
        probes.pack_sum(torch.zeros(N, 8))
    with pytest.raises(ValueError, match="float32"):
        probes.derive_pack_sum(torch.zeros(N, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        probes.derive_pack_sum(torch.zeros(3, N).T)


# -- r8: scripts/r8_mosaic_rules.py's bodies on x8 = arange(1024) (8, 128)

def _k_any(x_ref, o_ref, buf, sem):
    """r8_mosaic_rules.py:50-54 ``k_any`` (probes 1a, 1b)."""
    cp = pltpu.make_async_copy(x_ref, buf.at[0], sem)
    cp.start(); cp.wait()
    cp2 = pltpu.make_async_copy(buf.at[0], o_ref, sem)
    cp2.start(); cp2.wait()


def _k_ws(x_ref, o_ref, vbuf, sem):
    """r8_mosaic_rules.py:63-67 ``k_ws`` (1c)."""
    cp = pltpu.make_async_copy(x_ref, vbuf, sem)
    cp.start(); cp.wait()
    cp2 = pltpu.make_async_copy(vbuf, o_ref, sem)
    cp2.start(); cp2.wait()


def _k_refslice(x_ref, o_ref, b, sem):
    """r8_mosaic_rules.py:72-77 ``k_refslice`` (2a)."""
    cp = pltpu.make_async_copy(x_ref, b, sem)
    cp.start(); cp.wait()
    cp2 = pltpu.make_async_copy(b.at[pl.ds(0, 3), :],
                                o_ref.at[pl.ds(0, 3), :], sem)
    cp2.start(); cp2.wait()


def _k_valslice(x_ref, o_ref, b, sem):
    """r8_mosaic_rules.py:82-90 ``k_valslice`` (2b)."""
    cp = pltpu.make_async_copy(x_ref, b, sem)
    cp.start(); cp.wait()
    v = b[...]
    b[...] = jnp.concatenate([v[0:3, :] * 2.0, v[3:8, :]], axis=0)
    cp2 = pltpu.make_async_copy(b, o_ref, sem)
    cp2.start(); cp2.wait()


def _k_narrow(x_ref, o_ref, nb, wb, sem):
    """r8_mosaic_rules.py:94-99 ``k_narrow`` (3a)."""
    cp = pltpu.make_async_copy(x_ref.at[:, pl.ds(0, 3)], nb, sem)
    cp.start(); cp.wait()
    wb[...] = jnp.pad(nb[...], ((0, 0), (0, 125)))
    cp2 = pltpu.make_async_copy(wb, o_ref, sem)
    cp2.start(); cp2.wait()


def _k_transpose(x_ref, o_ref, b8, b4, sem):
    """r8_mosaic_rules.py:105-116 ``k_transpose`` (3b)."""
    cp = pltpu.make_async_copy(x_ref, b8, sem)
    cp.start(); cp.wait()
    v8 = b8[...]
    xi = v8[0:3, :].T
    mci = v8[3:4, :].T
    tile = xi * mci
    b4[...] = jnp.concatenate([tile.T, jnp.zeros((1, 128), jnp.float32)],
                              axis=0)
    cp2 = pltpu.make_async_copy(b4, o_ref, sem)
    cp2.start(); cp2.wait()


_F32 = jnp.float32
# Each label of r8_mosaic_rules.py's ``run`` calls with its body, scratch
# and output shape (:56-118), and the port's wrapper.
R8_BODIES = {
    "1a ANY scratch": (_k_any, [pl.ANY((2, 8, 128), _F32)], (8, 128),
                       probes.workspace_copy),
    "1b HBM scratch": (_k_any, [pltpu.MemorySpace.HBM((2, 8, 128), _F32)],
                       (8, 128), probes.workspace_copy),
    "1c VMEM scratch + ANY in/out": (_k_ws, [pltpu.VMEM((8, 128), _F32)],
                                     (8, 128), probes.staged_copy),
    "2a sublane ref slice": (_k_refslice, [pltpu.VMEM((8, 128), _F32)],
                             (8, 128), probes.ref_slice),
    "2b value row split": (_k_valslice, [pltpu.VMEM((8, 128), _F32)],
                           (8, 128), probes.value_slice),
    "3a narrow-lane scratch": (_k_narrow, [pltpu.VMEM((8, 3), _F32),
                                           pltpu.VMEM((8, 128), _F32)],
                               (8, 128), probes.narrow_copy),
    "3b narrow value transpose": (_k_transpose,
                                  [pltpu.VMEM((8, 128), _F32),
                                   pltpu.VMEM((4, 128), _F32)], (4, 128),
                                  probes.value_transpose),
}


def _run_body(kernel, scratch, out_shape, x):
    """r8_mosaic_rules.py:31-38, ``run``'s pallas_call, in interpret
    mode."""
    return np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        scratch_shapes=scratch + [pltpu.SemaphoreType.DMA],
        interpret=True,
    )(x))


@pytest.mark.parametrize("label", list(R8_BODIES))
def test_r8_probe_matches_jax_body(label):
    kernel, scratch, out_shape, wrapper = R8_BODIES[label]
    x = probes.r8_tile()
    want = _run_body(kernel, scratch, out_shape, jnp.asarray(x))
    got = wrapper(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == out_shape
    # Exact, NaN where the body leaves the output unwritten (2a's rows
    # 3-7, on both sides).
    assert np.array_equal(got, want, equal_nan=True)
    if label.startswith("2a"):
        assert np.array_equal(got[:3], x[:3])
        assert np.isnan(got[3:]).all() and np.isnan(want[3:]).all()


def test_r8_probe_4_is_the_copy_its_body_defines():
    """``k_remote`` (r8_mosaic_rules.py:121-126) copies x to device 0's
    output at P = 1; in interpret mode outside a mesh the remote copy
    raises, so the port's probe is held to out = x."""
    x = probes.r8_tile()
    got = probes.peer_copy(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), x)
    assert got.data_ptr() != torch.from_numpy(x).data_ptr()


def test_run_r8_on_the_cpu():
    """``run_r8``'s record: every probe of the script, in its order, OK
    and exact; the v5e expectations as the script records them."""
    lines = []
    rec = probes.run_r8("cpu", log=lines.append)
    assert rec["ok"]
    assert [p["label"] for p in rec["probes"]] == [
        *R8_BODIES, "4 remote DMA to self"]
    assert [p["v5e"] for p in rec["probes"]] == [
        "FAIL", "FAIL", "OK", "FAIL", "OK", "FAIL", "OK", "OK"]
    assert all(p["ok"] and p["exact"] for p in rec["probes"])
    assert all(" OK exact=True " in line for line in lines[1:])


def test_run_r8_reports_a_failed_probe(monkeypatch):
    """A probe that raises, or gives another array, makes the record not
    ok, and the script exits 1."""
    def broken(x):
        raise RuntimeError("launch refused")
    wrong = list(probes.R8_PROBES)
    wrong[2] = wrong[2][:2] + (broken, wrong[2][3])
    wrong[4] = wrong[4][:2] + (probes.staged_copy, wrong[4][3])
    monkeypatch.setattr(probes, "R8_PROBES", tuple(wrong))
    rec = probes.run_r8("cpu", log=lambda line: None)
    assert not rec["ok"]
    assert rec["probes"][2]["error"] == "RuntimeError: launch refused"
    assert rec["probes"][4]["ok"] and not rec["probes"][4]["exact"]
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import r8_mosaic_rules_torch
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    assert r8_mosaic_rules_torch.main(["--device", "cpu"]) == 1


@pytest.mark.parametrize("wrapper", [
    probes.workspace_copy, probes.staged_copy, probes.ref_slice,
    probes.value_slice, probes.narrow_copy, probes.value_transpose,
    probes.peer_copy])
def test_r8_refuses_other_tiles(wrapper):
    for x in (torch.zeros(8, 64), torch.zeros(8, 128, dtype=torch.float64),
              torch.zeros(128, 8).T, torch.zeros(8, 128, device="meta")):
        with pytest.raises(ValueError, match=r"\(8, 128\) float32"):
            wrapper(x)


@pytest.mark.parametrize("script", ["r3_platbug_torch.py",
                                    "r8_mosaic_rules_torch.py"])
def test_scripts_run_without_jax(script):
    """The scripts and the new modules import neither jax nor nbody_tpu:
    with both blocked, each script exits 0 on the CPU and prints its
    record last."""
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['nbody_tpu'] = None; "
            "import nbody_tpu_torch.ops.probes, nbody_tpu_torch.bench_suite; "
            f"sys.argv = [{script!r}, '--device', 'cpu']; "
            f"runpy.run_path('scripts/{script}', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert '"ok": true' in proc.stdout.strip().splitlines()[-1]
