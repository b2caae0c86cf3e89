"""The port's IJ assembly, Matrix Market I/O and the ij driver's I/O and
LOBPCG flags against hypre_tpu's.

IJMatrix/IJVector: set/add assembly (a later set wins, adds after it
accumulate) gives the reference's CSR, and print_to writes the
reference's bytes.  mm_read/mm_write: every format the reference reads
and writes round-trips to the reference's matrices and bytes.

The driver's flags, each run through both drivers in a temporary
directory (the reference writes IJ.out.A and IJ.out.b into the working
directory): -printsystem writes the reference's files byte for byte;
-fromfile and -rhsfromfile read them back and take the reference's
iterations and, to rtol 1e-3, its residual; -lobpcg gives the
reference's LOBPCG iterations and eigenvalues to 1e-10 relative.  A
round trip through -printsystem and -fromfile/-rhsfromfile solves in
the generated problem's iterations."""
import io
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypre_tpu import ij as ref_ijmod
from hypre_tpu import mmio as ref_mmio
from hypre_tpu.drivers import ij as ref_ij
from hypre_tpu_torch import Config, ij as ijmod, mmio, set_config
from hypre_tpu_torch.drivers import ij

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


def _assembled(mod):
    m = mod.IJMatrix(0, 5, 0, 5)
    m.set_values([0, 1, 2, 5, 5], [0, 1, 3, 5, 0], [4.0, 2.0, -1.0, 3.0,
                                                    0.5])
    m.add_to_values([0, 0, 5], [0, 1, 5], [1.0, -2.0, 1.5])
    m.set_values([2], [3], [7.0])
    m.add_to_values([2, 2], [3, 3], [0.25, 0.25])
    v = mod.IJVector(0, 5)
    v.set_values([0, 3], [1.0, 2.0])
    v.add_to_values([3, 3, 5], [0.5, 0.5, -1.0])
    return m, v


def test_ij_assembly_matches_reference():
    (gm, gv), (wm, wv) = _assembled(ijmod), _assembled(ref_ijmod)
    assert (gm.assemble() != wm.assemble()).nnz == 0
    assert np.array_equal(gv.assemble(), wv.assemble())


def test_ij_print_writes_the_references_bytes(tmp_path):
    (gm, gv), (wm, wv) = _assembled(ijmod), _assembled(ref_ijmod)
    for obj, name in ((gm, "g.A"), (wm, "w.A"), (gv, "g.b"), (wv, "w.b")):
        obj.print_to(str(tmp_path / name))
    for kind in ("A", "b"):
        assert (tmp_path / f"g.{kind}").read_bytes() \
            == (tmp_path / f"w.{kind}").read_bytes()
    back = ijmod.IJMatrix.read_from(str(tmp_path / "w.A")).assemble()
    assert (back != wm.assemble()).nnz == 0


MM_CASES = ["general", "symmetric", "vector", "block"]


def _mm_object(case):
    rng = np.random.default_rng(4)
    if case in ("general", "symmetric"):
        A = sp.random(9, 9, density=0.3, random_state=5, format="csr")
        return (A + A.T).tocsr() if case == "symmetric" else A
    return rng.standard_normal(7) if case == "vector" \
        else rng.standard_normal((7, 3))


@pytest.mark.parametrize("case", MM_CASES)
def test_matrix_market_round_trip(tmp_path, case):
    obj = _mm_object(case)
    sym = case == "symmetric"
    mmio.mm_write(str(tmp_path / "g.mtx"), obj, symmetric=sym)
    ref_mmio.mm_write(str(tmp_path / "w.mtx"), obj, symmetric=sym)
    assert (tmp_path / "g.mtx").read_bytes() \
        == (tmp_path / "w.mtx").read_bytes()
    got = mmio.mm_read(str(tmp_path / "w.mtx"))
    want = ref_mmio.mm_read(str(tmp_path / "w.mtx"))
    if sp.issparse(want):
        assert (got != want).nnz == 0
    else:
        assert np.array_equal(got, want)


def test_matrix_market_pattern(tmp_path):
    path = tmp_path / "p.mtx"
    path.write_text("%%MatrixMarket matrix coordinate pattern symmetric\n"
                    "% a comment\n4 4 3\n1 1\n3 1\n4 2\n")
    assert (mmio.mm_read(str(path)) != ref_mmio.mm_read(str(path))).nnz == 0


def _tail(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) in (0, None)
    out = buf.getvalue()
    it = re.search(r"^Iterations = (\d+)", out, re.M)
    res = re.search(r"Final Relative Residual Norm = (\S+)", out)
    return out, (int(it.group(1)) if it else None,
                 float(res.group(1)) if res else None)


SYSTEM = ["-n", "9", "8", "7", "-solver", "2", "-rhsrand", "-exec_host"]


def _printed(tmp_path, monkeypatch):
    """Both drivers' -printsystem files, each in its own directory."""
    dirs = {}
    for tag, main in (("port", ij.main), ("ref", ref_ij.main)):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        dirs[tag] = (d, _tail(main, SYSTEM + ["-printsystem"])[1])
    return dirs


def test_printsystem_writes_the_references_files(tmp_path, monkeypatch):
    dirs = _printed(tmp_path, monkeypatch)
    for name in ("IJ.out.A", "IJ.out.b"):
        assert (dirs["port"][0] / name).read_bytes() \
            == (dirs["ref"][0] / name).read_bytes()
    assert dirs["port"][1][0] == dirs["ref"][1][0]


@pytest.mark.parametrize("flags", [["-fromfile", "A"],
                                   ["-fromfile", "A", "-rhsfromfile", "b"]])
def test_fromfile_matches_reference(tmp_path, monkeypatch, flags):
    dirs = _printed(tmp_path, monkeypatch)
    d = dirs["ref"][0]
    monkeypatch.chdir(d)
    argv = ["-solver", "1", "-exec_host"] + [
        str(d / f"IJ.out.{f}") if f in ("A", "b") else f for f in flags]
    got = _tail(ij.main, argv)[1]
    want = _tail(ref_ij.main, argv)[1]
    assert got[0] == want[0]
    assert abs(got[1] - want[1]) <= 1e-3 * want[1]
    if "-rhsfromfile" in flags:
        # b read back is the generated -rhsrand b: the generated run's
        # iterations
        gen = _tail(ij.main, SYSTEM[:4] + ["-solver", "1", "-rhsrand",
                                           "-exec_host"])[1]
        assert got[0] == gen[0]


def test_lobpcg_flag_matches_reference():
    argv = ["-n", "8", "8", "8", "-lobpcg", "-solver", "1", "-exec_host"]

    def parse(out):
        it = int(re.search(r"LOBPCG iterations = (\d+)", out).group(1))
        lam = [float(m.split()[0]) for m in re.findall(
            r"^ ?-?\d\.\d+e[+-]\d+  \S+$", out, re.M)]
        return it, np.array(lam)

    got, want = parse(_tail(ij.main, argv)[0]), parse(
        _tail(ref_ij.main, argv)[0])
    assert got[0] == want[0] and len(got[1]) == len(want[1]) == 4
    np.testing.assert_allclose(got[1], want[1], rtol=1e-10)
    lam_1 = 3 * 2 * (1 - np.cos(np.pi / 9))
    assert got[1][0] == pytest.approx(lam_1, rel=1e-6)


def test_unknown_solver_raises():
    with pytest.raises(ValueError, match="solver id 7"):
        ij.main(["-n", "4", "4", "4", "-solver", "7", "-exec_host"])
