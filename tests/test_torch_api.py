"""The port's API surface against hypre_tpu's, in f64 on the CPU:
the HYPRE_* shim (hypre_compat), iterative refinement (refine) and the
checkpoints (core.checkpoint).

* hypre_compat: every HYPRE_* name of the reference's shim exists in
  the port's; both flows of tests/test_hypre_compat.py (AMG-PCG through
  the handles; standalone AMG and AMG-GMRES) take the reference's
  iterations, with x within 1e-10 relative; a HYPRE_* name with no knob
  raises a KeyError (that is also an AttributeError, as the reference's
  module raises for a name it lacks).
* refine: the three cases of tests/test_refine.py, each beside the
  reference: the stencil apply bit for bit, refinement over an
  f32-rounded direct solve with the reference's outer count and x, and
  over an AMG-PCG inner solve with the reference's outer and inner
  counts.
* checkpoints: save_amg/load_amg round trips of hierarchies with DIA,
  dense, stencil, CSR levels and wavefront factors give the same PCG
  iterations and x bit for bit; a wrong FORMAT_VERSION raises, and so
  does a class outside ``hypre_tpu_torch.``.
"""
import json

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch
from torch_port_helpers import LAPLACE_7PT, rel_diff

from hypre_tpu import hypre_compat as ref_H
from hypre_tpu.gen import laplacian as ref_laplacian
from hypre_tpu.ops import sparse_op_from_scipy as ref_op
from hypre_tpu.solvers import AmgConfig as RefAmgConfig
from hypre_tpu.solvers import BoomerAMG as RefBoomerAMG
from hypre_tpu.solvers import pcg as ref_pcg
from hypre_tpu.solvers import refine as ref_refine
from hypre_tpu_torch import Config, hypre_compat as H, set_config
from hypre_tpu_torch.core import checkpoint
from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops import sparse_op_from_scipy
from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG, pcg, refine

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


def test_every_setter_name_is_kept():
    names = [n for n in dir(ref_H) if n.startswith("HYPRE_")]
    assert len(names) > 50
    missing = [n for n in names if not hasattr(H, n)]
    assert not missing


def test_unknown_setter_raises_key_error():
    with pytest.raises(KeyError):
        H.HYPRE_BoomerAMGSetSmoothType
    with pytest.raises(AttributeError):
        getattr(H, "HYPRE_BoomerAMGSetSmoothType")
    assert not hasattr(H, "HYPRE_AMSSetDimension")


def _amg_pcg_flow(mod, A, b):
    solver = mod.HYPRE_BoomerAMGCreate()
    mod.HYPRE_BoomerAMGSetStrongThreshold(solver, 0.25)
    mod.HYPRE_BoomerAMGSetRelaxType(solver, 18)
    mod.HYPRE_BoomerAMGSetInterpType(solver, 6)
    mod.HYPRE_BoomerAMGSetCoarsenType(solver, 8)     # PMIS
    mod.HYPRE_BoomerAMGSetMaxLevels(solver, 20)
    krylov = mod.HYPRE_ParCSRPCGCreate()
    mod.HYPRE_PCGSetTol(krylov, 1e-8)
    mod.HYPRE_PCGSetPrecond(krylov, precond_handle=solver)
    mod.HYPRE_ParCSRPCGSetup(krylov, A, b)
    x = mod.HYPRE_ParCSRPCGSolve(krylov, A, b)
    return (x, mod.HYPRE_PCGGetNumIterations(krylov),
            mod.HYPRE_PCGGetFinalRelativeResidualNorm(krylov))


def test_c_api_amg_pcg_flow():
    A = laplacian(12, 12, 12)
    b = np.ones(A.shape[0])
    x, it, rel = _amg_pcg_flow(H, A, b)
    x_ref, it_ref, _ = _amg_pcg_flow(ref_H, ref_laplacian(12, 12, 12), b)
    assert isinstance(x, np.ndarray)
    assert it == it_ref and 0 < it < 40
    assert rel < 1e-7
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7
    assert rel_diff(x, x_ref) <= 1e-10


def _standalone_and_gmres(mod, A, b):
    s = mod.HYPRE_BoomerAMGCreate()
    mod.HYPRE_BoomerAMGSetTol(s, 1e-8)
    mod.HYPRE_BoomerAMGSetMaxIter(s, 60)
    mod.HYPRE_BoomerAMGSetup(s, A)
    x_amg = mod.HYPRE_BoomerAMGSolve(s, A, b)
    g = mod.HYPRE_ParCSRGMRESCreate()
    mod.HYPRE_GMRESSetKDim(g, 20)
    mod.HYPRE_GMRESSetTol(g, 1e-8)
    mod.HYPRE_GMRESSetPrecond(g, precond_handle=s)
    x = mod.HYPRE_ParCSRGMRESSolve(g, A, b)
    return (x_amg, x, mod.HYPRE_GMRESGetNumIterations(g),
            mod.HYPRE_BoomerAMGGetNumIterations(s))


def test_c_api_standalone_amg_and_gmres():
    A = laplacian(24, 24)
    b = np.ones(A.shape[0])
    x_amg, x, it, amg_it = _standalone_and_gmres(H, A, b)
    ref = _standalone_and_gmres(ref_H, ref_laplacian(24, 24), b)
    assert np.linalg.norm(b - A @ x_amg) / np.linalg.norm(b) < 1e-7
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7
    assert rel_diff(x_amg, ref[0]) <= 1e-10
    assert rel_diff(x, ref[1]) <= 1e-10
    assert it == ref[2] and it < 30
    # the reference's departure, kept: no count is recorded
    assert amg_it == ref[3] == 0


def test_stencil_apply_matches_matrix_and_reference():
    A = laplacian(9, 7, 5)
    x = np.random.RandomState(0).randn(A.shape[0])
    y = refine.stencil_apply_f64((9, 7, 5), LAPLACE_7PT, x)
    np.testing.assert_allclose(y, A @ x, rtol=1e-12)
    np.testing.assert_array_equal(
        y, ref_refine.stencil_apply_f64((9, 7, 5), LAPLACE_7PT, x))


def test_ir_reaches_f64_tolerance_from_f32_inner():
    n = (12, 10, 8)
    A = laplacian(*n)
    lu = spla.splu(A.tocsc())
    b = np.random.RandomState(1).randn(A.shape[0])

    def inner(r32):
        dx = lu.solve(np.asarray(r32, np.float64))
        return torch.from_numpy(dx.astype(np.float32)), 1

    def apply(x):
        return refine.stencil_apply_f64(n, LAPLACE_7PT, x)

    out = refine.ir_solve(apply, b, inner, tol=1e-10)
    ref = ref_refine.ir_solve(
        apply, b, lambda r: (inner(r)[0].numpy(), 1), tol=1e-10)
    assert out["relres"] <= 1e-10 and out["outer_iters"] <= 4
    assert out["outer_iters"] == ref["outer_iters"]
    np.testing.assert_array_equal(out["x"], ref["x"])


def test_ir_with_amg_pcg_inner():
    n = (10, 10, 10)
    A = laplacian(*n)
    b = np.ones(A.shape[0])
    amg = BoomerAMG(AmgConfig()).setup(A)
    op = sparse_op_from_scipy(A)
    ref_amg = RefBoomerAMG(RefAmgConfig()).setup(A)
    rop = ref_op(A)

    def inner(r32):
        res = pcg(op, np.asarray(r32, np.float64), M=amg, tol=1e-6,
                  max_iter=50)
        return res.x.numpy().astype(np.float32), res.iters

    def ref_inner(r32):
        res = ref_pcg(rop, np.asarray(r32, np.float64), M=ref_amg,
                      tol=1e-6, max_iter=50)
        return np.asarray(res.x).astype(np.float32), int(res.iters)

    def apply(x):
        return refine.stencil_apply_f64(n, LAPLACE_7PT, x)

    out = refine.ir_solve(apply, b, inner, tol=1e-9)
    ref = ref_refine.ir_solve(apply, b, ref_inner, tol=1e-9)
    assert out["relres"] <= 1e-9
    assert np.linalg.norm(b - A @ out["x"]) / np.linalg.norm(b) <= 1.1e-9
    assert out["outer_iters"] == ref["outer_iters"]
    assert out["inner_iters_total"] == ref["inner_iters_total"]


CKPT_CASES = {
    # DIA level 0, dense coarse levels
    "dia": (lambda: laplacian(20, 20), {}, None),
    # a StencilOp level 0 (its torch dtype), CSR levels
    "stencil_csr": (lambda: laplacian(14, 14, 14), {"prefer_dia": False},
                    ((14, 14, 14), LAPLACE_7PT)),
    # exact GS past exact_gs_max: wavefront factors
    "wavefront": (lambda: laplacian(22, 22, 22), {"relax_type": 13}, None),
}


@pytest.mark.parametrize("case", sorted(CKPT_CASES))
def test_checkpoint_round_trip(case, tmp_path):
    make, kw, fine = CKPT_CASES[case]
    A = make()
    amg = BoomerAMG(AmgConfig(interp_type=6, **kw)).setup(
        A, fine_stencil=fine)
    p = str(tmp_path / "amg.npz")
    checkpoint.save_amg(amg, p)
    amg2 = checkpoint.load_amg(p)
    assert amg2.level_formats == amg.level_formats
    assert amg2.level_sizes == amg.level_sizes
    assert amg2.config == amg.config
    op = sparse_op_from_scipy(A)
    b = np.ones(A.shape[0])
    r1 = pcg(op, b, M=amg, tol=1e-8, max_iter=100)
    r2 = pcg(op, b, M=amg2, tol=1e-8, max_iter=100)
    assert r1.iters == r2.iters and r1.relres <= 1e-8
    assert torch.equal(r1.x, r2.x)


def _blob(path):
    with np.load(path, allow_pickle=False) as z:
        return json.loads(bytes(z["__json__"]).decode()), dict(z)


def _rewrite(path, blob, arrays):
    arrays = {k: v for k, v in arrays.items() if k != "__json__"}
    with open(path, "wb") as f:
        np.savez(f, __json__=np.frombuffer(json.dumps(blob).encode(),
                                           dtype=np.uint8), **arrays)


def test_checkpoint_refuses_a_wrong_version(tmp_path):
    p = str(tmp_path / "amg.npz")
    checkpoint.save_amg(BoomerAMG(AmgConfig()).setup(laplacian(8, 8)), p)
    blob, arrays = _blob(p)
    blob["version"] = checkpoint.FORMAT_VERSION + 1
    _rewrite(p, blob, arrays)
    with pytest.raises(ValueError, match="format"):
        checkpoint.load_amg(p)


@pytest.mark.parametrize("module", ["hypre_tpu.solvers.amg",
                                    "hypre_tpu_torchx.solvers.amg",
                                    "numpy"])
def test_checkpoint_refuses_foreign_classes(module, tmp_path):
    p = str(tmp_path / "cfg.npz")
    checkpoint.save_pytree(AmgConfig(), p)
    blob, arrays = _blob(p)
    node = blob["structure"]["tree"]
    assert node["__cls__"] == "hypre_tpu_torch.solvers.amg:AmgConfig"
    node["__cls__"] = f"{module}:AmgConfig"
    _rewrite(p, blob, arrays)
    with pytest.raises(ValueError, match="non-whitelisted"):
        checkpoint.load_pytree(p)
