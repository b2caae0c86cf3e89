"""Exact (l1-)Gauss-Seidel: the wavefront triangular solve and the
relax 3/8/13/14 V-cycle against hypre_tpu.

Wavefront depths are integers and must be equal.  A triangular solve
and a cycle are held to 1e-12 relative (f64): the port sums each
wavefront's entries in torch's order, the reference in XLA's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from torch_port_helpers import hierarchy_dicts, rand_csr, rel_diff, set_native

from hypre_tpu.gen import difconv as ref_difconv
from hypre_tpu.gen import laplacian as ref_laplacian
from hypre_tpu.ops import trisolve as ref_trisolve
from hypre_tpu.solvers import amg as ref_amg
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.convert import hierarchy_from_numpy
from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.ops import trisolve
from hypre_tpu_torch.solvers import amg as port_amg

torch.set_num_threads(1)
N = 12
EXACT_GS_MAX = 300     # so that 12^3 takes both the wavefront and dense branch


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


MATRICES = {
    "7pt": lambda: ref_laplacian(7, 6, 5).tocsr(),
    "difconv": lambda: ref_difconv(6, 5, 4, ax=1.1, ay=-0.7).tocsr(),
    "rand_spd": lambda: rand_csr(90, 90, 0.05, 3, spd=True),
}


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_wavefront_depths_match_reference(name, backward, native,
                                          monkeypatch):
    set_native(monkeypatch, native)
    A = MATRICES[name]()
    from hypre_tpu_torch.setup.utils import native_enabled

    assert native_enabled() == native
    want = ref_trisolve._wavefronts_numpy(A, backward)
    if native:
        from hypre_tpu.csrc import build as ref_native
        from hypre_tpu_torch.csrc import build as native_build

        np.testing.assert_array_equal(ref_native.gs_wavefronts(A, backward),
                                      want)
        got = native_build.gs_wavefronts(A, backward)
    else:
        got = trisolve._wavefronts_numpy(A, backward)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_trisolve_matches_reference(name, backward):
    A = MATRICES[name]()
    d = np.abs(A.diagonal()) + 0.5 * np.abs(A).sum(axis=1).A1
    ref = ref_trisolve.build_trisolve(A, d, backward=backward,
                                      real_dtype=np.float64)
    port = trisolve.build_trisolve(A, d, backward=backward,
                                   dtype=torch.float64, device="cpu")
    assert port.block_bounds == ref.block_bounds
    np.testing.assert_array_equal(port.perm.numpy(), np.asarray(ref.perm))
    r = np.random.default_rng(7).standard_normal(A.shape[0])
    got = port.solve(torch.from_numpy(r)).numpy()
    want = np.asarray(jax.jit(ref_trisolve.WavefrontTriSolve.solve)(
        ref, jnp.asarray(r)))
    assert rel_diff(got, want) <= 1e-12
    T = (sp.triu(A, 1) if backward else sp.tril(A, -1)) + sp.diags(d)
    want = spla.spsolve_triangular(T.tocsr(), r, lower=not backward)
    assert rel_diff(got, want) <= 1e-12


def _configs(relax):
    kw = dict(coarsen_type="hmis", interp_type=6, relax_type=relax,
              exact_gs_max=EXACT_GS_MAX)
    return ref_amg.AmgConfig(**kw), port_amg.AmgConfig(**kw)


@pytest.mark.parametrize("relax", [13, 14, 8, 3])
def test_exact_gs_cycle_matches_reference(relax):
    """The reference's hierarchy, carried across by convert (wavefront
    and dense factors alike), and the port's own setup both give the
    reference's V-cycle."""
    ref_cfg, port_cfg = _configs(relax)
    ref = ref_amg.BoomerAMG(ref_cfg).setup(ref_laplacian(N, N, N))
    h = ref.hierarchy
    assert h.levels[0].gs_wf_lo is not None
    assert any(lvl.gs_lo is not None for lvl in h.levels)
    f = np.random.default_rng(11).standard_normal(N ** 3)
    # jit: one compile of the whole cycle, not one per wavefront's op
    want = np.asarray(jax.jit(ref_amg.amg_cycle)(h, jnp.asarray(f)))

    carried = hierarchy_from_numpy(
        hierarchy_dicts(h), np.asarray(h.c_lu), np.asarray(h.c_piv),
        relax_weight=h.relax_weight, num_sweeps=h.num_sweeps,
        relax_type=h.relax_type)
    got = port_amg.amg_cycle(carried, torch.from_numpy(f)).numpy()
    assert rel_diff(got, want) <= 1e-12

    port = port_amg.BoomerAMG(port_cfg).setup(laplacian(N, N, N))
    assert port.level_sizes == ref.level_sizes
    got = port.precondition(torch.from_numpy(f)).numpy()
    assert rel_diff(got, want) <= 1e-12
