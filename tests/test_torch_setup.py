"""The port's host setup builds hypre_tpu's hierarchy bit for bit.

Same matrix in, same CF splits, P, R and coarse A out, level by level,
with the OpenMP kernels on and off, for direct (3) and ext+i (6)
interpolation under PMIS and HMIS coarsening."""
import numpy as np
import pytest
import torch
from torch_port_helpers import assert_csr_equal, set_native

import hypre_tpu.gen as ref_gen
from hypre_tpu.setup import l1norms as ref_l1
from hypre_tpu.setup import strength as ref_strength
from hypre_tpu.setup import utils as ref_utils
from hypre_tpu.solvers import amg as ref_amg
import hypre_tpu_torch.gen as port_gen
from hypre_tpu_torch.setup import l1norms as port_l1
from hypre_tpu_torch.setup import strength as port_strength
from hypre_tpu_torch.setup import utils as port_utils
from hypre_tpu_torch.solvers import amg as port_amg

torch.set_num_threads(1)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("coarsen", ["pmis", "hmis"])
@pytest.mark.parametrize("interp", [6, 3])
@pytest.mark.parametrize("n", [16, 24])
def test_hierarchy_matches_reference(monkeypatch, n, interp, coarsen,
                                     native):
    set_native(monkeypatch, native)
    A = port_gen.laplacian(n, n, n)
    port = list(port_amg.iter_host_hierarchy(
        A, port_amg.AmgConfig(interp_type=interp, coarsen_type=coarsen)))
    ref = list(ref_amg.iter_host_hierarchy(
        ref_gen.laplacian(n, n, n),
        ref_amg.AmgConfig(interp_type=interp, coarsen_type=coarsen)))
    assert len(port) == len(ref) >= 3
    for (a, p, r, cf), (a2, p2, r2, cf2) in zip(port[:-1], ref[:-1]):
        np.testing.assert_array_equal(cf, cf2)
        for m, m2 in ((a, a2), (p, p2), (r, r2)):
            assert_csr_equal(m, m2)
    assert_csr_equal(port[-1], ref[-1])


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("gen", [
    ("laplacian", (13, 9, 7)), ("laplacian", (33, 33, 1)),
    ("laplacian_27pt", (9, 8, 7)), ("laplacian_9pt", (17, 11)),
    ("difconv", (12, 10, 8))])
def test_generators_match_reference(monkeypatch, gen, native):
    set_native(monkeypatch, native)
    name, shape = gen
    assert_csr_equal(getattr(port_gen, name)(*shape),
                     getattr(ref_gen, name)(*shape))


def test_pmis_hash_bit_for_bit_with_wraparound():
    ids = np.array([0, 1, 2, 12345, 2**31 + 7, 2**53 + 1, 2**62,
                    2**63 - 1], dtype=np.int64)
    for seed in (0, 2747, 2**40 + 3):
        a = port_utils.pmis_hash(ids, seed)
        b = ref_utils.pmis_hash(ids, seed)
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a.view(np.uint64), b.view(np.uint64))
        assert ((a >= 0) & (a < 1)).all()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_strength_and_l1_norms_match_reference(monkeypatch, native):
    set_native(monkeypatch, native)
    A = port_gen.difconv(10, 9, 8, ax=30.0, ay=-20.0)
    S, mask = port_strength.strength_matrix(A, 0.25, 0.9, return_mask=True)
    S2, mask2 = ref_strength.strength_matrix(A, 0.25, 0.9, return_mask=True)
    np.testing.assert_array_equal(mask, mask2)
    assert_csr_equal(S.astype(np.float64), S2.astype(np.float64))
    for option in (1, 4, 5):
        np.testing.assert_array_equal(port_l1.l1_norms(A, option),
                                      ref_l1.l1_norms(A, option))


def test_unported_options_raise():
    """Every option of AmgConfig builds now; only an interpolation type
    that the reference does not build either raises (amg.py:275)."""
    A = port_gen.laplacian(6, 6, 6)
    for kw in ({"relax_type": 16}, {"coarsen_type": "cljp"},
               {"interp_type": 0}, {"cycle_type": "W"},
               {"agg_num_levels": 1}, {"additive": 0}):
        assert len(list(port_amg.iter_host_hierarchy(
            A, port_amg.AmgConfig(**kw)))) >= 2
    for amg in (port_amg, ref_amg):
        with pytest.raises(ValueError, match="interp_type 2"):
            list(amg.iter_host_hierarchy(A, amg.AmgConfig(interp_type=2)))
