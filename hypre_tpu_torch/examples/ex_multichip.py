"""Distributed example: BoomerAMG-PCG over row shards.

Port of examples/ex_multichip.py.  The reference shards over a device
mesh; here the shards are stacked in one process (``StackedComm``, the
default: 8 shards) or spread over the ranks of a torch.distributed
group (pass a ``DistComm``).

    python -m hypre_tpu_torch.examples.ex_multichip

``dryrun_multichip(n_shards)`` runs the four solves of the repository's
``__graft_entry__.dryrun_multichip`` (:52-130) at 12^3: V-cycle PCG
(equal in iterations to the single-device PCG), W-cycle GMRES, the
distributed setup's PCG with the matrix-free stencil fine level (within
one iteration of the single-device device setup's), and returns their
numbers.
"""
import numpy as np

from hypre_tpu_torch.gen import laplacian
from hypre_tpu_torch.solvers.amg import AmgConfig
from hypre_tpu_torch.solvers.par_amg import ParBoomerAMG

ST7 = [((0, 0, 0), 6.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
       ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
       ((0, 0, -1), -1.0), ((0, 0, 1), -1.0)]


def main(n=24, comm=8):
    A = laplacian(n, n, n)
    pamg = ParBoomerAMG(comm, AmgConfig(interp_type=6)).setup(A)
    b = np.ones(A.shape[0])
    x, iters, relres = pamg.solve_pcg(b, tol=1e-8, max_iter=100)
    print(f"devices = {pamg.n_shards}")
    print(f"Iterations = {iters}")
    print(f"Final Relative Residual Norm = {relres:e}")
    return x, iters, relres


def dryrun_multichip(n_shards: int = 8, n: int = 12) -> dict:
    """The distributed AMG-PCG solve on n_shards stacked shards, checked
    as the reference's dryrun checks it; returns the counts."""
    from hypre_tpu_torch.ops import sparse_op_from_scipy
    from hypre_tpu_torch.solvers import BoomerAMG, pcg

    A = laplacian(n, n, n)
    b = np.ones(A.shape[0])
    cfg = AmgConfig()
    pamg = ParBoomerAMG(n_shards, cfg).setup(A)
    x, iters, relres = pamg.solve_pcg(b, tol=1e-8, max_iter=200)
    assert np.isfinite(x).all()
    assert relres <= 1e-8, f"did not converge: relres={relres:.3e}"
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-6
    ref = pcg(sparse_op_from_scipy(A), b, M=BoomerAMG(cfg).setup(A),
              tol=1e-8, max_iter=200)
    assert ref.iters == iters, (
        f"{n_shards} shards: {iters} iterations != single-device "
        f"{ref.iters}")

    pamg_w = ParBoomerAMG(n_shards, AmgConfig(cycle_type="W")).setup(A)
    _, it_w, rel_w = pamg_w.solve(b, method="gmres", tol=1e-8, max_iter=200)
    assert rel_w <= 1e-8

    cfg_d = AmgConfig(interp_type=6, relax_type=18)
    pamg_d = ParBoomerAMG(n_shards, cfg_d).setup_distributed(
        A, fine_stencil=((n, n, n), ST7))
    assert pamg_d.hierarchy.levels[0].stencil is not None
    xd, it_d, rel_d = pamg_d.solve_pcg(b, tol=1e-8, max_iter=200)
    assert rel_d <= 1e-8, f"distributed setup: relres {rel_d:.3e}"
    assert np.linalg.norm(A @ xd - b) / np.linalg.norm(b) < 1e-6
    dev_amg = BoomerAMG(cfg_d).setup_device(stencil=((n, n, n), ST7))
    ref_d = pcg(dev_amg.hierarchy.levels[0].A, b, M=dev_amg, tol=1e-8,
                max_iter=200)
    assert abs(ref_d.iters - it_d) <= 1, (
        f"distributed setup {it_d} iterations vs single-device device "
        f"setup {ref_d.iters}")
    out = {"n_shards": n_shards, "pcg": iters, "relres": relres,
           "single_pcg": ref.iters, "gmres_w": it_w, "dist_pcg": it_d,
           "device_setup_pcg": ref_d.iters, "levels": pamg.level_sizes,
           "dist_levels": pamg_d.level_sizes}
    print(f"dryrun_multichip({n_shards}): {iters} PCG iters "
          f"(== single-device), relres={relres:.3e}, W-cycle GMRES {it_w} "
          f"iters, distributed-setup PCG {it_d} iters (single-device "
          f"device setup {ref_d.iters}), levels={pamg.level_sizes}")
    return out


if __name__ == "__main__":
    main()
