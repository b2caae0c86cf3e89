"""MGR: multilevel multigrid reduction preconditioner.

Port of hypre_tpu/solvers/mgr.py (``MGR`` :67), the analog of hypre's
MGR (ref: src/parcsr_ls/par_mgr_setup.c:14, par_mgr.c cycle driver).
The user tags coarse dofs per reduction level (explicit masks, or by
function id with SetCpointsByBlock semantics); each level reduces onto
its coarse block:

  A_l = [A_ff  A_fc]     P_l = [W_p]   W_p = -D_ff^-1 A_fc  (interp 2)
        [A_cf  A_cc]           [ I ]         0              (interp 0)

  R_l = [W_r  I]         W_r = -A_cf D_ff^-1  (restrict 2) or 0 (0)

  A_{l+1} = R_l A_l P_l   (Galerkin on the reduction)

F-relaxation: "jacobi" (diagonal sweeps on A_ff, hypre's default),
"l1jacobi", or "amg" (an inner BoomerAMG V-cycle on A_ff).  The last
coarse grid is solved by one BoomerAMG V-cycle.  The setup is host
scipy, as the reference's; the blocks are stored in the solve formats
(K2 on CSR blocks) and the cycle runs on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from hypre_tpu_torch.solvers.amg import AmgConfig, BoomerAMG, amg_cycle


@dataclasses.dataclass
class MgrConfig:
    f_relax_type: str = "jacobi"      # jacobi | l1jacobi | amg
    f_relax_sweeps: int = 1
    interp_type: int = 2              # 0 injection, 2 diagonal
    restrict_type: int = 0            # 0 injection, 2 diagonal
    # per-level coarse selection by function ids (SetCpointsByBlock):
    # level l keeps dofs whose function id is in coarse_funcs[l]
    coarse_funcs: Optional[Sequence[Sequence[int]]] = None
    num_functions: int = 1
    amg: AmgConfig = dataclasses.field(
        default_factory=lambda: AmgConfig(interp_type=6))
    f_amg: AmgConfig = dataclasses.field(
        default_factory=lambda: AmgConfig(interp_type=3, max_levels=4))


@dataclasses.dataclass
class _MgrLevel:
    fj: torch.Tensor
    cj: torch.Tensor
    Aff: object
    Afc: object
    Acf: object
    dff_inv: torch.Tensor           # diagonal or l1 weights
    f_amg: Optional[BoomerAMG]      # inner AMG on A_ff (block relax)
    wp_diag: bool                   # interp 2?
    wr_diag: bool                   # restrict 2?


class MGR:
    def __init__(self, config: MgrConfig | None = None):
        self.config = config or MgrConfig()
        self.levels: list[_MgrLevel] = []
        self.amg_h: BoomerAMG | None = None
        self.level_sizes: list[int] = []

    def setup(self, A: sp.csr_matrix,
              c_mask: np.ndarray | Sequence[np.ndarray] | None = None,
              dof_func: np.ndarray | None = None) -> "MGR":
        """c_mask: one boolean mask (one reduction), a list of per-level
        masks (each over the previous level's coarse dofs), or None
        with cfg.coarse_funcs and num_functions set."""
        from hypre_tpu_torch.core.config import get_config, get_device
        from hypre_tpu_torch.ops.formats import sparse_op_from_scipy
        from hypre_tpu_torch.setup.l1norms import l1_norms

        cfg = self.config
        dtype, device = get_config().real_dtype, get_device()
        A = A.tocsr()
        self.level_sizes = [A.shape[0]]

        # the level plan as a list of masks
        if c_mask is None:
            if cfg.coarse_funcs is None:
                raise ValueError("need c_mask or coarse_funcs")
            if dof_func is None:
                dof_func = (np.arange(A.shape[0])
                            % cfg.num_functions).astype(np.int32)
            masks = []
            dof = dof_func
            for keep in cfg.coarse_funcs:
                m = np.isin(dof, np.asarray(list(keep)))
                masks.append(m)
                dof = dof[m]
        elif isinstance(c_mask, np.ndarray):
            masks = [np.asarray(c_mask, bool)]
        else:
            masks = [np.asarray(m, bool) for m in c_mask]

        def op(M):
            return sparse_op_from_scipy(M, prefer_dia=False)

        Al = A
        self.levels = []
        for m in masks:
            c_idx = np.flatnonzero(m)
            f_idx = np.flatnonzero(~m)
            Aff = Al[f_idx][:, f_idx].tocsr()
            Afc = Al[f_idx][:, c_idx].tocsr()
            Acf = Al[c_idx][:, f_idx].tocsr()
            Acc = Al[c_idx][:, c_idx].tocsr()

            if cfg.f_relax_type == "l1jacobi":
                dff = l1_norms(Aff, 1)
            else:
                dff = Aff.diagonal()
            dff = np.where(dff != 0, dff, 1.0)
            Dinv = sp.diags(1.0 / dff)
            Wp = (-Dinv @ Afc).tocsr() if cfg.interp_type == 2 else None
            Wr = (-Acf @ Dinv).tocsr() if cfg.restrict_type == 2 \
                else None
            # Galerkin A_H = [Wr I] A [Wp; I]
            AH = Acc
            if Wp is not None:
                AH = AH + Acf @ Wp
            if Wr is not None:
                AH = AH + Wr @ Afc
                if Wp is not None:
                    AH = AH + Wr @ (Aff @ Wp)
            AH = AH.tocsr()
            AH.sum_duplicates()

            f_amg = None
            if cfg.f_relax_type == "amg" and Aff.shape[0] > 0:
                f_amg = BoomerAMG(cfg.f_amg).setup(Aff)

            self.levels.append(_MgrLevel(
                fj=torch.as_tensor(f_idx, device=device),
                cj=torch.as_tensor(c_idx, device=device),
                Aff=op(Aff), Afc=op(Afc), Acf=op(Acf),
                dff_inv=torch.as_tensor(1.0 / dff, dtype=dtype,
                                        device=device),
                f_amg=f_amg,
                wp_diag=cfg.interp_type == 2,
                wr_diag=cfg.restrict_type == 2))
            self.level_sizes.append(AH.shape[0])
            Al = AH

        self.amg_h = BoomerAMG(cfg.amg).setup(Al)
        return self

    # -- cycle --------------------------------------------------------

    def _f_relax(self, lvl: _MgrLevel, rf, xf=None):
        from hypre_tpu_torch.ops.formats import matvec

        if lvl.f_amg is not None:
            r = rf if xf is None else rf - matvec(lvl.Aff, xf)
            z = amg_cycle(lvl.f_amg.hierarchy, r)
            return z if xf is None else xf + z
        for _ in range(self.config.f_relax_sweeps):
            if xf is None:
                xf = lvl.dff_inv * rf
            else:
                xf = xf + lvl.dff_inv * (rf - matvec(lvl.Aff, xf))
        return xf

    def _cycle_at(self, l: int, r):
        from hypre_tpu_torch.ops.formats import matvec

        if l == len(self.levels):
            return amg_cycle(self.amg_h.hierarchy, r)
        lvl = self.levels[l]
        rf = r[lvl.fj]
        rc = r[lvl.cj]
        xf = self._f_relax(lvl, rf)
        # restricted residual r_H = [Wr I] (r - A [xf; 0])
        rh = rc - matvec(lvl.Acf, xf)
        if lvl.wr_diag:
            # Wr (rf - Aff xf) with Wr = -Acf D^-1
            rf_res = rf - matvec(lvl.Aff, xf)
            rh = rh - matvec(lvl.Acf, lvl.dff_inv * rf_res)
        xc = self._cycle_at(l + 1, rh)
        # interpolate: xf += Wp xc
        if lvl.wp_diag:
            xf = xf - lvl.dff_inv * matvec(lvl.Afc, xc)
        # post F-relax on the updated residual
        xf = self._f_relax(lvl, rf - matvec(lvl.Afc, xc), xf)
        out = torch.zeros_like(r)
        out[lvl.fj] = xf
        out[lvl.cj] = xc
        return out

    def precondition(self, r):
        return self._cycle_at(0, r)
