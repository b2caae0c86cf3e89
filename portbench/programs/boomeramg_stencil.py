"""The system under test for a configuration with a stencil and an
``amg`` group: the operator made on the card from its stencil (kernel
K1), BoomerAMG's device setup on it (``setup_device``), and PCG
preconditioned by one AMG cycle (kernel K2 on the coarse levels)."""
from __future__ import annotations

import time

import torch

from portbench import roofline


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """What set-up made: `op`, `amg`, and the seconds of setup_device
    alone (host clock, ending in a synchronize) as `setup_s`."""

    def __init__(self, cfg: dict, dtype: torch.dtype, device: torch.device):
        from hypre_tpu_torch import Config, set_config
        from hypre_tpu_torch.ops.stencil import stencil_op
        from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG

        set_config(Config(real_dtype=dtype, device=device.type))
        self.device, self.dtype = device, dtype
        self.krylov = cfg["krylov"]
        grid = tuple(cfg["grid"])
        entries = [(tuple(d), v) for d, v in cfg["stencil"]]
        self.op = stencil_op(grid, entries, dtype=dtype)
        sync(device)
        t0 = time.perf_counter()
        self.amg = BoomerAMG(AmgConfig(**cfg["amg"])).setup_device(
            stencil=(grid, entries))
        sync(device)
        self.setup_s = time.perf_counter() - t0
        self.n = self.op.n_rows

    def precondition(self, r):
        return self.amg.precondition(r)

    def solve(self, b, M):
        """One PCG solve of A x = b from x0 = 0, ended by a synchronize;
        returns pcg's result (x, iters, relres)."""
        from hypre_tpu_torch.solvers import krylov

        res = krylov.pcg(self.op, b, M=M, tol=self.krylov["tol"],
                         max_iter=self.krylov["max_iter"])
        sync(self.device)
        return res

    def solved(self, res) -> bool:
        return bool(res.relres <= self.krylov["tol"])

    @staticmethod
    def counters() -> dict:
        """The program's launch counters of K1 and K2."""
        from hypre_tpu_torch.ops.spmv import csr_spmv
        from hypre_tpu_torch.ops.stencil import stencil_matvec

        return {"stencil_matvec": stencil_matvec.launches,
                "csr_spmv": csr_spmv.launches}

    @staticmethod
    def reset_counters() -> None:
        from hypre_tpu_torch.ops.spmv import csr_spmv
        from hypre_tpu_torch.ops.stencil import stencil_matvec

        stencil_matvec.launches = 0
        csr_spmv.launches = 0

    def served(self) -> list:
        """The operators the declared kernels serve in a solve: the fine
        stencil operator (K1) and every CSR operator of the hierarchy
        (K2), each with its shape facts and its bytes bound a launch."""
        served, seen = [], set()
        cands = [("A0", self.op)]
        for l, lvl in enumerate(self.amg.hierarchy.levels):
            cands += [(f"{nm}{l}", getattr(lvl, nm)) for nm in ("A", "P",
                                                                "R")]
        for key, o in cands:
            if o is None:
                continue
            # the solve's operator and level 0's are one stencil, two
            # objects
            ident = ((o.grid, o.entries, o.dtype)
                     if type(o).__name__ == "StencilOp" else id(o))
            if ident in seen:
                continue
            seen.add(ident)
            d = roofline.describe(o)
            if d is not None:
                served.append({"key": key, **d})
        return served


def build(cfg: dict, dtype: torch.dtype, device: torch.device) -> Program:
    return Program(cfg, dtype, device)
