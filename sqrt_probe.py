#!/usr/bin/env python3
"""Which f64 square roots are correctly rounded: torch's on the card,
torch's on the CPU, and core/ieee.py's sqrt_rn on both, each against
numpy's np.sqrt (IEEE 754, the host Chebyshev setup's).

    python3 sqrt_probe.py

Inputs: 10^6 uniform values in [0.5, 64), 10^6 doubles of random
exponent and mantissa, the 10^6 doubles just below 1^2 .. 10^6^2, and
|diag| of each level of the 32^3 7-pt device hierarchy (relax 16), the
values the device Chebyshev setup takes the root of.  Prints one JSON
line a set: for each square root (and for 1/sqrt and rsqrt) the count
of results that differ from numpy's, and the largest difference in ulps;
then nvidia-smi's name and power limit.  Needs one CUDA card.
"""
import json
import subprocess
import sys

import numpy as np
import torch

from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.core.ieee import sqrt_rn
from hypre_tpu_torch.setup import device_amg as dev
from hypre_tpu_torch.solvers import AmgConfig

LAPLACE_7PT = [((0, 0, 0), 6.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
               ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
               ((0, 0, -1), -1.0), ((0, 0, 1), -1.0)]


def parts(got: torch.Tensor, want: np.ndarray) -> dict:
    g = got.cpu().numpy()
    ulps = np.abs(g.view(np.int64) - want.view(np.int64))
    return {"differ": int((g != want).sum()), "max_ulps": int(ulps.max())}


def probe(name: str, d: np.ndarray) -> dict:
    cpu = torch.from_numpy(d)
    card = cpu.cuda()
    root, inv = np.sqrt(d), 1.0 / np.sqrt(d)
    return {"set": name, "n": int(d.size),
            "torch.sqrt card": parts(torch.sqrt(card), root),
            "torch.sqrt cpu": parts(torch.sqrt(cpu), root),
            "sqrt_rn card": parts(sqrt_rn(card), root),
            "sqrt_rn cpu": parts(sqrt_rn(cpu), root),
            "1/torch.sqrt card": parts(1.0 / torch.sqrt(card), inv),
            "1/torch.sqrt cpu": parts(1.0 / torch.sqrt(cpu), inv),
            "torch.rsqrt card": parts(torch.rsqrt(card), inv),
            "1/sqrt_rn card": parts(1.0 / sqrt_rn(card), inv),
            "1/sqrt_rn cpu": parts(1.0 / sqrt_rn(cpu), inv)}


def main() -> int:
    if not torch.cuda.is_available():
        print("sqrt_probe: no CUDA device is available", file=sys.stderr)
        return 2
    rng = np.random.default_rng(7)
    n = 10**6
    bits = (rng.integers(1, 0x7FE, n, dtype=np.int64) << 52) \
        | rng.integers(0, 1 << 52, n, dtype=np.int64)
    sets = [("uniform [0.5, 64)", rng.uniform(0.5, 64.0, n)),
            ("random bits", bits.view(np.float64)),
            ("below squares", np.nextafter(
                np.arange(1, n + 1, dtype=np.float64) ** 2, 0))]
    set_config(Config(real_dtype=torch.float64, device="cuda"))
    items = list(dev.iter_device_hierarchy(
        dev.dell_stencil((32, 32, 32), LAPLACE_7PT),
        AmgConfig(interp_type=6, relax_type=16)))
    levels = [it[0] for it in items[:-1]] + [items[-1]]
    sets.append(("|diag| of the 32^3 device hierarchy", np.concatenate(
        [dev.device_diagonal(A).abs().cpu().numpy() for A in levels])))
    for name, d in sets:
        print(json.dumps(probe(name, d)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
