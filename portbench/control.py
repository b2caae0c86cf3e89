"""The readings that the limits of `correct` are set from, in one
process: the program as the configuration states it and its control,
the program's own float32 path (every stored operator and vector of the
solve phase in float32; the nearest precision below the configuration's
float64), each over many seeds with a short window at the cell's load.

    python3 -m portbench.control --workload out14.solve \
        --seeds 1 2 3 --seconds 4 --dtypes float64 float32

Prints one JSON line a seed and precision with every compared number.
The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time

import torch

from portbench import harness


def readings(spec, dtype, seeds, seconds, device) -> list:
    """The compared numbers of the program built once in `dtype`, over
    short windows at the cell's load, a seed each."""
    cfg, traffic = spec["config"], spec["traffic"]
    gen = harness.module("generators", traffic["kind"])
    checks = harness.module("checks", cfg["checks"])
    program = harness.build_program(cfg, device, dtype)
    out = []
    for seed in seeds:
        state = gen.start(program, traffic, seed, device, False)
        win = gen.window(state, seconds)
        t0 = time.perf_counter()
        detail = {}
        found = checks.compare(program, win, cfg, traffic, seed, device,
                               detail)
        out.append({"dtype": str(dtype).split(".")[-1], "seed": seed,
                    "attempted": win["attempted"],
                    "iters": sorted(set(win.get("iters", []))),
                    "check_s": time.perf_counter() - t0,
                    "device_setup_s": program.setup_s,
                    "values": {k: c["value"] for k, c in found.items()},
                    "detail": detail})
        print(json.dumps(out[-1]), flush=True)
        del state, win
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--dtypes", nargs="+", default=["float64", "float32"])
    ap.add_argument("--control-seeds", type=int, nargs="+",
                    help="seeds of the float32 control (default: the "
                    "first three of --seeds)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    for name in args.dtypes:
        seeds = args.seeds
        if name != spec["config"]["precision"]:
            seeds = args.control_seeds or args.seeds[:3]
        readings(spec, getattr(torch, name), seeds, args.seconds, device)
        torch.cuda.empty_cache() if device.type == "cuda" else None
    return 0


if __name__ == "__main__":
    sys.exit(main())
