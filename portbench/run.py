"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload out14.solve --seed 7 \
        --seconds 30 --trace 0

Untraced runs report the cell's end-to-end metrics, traced runs
(--trace 1) its per-layer metrics.  The last line of standard output is
one JSON object; the numbers compared with the reference are printed
last on standard error, each beside its limit, and under "checks" last
in that line.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(here, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))

    from portbench import harness

    spec = harness.cell_spec(args.workload)
    import torch

    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 2
    out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           T0, torch.device("cuda", 0))
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}, which it may not",
              file=sys.stderr)
        return 3
    print(f"portbench: {out['device']['kind']} ({harness.power_limit()}), "
          f"{out['attempted']} attempted; host {harness.host()}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
