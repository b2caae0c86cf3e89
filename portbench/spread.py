"""Median and spread of each metric over runs of one cell.

    python3 -m portbench.spread RESULT_FILE...

Each file holds the standard output of one run (its last line is the
result).  The spread is the distance between the first and the third
quartile (statistics.quantiles(values, n=4)) as a share of the median,
the measure the bounds in BENCHMARK.json are set from: about five
times the widest spread over the cells, never under 1%.
"""
import json
import statistics
import sys


def last_line(path: str) -> dict:
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    return json.loads(lines[-1])


def spread(values: list) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(paths) -> int:
    runs = [last_line(p) for p in paths]
    names = sorted({k for r in runs for k in r["metrics"]})
    for name in names:
        vals = [r["metrics"][name]["value"] for r in runs
                if name in r["metrics"]]
        row = {"metric": name, "n": len(vals),
               "median": statistics.median(vals), "min": min(vals),
               "max": max(vals)}
        if len(vals) >= 2:
            row["spread"] = spread(vals)
        print(json.dumps(row))
    print(json.dumps({"correct": [r["correct"] for r in runs],
                      "attempted": [r["attempted"] for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
