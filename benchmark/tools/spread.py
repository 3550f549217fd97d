"""Spreads of a cell's runs, for setting bounds.

    python3 benchmark/tools/spread.py RESULT_FILE [RESULT_FILE ...] --sets 6

Each file holds one run's standard output (its last line is the result).
The runs, in the order given, form sets of ``--sets`` runs; for each
end-to-end metric prints each set's median and its spread (the distance
between the first and third quartiles of `statistics.quantiles(values,
n=4)` over the median), the spread without each set's run farthest from
its median, the spread of all runs, and five times the widest set spread.
"""

from __future__ import annotations

import argparse
import json
import statistics


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values):
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("files", nargs="+")
    p.add_argument("--sets", type=int, default=6)
    a = p.parse_args(argv)
    runs = [json.loads(open(f).read().strip().splitlines()[-1]) for f in a.files]
    names = sorted({m for r in runs for m in r["metrics"]})
    for m in names:
        vals = [r["metrics"][m]["value"] for r in runs if m in r["metrics"]]
        sets = [vals[i:i + a.sets] for i in range(0, len(vals), a.sets)]
        per = [(statistics.median(s), spread(s), trimmed(s)) for s in sets if len(s) >= 3]
        print(json.dumps({"metric": m, "values": vals,
                          "sets": [{"median": md, "spread": sp, "trimmed": tr} for md, sp, tr in per],
                          "all_spread": spread(vals) if len(vals) >= 3 else None,
                          "five_x_widest": 5 * max(sp for _, sp, _ in per) if per else None}))
    print(json.dumps({"correct": [r["correct"] for r in runs]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
