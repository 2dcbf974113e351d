"""The roofline table of the port's dry-run cells, in markdown (the
counterpart of ``tools/make_roofline_table.py``), from the JSONs that
``python -m repro_torch.launch.dryrun --sweep`` writes:

    PYTHONPATH=src python tools_torch/make_roofline_table.py [pod1|pod2] \\
        [--dir results/dryrun_torch]

Per cell: the per-chip time bounds on one H100 SXM5 (compute, HBM bytes,
the analytic collectives), the one that dominates, the model FLOPs over
the FLOPs the trace counted, the roofline fraction, the per-chip peak
and whether it fits the card's memory.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def rows(out_dir: str, pod: str) -> list[dict]:
    found = []
    for path in sorted(glob.glob(os.path.join(out_dir, f"*_{pod}.json"))):
        with open(path) as f:
            found.append(json.load(f))
    return sorted(found, key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])))


def table(cells: list[dict]) -> str:
    lines = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
             "| model/counted flops | roofline frac | peak GiB / chip | fits |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in cells:
        if r.get("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | SKIP | — | — | — | "
                         f"n/a ({r['reason'][:48]}…) |")
            continue
        t, m = r["roofline"], r["memory"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.2f} | {t['memory_s']:.2f} | "
            f"{t['collective_s']:.2f} | {t['dominant']} | {t['model_over_counted_flops']:.3f} | "
            f"{t['roofline_fraction']:.4f} | {m['live_gib']:.1f} of {m['hbm_gib']:.1f} | "
            f"{'✓' if m['fits_hbm'] else '✗'} |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("pod", nargs="?", default="pod1", choices=["pod1", "pod2"])
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args()
    print(table(rows(args.dir, args.pod)))


if __name__ == "__main__":
    main()
