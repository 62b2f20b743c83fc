"""Roofline report: the (arch x shape x mesh) table of the dry run's
counted cells (the reference's ``roofline/report.py``).

Reads the dry-run records, derives the three roofline terms and the
dominant one on the H100 (``analysis.HW_H100``), and writes a markdown
table and a JSON artifact.  The terms are counts over peak rates, not
times measured on a card.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dryrun-dir ...]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.launch.dryrun import OUTDIR, applicable_shapes, cell_name
from repro_torch.roofline.analysis import HW_H100, Hardware, analyze_cell

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def collect(dryrun_dir: str, mesh: str = "single",
            hw: Hardware = HW_H100) -> List[Dict]:
    rows = []
    for arch in ASSIGNED_ARCHS:
        app = dict(applicable_shapes(arch))
        for shape in SHAPE_ORDER:
            if shape not in app:
                rows.append({"arch": arch, "shape": shape, "mesh": mesh,
                             "status": "skip(full-attn)"})
                continue
            path = os.path.join(dryrun_dir,
                                cell_name(arch, shape, mesh) + ".json")
            if not os.path.exists(path):
                rows.append({"arch": arch, "shape": shape, "mesh": mesh,
                             "status": "missing"})
                continue
            rows.append(analyze_cell(path, hw))
    return rows


def to_markdown(rows: List[Dict]) -> str:
    out = ["| arch | shape | status | compute | memory | collective | "
           "dominant | useful ratio | MFU@bound | HBM GiB |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r.get('status')} |"
                       + " - |" * 7)
            continue
        t = r["roofline"]
        mem = r.get("memory", {})
        hbm = (mem.get("argument_size_in_bytes", 0)
               + mem.get("temp_size_in_bytes", 0)) / 2 ** 30
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {fmt_s(t['compute_s'])} | "
            f"{fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} | "
            f"**{t['dominant']}** | {t['useful_ratio']:.2f} | "
            f"{t['mfu_at_bound']*100:.1f}% | {hbm:.1f} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun-dir", default=OUTDIR)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default="results/torch/roofline.json")
    args = ap.parse_args(argv)
    rows = collect(args.dryrun_dir, args.mesh)
    ok = [r for r in rows if r.get("status") == "ok"]
    print(to_markdown(rows))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2, default=str)
    print(f"\n{len(ok)} analyzed; wrote {args.out}")


if __name__ == "__main__":
    main()
