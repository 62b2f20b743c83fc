"""Splice the baseline and optimized roofline tables into a markdown file
at its ``<!-- BASELINE_TABLE -->`` and ``<!-- OPT_TABLE -->`` markers (the
reference's ``roofline/insert_tables.py``, which writes its
``EXPERIMENTS.md``).

    PYTHONPATH=src python -m repro_torch.roofline.insert_tables PATH
"""
import argparse

from repro_torch.roofline.report import collect, to_markdown


def insert(path: str, dryrun_dir: str = "results/torch/dryrun",
           opt_dir: str = "results/torch/dryrun_opt") -> None:
    base = to_markdown(collect(dryrun_dir, "single"))
    try:
        opt = to_markdown(collect(opt_dir, "single"))
    except Exception as e:
        opt = f"(optimized sweep incomplete: {e})"
    with open(path) as f:
        text = f.read()
    text = text.replace("<!-- BASELINE_TABLE -->", base)
    text = text.replace("<!-- OPT_TABLE -->", opt)
    with open(path, "w") as f:
        f.write(text)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path")
    ap.add_argument("--dryrun-dir", default="results/torch/dryrun")
    ap.add_argument("--opt-dir", default="results/torch/dryrun_opt")
    args = ap.parse_args(argv)
    insert(args.path, args.dryrun_dir, args.opt_dir)
    print("tables inserted")


if __name__ == "__main__":
    main()
