#!/usr/bin/env python3
"""The int4 and int8 merges over the whole lm100m x 4-pod tree, for the
``repro_torch`` package under ``--src``, on an NVIDIA card:

    python tools/merge_probe.py [--src src] [--reps 20]

Each merge pass (one grouped launch where the package has the grouped
entry, else one call per leaf) is held bitwise to the plain version, then
timed three ways, as ``chip_smoke.py`` times it: the card's own time of a
pass (``device_ms``), the wall time of back-to-back passes (CUDA events,
so the host's issue of every launch counts) and the launches a pass.
Run it against two checkouts in one call (a parent commit unpacked into
a git-ignored directory, then this one, in turns) to compare their
kernels on one card.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PODS = 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    from chip_smoke import device_ms, time_ms
    if not torch.cuda.is_available():
        raise SystemExit("merge_probe: needs an NVIDIA card")
    from repro_torch.dist import wire
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import dequant_merge as dqm
    from repro_torch.launch.train import _preset
    from repro_torch.models.lm import init_lm
    from repro_torch.utils.trees import tree_flatten

    dev = torch.device("cuda", 0)
    build.build_all()
    g_leaves, _ = tree_flatten(init_lm(_preset("lm100m"), 0, dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    deltas = [1e-3 * torch.randn((PODS,) + tuple(g.shape), generator=gen,
                                 device=dev) for g in g_leaves]
    axes = [wire.block_axis(d.shape) for d in deltas]
    noise = wire.GeneratorNoise(1, dev)
    w2 = torch.tensor([1 / 3.1, 1 / 3.2, 1 / 3.0, 1 / 3.3], device=dev)
    denom = torch.tensor(1 / 3.4, device=dev) + w2.sum()
    push = torch.tensor(True, device=dev)
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"src": args.src, "device": smi}
    for fmt_name, kernel, key in (("int4", "dequant_merge_packed", "q_packed"),
                                  ("int8", "dequant_merge", "q")):
        fmt = wire.get_format(fmt_name)
        pays = [fmt.encode(d, key=(0, i), noise=noise)
                for i, d in enumerate(deltas)]
        leaves = [(g, p[key], p["scales"], ax)
                  for g, p, ax in zip(g_leaves, pays, axes)]
        group = getattr(dqm, f"{kernel}_group_cuda", None)
        single = getattr(dqm, f"{kernel}_cuda")
        plain = getattr(ref, f"{kernel}_ref")

        def one_pass():
            if group is not None:
                return group(leaves, w2, denom, push)
            return [single(g, q, s, w2, denom, push, axis=ax)
                    for g, q, s, ax in leaves]

        build.reset_launches()
        got = one_pass()
        launches = build.LAUNCHES[kernel]
        equal = all(torch.equal(a, plain(g, q, s, w2, denom, push, axis=ax))
                    for a, (g, q, s, ax) in zip(got, leaves))
        del got
        out[fmt_name] = {"equal": equal, "launches": launches,
                         "card_ms": device_ms(torch, one_pass, args.reps),
                         "wall_ms": time_ms(torch, one_pass, args.reps),
                         "grouped": group is not None}
        del pays, leaves
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
