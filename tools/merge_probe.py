#!/usr/bin/env python3
"""The merges over whole trees, for the ``repro_torch`` package under
``--src``, on an NVIDIA card:

    python tools/merge_probe.py [--src src] [--reps 20] [--only lwu]
        [--sub OLD NEW ...]

``int4`` and ``int8``: the int4 and int8 merges over the lm100m x 4-pod
tree.  ``lwu``: the loss-weighted update over the lm100m x 4-pod tree in
fp32 and over qwen3-8b's tree (its published widths, 1 of 36 layers) x 2
pods in bf16.  Each pass (one grouped launch where the package has the
grouped entry, else one call per leaf) is held bitwise to the plain
version, then timed three ways, as ``chip_smoke.py`` times it: the card's
own time of a pass (``device_ms``), the wall time of back-to-back passes
(CUDA events, so the host's issue of every launch counts) and the
launches a pass; ``bound_ms`` is the pass's bytes over 3.35 TB/s.
Run it against two checkouts in one call (a parent commit unpacked into
a git-ignored directory, then this one, in turns) to compare their
kernels on one card.  ``--sub OLD NEW`` (repeatable) first copies the
package to ``build/merge_probe/<digest>/src`` with ``OLD`` replaced by
``NEW`` in every source and module of ``repro_torch/kernels`` that holds
it (a variant of the kernels: ``--sub "kLwuSlots = 1;" "kLwuSlots = 2;"
--sub "= 1               # kLwuSlots" "= 2               # kLwuSlots"``
changes the constant on both sides).
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PODS = 4
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet


def variant(src: Path, subs) -> Path:
    """A copy of the package under ``src`` with ``subs`` applied to the
    kernels' sources and their Python modules (``repro_torch/kernels``)."""
    key = hashlib.sha1(json.dumps([str(src), subs]).encode()).hexdigest()
    dst = ROOT / "build" / "merge_probe" / key[:12] / "src"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    files = [f for f in (dst / "repro_torch" / "kernels").rglob("*")
             if f.suffix in (".cu", ".py")]
    for old, new in subs:
        hits = [f for f in files if old in f.read_text()]
        if not hits:
            raise SystemExit(f"merge_probe: {old!r} is in no kernel source")
        for f in hits:
            f.write_text(f.read_text().replace(old, new))
    return dst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="+", choices=("int4", "int8", "lwu"),
                    default=("int4", "int8", "lwu"))
    ap.add_argument("--sub", nargs=2, action="append", default=[],
                    metavar=("OLD", "NEW"))
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    if args.sub:
        src = variant(src, args.sub)
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch
    from chip_smoke import device_ms, nbytes, time_ms
    if not torch.cuda.is_available():
        raise SystemExit("merge_probe: needs an NVIDIA card")
    from repro_torch.dist import wire
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import dequant_merge as dqm
    from repro_torch.kernels import loss_weighted_update as lwu
    from repro_torch.launch.placed_audit import _config
    from repro_torch.launch.train import _preset
    from repro_torch.models.lm import init_lm
    from repro_torch.utils.trees import tree_flatten

    dev = torch.device("cuda", 0)
    build.build_all(["wire_kernels"])
    g_leaves, _ = tree_flatten(init_lm(_preset("lm100m"), 0, dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    deltas = [1e-3 * torch.randn((PODS,) + tuple(g.shape), generator=gen,
                                 device=dev) for g in g_leaves]
    axes = [wire.block_axis(d.shape) for d in deltas]
    noise = wire.GeneratorNoise(1, dev)
    w2 = torch.tensor([1 / 3.1, 1 / 3.2, 1 / 3.0, 1 / 3.3], device=dev)
    w1 = torch.tensor(1 / 3.4, device=dev)
    denom = w1 + w2.sum()
    push = torch.tensor(True, device=dev)
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"src": args.src, "subs": args.sub, "device": smi}

    def measure(kernel, one_pass, want, ins):
        build.reset_launches()
        got = one_pass()
        launches = build.LAUNCHES[kernel]
        equal = all(torch.equal(a, b) for a, b in zip(got, want()))
        moved = nbytes(ins) + nbytes(got)
        del got
        card = device_ms(torch, one_pass, args.reps)
        bound = 1e3 * moved / HBM_BYTES_PER_S
        return {"equal": equal, "launches": launches, "card_ms": card,
                "wall_ms": time_ms(torch, one_pass, args.reps),
                "bound_ms": bound, "share": bound / card, "bytes": moved}

    for fmt_name, kernel, key in (("int4", "dequant_merge_packed", "q_packed"),
                                  ("int8", "dequant_merge", "q")):
        if fmt_name not in args.only:
            continue
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

        out[fmt_name] = measure(
            kernel, one_pass,
            lambda: [plain(g, q, s, w2, denom, push, axis=ax)
                     for g, q, s, ax in leaves],
            g_leaves + [t for p in pays for t in p.values()])
        out[fmt_name]["grouped"] = group is not None
        del pays, leaves
        torch.cuda.empty_cache()
    if "lwu" in args.only:
        group = getattr(lwu, "loss_weighted_update_group_cuda", None)
        lm_pods = [g[None] + d for g, d in zip(g_leaves, deltas)]
        del deltas
        qg = tree_flatten(init_lm(_config({"preset": "qwen3-8b",
                                           "layers": 1}), 0, dev,
                                  draw_on=dev, dtype=torch.bfloat16))[0]
        qgen = torch.Generator(device=dev).manual_seed(16)
        qpods = [g[None] + 1e-3 * torch.randn(
            (2,) + tuple(g.shape), generator=qgen, device=dev,
            dtype=torch.bfloat16) for g in qg]
        cases = (("lwu lm100m fp32", g_leaves, lm_pods, w2),
                 ("lwu qwen3-8b bf16", qg, qpods,
                  torch.tensor([1 / 3.1, 1 / 3.2], device=dev)))
        for label, gs, pods, w in cases:
            pairs = list(zip(gs, pods))
            d = w1 + w.sum()

            def one_pass():
                if group is not None:
                    return group(pairs, w1, w, d, push)
                return [lwu.loss_weighted_update_cuda(g, p, w1, w, d, push)
                        for g, p in pairs]

            out[label] = measure(
                "loss_weighted_update", one_pass,
                lambda: [ref.loss_weighted_update_ref(g, p, w1, w, d, push)
                         for g, p in pairs], gs + pods)
            out[label]["grouped"] = group is not None
            del pairs
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
