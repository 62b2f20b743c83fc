#!/usr/bin/env python3
"""The int4 pack and unpack over the whole lm100m x 4-pod tree, for the
``repro_torch`` package under ``--src``, on an NVIDIA card:

    python tools/pack_probe.py [--src src] [--reps 20]

A pass is what the round's encode does after the quantizer: with the
grouped entry (``pack_int4_group_cuda``), one launch over all 14 leaves,
the two tail-only norm leaves included; without it, the per-leaf path
(each leaf's whole blocks by the kernel, its tail by the plain
``pack_tail_ref``, concatenated), and the kernel alone over the 12
whole-block leaves.  Unpack is the mirror.  Each pass is held bitwise to
the plain version, then timed as ``chip_smoke.py`` times it: the card's
own time (``device_ms``), the wall time of back-to-back passes (CUDA
events, the host's issue of every launch included) and the launches a
pass.  Beside them, two PyTorch calls that move the same bytes in the
same read:write ratios (an int8 add, a widening copy) as yardsticks of
what the card reaches on that pattern, and then ``encode_tree(...,
"int4")`` with its residual over the tree.
Run it against two checkouts in one call (a parent commit unpacked into a
git-ignored directory, then this one, in turns) to compare them on one
card.  Prints one JSON line.
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
        raise SystemExit("pack_probe: needs an NVIDIA card")
    from repro_torch.dist import wire
    from repro_torch.dist.compression import encode_tree
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import pack as pk
    from repro_torch.launch.train import _preset
    from repro_torch.models.lm import init_lm
    from repro_torch.utils.trees import tree_flatten

    dev = torch.device("cuda", 0)
    build.build_all()
    g_leaves, _ = tree_flatten(init_lm(_preset("lm100m"), 0, dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    deltas = [1e-3 * torch.randn((PODS,) + tuple(g.shape), generator=gen,
                                 device=dev) for g in g_leaves]
    del g_leaves
    axes = [wire.block_axis(d.shape) for d in deltas]
    noise = wire.GeneratorNoise(1, dev)
    fmt = wire.get_format("int4")
    nib = [(fmt._quantize(d, (0, i), noise)[0], d.shape[ax], ax)
           for i, (d, ax) in enumerate(zip(deltas, axes))]

    def pack_tail(t, rem, ax):
        return ref.pack_tail_ref(t.narrow(ax, 0, rem), axis=ax)

    def unpack_tail(t, rem, ax):
        return ref.unpack_tail_ref(t, rem, axis=ax)

    wires = [(p, d, ax) for p, (_, d, ax) in zip(per_leaf(
        torch, nib, lambda x, ax: ref.pack_nibbles_ref(x, axis=ax),
        pack_tail, 256), nib)]
    grouped = hasattr(pk, "pack_int4_group_cuda")

    def per_leaf_pack(leaves):
        return per_leaf(torch, leaves, lambda x, ax: pk.pack_int4_cuda(
            x.contiguous(), axis=ax), pack_tail, 256)

    def per_leaf_unpack(leaves):
        return per_leaf(torch, leaves, lambda x, ax: pk.unpack_int4_cuda(
            x.contiguous(), axis=ax), unpack_tail, 128)

    whole = [i for i, (_, d, _) in enumerate(nib) if d % 256 == 0]
    passes = {
        "pack": ((lambda: pk.pack_int4_group_cuda(nib)) if grouped
                 else (lambda: per_leaf_pack(nib)), "pack_int4",
                 [w for w, _, _ in wires]),
        "unpack": ((lambda: pk.unpack_int4_group_cuda(wires)) if grouped
                   else (lambda: per_leaf_unpack(wires)), "unpack_int4",
                   [q.narrow(ax, 0, d) for q, d, ax in nib]),
    }
    if not grouped:
        passes["pack_kernels_only"] = (
            lambda: [pk.pack_int4_cuda(nib[i][0], axis=nib[i][2])
                     for i in whole], "pack_int4",
            [wires[i][0] for i in whole])
        passes["unpack_kernels_only"] = (
            lambda: [pk.unpack_int4_cuda(wires[i][0], axis=wires[i][2])
                     for i in whole], "unpack_int4",
            [nib[i][0] for i in whole])
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"src": args.src, "device": smi, "grouped": grouped}
    for label, (one_pass, kernel, want) in passes.items():
        build.reset_launches()
        got = one_pass()
        launches = build.LAUNCHES[kernel]
        equal = len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want))
        del got
        out[label] = {"equal": equal, "launches": launches,
                      "card_ms": device_ms(torch, one_pass, args.reps),
                      "wall_ms": time_ms(torch, one_pass, args.reps)}
    # yardsticks of the same byte pattern, no PyTorch call computing the
    # function: an int8 add reads two wire-sized arrays and writes one
    # (pack's 2:1), a widening copy reads one and writes it twice as wide
    # (unpack's 1:2)
    flat = torch.cat([w.reshape(-1) for w, _, _ in wires])
    other = torch.roll(flat, 1)
    for label, fn in (("add_int8", lambda: torch.add(flat, other)),
                      ("widen_int16", lambda: flat.to(torch.int16))):
        out[label] = {"bytes": 3 * flat.numel(),
                      "card_ms": device_ms(torch, fn, args.reps)}
    del nib, wires, flat, other
    torch.cuda.empty_cache()

    def encode():
        return encode_tree(deltas, "int4", round_step=0, noise=noise)

    build.reset_launches()
    encode()
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    out["encode_tree"] = {"launches": launches,
                          "card_ms": device_ms(torch, encode, 5),
                          "wall_ms": time_ms(torch, encode, 5)}
    print(json.dumps(out))
    return 0


def per_leaf(torch, leaves, whole, tail, width):
    """Each leaf ``(x, d, axis)`` as the parent's wire path takes it:
    ``whole(x, axis)`` over its whole blocks (``width`` rows of ``x`` a
    block), ``tail(rest, rem, axis)`` over the rest, concatenated."""
    out = []
    for x, d, ax in leaves:
        nf, rem = divmod(d, 256)
        parts = [whole(x.narrow(ax, 0, nf * width), ax)] if nf else []
        if rem:
            parts.append(tail(x.narrow(ax, nf * width,
                                       x.shape[ax] - nf * width), rem, ax))
        out.append(parts[0] if len(parts) == 1 else torch.cat(parts, ax))
    return out


if __name__ == "__main__":
    sys.exit(main())
