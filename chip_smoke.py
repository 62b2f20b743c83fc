#!/usr/bin/env python3
"""Drive the PyTorch port's Hermes main path on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):

1. the device: name, count, and ``nvidia-smi``'s name and power limit;
2. build the CUDA wire kernels from ``src/repro_torch/kernels/csrc``;
3. each kernel at the lm100m x 4-pod leaf shapes (every leaf of the tree):
   held against its plain PyTorch version (pack/unpack exactly equal, the
   merges bitwise), then timed with CUDA events beside the plain version
   and its HBM-bytes bound;
4. one forced all-open ``hermes_merge`` at lm100m (int4, then none) against
   the plain merge association;
5. the main path, ``train_hermes`` at lm100m with 4 pods, int4, with the
   launch counters zeroed before and read after (then a short ``none`` run
   for the fp32 merge kernel), and an lmtiny run on the card against the
   same run on the CPU;
6. a ``kernels`` JSON line, the ``nvidia-smi`` line, and the result line.

It needs the repository's ``src/`` beside it and imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS = 67e12            # H100 SXM data sheet, fp32 outside tensor cores
SOURCE = "src/repro_torch/kernels/csrc/wire_kernels.cu"
REPLACES = {
    "pack_int4": "src/repro/kernels/pack.py:85",
    "unpack_int4": "src/repro/kernels/pack.py:104",
    "dequant_merge_packed": "src/repro/kernels/dequant_merge.py:202",
    "loss_weighted_update": "src/repro/kernels/loss_weighted_update.py:60",
}
PODS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.config import HermesConfig, OptimizerConfig
    from repro_torch.dist import hermes_sync, wire
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.dequant_merge import dequant_merge_packed_cuda
    from repro_torch.kernels.loss_weighted_update import (
        loss_weighted_update_cuda)
    from repro_torch.kernels.pack import pack_int4_cuda, unpack_int4_cuda
    from repro_torch.launch.train import _preset, train_hermes
    from repro_torch.models.lm import init_lm
    from repro_torch.utils.trees import tree_flatten, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[1] device {kind!r} count={count} nvidia-smi: {smi}")
    log(f"    torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    build.lib()
    log(f"[2] built {build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("    ptxas: " + line.strip())

    # ---- 3. every kernel at lm100m x 4 pods, against its plain version ---
    cfg = _preset("lm100m")
    w_global = init_lm(cfg, 0, dev)
    g_leaves, _ = tree_flatten(w_global)
    n_params = sum(x.numel() for x in g_leaves)
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, config says "
                             f"{cfg.param_count()}")
    gen = torch.Generator(device=dev).manual_seed(1)
    fmt = wire.get_format("int4")
    noise = wire.GeneratorNoise(1, dev)
    # the main path's inputs: the stacked push deltas, quantized and packed
    deltas = [1e-3 * torch.randn((PODS,) + tuple(g.shape), generator=gen,
                                 device=dev) for g in g_leaves]
    axes = [wire.block_axis(d.shape) for d in deltas]
    blocked = [i for i, (d, ax) in enumerate(zip(deltas, axes))
               if d.shape[ax] % wire.BLOCK == 0]
    q_in = [fmt._quantize(deltas[i], (0, i), noise)[0] for i in blocked]
    payloads = [fmt.encode(d, key=(0, i), noise=noise)
                for i, d in enumerate(deltas)]
    pods_f32 = [g[None] + d for g, d in zip(g_leaves, deltas)]
    del deltas
    wire_bytes = sum(wire.payload_nbytes(p) for p in payloads)
    log(f"    int4 wire: {wire_bytes:,} bytes for {PODS} pods "
        f"({wire_bytes / (PODS * n_params):.4f} B/parameter)")
    w2 = torch.tensor([1 / 3.1, 1 / 3.2, 1 / 3.0, 1 / 3.3], device=dev)
    w1 = torch.tensor(1 / 3.4, device=dev)
    denom = w1 + w2.sum()
    push = torch.tensor(True, device=dev)

    cases = {
        "pack_int4": (
            lambda: [pack_int4_cuda(q, axis=axes[i])
                     for q, i in zip(q_in, blocked)],
            lambda: [ref.pack_nibbles_ref(q, axis=axes[i])
                     for q, i in zip(q_in, blocked)],
            0),
        "unpack_int4": (
            lambda: [unpack_int4_cuda(payloads[i]["q_packed"], axis=axes[i])
                     for i in blocked],
            lambda: [ref.unpack_nibbles_ref(payloads[i]["q_packed"],
                                            axis=axes[i]) for i in blocked],
            0),
        "dequant_merge_packed": (
            lambda: [dequant_merge_packed_cuda(
                g, p["q_packed"], p["scales"], w2, denom, push, axis=ax)
                for g, p, ax in zip(g_leaves, payloads, axes)],
            lambda: [ref.dequant_merge_packed_ref(
                g, p["q_packed"], p["scales"], w2, denom, push, axis=ax)
                for g, p, ax in zip(g_leaves, payloads, axes)],
            2 + 3 * PODS),
        "loss_weighted_update": (
            lambda: [loss_weighted_update_cuda(g, p, w1, w2, denom, push)
                     for g, p in zip(g_leaves, pods_f32)],
            lambda: [ref.loss_weighted_update_ref(g, p, w1, w2, denom, push)
                     for g, p in zip(g_leaves, pods_f32)],
            2 + 2 * PODS),
    }
    inputs = {
        "pack_int4": q_in,
        "unpack_int4": [payloads[i]["q_packed"] for i in blocked],
        "dequant_merge_packed": g_leaves
        + [t for p in payloads for t in p.values()],
        "loss_weighted_update": g_leaves + pods_f32,
    }
    results = {}
    log(f"[3] kernels at {cfg.name} ({n_params:,} parameters) x {PODS} pods, "
        f"the whole tree per call")
    for name, (kern, plain, flops_per_out) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(float((a.to(torch.float32) - b.to(torch.float32))
                        .abs().max()) for a, b in zip(got, want))
        if not exact:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        moved = nbytes(inputs[name]) + nbytes(got)
        n_out = sum(t.numel() for t in got)
        bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
        ops_ms = 1e3 * n_out * flops_per_out / FP32_FLOPS
        del got, want
        ms = time_ms(torch, kern, reps=20)
        plain_ms = time_ms(torch, plain, reps=3, warmup=1)
        results[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }
        log(f"    {name:22s} equal=True  kernel {ms:8.3f} ms  plain "
            f"{plain_ms:8.3f} ms  bound {max(bytes_ms, ops_ms):.3f} ms "
            f"({moved / 1e9:.3f} GB)  {bytes_ms / ms:5.1%} of the bound")
    del q_in, payloads, pods_f32
    torch.cuda.empty_cache()

    # ---- 4. a forced all-open merge at lm100m ----------------------------
    log("[4] forced all-open hermes_merge at lm100m x 4 pods")
    pod_params = tree_map(
        lambda g: g[None] + 1e-3 * torch.randn(
            (PODS,) + tuple(g.shape), generator=gen, device=dev), w_global)
    gates = torch.ones(PODS, dtype=torch.bool, device=dev)
    losses = torch.tensor([3.1, 3.2, 3.0, 3.3], device=dev)
    L = torch.tensor(3.4, device=dev)
    for compression in ("int4", "none"):
        outs = {}
        for use_kernel in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, new_global, _, _ = hermes_sync.hermes_merge(
                pod_params, gates, losses, w_global, L,
                compression=compression, use_kernel=use_kernel,
                round_step=0, noise=noise)
            torch.cuda.synchronize()
            outs[use_kernel] = (new_global, 1e3 * (time.perf_counter() - t0))
        gap = max(float((a - b).abs().max()) for a, b in zip(
            tree_flatten(outs[True][0])[0], tree_flatten(outs[False][0])[0]))
        finite = all(bool(torch.isfinite(x).all())
                     for x in tree_flatten(outs[True][0])[0])
        # two fp32 associations of one sum over |w| <= 1, values ~0.1
        if not finite or gap > 1e-5:
            raise AssertionError(f"{compression} merge: finite={finite} "
                                 f"gap to the plain association {gap}")
        log(f"    {compression:4s} kernels {outs[True][1]:8.1f} ms  plain "
            f"association {outs[False][1]:8.1f} ms  max gap {gap:.3g}")
    del pod_params, outs
    torch.cuda.empty_cache()

    # ---- 5. the main path ------------------------------------------------
    opt = OptimizerConfig(name="adamw", lr=3e-4)
    for compression, steps in (("int4", 20), ("none", 8)):
        hcfg = HermesConfig(alpha=-1.3, beta=0.1, lam=2, eta=1.0,
                            compression=compression)
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        out = train_hermes(cfg, steps=steps, batch=8, seq=128, pods=PODS,
                           opt_cfg=opt, hcfg=hcfg, log_every=10, seed=0,
                           device=dev)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        finite = all(math.isfinite(x) for x in
                     [out["global_loss"]] + out["pod_losses"]
                     + [l for _, l, _ in out["history"]])
        log(f"[5] lm100m {compression}: {steps} steps, {out['rounds']} "
            f"rounds, {out['merges']} merges, global loss "
            f"{out['global_loss']:.4f}, {out['ms_per_step']:.1f} ms/step, "
            f"{out['ms_per_round']:.1f} ms/round, wall {wall:.1f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"launches {launches}")
        log(f"    gates per round {[g for _, _, g in out['history']]}")
        if not finite or out["merges"] < 1:
            raise AssertionError(f"{compression} main path: finite={finite} "
                                 f"merges={out['merges']}")
        needed = (("pack_int4", "unpack_int4", "dequant_merge_packed")
                  if compression == "int4" else ("loss_weighted_update",))
        for name in needed:
            if launches[name] < 1:
                raise AssertionError(f"main path never launched {name}")
            results[name]["launches"] = launches[name]

    # the same small run on the card (kernels) and on the CPU (plain
    # versions, fused association), with one noise source for both
    cpu_noise = wire.GeneratorNoise(0, torch.device("cpu"))
    small = {}
    for label, device, dispatch in (("card", dev, "auto"),
                                    ("cpu", torch.device("cpu"), "on")):
        small[label] = train_hermes(
            _preset("lmtiny"), steps=8, batch=4, seq=32, pods=3,
            opt_cfg=OptimizerConfig(name="adamw", lr=3e-3),
            hcfg=HermesConfig(alpha=-0.8, lam=2, kernel_dispatch=dispatch),
            log_every=10 ** 6, device=device, noise=cpu_noise)
    a, b = small["card"], small["cpu"]
    same_gates = [g for _, _, g in a["history"]] == \
        [g for _, _, g in b["history"]]
    rel = abs(a["global_loss"] - b["global_loss"]) / abs(b["global_loss"])
    log(f"    lmtiny card vs CPU: gates equal={same_gates}, merges "
        f"{a['merges']}/{b['merges']}, global loss rel gap {rel:.2e}")
    # The card's and the CPU's fp32 matmuls sum in other orders; over 8
    # AdamW steps at lr 3e-3 that ~1e-6 gap is amplified (Adam's update is
    # ~lr*sign(g) where g is near zero), to ~2e-4 of the loss on an H100.
    if not same_gates or a["merges"] != b["merges"] or rel > 1e-3:
        raise AssertionError("lmtiny on the card disagrees with the CPU run")

    # ---- 6. result lines -------------------------------------------------
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
