#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card: the Hermes
trainer, serving, the Level-A cluster simulator, the single trainer with
its checkpoints, and the paper's studies.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):

1. the device: name, count, and ``nvidia-smi``'s name and power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together);
3. each kernel at the lm100m x 4-pod leaf shapes (every leaf of the tree):
   held against its plain PyTorch version (pack and unpack, one grouped
   launch over all 14 leaves each, tails included, q and scales exactly
   equal, the merges (one grouped launch over the tree each) and the
   dequantize bitwise), then timed beside the plain version, its
   HBM-bytes bound and, where one exists, a single PyTorch call computing
   the same function: the card's time of a pass (CUDA events around a
   pass queued behind a spin of the card), the wall time of back-to-back
   passes (CUDA events) and the launches a pass;
4. one forced all-open ``hermes_merge`` at lm100m (int4, int8, then none)
   against the plain merge association, and at lm100m int8
   ``hermes_dispatch`` + ``hermes_commit`` against ``hermes_round`` on the
   same inputs (bitwise);
5. the main paths, each with the launch counters zeroed just before and
   read just after: ``train_hermes`` at lm100m with 4 pods, int4 sync;
   a short ``none`` run for the fp32 merge kernel; int8 with async rounds;
   and the flat ``compression.quantize_int8`` / ``dequantize_int8`` over
   every lm100m leaf; then lmtiny runs on the card (int4 sync, int8 async)
   against the same runs on the CPU;
6. the serving kernels against their plain versions at the serving path's
   shapes (flash attention at lm100m prefill and decode, a windowed
   case, and recurrentgemma-2b's head dim 256 with one KV head: windowed
   prefill over 2560 tokens and decode on the wrapped 2048-slot ring, in
   fp32 and bf16, each on the design the wrapper picks: the SIMT kernel
   for fp32 prefill, the wgmma kernel for bf16 prefill, the split-KV
   kernel and its combine for decode, which are also held and timed one
   at a time; each case's distance from an fp64 softmax printed beside
   the plain version's; WKV6 at rwkv6-3b prefill and decode; the RG-LRU
   at recurrentgemma-2b prefill and decode, bitwise), timed beside the
   plain version, the bound and, for attention, one
   ``scaled_dot_product_attention`` call: the card's own time per call
   (``device_ms``), with the wall time of back-to-back calls beside it;
7. ``serve`` at lm100m (batch 8, prompt 512, 64 new tokens), at rwkv6-3b
   (all 32 layers, bf16, batch 4, prompt 256, 32 new tokens) and at
   recurrentgemma-2b (all 26 layers, bf16, batch 4, prompt 2560, 32 new
   tokens: the prompt wraps the 2048-slot rings), each with the launch
   counters zeroed just before and read just after, its prefill and
   first decode logits compared with the plain versions on the same
   parameters, prompt and first token (held at lm100m, and at rwkv6-3b
   and recurrentgemma-2b in an fp32 run of the same model, beside the
   bf16 gap);
8. the static analyzer, ``repro_torch.launch.analyze --self-test`` on
   the card, with the launch counters zeroed just before and read just
   after: every ported kernel's launch spec and the pack constants lint
   clean, ``train_hermes``'s loop passes the host-sync guard, and each
   fixture raises its named class; the mis-tiled copy (the last TPU
   kernel, ``selftest_bad_tiles``) launches there and equals its plain
   version bit for bit.  Then the copy and ``x.clone()`` are timed on the
   card's own clock (``device_ms``, wall time beside) with the plain
   version, and the synchronising calls of one lm100m int4
   round, one int8 dispatch + commit and a short trainer run are counted
   under ``torch.cuda.set_sync_debug_mode("warn")``;
9. Level A, the paper's cluster simulator: (a) one SGD step of each CNN
   (mnist-cnn, cifar-alexnet) on the card against the CPU, loss,
   gradients and parameters; (b) the grouped pack and unpack on the int4
   push trees of both CNNs (nearly all short tails), bitwise, timed, one
   launch a pass (``pack_int4[mnist-cnn]`` and the others in the
   ``kernels`` line); (c) the quickstart's study, ``run_framework`` with
   int4 Hermes then BSP, and (d) cifar-alexnet Hermes at Table III's
   settings, each with the launch counters zeroed just before and read
   just after: one pack and one unpack launch a push, replicas on the
   card;
10. the trainer's whole entry point and the paper's studies: (a)
    ``train_single`` at lm100m (batch 8, seq 128) under deterministic
    algorithms, 3 steps into a checkpoint, the checkpoint restored on the
    card and held bit for bit against its file, 3 more steps resumed from
    it, the losses and the final checkpoint bitwise those of a straight
    6-step run, ms/step; (b) ``train_hermes`` at lm100m with 4 pods, int4,
    ``participation_rate=0.5`` under ``topk`` and then ``prob``
    admission: every admitted set a subset of the open one (``topk``: the
    budget, ``prob``: the round's draw), one pack, one unpack and one
    packed merge launch a merged round; (c) the studies of
    ``repro_torch.studies`` on the card at their own fast settings,
    ``comm_overhead.smoke`` and ``run``, ``table3_convergence.run("mnist")``,
    ``straggler.async_overlap`` (its own asserts) and ``gup_trace.run``,
    each run with the launch counters zeroed just before and read just
    after (one pack and one unpack launch an int4 push, none for the
    other frameworks), each study's result a JSON line;
11. a ``kernels`` JSON line, the ``nvidia-smi`` line, and the result line.

It needs the repository's ``src/`` beside it and imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
# dense peak operation rates of one H100 SXM by operand type (NVIDIA's data
# sheet; fp32 outside the tensor cores, TF32 stays off): a kernel's
# operation bound takes the fastest type among its inputs
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
            "int8": 1979e12}
EPS32 = 2.0 ** -23            # fp32 machine epsilon
WIRE_SOURCE = "src/repro_torch/kernels/csrc/wire_kernels.cu"
MODEL_SOURCE = "src/repro_torch/kernels/csrc/model_kernels.cu"
ATTENTION_SOURCE = "src/repro_torch/kernels/csrc/attention_kernels.cu"
FIXTURE_SOURCE = "src/repro_torch/kernels/csrc/fixture_kernels.cu"
REPLACES = {
    "pack_int4": "src/repro/kernels/pack.py:85",
    "unpack_int4": "src/repro/kernels/pack.py:104",
    "dequant_merge_packed": "src/repro/kernels/dequant_merge.py:202",
    "loss_weighted_update": "src/repro/kernels/loss_weighted_update.py:60",
    "dequant_merge": "src/repro/kernels/dequant_merge.py:109",
    "quantize_int8": "src/repro/kernels/quantize.py:47",
    "dequantize_int8": "src/repro/kernels/quantize.py:67",
    "flash_attention": "src/repro/kernels/flash_attention.py:106",
    "flash_simt": "src/repro/kernels/flash_attention.py:106",
    "flash_decode": "src/repro/kernels/flash_attention.py:106",
    "flash_decode_combine": "src/repro/kernels/flash_attention.py:106",
    "flash_prefill": "src/repro/kernels/flash_attention.py:106",
    "wkv6": "src/repro/kernels/rwkv6_scan.py:99",
    "rglru": "src/repro/kernels/rglru_scan.py:71",
    "tile_copy": "src/repro/launch/analyze.py:499",
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


def device_ms(torch, fn, reps: int = 10) -> float:
    """Mean card time per call of ``fn()``: each call is queued behind a
    spin of the card (``torch.cuda._sleep``) at least three times as long
    as the host takes to issue it, so every launch of the call is waiting
    on the card before the card reaches it, and the CUDA events around the
    call time the card alone, not the host's issue rate (what
    :func:`time_ms` may find).  The profiler misses some launches of the
    port's libraries (ROADMAP, queue 3), so it is not used here."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    # the spin's cycles per ms, measured: clocks vary with the power limit
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / start.elapsed_time(end)
    spin = int(cycles_per_ms * max(2.0, 3 * issue_ms))
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops, moved, dtypes):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of the fastest input type."""
    peak = max(PEAK_OPS[str(dt).removeprefix("torch.")] for dt in dtypes)
    bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / peak
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def kernel_entry(name, err, ms, plain_ms, flops, moved, dtypes, library_ms):
    """One ``kernels`` JSON entry (its ``launches`` filled in later)."""
    bound_ms, bound_by = bound(flops, moved, dtypes)
    return {"name": name, "route": "cuda", "source": MODEL_SOURCE,
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def attention_fp64(torch, q, k, v, qpos, kvpos, window):
    """The contract's causal attention evaluated in fp64 (the yardstick
    both the kernel's and the plain version's distance is printed from)."""
    from repro_torch.kernels.flash_attention import visible
    B, Sq, H, D = q.shape
    K = k.shape[2]
    sc = torch.einsum("bqkgd,bskd->bkgqs",
                      q.double().reshape(B, Sq, K, H // K, D),
                      k.double()) * D ** -0.5
    sc = sc.masked_fill(~visible(qpos, kvpos, causal=True, window=window),
                        -torch.inf)
    return torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(sc, -1),
                        v.double()).reshape(B, Sq, H, D)


def decode_kernels(torch, results, q, k, v, qpos, kvpos, window, want,
                   flops) -> None:
    """The two decode kernels one at a time at recurrentgemma-2b's decode
    shape: the split kernel's partials, combined in plain PyTorch, held to
    the plain attention; the combine kernel held to its plain version on
    the same partials; each timed beside its plain version and its bound
    (no single PyTorch call computes either half)."""
    from repro_torch.kernels.flash_attention import (
        decode_combine, decode_combine_plain, decode_split,
        decode_split_plain)
    D = q.shape[-1]
    kw = dict(causal=True, window=window, scale=D ** -0.5)
    part_ml, part_acc = decode_split(q, k, v, qpos, kvpos, **kw)
    via_plain = decode_combine_plain(part_ml, part_acc, q.dtype)
    got = decode_combine(part_ml, part_acc, q.dtype)
    torch.cuda.synchronize()
    # the split: its partials, combined in fp32 and rounded, against the
    # plain attention (the check of phase 6 above); the combine: fp32 sums
    # over the splits in another order, then both round to bf16
    for label, have, ref in (("flash_decode", via_plain, want),
                             ("flash_decode_combine", got, via_plain)):
        gap = (have.float() - ref.float()).abs()
        if bool((gap > 2e-5 + 2 ** -7 * ref.float().abs()).any()):
            raise AssertionError(f"{label}: max abs err {float(gap.max())} "
                                 f"against its plain version")
    split_err = float((via_plain.float() - want.float()).abs().max())
    comb_err = float((got.float() - via_plain.float()).abs().max())
    scratch = (part_ml.numel() + part_acc.numel()) * 4
    split_moved = (q.numel() + k.numel() + v.numel()) * q.element_size() \
        + (qpos.numel() + kvpos.numel()) * 4 + scratch
    split_ms = time_ms(torch, lambda: decode_split(q, k, v, qpos, kvpos,
                                                   **kw), reps=20)
    split_plain_ms = time_ms(torch, lambda: decode_split_plain(
        q, k, v, qpos, kvpos, **kw), reps=5, warmup=1)
    comb_moved = scratch + got.numel() * got.element_size()
    comb_ms = time_ms(torch, lambda: decode_combine(part_ml, part_acc,
                                                    q.dtype), reps=20)
    comb_plain_ms = time_ms(torch, lambda: decode_combine_plain(
        part_ml, part_acc, q.dtype), reps=5, warmup=1)
    split_dev = device_ms(torch, lambda: decode_split(q, k, v, qpos, kvpos,
                                                      **kw))
    comb_dev = device_ms(torch, lambda: decode_combine(part_ml, part_acc,
                                                       q.dtype))
    splits = part_acc.shape[3]
    results["flash_decode"] = kernel_entry(
        "flash_decode", split_err, split_dev, split_plain_ms, flops,
        split_moved, (q.dtype,), None)
    results["flash_decode_combine"] = kernel_entry(
        "flash_decode_combine", comb_err, comb_dev, comb_plain_ms,
        3 * part_acc.numel(), comb_moved, (torch.float32,), None)
    for name, err, ms, plain_ms, dev_ms in (
            ("flash_decode", split_err, split_ms, split_plain_ms, split_dev),
            ("flash_decode_combine", comb_err, comb_ms, comb_plain_ms,
             comb_dev)):
        entry = results[name]
        entry["wall_ms"] = ms
        log(f"      {name:22s} ({splits} splits) err {err:.2e}  kernel "
            f"{dev_ms:8.4f} ms (wall {ms:.4f})  plain "
            f"{plain_ms:8.4f} ms  bound "
            f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})  "
            f"{entry['bound_ms'] / dev_ms:6.1%} of the bound")


def serving_kernels(torch, dev, results) -> None:
    """Phase 6: flash attention, WKV6 and the RG-LRU at the serving path's
    shapes, against their plain versions, timed."""
    from repro_torch.kernels.flash_attention import (
        design, flash_attention_cuda, flash_attention_plain, visible)
    from repro_torch.kernels.rglru_scan import grid as rglru_grid
    from repro_torch.kernels.rglru_scan import rglru_cuda, rglru_plain
    from repro_torch.kernels.rglru_scan import (
        vector_path as rglru_vector_path)
    from repro_torch.kernels.rwkv6_scan import plan as wkv6_plan
    from repro_torch.kernels.rwkv6_scan import wkv6_cuda, wkv6_plain
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    i32 = dict(dtype=torch.int32, device=dev)

    def linear(skv, written):
        kvpos = torch.arange(skv, **i32)
        kvpos[written:] = -1
        return kvpos

    # recurrentgemma-2b decode at position 2560 after a 2560-token prefill:
    # the 2048-slot ring holds positions 2048-2559 in slots 0-511 and
    # 512-2047 in slots 512-2047, out of order, as the prefill stores them
    ring = torch.cat([torch.arange(2048, 2560, **i32),
                      torch.arange(512, 2048, **i32)])
    f32, bf16 = torch.float32, torch.bfloat16
    log("[6] serving kernels against their plain versions")
    # (label, B, Sq, H, K, D, first query position, KV positions, window,
    #  dtype): lm100m prefill into the 577-slot cache of prompt 512 + 64
    # new tokens + 1, decode at positions 512 and 575, and a windowed case
    # at a small size; recurrentgemma-2b (MQA, 10 heads of 256, window
    # 2048) prefill over 2560 tokens and decode on the wrapped ring, in
    # fp32 and in bf16, the path's dtype.  Each runs the design
    # flash_attention_cuda picks (printed): the SIMT kernel for fp32
    # prefill, the wgmma kernel for bf16 prefill, the split-KV kernel and
    # its combine for decode.
    cases = [("lm100m prefill", 8, 512, 12, 4, 64, 0, linear(577, 512), 0,
              f32),
             ("lm100m decode@512", 8, 1, 12, 4, 64, 512, linear(577, 513), 0,
              f32),
             ("lm100m decode@575", 8, 1, 12, 4, 64, 575, linear(577, 576), 0,
              f32),
             ("window 16", 2, 100, 6, 2, 64, 0, linear(100, 100), 16, f32)]
    for dt, name in ((f32, "fp32"), (bf16, "bf16")):
        cases += [(f"rg prefill {name}", 4, 2560, 10, 1, 256, 0,
                   torch.arange(2560, **i32), 2048, dt),
                  (f"rg decode@2560 {name}", 4, 1, 10, 1, 256, 2560, ring,
                   2048, dt)]
    timed = {}
    worst = 0.0
    for label, B, Sq, H, K, D, q0, kvpos, window, dt in cases:
        Skv = kvpos.numel()
        q, k, v = (randn(B, Sq, H, D, dtype=dt), randn(B, Skv, K, D, dtype=dt),
                   randn(B, Skv, K, D, dtype=dt))
        qpos = torch.arange(q0, q0 + Sq, **i32)
        kw = dict(causal=True, window=window)
        kind = design(Sq, D, dt)
        got = flash_attention_cuda(q, k, v, qpos, kvpos, **kw)
        want = flash_attention_plain(q, k, v, qpos, kvpos, **kw)
        torch.cuda.synchronize()
        gap = (got.float() - want.float()).abs()
        err = float(gap.max())
        # fp32 on both sides: the softmax sums over <= 2048 keys in another
        # order and the kernel rescales once per 64-key tile; outputs are
        # means of N(0, 1) values, so 2e-5 absolute is ~100 fp32 ulps.
        # bf16: both round such an fp32 result to bf16, so they may sit
        # one bf16 ulp (at most 2^-7 of the value) apart
        tol = 2e-5 + (2 ** -7 * want.float().abs() if dt == bf16 else 0)
        if not bool(torch.isfinite(got).all()) or bool((gap > tol).any()):
            raise AssertionError(f"flash_attention {label}: max abs err "
                                 f"{err} against its plain version")
        if dt == f32:
            worst = max(worst, err)
        exact = attention_fp64(torch, q, k, v, qpos, kvpos, window)
        err64 = float((got.double() - exact).abs().max())
        plain64 = float((want.double() - exact).abs().max())
        del exact
        pairs = int(visible(qpos, kvpos, causal=True, window=window).sum())
        flops = 4 * D * pairs * B * H
        moved = (q.numel() + k.numel() + v.numel() + got.numel()) \
            * q.element_size() + (Sq + Skv) * 4
        ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, qpos,
                                                         kvpos, **kw),
                     reps=20)
        plain_ms = time_ms(torch, lambda: flash_attention_plain(
            q, k, v, qpos, kvpos, **kw), reps=5, warmup=1)
        # one library call for the same function: SDPA with the boolean
        # mask of the positions (timed only; the port never calls it)
        mask = visible(qpos, kvpos, causal=True, window=window)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
        lib_err = float((lib.transpose(1, 2).float() - want.float())
                        .abs().max())
        lib_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                             enable_gqa=True), reps=20)
        # ms and library_ms are the card's own time per call (device_ms);
        # a decode call's wall time is set by the host's issue of it, and
        # is kept beside them
        dev_ms = device_ms(torch, lambda: flash_attention_cuda(
            q, k, v, qpos, kvpos, **kw))
        lib_dev_ms = device_ms(torch, lambda: sdpa(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        entry = kernel_entry("flash_attention", err, dev_ms, plain_ms, flops,
                             moved, (dt,), lib_dev_ms)
        entry.update(design=kind, wall_ms=ms, library_wall_ms=lib_ms)
        timed[label] = entry
        log(f"    flash {label:20s} [{kind}] err {err:.2e}  kernel "
            f"{dev_ms:8.4f} ms (wall {ms:.4f})  plain {plain_ms:8.4f} ms  "
            f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}; "
            f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB, {pairs:,} "
            f"visible pairs per head)  {entry['bound_ms'] / dev_ms:6.1%} of "
            f"the bound  SDPA {lib_dev_ms:.4f} ms (wall {lib_ms:.4f}; err "
            f"{lib_err:.1e})  from fp64: kernel {err64:.3g}, plain "
            f"{plain64:.3g}")
        if label == "rg decode@2560 bf16":
            decode_kernels(torch, results, q, k, v, qpos, kvpos, window,
                           want, flops)
        del q, k, v, got, want, gap, mask, qt, kt, vt, lib
    torch.cuda.empty_cache()
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    flash_keys = keys + ("wall_ms", "library_wall_ms")
    # the wrapper's entry: lm100m prefill (the SIMT kernel) on top, and the
    # designs at the serving shapes beneath it
    main_entry = dict(timed["lm100m prefill"])
    main_entry["max_abs_err"] = worst
    main_entry["decode"] = {key: timed["lm100m decode@512"][key]
                            for key in flash_keys}
    d256 = {"prefill": "rg prefill bf16", "decode": "rg decode@2560 bf16",
            "prefill_fp32": "rg prefill fp32",
            "decode_fp32": "rg decode@2560 fp32"}
    main_entry["d256"] = {sub: {key: timed[label][key] for key in flash_keys}
                          for sub, label in d256.items()}
    results["flash_attention"] = main_entry
    simt = dict(timed["lm100m prefill"], name="flash_simt")
    simt["d256_fp32"] = {key: timed["rg prefill fp32"][key]
                         for key in flash_keys}
    results["flash_simt"] = simt
    results["flash_prefill"] = dict(timed["rg prefill bf16"],
                                    name="flash_prefill",
                                    source=ATTENTION_SOURCE)

    # WKV6 at rwkv6-3b: B 4, 40 heads of 64, bf16 r/k/v, fp32 log_w in the
    # model's regime (log_w = -exp(decay), decay ~ 0)
    timed = {}
    worst = 0.0
    for label, T, state in (("rwkv6-3b prefill", 256, False),
                            ("rwkv6-3b decode", 1, True)):
        B, H, D = 4, 40, 64
        r, k, v = (randn(B, T, H, D, dtype=torch.bfloat16) for _ in range(3))
        log_w = -torch.exp(0.3 * randn(B, T, H, D))
        u = 0.5 * randn(H, D)
        s0 = randn(B, H, D, D) if state else torch.zeros((B, H, D, D),
                                                          device=dev)
        y, s1 = wkv6_cuda(r, k, v, log_w, u, s0)
        y_ref, s1_ref = wkv6_plain(r, k, v, log_w, u, s0)
        torch.cuda.synchronize()
        err_y = float((y.float() - y_ref.float()).abs().max())
        err_s = float((s1 - s1_ref).abs().max())
        scale_y = float(y_ref.float().abs().max())
        scale_s = float(s1_ref.abs().max())
        # the state is fp32 on both sides, summed over D keys in another
        # order: 1e-5 of its largest value.  y is that fp32 number rounded
        # to bf16 on each side, so a rounding may flip: one bf16 ulp (at
        # most 2^-7 of |y|) plus the fp32 term
        bad_y = ((y.float() - y_ref.float()).abs()
                 > 2 ** -7 * y_ref.float().abs() + 1e-5 * scale_y).any()
        if (bool(bad_y) or err_s > 1e-5 * scale_s
                or not bool(torch.isfinite(y.float()).all())):
            raise AssertionError(f"wkv6 {label}: y err {err_y} (max |y| "
                                 f"{scale_y}), state err {err_s} (max "
                                 f"{scale_s}) against its plain version")
        worst = max(worst, err_y, err_s)
        flops = 7 * D * D * B * H * T
        moved = 3 * r.numel() * 2 + log_w.numel() * 4 + u.numel() * 4 \
            + y.numel() * 2 + 2 * s0.numel() * 4
        # ms: the card's own time per call (device_ms); the wall time of
        # back-to-back calls beside it (at T 1 the host's issue of each)
        ms = device_ms(torch, lambda: wkv6_cuda(r, k, v, log_w, u, s0))
        wall_ms = time_ms(torch, lambda: wkv6_cuda(r, k, v, log_w, u, s0),
                          reps=20)
        plain_ms = time_ms(torch, lambda: wkv6_plain(r, k, v, log_w, u, s0),
                           reps=3, warmup=1)
        entry = kernel_entry("wkv6", max(err_y, err_s), ms, plain_ms, flops,
                             moved, (r.dtype, log_w.dtype), None)
        entry["wall_ms"] = wall_ms
        timed[label] = entry
        pl = wkv6_plan(D, T)
        log(f"    wkv6 {label:18s} [{B * H * pl.blocks} blocks of "
            f"{pl.threads}, {pl.keys} keys a block] y err {err_y:.2e} (max "
            f"|y| {scale_y:.3g})  state err {err_s:.2e}  kernel {ms:8.4f} ms "
            f"(wall {wall_ms:.4f})  plain {plain_ms:8.3f} ms  bound "
            f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}; "
            f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB)  "
            f"{entry['bound_ms'] / ms:6.1%} of the bound")
    main_entry = dict(timed["rwkv6-3b prefill"])
    main_entry["max_abs_err"] = worst
    main_entry["decode"] = {key: timed["rwkv6-3b decode"][key]
                            for key in keys + ("wall_ms",)}
    results["wkv6"] = main_entry
    torch.cuda.empty_cache()

    # RG-LRU at recurrentgemma-2b: B 4, lru_width 2560, a in (0.9, 1) as
    # the model's init puts a = exp(-8 softplus(lam) r)
    timed = {}
    for label, T in (("rg prefill", 2560), ("rg decode", 1)):
        B, W = 4, 2560
        a = torch.exp(-0.1 * torch.rand((B, T, W), generator=gen,
                                        device=dev))
        b = 0.3 * randn(B, T, W)
        h0 = randn(B, W)
        y, hT = rglru_cuda(a, b, h0)
        y_ref, hT_ref = rglru_plain(a, b, h0)
        torch.cuda.synchronize()
        # the kernel's fp32 multiply then add (no FMA) is the plain
        # version's two torch ops: bit for bit
        if not (torch.equal(y, y_ref) and torch.equal(hT, hT_ref)):
            err = float(max((y - y_ref).abs().max(),
                            (hT - hT_ref).abs().max()))
            raise AssertionError(f"rglru {label}: kernel differs from its "
                                 f"plain version (max abs err {err})")
        flops = 2 * B * T * W
        moved = (a.numel() + b.numel() + y.numel() + h0.numel()
                 + hT.numel()) * 4
        ms = device_ms(torch, lambda: rglru_cuda(a, b, h0))
        wall_ms = time_ms(torch, lambda: rglru_cuda(a, b, h0), reps=20)
        plain_ms = time_ms(torch, lambda: rglru_plain(a, b, h0), reps=3,
                           warmup=1)
        entry = kernel_entry("rglru", 0.0, ms, plain_ms, flops, moved,
                             (a.dtype,), None)
        entry["wall_ms"] = wall_ms
        timed[label] = entry
        log(f"    rglru {label:12s} [{rglru_grid(B, W)} blocks, 16-byte "
            f"copies {rglru_vector_path(W, a, b)}] equal=True  kernel "
            f"{ms:8.4f} ms (wall {wall_ms:.4f})  plain {plain_ms:8.3f} ms  "
            f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}; "
            f"{moved / 1e6:.2f} MB)  {entry['bound_ms'] / ms:6.1%} of the "
            f"bound")
        del a, b, h0, y, hT, y_ref, hT_ref
    main_entry = dict(timed["rg prefill"])
    main_entry["decode"] = {key: timed["rg decode"][key]
                            for key in keys + ("wall_ms",)}
    results["rglru"] = main_entry
    torch.cuda.empty_cache()


def path_launches(cfg, prompt_len: int, gen: int):
    """The launches a serve of ``gen`` new tokens must make: each layer's
    kernel once in prefill and once per decode step.  An attention layer
    counts one ``flash_attention`` wrapper call a step, its prefill on the
    design its dtype and head dim take (the SIMT kernel, or the wgmma
    kernel in bf16 at D >= 64), each decode step on the split-KV kernel
    and its combine."""
    from repro_torch.kernels.flash_attention import design
    n_rec = sum(cfg.layer_is_recurrent(i) for i in range(cfg.num_layers)) \
        if cfg.is_hybrid else 0
    n_attn = 0 if cfg.is_attention_free else cfg.num_layers - n_rec
    want = {"rglru": n_rec * (1 + gen),
            "wkv6": cfg.num_layers * (1 + gen) if cfg.is_attention_free
            else 0,
            "flash_attention": n_attn * (1 + gen),
            design(prompt_len, cfg.resolved_head_dim, cfg.dtype): n_attn,
            "flash_decode": n_attn * gen,
            "flash_decode_combine": n_attn * gen}
    return {k: n for k, n in want.items() if n}


def serving_paths(torch, dev, results) -> None:
    """Phase 7: ``serve`` at lm100m, rwkv6-3b and recurrentgemma-2b through
    the kernels, counted, and held against the plain versions."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import prompt_tokens, serve
    from repro_torch.launch.train import _preset
    from repro_torch.models.layers import compute_dtype
    from repro_torch.models.lm import (
        decode_step, init_cache, init_lm, prefill_step)
    from repro_torch.utils.trees import tree_leaves, tree_map

    rwkv = get_config("rwkv6-3b")
    rg = get_config("recurrentgemma-2b")
    # (config, batch, prompt, new tokens, plain attention impl, the main
    #  path?, tolerance of the logits relative to their largest magnitude
    #  or None, and why)
    runs = (
        (_preset("lm100m"), 8, 512, 64, "naive", True,
         1e-4, "fp32 throughout; attention sums in another order, through "
         "12 layers"),
        (rwkv, 4, 256, 32, "auto", True, None,
         "bf16 activations: the random-init 32-layer stack carries a "
         "one-ulp flip of a bf16 WKV output into other logits, so this "
         "run is held to finite logits and its gap is reported; the fp32 "
         "run of the same model holds the numbers"),
        (replace(rwkv, dtype="float32"), 4, 256, 4, "auto", False,
         1e-2, "fp32: the kernel and the scan sum in other orders, and the "
         "random-init 32-layer stack amplifies that difference"),
        # the prompt wraps each attention layer's 2048-slot ring; decode
        # at 2560-2591 overwrites slots 512-543
        (rg, 4, 2560, 32, "auto", True, None,
         "the random-init stack amplifies a rounding difference at every "
         "attention layer, in fp32 as in bf16 (wk of the one KV head takes "
         "scale 1, so scores reach thousands and the softmax is nearly an "
         "argmax); the gap is reported, and the fp32 block-by-block check "
         "below holds the numbers"),
    )
    params, params_for = None, None
    for (cfg, batch, prompt_len, gen, plain_impl, main_path, rtol,
         why) in runs:
        torch.cuda.reset_peak_memory_stats()
        if params_for != cfg.name:
            params = None
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            params = init_lm(cfg, 0, dev, draw_on=dev)
            torch.cuda.synchronize()
            params_for = cfg.name
            n_params = sum(x.numel() for x in tree_leaves(params))
            if n_params != cfg.param_count():
                raise AssertionError(f"{cfg.name}: {n_params} parameters, "
                                     f"config says {cfg.param_count()}")
            log(f"[7] {cfg.name}: {n_params:,} fp32 parameters drawn on the "
                f"card in {time.perf_counter() - t0:.1f} s")
        log(f"[7] {cfg.name} serve, {cfg.dtype} compute: batch {batch}, "
            f"prompt {prompt_len}, {gen} new tokens"
            + ("" if main_path else " (a check of the numbers, not the "
               "main path)"))
        labels = ((("kernel", "kernel", "kernel"),
                   ("plain", plain_impl, "scan")) if main_path
                  else (("kernel", "kernel", "kernel"),))
        runs_out = {}
        for label, impl, rec_impl in labels:
            build.reset_launches()
            runs_out[label] = out = serve(
                cfg, batch=batch, prompt_len=prompt_len, gen=gen, device=dev,
                impl=impl, rec_impl=rec_impl, params=params,
                keep_logits=True)
            launches = {k: v for k, v in build.LAUNCHES.items() if v}
            log(f"    {label:6s} prefill {out['prefill_s']:.4f} s  decode "
                f"{out['decode_s']:.4f} s  {out['decode_tok_per_s']:.1f} "
                f"tok/s  launches {launches}")
            if label == "kernel":
                want = path_launches(cfg, prompt_len, gen)
                if launches != want:
                    raise AssertionError(f"{cfg.name} serve launched "
                                         f"{launches}, want {want}")
                for kernel, n in want.items():
                    if not main_path:
                        continue
                    entry = results[kernel]
                    entry.setdefault("launches_by_path", {})[
                        f"serve {cfg.name}"] = n
                    if entry["launches"] is None:
                        entry["launches"] = n
            elif launches:
                raise AssertionError(f"the plain serve launched {launches}")
        ker = runs_out["kernel"]
        # the plain versions on the same prompt, then one decode step fed
        # the kernel run's first token
        cache = init_cache(cfg, batch, prompt_len + gen + 1,
                           dtype=compute_dtype(cfg), device=dev)
        prompt = torch.from_numpy(prompt_tokens(cfg, batch, prompt_len,
                                                0)).to(dev)
        with torch.no_grad():
            p_logits, cache = prefill_step(params, cache, {"tokens": prompt},
                                           cfg, impl=plain_impl,
                                           rec_impl="scan")
            d_logits, _ = decode_step(params, cache, ker["tokens"][:, :1],
                                      prompt_len, cfg, impl=plain_impl,
                                      rec_impl="scan")
        for what, got, want in (("prefill", ker["prefill_logits"], p_logits),
                                ("first decode", ker["decode_logits"],
                                 d_logits)):
            got, want = got.float(), want.float()
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            finite = bool(torch.isfinite(got).all())
            tol = "not held" if rtol is None else f"tolerance {rtol:.3g} of it"
            log(f"    {what} logits {tuple(got.shape)}: max abs err {err:.4g}"
                f" against the plain versions (max |logit| {scale:.4g}; "
                f"{tol}: {why})")
            if not finite or got.shape != (batch, 1, cfg.vocab_size) \
                    or (rtol is not None and err > rtol * scale):
                raise AssertionError(f"{cfg.name} serve {what} logits")
        if main_path:
            same = float((ker["tokens"] == runs_out["plain"]["tokens"])
                         .float().mean())
            log(f"    generated tokens equal to the plain run's: {same:.1%}")
        log(f"    peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if cfg.is_hybrid:
            layerwise_check(torch, dev, replace(cfg, dtype="float32"),
                            params, prompt, ker["tokens"][:, :1])
        del cache, runs_out, ker, p_logits, d_logits
    del params
    torch.cuda.empty_cache()

    # rg-smoke on the card (kernels) against the CPU (plain versions) on one
    # set of parameters, in fp32: a 40-token prompt wraps the 32-slot ring
    small = replace(_preset("recurrentgemma-2b"), dtype="float32")
    cpu = torch.device("cpu")
    p_cpu = init_lm(small, 0, cpu)
    p_card = tree_map(lambda t: t.to(dev), p_cpu)
    out = {label: serve(small, batch=2, prompt_len=40, gen=6, device=d,
                        params=p, keep_logits=True)
           for label, d, p in (("card", dev, p_card), ("cpu", cpu, p_cpu))}
    for what in ("prefill_logits", "decode_logits"):
        got, want = out["card"][what].cpu(), out["cpu"][what]
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        log(f"    rg-smoke card vs CPU {what}: max abs err {err:.3g} (max "
            f"|logit| {scale:.3g}; tolerance 1e-4 of it: fp32 matmuls and "
            f"attention sums in other orders, 3 layers)")
        if err > 1e-4 * scale:
            raise AssertionError(f"rg-smoke {what} on the card differs from "
                                 f"the CPU")
    if not torch.equal(out["card"]["tokens"].cpu(), out["cpu"]["tokens"]):
        raise AssertionError("rg-smoke generated other tokens on the card")


def layerwise_check(torch, dev, cfg, params, prompt, token) -> None:
    """recurrentgemma-2b in fp32, block by block: every block runs through
    the kernels and through the plain versions on the same input (the
    kernel path's output of the block before), statefully, in prefill
    over the whole prompt and in one decode step, each path writing its
    own cache.  Holds each block's output, and the cache it writes, to
    fp32 tolerance, and in decode each attention layer's kernel output to
    an fp64 evaluation of the same softmax; the end-to-end logits cannot
    be held, since the random-init stack amplifies any rounding
    difference.  Both phases are read before a failure is raised."""
    from repro_torch.kernels.flash_attention import visible
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models.lm import apply_block, block_kind, init_cache

    batch, prompt_len = prompt.shape
    caches = {label: init_cache(cfg, batch, prompt_len + 2,
                                dtype=torch.float32, device=dev)
              for label in ("kernel", "plain")}

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max().clamp(min=1e-30))

    def against_fp64(lp, x, c, positions):
        """The decode attention of one layer from its written cache: the
        largest |score|, the least gap between a row's two largest scores,
        and each fp32 path's distance from the fp64 softmax."""
        q = A._project_qkv(lp["mixer"], L.apply_norm(lp["norm1"], x), cfg,
                           positions)[0]
        qp = positions.to(torch.int32)
        kw = dict(window=cfg.attn_window, q_positions=qp,
                  kv_positions=c["pos"])
        B, Sq, H, D = q.shape
        K = c["k"].shape[2]
        sc = torch.einsum("bqkgd,bskd->bkgqs",
                          q.double().reshape(B, Sq, K, H // K, D),
                          c["k"].double()) * D ** -0.5
        sc = sc.masked_fill(~visible(qp, c["pos"], causal=True,
                                     window=cfg.attn_window), -torch.inf)
        exact = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(sc, -1),
                             c["v"].double()).reshape(B, Sq, H, D)
        top2 = torch.topk(sc, 2, dim=-1).values
        return (float(sc.masked_fill(sc == -torch.inf, 0).abs().max()),
                float((top2[..., 0] - top2[..., 1]).min()),
                *(rel(A.attention_impl(q, c["k"], c["v"], impl=impl, **kw),
                      exact) for impl in ("kernel", "auto")))

    log(f"[7] {cfg.name} fp32, block by block, kernels against the plain "
        f"versions on the same input")
    # fp32: attention sums over <= 2048 keys in another order, and the
    # RG-LRU kernel is bitwise its plain version, so 1e-5 of a block's
    # largest output (~100 fp32 ulps).  Decode is held to 1e-3: its 40
    # attention rows include near ties between two keys at scores of
    # thousands (printed), where one fp32 ulp of a score is ~2.4e-4, so
    # kernel and plain path may each sit up to ~1e-4 from the fp64 softmax
    # on their own rounding; the kernel's distance from fp64 is held to
    # the same 1e-3.
    tolerance = {"prefill": 1e-5, "decode": 1e-3}
    failures = []
    with torch.no_grad():
        for phase, tokens, pos in (("prefill", prompt, 0),
                                   ("decode", token, prompt_len)):
            x = L.embed(params["embedding"], tokens, torch.float32)
            positions = torch.arange(pos, pos + tokens.shape[1], device=dev)
            worst_out = worst_cache = 0.0
            evidence = []
            for li, lp in enumerate(params["blocks"]):
                kind = block_kind(cfg, li)
                outs = {}
                for label, impl, rec_impl in (("kernel", "kernel", "kernel"),
                                              ("plain", "auto", "scan")):
                    c = caches[label][li]
                    outs[label], new = apply_block(
                        lp, x, cfg, kind=kind, positions=positions,
                        impl=impl, rec_impl=rec_impl, cache=c, pos=pos)
                    for name, t in new.items():
                        if t is not c[name]:
                            c[name].copy_(t)
                worst_out = max(worst_out, rel(outs["kernel"], outs["plain"]))
                worst_cache = max(worst_cache, *(
                    rel(caches["kernel"][li][name], caches["plain"][li][name])
                    for name in caches["kernel"][li]))
                if phase == "decode" and kind == "attn_local":
                    evidence.append((li,) + against_fp64(
                        lp, x, caches["kernel"][li], positions))
                x = outs["kernel"]
            log(f"    {phase}: largest gap of a block's output {worst_out:.3g}"
                f", of its cache {worst_cache:.3g}, relative to their "
                f"largest magnitude (tolerance {tolerance[phase]:g}; 1e-5 "
                f"for the cache)")
            for li, smax, gap, err_k, err_p in evidence:
                log(f"      layer {li:2d} attention: max |score| {smax:.5g}, "
                    f"least top-2 gap {gap:.4g}; from fp64: kernel "
                    f"{err_k:.3g} (tolerance {tolerance[phase]:g}), plain "
                    f"{err_p:.3g}")
                if err_k > tolerance[phase]:
                    failures.append(f"{phase} layer {li}: the kernel's "
                                    f"attention is {err_k:.3g} from fp64")
            if worst_out > tolerance[phase] or worst_cache > 1e-5:
                failures.append(f"{phase}: a block through the kernels "
                                f"differs from the plain versions")
    del caches
    if failures:
        raise AssertionError(f"{cfg.name}: " + "; ".join(failures))


def count_syncs(torch, fn):
    """The synchronising CUDA calls ``fn()`` makes (each one warns under
    ``torch.cuda.set_sync_debug_mode("warn")``): ``(count, {"file:line":
    count})`` by the Python line that made them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            path = Path(w.filename)
            where = (f"{path.relative_to(ROOT)}:{w.lineno}"
                     if path.is_relative_to(ROOT) else f"{path.name}:"
                     f"{w.lineno}")
            sites[where] = sites.get(where, 0) + 1
    return sum(sites.values()), dict(sorted(sites.items(),
                                            key=lambda kv: -kv[1]))


def analyzer(torch, dev, results) -> None:
    """Phase 8: the analyzer's self-test on the card, the mis-tiled copy
    against its plain version, timed, and the round's host syncs."""
    from repro_torch.config import HermesConfig, OptimizerConfig
    from repro_torch.core.gup import gup_gate
    from repro_torch.dist import hermes_sync
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.tile_copy import (
        SHAPE, tile_copy_cuda, tile_copy_plain)
    from repro_torch.launch import analyze
    from repro_torch.launch.train import _preset, train_hermes
    from repro_torch.models.lm import init_lm
    from repro_torch.utils.trees import tree_map

    log("[8] python -m repro_torch.launch.analyze --self-test, on the card")
    build.reset_launches()
    record = analyze.main(["--self-test", "--device", str(dev)])
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    fixtures = {f["fixture"]: f for f in record["self_test"]}
    labels = [t["label"] for t in record["targets"]]
    specs = [lb for lb in labels
             if lb.startswith("kernel[") and lb != "kernel[pack-constants]"]
    log(f"    {len(specs)} launch specs, the pack constants and "
        f"train_hermes's loop clean: {record['ok']}; fixtures "
        f"{sorted(fixtures)} raised their classes; the copy equal to its "
        f"plain version: {fixtures['bad-tiles']['copy_equal']}; launches "
        f"{launches}")
    if (not record["ok"] or launches != {"tile_copy": 1}
            or len(specs) != len(ops.kernel_lint_cases())
            or fixtures["bad-tiles"]["copy_equal"] is not True
            or "train_hermes[source]" not in labels):
        raise AssertionError(f"the analyzer's self-test on the card: "
                             f"{record}")

    x = torch.randn(SHAPE, generator=torch.Generator(device=dev)
                    .manual_seed(3), device=dev)
    got, want = tile_copy_cuda(x), tile_copy_plain(x)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("tile_copy differs from its plain version")
    moved = 2 * x.numel() * x.element_size()
    bound_ms, bound_by = bound(0, moved, (x.dtype,))
    # the card's own time per call (device_ms), the wall time of
    # back-to-back calls (the host's issue) beside it
    ms = device_ms(torch, lambda: tile_copy_cuda(x), reps=20)
    wall_ms = time_ms(torch, lambda: tile_copy_cuda(x), reps=20)
    plain_ms = time_ms(torch, lambda: tile_copy_plain(x), reps=20)
    clone_ms = device_ms(torch, lambda: x.clone(), reps=20)
    clone_wall_ms = time_ms(torch, lambda: x.clone(), reps=20)
    results["tile_copy"] = {
        "name": "tile_copy", "route": "cuda", "source": FIXTURE_SOURCE,
        "replaces": REPLACES["tile_copy"], "launches": launches["tile_copy"],
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": clone_ms,
        "wall_ms": wall_ms, "library_wall_ms": clone_wall_ms}
    log(f"    tile_copy {tuple(SHAPE)} in (8, 100) tiles on an (8, 3) grid: "
        f"equal=True  kernel {ms:.4f} ms [wall {wall_ms:.4f}]  plain "
        f"{plain_ms:.4f} ms  x.clone() {clone_ms:.4f} ms [wall "
        f"{clone_wall_ms:.4f}]  bound {bound_ms:.6f} ms ({bound_by}; "
        f"{moved:,} B): the launch floor, not the bytes, sets all three")

    # the host syncs of one round at lm100m x 4 pods, gates open
    cfg = _preset("lm100m")
    w_global = init_lm(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    pods = tree_map(lambda g: g[None] + 1e-3 * torch.randn(
        (PODS,) + tuple(g.shape), generator=gen, device=dev), w_global)
    L = torch.tensor(3.4, device=dev)
    low = torch.tensor([2.1, 2.2, 2.0, 2.3], device=dev)
    syncs = {}
    for compression in ("int4", "int8"):
        hcfg = HermesConfig(compression=compression)
        gup = hermes_sync.hermes_pod_state(hcfg, PODS, dev)
        for level in (3.0, 3.2):  # a loss history the next losses beat
            _, gup = gup_gate(gup, torch.full((PODS,), level, device=dev),
                              hcfg)
        if compression == "int4":
            def one_round(gup=gup, hcfg=hcfg):
                return hermes_sync.hermes_round(pods, gup, low, w_global, L,
                                                hcfg)["gates"]
            label = "int4 hermes_round"
        else:
            def one_round(gup=gup, hcfg=hcfg):
                dp = hermes_sync.hermes_dispatch(pods, gup, low, w_global, L,
                                                 hcfg)
                hermes_sync.hermes_commit(pods, dp["pending"], w_global,
                                          cfg=hcfg)
                return dp["gates"]
            label = "int8 hermes_dispatch + hermes_commit"
        # warm-up (kernels loaded, allocator primed), and the gates open
        if not bool(one_round().all()):
            raise AssertionError(f"{label}: the gates did not open")
        syncs[label], where = count_syncs(torch, one_round)
        log(f"    {label}: {syncs[label]} synchronising calls, at {where}")
    del pods, w_global
    torch.cuda.empty_cache()
    out = {}
    steps = 4
    label = f"train_hermes, {steps} steps"
    syncs[label], where = count_syncs(
        torch, lambda: out.update(train_hermes(
            cfg, steps=steps, batch=8, seq=128, pods=PODS,
            opt_cfg=OptimizerConfig(name="adamw", lr=3e-4),
            hcfg=HermesConfig(alpha=-1.3, beta=0.1, lam=2, eta=1.0),
            log_every=10 ** 6, device=dev)))
    log(f"    {label} ({out['rounds']} rounds, {out['merges']} merges): "
        f"{syncs[label]} synchronising calls; the most at "
        f"{dict(list(where.items())[:10])}")
    log(f"    synchronising calls at lm100m x {PODS} pods (rounds with the "
        f"gates open): {syncs}")
    torch.cuda.empty_cache()


def tree_gap(got, want):
    """Largest |got - want| over matching tensors, and the largest |want|."""
    gap = max(float((a.detach().cpu() - b.detach().cpu()).abs().max())
              for a, b in zip(got, want))
    top = max(float(b.detach().abs().max()) for b in want)
    return gap, top


def level_a(torch, dev, results) -> None:
    """Phase 9: the paper's Level-A simulator on the card: the CNN step
    against the CPU, the grouped pack and unpack on the CNN trees, the
    quickstart's study and cifar-alexnet Hermes at Table III's settings."""
    from repro_torch.config import HermesConfig
    from repro_torch.core.allocator import Allocation
    from repro_torch.core.bundles import make_paper_bundle
    from repro_torch.core.cluster import _make_step
    from repro_torch.core.simulator import run_framework
    from repro_torch.dist import wire
    from repro_torch.dist.compression import payload_bytes
    from repro_torch.kernels import build
    from repro_torch.kernels.pack import (
        pack_int4_group_cuda, pack_int4_group_plain, unpack_int4_group_cuda,
        unpack_int4_group_plain)
    from repro_torch.models.cnn import param_count
    from repro_torch.utils.trees import (
        tree_flatten, tree_leaves, tree_map, tree_unflatten)

    archs = {"mnist": "mnist-cnn", "cifar": "cifar-alexnet"}
    # (a) one SGD step of each CNN at full width on the card against the
    # plain CPU step, from one set of parameters; the second step reads a
    # momentum buffer (cifar: 0.9).  cuDNN's fp32 convs (TF32 off) sum in
    # other orders than the CPU's: held to 1e-4 of each tensor's largest
    # magnitude
    tol = 1e-4
    trees = {}
    for dataset, arch in archs.items():
        bundle, _ = make_paper_bundle(dataset, n=256)
        params = bundle.init(torch.Generator().manual_seed(0), "cpu")
        trees[arch] = params
        batch = {k: torch.as_tensor(v[:16])
                 for k, v in bundle.train_data.items()}
        step = _make_step(bundle)
        out = {}
        for where in ("cpu", dev):
            p = tree_map(lambda x: x.to(where), params)
            b = {k: v.to(where) for k, v in batch.items()}
            leaves, treedef = tree_flatten(p)
            leaves = [x.detach().requires_grad_(True) for x in leaves]
            loss = bundle.loss(tree_unflatten(treedef, leaves), b)
            grads = torch.autograd.grad(loss, leaves)
            mom = tree_map(torch.zeros_like, p)
            for _ in range(2):
                p, mom = step(p, mom, b)
            out[str(where)] = (float(loss.detach()), list(grads),
                               tree_leaves(p),
                               float(bundle.loss(p, b)))
        cpu, card = out["cpu"], out[str(dev)]
        loss_gap = abs(card[0] - cpu[0]) / abs(cpu[0])
        grad_gap, grad_top = tree_gap(card[1], cpu[1])
        par_gap, par_top = tree_gap(card[2], cpu[2])
        on_card = all(x.device == dev for x in card[2])
        log(f"[9a] {arch} ({param_count(params):,} parameters, batch 16, "
            f"eta {bundle.eta}, momentum {bundle.momentum}): card vs CPU "
            f"loss rel gap {loss_gap:.2e}, gradients {grad_gap:.2e} of "
            f"{grad_top:.3g}, parameters after two steps {par_gap:.2e} of "
            f"{par_top:.3g}, loss after them {card[3]:.6f} / {cpu[3]:.6f} "
            f"(tolerance {tol:g} relative to the largest magnitude)")
        if (not on_card or loss_gap > tol or grad_gap > tol * grad_top
                or par_gap > tol * par_top
                or abs(card[3] - cpu[3]) > tol * abs(cpu[3])):
            raise AssertionError(f"{arch}: the step on the card disagrees "
                                 f"with the CPU")

    # (b) the grouped pack and unpack on the int4 payload trees of a push
    fmt = wire.get_format("int4")
    noise = wire.GeneratorNoise(9, dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    cases = {}
    for arch, params in trees.items():
        pack_leaves = []
        for i, x in enumerate(tree_leaves(params)):
            delta = 1e-2 * torch.randn(x.shape, generator=gen, device=dev)
            q, _, _, ax, d, _ = fmt._quantize(delta, (0, i), noise)
            pack_leaves.append((q, d, ax))
        wires = pack_int4_group_plain(pack_leaves)
        unpack_leaves = [(p, d, ax) for p, (_, d, ax) in
                         zip(wires, pack_leaves)]
        cases[f"pack_int4[{arch}]"] = (
            "pack_int4", lambda lv=pack_leaves: pack_int4_group_cuda(lv),
            lambda lv=pack_leaves: pack_int4_group_plain(lv),
            [q.narrow(ax, 0, d) for q, d, ax in pack_leaves])
        cases[f"unpack_int4[{arch}]"] = (
            "unpack_int4",
            lambda lv=unpack_leaves: unpack_int4_group_cuda(lv),
            lambda lv=unpack_leaves: unpack_int4_group_plain(lv), wires)
        log(f"[9b] {arch}: {len(pack_leaves)} leaves, blocked axes and real "
            f"lengths {[(ax, d) for _, d, ax in pack_leaves]}; int4 push "
            f"{payload_bytes(params, 'int4'):,} B (none "
            f"{payload_bytes(params, 'none'):,})")
    for name, (kernel, kern, plain, inputs) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version")
        moved = nbytes(inputs) + nbytes(got)
        bound_ms, bound_by = bound(0, moved, (torch.int8,))
        build.reset_launches()
        kern()
        per_pass = build.LAUNCHES[kernel]
        wall_ms = time_ms(torch, kern, reps=50)
        ms = device_ms(torch, kern, reps=20)
        plain_ms = time_ms(torch, plain, reps=20)
        results[name] = {
            "name": name, "route": "cuda", "source": WIRE_SOURCE,
            "replaces": REPLACES[kernel], "launches": None,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "wall_ms": wall_ms, "launches_per_pass": per_pass}
        log(f"    {name:26s} equal=True  kernel {ms:.4f} ms [wall "
            f"{wall_ms:.4f}; {per_pass} launches a pass]  plain "
            f"{plain_ms:.4f} ms  bound {bound_ms:.6f} ms ({bound_by}; "
            f"{moved:,} B)")
        if per_pass != 1:
            raise AssertionError(f"{name}: {per_pass} launches a pass")

    # (c) the quickstart's study (examples/quickstart.py) on the card, and
    # (d) cifar-alexnet Hermes at Table III's settings
    # (benchmarks/table3_convergence.py), bounded in iterations and wall
    def study(label, framework, bundle, arch, **kw):
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        r = run_framework(framework, bundle, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        pushes = sum(p for *_, p in r.gup_trace)
        log(f"    {label}: {r.iterations} iterations, {r.ps_updates} PS "
            f"updates, {pushes} gated pushes, sim {r.sim_time:.2f} s, acc "
            f"{r.conv_acc:.3f} (reached {r.reached_target}), {r.api_calls} "
            f"API calls, {r.bytes_transferred / 1e6:.2f} MB, WI "
            f"{r.wi_avg:.2f}, wall {wall:.1f} s, replicas on {r.device}, "
            f"launches {launches}")
        if r.device != str(dev):
            raise AssertionError(f"{label}: replicas on {r.device}")
        if framework == "hermes":
            if pushes < 1 or launches.get("pack_int4", 0) < 1 \
                    or launches != {"pack_int4": pushes,
                                    "unpack_int4": pushes}:
                raise AssertionError(f"{label}: {pushes} pushes, launches "
                                     f"{launches}")
            for kernel in ("pack_int4", "unpack_int4"):
                results[f"{kernel}[{arch}]"]["launches"] = launches[kernel]
        return r, wall

    bundle, _ = make_paper_bundle("mnist", n=3000, eval_batch=128)
    kw = dict(num_workers=6, target_acc=0.90, max_iterations=500,
              max_wall=60, init_alloc=Allocation(128, 16), eval_every=3)
    log("[9c] the quickstart on the card: mnist n 3000, 6 workers, "
        "Allocation(128, 16), target 0.90, int4 Hermes, then BSP")
    h, h_wall = study("hermes", "hermes", bundle, "mnist-cnn",
                      hermes_cfg=HermesConfig(alpha=-1.3, beta=0.1, lam=5,
                                              eta=bundle.eta), **kw)
    b, b_wall = study("bsp", "bsp", bundle, "mnist-cnn", **kw)
    log(f"    {'':10s}{'iters':>8s}{'sim time':>10s}{'acc':>8s}"
        f"{'API calls':>11s}{'WI':>6s}{'wall':>8s}")
    for r, wall in ((b, b_wall), (h, h_wall)):
        log(f"    {r.framework:10s}{r.iterations:8d}{r.sim_time:9.1f}s"
            f"{r.conv_acc:8.3f}{r.api_calls:11d}{r.wi_avg:6.2f}"
            f"{wall:7.1f}s")
    log(f"    Hermes speedup vs BSP: {b.sim_time / h.sim_time:.2f}x (sim "
        f"time); comm reduction: {1 - h.api_calls / b.api_calls:.1%} (API "
        f"calls)")

    bundle, noniid = make_paper_bundle("cifar", n=6000, eval_batch=128)
    log("[9d] cifar-alexnet Hermes at Table III's settings on the card: n "
        "6000, 12 workers, non-IID, lam 15, int4, target 0.62, capped at "
        "900 iterations and 45 s of wall time")
    study("hermes", "hermes", bundle, "cifar-alexnet", num_workers=12,
          noniid=noniid, target_acc=0.62, max_iterations=900, max_wall=45,
          init_alloc=Allocation(128, 16), eval_every=3,
          hermes_cfg=HermesConfig(alpha=-1.3, beta=0.1, lam=15,
                                  eta=bundle.eta))
    torch.cuda.empty_cache()


def _same_bits(a, b) -> bool:
    """Two host arrays equal byte for byte (shape and dtype too)."""
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _checkpoint_arrays(path):
    """``{key: host array}`` of one checkpoint, read with numpy alone."""
    import numpy as np
    with open(path / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    with np.load(path / "arrays.npz") as data:
        return {m["key"]: data[f"a{m['idx']}"] for m in leaves}


def single_trainer(torch, dev, smi) -> None:
    """Phase 10a: ``train_single`` at lm100m on the card, checkpointed,
    restored and resumed, against a straight run."""
    import shutil
    from repro_torch.checkpoint import restore_tree
    from repro_torch.checkpoint.checkpointer import (
        _flatten_with_paths, _to_host)
    from repro_torch.config import OptimizerConfig
    from repro_torch.launch.train import _preset, train_single
    from repro_torch.models.lm import init_lm
    from repro_torch.optim.optimizers import make_optimizer

    cfg = _preset("lm100m")
    opt = OptimizerConfig(name="adamw", lr=3e-4)
    half = 3
    ckdir = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(ckdir, ignore_errors=True)
    run = dict(batch=8, seq=128, opt_cfg=opt, log_every=10 ** 6, seed=0,
               device=dev)
    # Deterministic algorithms make the resumed run bitwise the straight
    # one: the embedding's backward then accumulates without atomics.
    # warn_only: cuBLAS's own determinism check would raise without
    # CUBLAS_WORKSPACE_CONFIG; one stream and fixed shapes keep its
    # GEMMs repeatable.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            straight = train_single(cfg, steps=2 * half,
                                    ckpt_dir=str(ckdir / "straight"), **run)
            straight_wall = time.perf_counter() - t0
            first = train_single(cfg, steps=half,
                                 ckpt_dir=str(ckdir / "resumed"), **run)
            params = init_lm(cfg, 1, dev)
            template = {"params": params,
                        "opt": make_optimizer(opt).init(params), "step": 0}
            t0 = time.perf_counter()
            state, step = restore_tree(template, str(ckdir / "resumed"),
                                       device=dev)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            del template, params
            saved = _checkpoint_arrays(ckdir / "resumed" / f"step_{half}")
            restored = {k: _to_host(leaf)[0]
                        for k, leaf in _flatten_with_paths(state)}
            on_card = all(leaf.device == dev for _, leaf in
                          _flatten_with_paths(state["params"]))
            same_state = (step == half and list(restored) == list(saved)
                          and state["step"] == half
                          and state["opt"]["step"] == half
                          and all(_same_bits(restored[k], saved[k])
                                  for k in saved))
            del state, restored, saved
            torch.cuda.empty_cache()
            resumed = train_single(cfg, steps=2 * half,
                                   ckpt_dir=str(ckdir / "resumed"),
                                   restore=True, **run)
    finally:
        torch.use_deterministic_algorithms(False)
    a = _checkpoint_arrays(ckdir / "straight" / f"step_{2 * half}")
    b = _checkpoint_arrays(ckdir / "resumed" / f"step_{2 * half}")
    same_final = list(a) == list(b) and all(_same_bits(a[k], b[k])
                                            for k in a)
    n_leaves = len(a)
    del a, b
    shutil.rmtree(ckdir, ignore_errors=True)
    losses = first["losses"] + resumed["losses"]
    finite = all(math.isfinite(x) for x in straight["losses"])
    log(f"[10a] train_single at lm100m ({cfg.param_count():,} parameters), "
        f"batch 8, seq 128, AdamW, deterministic algorithms: "
        f"{straight['ms_per_step']:.1f} ms/step ({smi}), straight "
        f"{2 * half} steps in {straight_wall:.1f} s of wall with a "
        f"checkpoint at the end; losses {straight['losses']}")
    log(f"    {half} steps, checkpoint, restored on the card in "
        f"{restore_s:.1f} s: {n_leaves} leaves, state equal to the file bit "
        f"for bit {same_state} (on the card {on_card}); resumed "
        f"{resumed['losses']} ({resumed['ms_per_step']:.1f} ms/step): "
        f"losses bitwise the straight run's {losses == straight['losses']}, "
        f"final checkpoint bitwise {same_final}; warnings "
        f"{sorted({str(w.message)[:80] for w in caught})}")
    if not (finite and same_state and on_card and same_final
            and losses == straight["losses"]
            and len(resumed["losses"]) == half):
        raise AssertionError("train_single's checkpoint round trip or "
                             "resume differs on the card")


def admission_runs(torch, dev) -> None:
    """Phase 10b: ``train_hermes`` at lm100m, 4 pods, int4, participation
    0.5, under both admission modes, every admission recorded."""
    from repro_torch.config import HermesConfig, OptimizerConfig
    from repro_torch.dist import hermes_sync, wire
    from repro_torch.kernels import build
    from repro_torch.launch.train import _preset, train_hermes

    real = hermes_sync.admit_gates
    record = []

    def recording(gates, losses, cfg, **kw):
        admitted = real(gates, losses, cfg, **kw)
        record.append((kw["round_step"], gates.to(torch.bool).cpu(),
                       admitted.cpu()))
        return admitted

    for admission in ("topk", "prob"):
        record.clear()
        hcfg = HermesConfig(alpha=-1.3, beta=0.1, lam=2, eta=1.0,
                            compression="int4", participation_rate=0.5,
                            admission=admission)
        hermes_sync.admit_gates = recording
        try:
            torch.cuda.synchronize()
            build.reset_launches()
            t0 = time.perf_counter()
            out = train_hermes(_preset("lm100m"), steps=10, batch=8, seq=128,
                               pods=PODS,
                               opt_cfg=OptimizerConfig(name="adamw",
                                                       lr=3e-4),
                               hcfg=hcfg, log_every=10 ** 6, seed=0,
                               device=dev)
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in build.LAUNCHES.items() if v}
        finally:
            hermes_sync.admit_gates = real
        noise = wire.GeneratorNoise(0, dev)
        faults = []
        for round_step, opened, admitted in record:
            n_open = int(opened.sum())
            if bool((admitted & ~opened).any()):
                faults.append(f"round {round_step}: admitted not in open")
            if admission == "topk":
                want = max(1, n_open // 2) if n_open else 0
                if int(admitted.sum()) != want:
                    faults.append(f"round {round_step}: {int(admitted.sum())}"
                                  f" admitted of {n_open} open")
            else:
                u = noise(round_step, hermes_sync.ADMISSION_LEAF, (PODS,))
                if not torch.equal(admitted, opened & (u < 0.5).cpu()):
                    faults.append(f"round {round_step}: not the draw")
        gates = [g for _, _, g in out["history"]]
        if gates != [int(a.sum()) for _, _, a in record]:
            faults.append("history differs from the recorded admissions")
        merges = out["merges"]
        want_launches = {"pack_int4": merges, "unpack_int4": merges,
                         "dequant_merge_packed": merges}
        log(f"[10b] lm100m int4 x {PODS} pods, participation 0.5, "
            f"{admission}: {out['rounds']} rounds, {merges} merges, open -> "
            f"admitted {[(int(o.sum()), int(a.sum())) for _, o, a in record]}"
            f", global loss {out['global_loss']:.4f}, "
            f"{out['ms_per_step']:.1f} ms/step, {out['ms_per_round']:.1f} "
            f"ms/round, wall {wall:.1f} s, launches {launches}")
        if (faults or merges < 1 or not math.isfinite(out["global_loss"])
                or launches != want_launches):
            raise AssertionError(f"{admission} admission at lm100m: "
                                 f"{faults} launches {launches}")


def studies(torch, dev) -> None:
    """Phase 10c: the paper's studies on the card at their fast settings,
    every run's launches counted."""
    from repro_torch.kernels import build
    from repro_torch.studies import (
        comm_overhead, gup_trace, straggler, table3_convergence)

    runs = []

    def counted(module):
        real = module.run_framework

        def run(framework, bundle, **kw):
            torch.cuda.synchronize()
            build.reset_launches()
            t0 = time.perf_counter()
            r = real(framework, bundle, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in build.LAUNCHES.items() if v}
            pushes = sum(p for *_, p in r.gup_trace)
            cfg = kw.get("hermes_cfg")
            int4 = framework == "hermes" and cfg.compression == "int4"
            want = {"pack_int4": pushes, "unpack_int4": pushes} \
                if int4 and pushes else {}
            runs.append({"framework": framework,
                         "async": bool(cfg and cfg.async_rounds),
                         "iterations": r.iterations, "pushes": pushes,
                         "sim_s": r.sim_time, "api_calls": r.api_calls,
                         "mbytes": r.bytes_transferred / 1e6,
                         "acc": r.conv_acc, "reached": r.reached_target,
                         "wall_s": wall, "launches": launches,
                         "device": r.device})
            if r.device != str(dev) or launches != want:
                raise AssertionError(f"{framework}: replicas on {r.device}, "
                                     f"{pushes} int4 pushes, launches "
                                     f"{launches}")
            return r
        return real, run

    cases = (
        ("comm_overhead.smoke", comm_overhead,
         lambda: comm_overhead.smoke(device=dev)),
        ("comm_overhead.run", comm_overhead,
         lambda: comm_overhead.run(fast=True, device=dev)),
        ("table3_convergence.run", table3_convergence,
         lambda: table3_convergence.run("mnist", fast=True, device=dev)),
        ("straggler.async_overlap", straggler,
         lambda: straggler.async_overlap(fast=True, device=dev)),
        ("gup_trace.run", gup_trace,
         lambda: gup_trace.run(fast=True, device=dev)),
    )
    for name, module, call in cases:
        runs.clear()
        real, wrapped = counted(module)
        module.run_framework = wrapped
        try:
            t0 = time.perf_counter()
            out = call()
            wall = time.perf_counter() - t0
        finally:
            module.run_framework = real
        pushes = sum(r["pushes"] for r in runs)
        log(f"[10c] {name}: wall {wall:.1f} s, {len(runs)} runs, {pushes} "
            f"int4 pushes, one pack and one unpack launch a push")
        print(json.dumps({"study": name, "wall_s": wall, "result": out,
                          "runs": runs}), flush=True)


def trainer_and_studies(torch, dev, smi) -> None:
    """Phase 10: the single trainer with its checkpoints, admission at
    lm100m, and the paper's studies on the card."""
    t0 = time.perf_counter()
    single_trainer(torch, dev, smi)
    torch.cuda.empty_cache()
    admission_runs(torch, dev)
    torch.cuda.empty_cache()
    studies(torch, dev)
    torch.cuda.empty_cache()
    log(f"[10] phase wall {time.perf_counter() - t0:.1f} s")


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
    from repro_torch.core.gup import gup_gate
    from repro_torch.dist import hermes_sync, wire
    from repro_torch.dist.compression import dequantize_int8, quantize_int8
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.dequant_merge import (
        dequant_merge_group_cuda, dequant_merge_packed_group_cuda)
    from repro_torch.kernels.loss_weighted_update import (
        loss_weighted_update_cuda)
    from repro_torch.kernels.pack import (
        pack_int4_group_cuda, pack_int4_group_plain, unpack_int4_group_cuda,
        unpack_int4_group_plain)
    from repro_torch.kernels.quantize import (
        dequantize_int8_cuda, quantize_int8_cuda)
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
    paths = build.build_all()
    log(f"[2] built {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build.build_log.splitlines():
        if ("registers" in line or "spill" in line or "entry" in line
                or line.startswith("---")):
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
    # pack's leaves: every leaf's padded nibbles with its real length,
    # the two tail-only norm leaves included; unpack's: every wire leaf
    pack_leaves = [(fmt._quantize(d, (0, i), noise)[0], d.shape[ax], ax)
                   for i, (d, ax) in enumerate(zip(deltas, axes))]
    payloads = fmt.encode_group(deltas, [(0, i) for i in range(len(deltas))],
                                noise)
    unpack_leaves = [(p["q_packed"], d.shape[ax], ax)
                     for p, d, ax in zip(payloads, deltas, axes)]
    pods_f32 = [g[None] + d for g, d in zip(g_leaves, deltas)]
    payloads8 = [wire.get_format("int8").encode(d) for d in deltas]
    # the flat API's input: each stacked delta leaf, quantized by the plain
    # version (the kernel's own output is held against it below)
    flat8 = [ref.quantize_int8_ref(d) for d in deltas]
    for name, pays in (("int4", payloads), ("int8", payloads8)):
        wire_bytes = sum(wire.payload_nbytes(p) for p in pays)
        log(f"    {name} wire: {wire_bytes:,} bytes for {PODS} pods "
            f"({wire_bytes / (PODS * n_params):.4f} B/parameter)")
    w2 = torch.tensor([1 / 3.1, 1 / 3.2, 1 / 3.0, 1 / 3.3], device=dev)
    w1 = torch.tensor(1 / 3.4, device=dev)
    denom = w1 + w2.sum()
    push = torch.tensor(True, device=dev)

    # name: (kernel, plain version, fp32 operations per output element,
    #        one PyTorch call computing the same function or None)
    cases = {
        # pack and unpack: one grouped launch over every leaf, tails
        # included, as the round's encode
        "pack_int4": (lambda: pack_int4_group_cuda(pack_leaves),
                      lambda: pack_int4_group_plain(pack_leaves), 0, None),
        "unpack_int4": (lambda: unpack_int4_group_cuda(unpack_leaves),
                        lambda: unpack_int4_group_plain(unpack_leaves), 0,
                        None),
        # the merges: one grouped launch over every leaf, as the round
        "dequant_merge_packed": (
            lambda: dequant_merge_packed_group_cuda(
                [(g, p["q_packed"], p["scales"], ax)
                 for g, p, ax in zip(g_leaves, payloads, axes)],
                w2, denom, push),
            lambda: [ref.dequant_merge_packed_ref(
                g, p["q_packed"], p["scales"], w2, denom, push, axis=ax)
                for g, p, ax in zip(g_leaves, payloads, axes)],
            2 + 3 * PODS, None),
        "loss_weighted_update": (
            lambda: [loss_weighted_update_cuda(g, p, w1, w2, denom, push)
                     for g, p in zip(g_leaves, pods_f32)],
            lambda: [ref.loss_weighted_update_ref(g, p, w1, w2, denom, push)
                     for g, p in zip(g_leaves, pods_f32)],
            2 + 2 * PODS, None),
        "dequant_merge": (
            lambda: dequant_merge_group_cuda(
                [(g, p["q"], p["scales"], ax)
                 for g, p, ax in zip(g_leaves, payloads8, axes)],
                w2, denom, push),
            lambda: [ref.dequant_merge_ref(
                g, p["q"], p["scales"], w2, denom, push, axis=ax)
                for g, p, ax in zip(g_leaves, payloads8, axes)],
            2 + 3 * PODS, None),
        "quantize_int8": (
            lambda: [t for d in deltas for t in quantize_int8_cuda(d)],
            lambda: [t for d in deltas for t in ref.quantize_int8_ref(d)],
            6, None),
        "dequantize_int8": (
            lambda: [dequantize_int8_cuda(q, sc, d.shape)
                     for (q, sc), d in zip(flat8, deltas)],
            lambda: [ref.dequantize_int8_ref(q, sc, d.shape)
                     for (q, sc), d in zip(flat8, deltas)],
            # int8 x fp32 promotes to fp32 in one elementwise kernel
            1, lambda: [torch.mul(q, sc) for q, sc in flat8]),
    }
    inputs = {
        # the real nibbles pack reads, not the quantizer's padding
        "pack_int4": [q.narrow(ax, 0, d) for q, d, ax in pack_leaves],
        "unpack_int4": [p for p, _, _ in unpack_leaves],
        "dequant_merge_packed": g_leaves
        + [t for p in payloads for t in p.values()],
        "loss_weighted_update": g_leaves + pods_f32,
        "dequant_merge": g_leaves + [t for p in payloads8 for t in p.values()],
        "quantize_int8": deltas,
        "dequantize_int8": [t for qs in flat8 for t in qs],
    }
    results = {}
    log(f"[3] kernels at {cfg.name} ({n_params:,} parameters) x {PODS} pods, "
        f"the whole tree per call")
    for name, (kern, plain, flops_per_out, library) in cases.items():
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
        bound_ms, bound_by = bound(n_out * flops_per_out, moved,
                                   {t.dtype for t in inputs[name]})
        del got, want
        build.reset_launches()
        kern()
        per_pass = build.LAUNCHES[name]
        # ms is the card's own time of a pass; the wall time of
        # back-to-back passes (CUDA events) also holds the host's issue of
        # every launch
        wall_ms = time_ms(torch, kern, reps=20)
        ms = device_ms(torch, kern)
        plain_ms = time_ms(torch, plain, reps=3, warmup=1)
        library_ms = None if library is None else time_ms(torch, library,
                                                          reps=20)
        results[name] = {
            "name": name, "route": "cuda", "source": WIRE_SOURCE,
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "wall_ms": wall_ms,
            "launches_per_pass": per_pass,
        }
        lib_txt = "" if library_ms is None else f"  library {library_ms:.3f} ms"
        log(f"    {name:22s} equal=True  kernel {ms:8.3f} ms [wall "
            f"{wall_ms:.3f}; {per_pass} launches a pass]  plain "
            f"{plain_ms:8.3f} ms  bound {bound_ms:.3f} ms ({bound_by}; "
            f"{moved / 1e9:.3f} GB)  {bound_ms / ms:5.1%} of the bound"
            + lib_txt)
    del pack_leaves, unpack_leaves, payloads, payloads8, flat8, pods_f32
    del deltas
    torch.cuda.empty_cache()

    # ---- 4. a forced all-open merge at lm100m ----------------------------
    log("[4] forced all-open hermes_merge at lm100m x 4 pods")
    pod_params = tree_map(
        lambda g: g[None] + 1e-3 * torch.randn(
            (PODS,) + tuple(g.shape), generator=gen, device=dev), w_global)
    gates = torch.ones(PODS, dtype=torch.bool, device=dev)
    losses = torch.tensor([3.1, 3.2, 3.0, 3.3], device=dev)
    L = torch.tensor(3.4, device=dev)
    for compression in ("int4", "int8", "none"):
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
    del outs

    # dispatch + commit back to back is hermes_round in two halves: the
    # anchor of the async trainer, held bitwise on the kernel path
    hcfg8 = HermesConfig(compression="int8")
    gup = hermes_sync.hermes_pod_state(hcfg8, PODS, dev)
    for level in (3.0, 3.2):  # a loss history the next losses beat
        _, gup = gup_gate(gup, torch.full((PODS,), level, device=dev), hcfg8)
    low = torch.tensor([2.1, 2.2, 2.0, 2.3], device=dev)
    sync = hermes_sync.hermes_round(pod_params, gup, low, w_global, L, hcfg8)
    dp = hermes_sync.hermes_dispatch(pod_params, gup, low, w_global, L, hcfg8)
    cm = hermes_sync.hermes_commit(pod_params, dp["pending"], w_global,
                                   cfg=hcfg8)
    torch.cuda.synchronize()
    same = {k: all(torch.equal(a, b) for a, b in zip(
        tree_flatten(sync[k])[0], tree_flatten(part[k])[0]))
        for k, part in (("w_global", cm), ("pod_params", cm), ("error", dp))}
    log(f"    int8 dispatch + commit vs hermes_round: gates "
        f"{sync['gates'].tolist()}, bitwise equal {same}")
    if not (bool(sync["gates"].all()) and all(same.values())):
        raise AssertionError("dispatch + commit differs from hermes_round")
    del pod_params, sync, dp, cm
    torch.cuda.empty_cache()

    # ---- 5. the main paths -----------------------------------------------
    opt = OptimizerConfig(name="adamw", lr=3e-4)
    main_paths = (
        ("int4", 20, False, ("pack_int4", "unpack_int4",
                             "dequant_merge_packed")),
        ("none", 8, False, ("loss_weighted_update",)),
        ("int8", 16, True, ("dequant_merge",)),
    )
    for compression, steps, async_rounds, needed in main_paths:
        hcfg = HermesConfig(alpha=-1.3, beta=0.1, lam=2, eta=1.0,
                            compression=compression,
                            async_rounds=async_rounds)
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
        mode = "async" if async_rounds else "sync"
        log(f"[5] lm100m {compression} {mode}: {steps} steps, "
            f"{out['rounds']} rounds, {out['merges']} merges (dispatched "
            f"{out['dispatched']}, committed {out['committed']}, drained "
            f"{out['drained']}), global loss {out['global_loss']:.4f}, "
            f"{out['ms_per_step']:.1f} ms/step, {out['ms_per_round']:.1f} "
            f"ms/round, wall {wall:.1f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"launches {launches}")
        log(f"    gates per round {[g for _, _, g in out['history']]}")
        if (not finite or out["merges"] < 1 or not out["drained"]
                or out["dispatched"] != out["committed"]):
            raise AssertionError(f"{compression} {mode} main path: "
                                 f"finite={finite} {out}")
        for name in needed:
            if launches[name] < 1:
                raise AssertionError(f"main path never launched {name}")
            results[name]["launches"] = launches[name]

    # the flat int8 API, the second entry point, over every lm100m leaf
    build.reset_launches()
    worst = 0.0
    for g in g_leaves:
        q, sc = quantize_int8(g)
        back = dequantize_int8(q, sc, g.shape)
        # half a quantum per element, plus one fp32 rounding of |x| each
        # for x/scale and q*scale
        half = torch.repeat_interleave(sc[:, 0], wire.BLOCK)[:g.numel()] / 2
        x = g.reshape(-1)
        over = (back.reshape(-1) - x).abs() - half - 2 * EPS32 * x.abs()
        if back.shape != g.shape or not bool(torch.isfinite(back).all()):
            raise AssertionError(f"flat int8 round trip of {tuple(g.shape)}")
        worst = max(worst, float(over.max()))
    launches = dict(build.LAUNCHES)
    log(f"[5] flat int8 API over {len(g_leaves)} lm100m leaves: round-trip "
        f"error minus its bound at most {worst:.3g} (must be <= 0), "
        f"launches {launches}")
    if worst > 0:
        raise AssertionError("flat int8 round trip beyond half a quantum")
    for name in ("quantize_int8", "dequantize_int8"):
        if launches[name] < 1:
            raise AssertionError(f"the flat API never launched {name}")
        results[name]["launches"] = launches[name]

    # small runs on the card (kernels) and on the CPU (plain versions,
    # fused association), with one noise source for both
    cpu_noise = wire.GeneratorNoise(0, torch.device("cpu"))
    for compression, async_rounds in (("int4", False), ("int8", True)):
        small = {}
        for label, device, dispatch in (("card", dev, "auto"),
                                        ("cpu", torch.device("cpu"), "on")):
            small[label] = train_hermes(
                _preset("lmtiny"), steps=8, batch=4, seq=32, pods=3,
                opt_cfg=OptimizerConfig(name="adamw", lr=3e-3),
                hcfg=HermesConfig(alpha=-0.8, lam=2, kernel_dispatch=dispatch,
                                  compression=compression,
                                  async_rounds=async_rounds),
                log_every=10 ** 6, device=device, noise=cpu_noise)
        a, b = small["card"], small["cpu"]
        same_gates = [g for _, _, g in a["history"]] == \
            [g for _, _, g in b["history"]]
        rel = abs(a["global_loss"] - b["global_loss"]) / abs(b["global_loss"])
        log(f"    lmtiny {compression} card vs CPU: gates equal={same_gates},"
            f" merges {a['merges']}/{b['merges']}, global loss rel gap "
            f"{rel:.2e}")
        # The card's and the CPU's fp32 matmuls sum in other orders; over 8
        # AdamW steps at lr 3e-3 that ~1e-6 gap is amplified (Adam's update
        # is ~lr*sign(g) where g is near zero), to ~2e-4 of the loss on an
        # H100.
        if not same_gates or a["merges"] != b["merges"] or rel > 1e-3:
            raise AssertionError(f"lmtiny {compression} on the card "
                                 f"disagrees with the CPU run")

    del w_global, g_leaves
    torch.cuda.empty_cache()
    serving_kernels(torch, dev, results)
    serving_paths(torch, dev, results)
    analyzer(torch, dev, results)
    level_a(torch, dev, results)

    trainer_and_studies(torch, dev, smi)

    # ---- 11. result lines -------------------------------------------------
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
