#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card: the Hermes
trainer, serving, the Level-A cluster simulator, the single trainer with
its checkpoints, the paper's studies, the fleet engine, the two-tier
round with the placed gather, elastic membership, the model zoo with MoE
and MLA, the encoder-decoder and the vision frontend, and the audits of
the Hermes wire.

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
8. the static analyzer's lint, host-sync guard and fixtures
   (``repro_torch.launch.analyze``; its round targets are phase 16) on
   the card, with the launch counters zeroed just before and read just
   after: every ported kernel's launch spec and the pack constants lint
   clean, ``train_hermes``'s loop passes the host-sync guard, and each
   fixture raises its named class; the mis-tiled copy (the last TPU
   kernel, ``selftest_bad_tiles``) launches there and equals its plain
   version bit for bit (the dropped-donation fixture's int4 round adds
   one pack, unpack and packed merge).  Then the copy and ``x.clone()`` are timed on the
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
11. the fleet engine: (a) the quickstart's study on the card under
    deterministic algorithms, each framework through ``engine="vector"``
    and then ``engine="legacy"`` (the same loops: without admission to
    draw, the vector entry must repeat the legacy run): int4 Hermes and
    BSP, then ASP, SSP and SelSync (delta 1.5, so that it both syncs and
    skips) capped at 60 iterations, each pair equal in every
    ``RunResult`` field but the wall time, meter events included, one
    pack and one unpack launch a push on the vector run, replicas on the
    card, both walls printed; (b) the same Hermes at
    ``participation_rate=0.5`` under ``prob`` admission on the vector
    engine: deferred pushes billed 0 bytes and no PS contact, one pack
    and one unpack launch an admitted push; (c) the batch engine on the
    host: ``studies.sim_scale.run(fast=True)`` and one 10k-worker x
    200-round cell with the full churn trace, participation 0.25, 8
    clusters, int8, under 60 s of wall, each cell a ``{"sim_scale": ...}``
    JSON line;
12. the two-tier Level-B round and the placed gather: (a) at lm100m x 4
    pods in 2 clusters, gates open, for ``none``, ``int8`` and ``int4``,
    ``hermes_cluster_round`` bitwise its dispatch + commit, one cluster
    bitwise ``hermes_round``, a commit with a dead gated member bitwise
    the round with its whole cluster shut, both tiers' billed bytes; the
    grouped pack and unpack on the ``(2,) + leaf`` partial tree bitwise
    their plain versions, one launch a pass (``pack_int4[cluster]``,
    ``unpack_int4[cluster]`` in the ``kernels`` line); (b) ``train_hermes``
    at lm100m, 4 pods in 2 clusters, int8 async and (run inside (c))
    int4 sync, each with the launch counters zeroed just before and read
    just after, and lmtiny on the card against the CPU; (c)
    ``launch.placed_audit``: four ranks on
    this card over gloo, the flat and two-tier rounds at lm100m (int4,
    int8), sync, async and closed, bitwise the unplaced ones that this
    process ran first, every gather the bytes of ``dist.wire``'s specs
    (a closed round only the gate exchange, a commit nothing), and the
    placed lm100m
    trainer (6 steps int4, deterministic algorithms) against the unplaced
    one: gates and merges equal, the loss gap printed;
13. elastic membership at lm100m x 4 pods (``launch.elastic``): (a)
    unplaced, ``drop_pod_equivalence`` (pod 1 dies) and
    ``rejoin_pod_equivalence`` (pod 3 dies and rejoins) for ``none``,
    ``int8`` and ``int4`` (the dither keyed by original pod id,
    :class:`PodKeyedNoise`): the resized path bitwise its oracle, the
    merged rounds, the launches of the wire kernels, the wall time of
    every ``elastic_shrink`` and ``elastic_grow``, the wire bytes at 3 and
    4 pods; (b) ``launch.placed_audit``'s elastic cases on four ranks of
    this card over gloo (``drop``, ``rejoin``, ``cluster_resize``; int8
    and int4): every rank's rows bitwise the never-resized oracle, every
    gather its spec at the current pod count, the dead rank silent after
    the shrink, the grow one broadcast of the 498,680,832-byte tree;
14. the model zoo (``launch.steps``): (a) flash attention at MLA's head
    dims, q / k ``D`` against v ``Dv``: deepseek-v2-lite's (192, 128) in
    bf16 decode (Sq 1 and 16 on a 1057-slot cache), bf16 ``flash_prefill``
    and fp32 ``flash_simt`` (B 4, Sq 1024, 16 heads), dsv2-smoke's (24, 16)
    on ``flash_simt`` and ``flash_decode``, each against its plain version
    and timed beside SDPA and the bound (``flash_attention[mla]`` in the
    ``kernels`` line); (b) deepseek-v2-lite-16b at full width through the
    prefill and decode setups, bf16 parameters drawn on the card, batch 4,
    prompt 1024, 32 greedy tokens, with the launch counters zeroed just
    before and read just after (27 ``flash_prefill``, 27 x 32 decode and
    combine), the peak memory held to 40 GB, the first and last layers'
    MLA attention and one layer's sorted MoE held against their plain
    versions; (c) qwen3-8b served at full width through ``launch.serve``
    (36 ``flash_prefill`` launches); (d) the bf16 train setup with fp32
    master weights at dsv2-smoke, 8 steps reducing the loss;
15. the encoder-decoder and the vision frontend: (a) flash attention at
    seamless-m4t-large-v2's non-causal bf16 encoder prefill (D 64, B 4,
    1024 x 1024, 16 heads on 16) and its cross decode (Sq 1 over 1024
    encoder keys), and at llava-next-34b's G 7, D 128 (56 heads on 8)
    prefill (B 2, 1024 queries, and the serve's 6144 timed alone) and
    decode (Sq 1 over a 6176-slot cache), each against its plain version
    and timed beside SDPA with the same mask (``flash_attention[encdec]``
    and ``[vlm]`` in the ``kernels`` line); (b) seamless-m4t-large-v2 at
    full width and depth through ``launch.serve`` (1,632,253,952 fp32
    parameters drawn on the card, bf16 compute, batch 4, 1024 frames, 32
    new tokens), with the launch counters zeroed just before and read
    just after (24 ``flash_prefill``, 1584 decode and 1584 combine), then
    every encoder block and every decoder block at the BOS step held
    against the plain attention on the same input; (c) llava-next-34b at
    full width, 16 of its 60 layers, through the prefill and decode
    setups (bf16 parameters drawn on the card, batch 2, 2880 patch
    embeddings + 3264 tokens, 32 new tokens into a 6176-slot cache; 16
    ``flash_prefill``, 512 decode and 512 combine; the whole process's
    peak held to 40 GB), the first and last layers' attention held to
    fp64; (d) the bf16 train setup at seamless-smoke and llava-smoke, 8
    steps each reducing the loss;
16. the audits of the Hermes wire: (a) the analyzer's round targets
    (``launch.analyze``) on two gloo ranks of this card, one pod a rank:
    the open round ships exactly the billed wire and the closed one only
    the gate exchange, the dispatch carries the gather and the commit no
    collective, ``topk`` and ``prob`` admission at participation 0.5 keep
    the specs, qwen3-8b's smoke train step issues no collective, the
    commit and the train step update their donated trees in place
    (``analysis.donation.DonationAliasing``), the fp32-hoist fixture
    raises ``fp32-model-crossing`` and the functional commit
    ``dropped-donation``; (b)
    ``launch.hermes_dryrun`` at qwen3-8b: the four formats' bills at full
    width and depth on meta tensors, then the round at full width with 1
    of its 36 layers, in bf16, every format, placed on two gloo ranks of
    this card against the unplaced run (bitwise), each rank's gathers the
    bill of the tree that ran, the closed rounds only the gate exchange,
    with the launch counters zeroed just before and read just after (this
    process's and the ranks'), the peak (the unplaced run's, and the two
    ranks' summed) held to 40 GB; (c) the bf16 merges at that tree and 2
    pods, bitwise their plain versions, timed on the card's clock beside
    their bound (``dequant_merge_packed[qwen3-8b bf16]`` and the others in
    the ``kernels`` line);
17. donation and the checkpoint restart: (a) ``train_hermes`` at lm100m
    x 4 pods, fp32, async int4 rounds, 4 steps through the donating pod
    step and commit (``launch.train.make_pod_step``,
    ``make_async_round_fns``), the wire kernels' launches counted
    (``donation_launches`` in the ``kernels`` line); then one pod step and
    one commit at that size, each donating and functional on the same
    inputs (cloned first): bitwise equal, the donating outputs in the
    donated storage under the donation rule (which names the functional
    ones' rebuild), each path's peak and rise in ``max_memory_allocated``
    printed; (b) ``launch.elastic.run_demo`` on 8 gloo ranks sharing the
    card: qwen3-8b's smoke model on a (2, 4) DeviceMesh, checkpointed and
    restored onto (1, 4), the meshes, losses and ``loss_continuous``;
18. the dry run's cost half at qwen3-8b (``launch.dryrun``): (a) its
    train_4k, prefill_32k and decode_32k cells counted on ``meta`` tensors
    at full width, depth and batch (the layer repeat), each ``ok``, with
    the bound on ``roofline.analysis.HW_H100``; (b) prefill_32k (batch 1)
    and decode_32k (batch 4) at all 36 layers with ``impl="kernel"``
    (36 ``flash_prefill``, 36 ``flash_decode`` and combine launches inside
    the step: ``dryrun_launches`` in the ``kernels`` line) and train_4k at
    1 of 36 layers, batch 1, each counted on the card and equal to the
    ``meta`` count of the same cut cell, then timed on the card's clock
    beside its bound, the model-FLOPs share at that time and its peak
    memory beside the count's argument + temp bytes, held to 40 GB;
    (c) each serve cell's flash calls replayed alone, their time beside
    their bound and the rest of the step's time beside its own;
19. a ``kernels`` JSON line, the ``nvidia-smi`` line, and the result line.

It needs the repository's ``src/`` beside it and imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
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
# the wire kernels, rows 1-5 of the kernel table
WIRE_ROWS = ("pack_int4", "unpack_int4", "dequant_merge_packed",
             "loss_weighted_update", "dequant_merge")


# phase 13a's draws of the masked == shrunk checks
DENOM_DRAWS, ROUND_SEEDS = 512, 16


def log(msg: str) -> None:
    print(msg, flush=True)


class PodKeyedNoise:
    """The int4 dither of phase 13, keyed by ORIGINAL pod id: ``noise(ids)``
    is the rounding noise of a round whose stacked rows are the original
    pods ``ids``.  Each leaf draws at the original ``(n_pods,) + leaf``
    shape and keeps the live pods' rows, so a pod rounds alike whether the
    others are masked or dropped (the round's own noise draws over the
    current stacking, which is not resize-invariant).  The slow tier of a
    two-tier round folds the base stream (its rows are clusters).  Module
    level, so the placed audit can hand it to its spawned ranks."""

    def __init__(self, seed: int, device: str, n_pods: int):
        self.seed, self.device, self.n_pods = seed, device, n_pods

    def __call__(self, ids):
        from repro_torch.dist.wire import GeneratorNoise
        return _PodRows(GeneratorNoise(self.seed, self.device), ids,
                        self.n_pods)


class _PodRows:
    def __init__(self, base, ids, n_pods: int):
        self.base, self.ids, self.n_pods = base, list(ids), n_pods

    def __call__(self, round_step, leaf, shape):
        if not shape or shape[0] != len(self.ids):
            return self.base(round_step, leaf, shape)
        full = self.base(round_step, leaf, (self.n_pods,) + tuple(shape[1:]))
        return full[self.ids]

    def fold(self, tag: int):
        return self.base.fold(tag)


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


def costed(name, cost, inputs, outputs):
    """A kernel module's ``cost`` (operations, bytes) of a call, held to
    the bytes of the call's own input and output tensors."""
    from repro_torch.analysis.cost import tensor_bytes
    moved = sum(map(tensor_bytes, list(inputs) + list(outputs)))
    if cost[1] != moved:
        raise AssertionError(f"{name}: cost() says {cost[1]} B, the call "
                             f"moves {moved}")
    return cost


def bound(flops, moved, dtypes):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of the fastest input type, the
    H100 SXM's data sheet as ``roofline.analysis.HW_H100`` holds it (fp32
    outside the tensor cores: TF32 stays off).  ``flops`` and ``moved``
    are a kernel module's ``cost``."""
    from repro_torch.roofline.analysis import HW_H100
    peak = max(HW_H100.peak(dt) for dt in dtypes)
    bytes_ms = 1e3 * moved / HW_H100.hbm_bw
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
                        v.double()).reshape(B, Sq, H, v.shape[-1])


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
    from repro_torch.kernels.flash_attention import cost as flash_cost
    from repro_torch.kernels.flash_attention import (
        design, flash_attention_cuda, flash_attention_plain, visible,
        visible_counts)
    from repro_torch.kernels.rglru_scan import cost as rglru_cost
    from repro_torch.kernels.rglru_scan import grid as rglru_grid
    from repro_torch.kernels.rglru_scan import rglru_cuda, rglru_plain
    from repro_torch.kernels.rglru_scan import (
        vector_path as rglru_vector_path)
    from repro_torch.kernels.rwkv6_scan import cost as wkv6_cost
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
        # order and the kernel rescales once per key tile; outputs are
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
        # the keys and values this run's data needs: the slots some query
        # sees (lm100m prefill: the 512 written of 577)
        pairs, seen = visible_counts(qpos, kvpos, causal=True,
                                     window=window)
        flops, moved = flash_cost(q.shape, k.shape, q.dtype, pairs=pairs,
                                  seen=seen)
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
        flops, moved = costed("wkv6", wkv6_cost(r.shape, r.dtype, u.dtype),
                              (r, k, v, log_w, u, s0), (y, s1))
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
        flops, moved = costed("rglru", rglru_cost((B, T, W)), (a, b, h0),
                              (y, hT))
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

    log("[8] the analyzer's lint, host-sync guard and fixtures, on the card "
        "(its round targets: phase 16)")
    build.reset_launches()
    reports = analyze.check_round_loop_source() + analyze.check_kernels()
    record = {"ok": all(r.ok for r in reports),
              "targets": [r.to_json() for r in reports],
              "self_test": analyze.run_selftests(dev)}
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
    # the copy, and the dropped-donation fixture's int4 dispatch and
    # commit: one pack, one unpack (the residual), one packed merge
    want = {"tile_copy": 1, "pack_int4": 1, "unpack_int4": 1,
            "dequant_merge_packed": 1}
    if (not record["ok"] or launches != want
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
    from repro_torch.kernels.tile_copy import cost as copy_cost
    flops, moved = costed("tile_copy", copy_cost(tuple(x.shape)), (x,),
                          (got,))
    bound_ms, bound_by = bound(flops, moved, (x.dtype,))
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
    from repro_torch.kernels.pack import cost as pack_cost
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
            [q.narrow(ax, 0, d) for q, d, ax in pack_leaves], pack_leaves)
        cases[f"unpack_int4[{arch}]"] = (
            "unpack_int4",
            lambda lv=unpack_leaves: unpack_int4_group_cuda(lv),
            lambda lv=unpack_leaves: unpack_int4_group_plain(lv), wires,
            unpack_leaves)
        log(f"[9b] {arch}: {len(pack_leaves)} leaves, blocked axes and real "
            f"lengths {[(ax, d) for _, d, ax in pack_leaves]}; int4 push "
            f"{payload_bytes(params, 'int4'):,} B (none "
            f"{payload_bytes(params, 'none'):,})")
    for name, (kernel, kern, plain, inputs, leaves) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version")
        flops, moved = costed(name, pack_cost(kernel, [
            (t.shape, d, ax) for t, d, ax in leaves]), inputs, got)
        bound_ms, bound_by = bound(flops, moved, (torch.int8,))
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


def fleet_engine(torch, dev, results) -> None:
    """Phase 11: the fleet engine.  ``engine="vector"`` against the legacy
    loops on the card, Level-A participation admission on it, and the
    batch engine's sweep on the host."""
    import dataclasses
    from repro_torch.config import HermesConfig
    from repro_torch.core.allocator import Allocation
    from repro_torch.core.bundles import make_paper_bundle
    from repro_torch.core.simulator import RunResult, run_framework
    from repro_torch.kernels import build
    from repro_torch.studies import sim_scale

    t_phase = time.perf_counter()
    fields = [f.name for f in dataclasses.fields(RunResult)
              if f.name not in ("wall_time", "meter_events")]

    def run(label, framework, engine, **kw):
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        r = run_framework(framework, bundle, engine=engine, device=dev,
                          **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        if r.device != str(dev):
            raise AssertionError(f"{label} {engine}: replicas on {r.device}")
        return r, wall, launches

    # (a) the quickstart's study (phase 9c's settings), each framework on
    # both engines.  Deterministic algorithms and cuDNN keep each op's
    # result repeatable, so the two engines, which run the same loops
    # when there is no admission to draw, must agree bit for bit.  warn_only: cuBLAS's own determinism check
    # would raise without CUBLAS_WORKSPACE_CONFIG; one stream and fixed
    # shapes keep its GEMMs repeatable (as in phase 10a).
    bundle, _ = make_paper_bundle("mnist", n=3000, eval_batch=128)
    base = dict(num_workers=6, target_acc=0.90, max_iterations=500,
                max_wall=60, init_alloc=Allocation(128, 16), eval_every=3)
    hermes = HermesConfig(alpha=-1.3, beta=0.1, lam=5, eta=bundle.eta)
    cases = (("hermes", dict(hermes_cfg=hermes)), ("bsp", {}),
             ("asp", dict(max_iterations=60)),
             ("ssp", dict(max_iterations=60, ssp_s=2)),
             ("selsync", dict(max_iterations=60, selsync_delta=1.5)))
    log("[11a] the quickstart on both engines, deterministic algorithms: "
        "mnist n 3000, 6 workers, Allocation(128, 16), target 0.90; ASP, "
        "SSP (s 2) and SelSync (delta 1.5) capped at 60 iterations")
    engine_launches = 0
    deterministic = torch.are_deterministic_algorithms_enabled()
    cudnn = torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for framework, kw in cases:
                kw = dict(base, **kw)
                vec, vec_wall, vec_launches = run(framework, framework,
                                                  "vector", **kw)
                leg, leg_wall, _ = run(framework, framework, "legacy", **kw)
                differ = [f for f in fields
                          if getattr(vec, f) != getattr(leg, f)]
                if list(vec.meter_events) != list(leg.meter_events):
                    differ.append("meter_events")
                pushes = sum(p for *_, p in vec.gup_trace)
                log(f"    {framework:8s} {vec.iterations} iterations, "
                    f"{vec.ps_updates} PS updates, sim {vec.sim_time:.3f} "
                    f"s, acc {vec.conv_acc:.3f}, {vec.api_calls} API calls"
                    f", {len(vec.meter_events)} meter events; wall vector "
                    f"{vec_wall:.2f} s, legacy {leg_wall:.2f} s; fields "
                    f"that differ {differ}; vector launches {vec_launches}")
                if differ:
                    raise AssertionError(f"{framework}: the vector engine "
                                         f"differs from legacy in {differ}")
                want = {"pack_int4": pushes, "unpack_int4": pushes} \
                    if framework == "hermes" else {}
                if vec_launches != want or (framework == "hermes"
                                            and pushes < 1):
                    raise AssertionError(f"{framework}: {pushes} int4 "
                                         f"pushes, launches {vec_launches}")
                syncs = vec.calls_by_kind.get("push", 0)
                if framework == "selsync" \
                        and not 0 < syncs < vec.iterations:
                    raise AssertionError(f"selsync: {syncs} syncs in "
                                         f"{vec.iterations} iterations: "
                                         f"one of its paths never ran")
                engine_launches += pushes
    finally:
        torch.use_deterministic_algorithms(deterministic)
        torch.backends.cudnn.deterministic = cudnn

    # (b) Level-A participation admission, which only engine="vector"
    # has: an open gate ships with probability 0.5
    hcfg = dataclasses.replace(hermes, participation_rate=0.5,
                               admission="prob")
    r, wall, launches = run("hermes prob", "hermes", "vector",
                            hermes_cfg=hcfg, **base)
    opened = sum(p for *_, p in r.gup_trace)
    deferred = [e for e in r.meter_events if e[2] == "push_deferred"]
    admitted = r.calls_by_kind.get("push", 0)
    log(f"[11b] Hermes int4 at participation 0.5, prob, vector: "
        f"{r.iterations} iterations, {opened} open gates, {admitted} "
        f"admitted, {len(deferred)} deferred (billed "
        f"{r.bytes_by_kind.get('push_deferred', 0.0)} B, "
        f"{r.calls_by_kind.get('push_deferred', 0)} PS contacts), sim "
        f"{r.sim_time:.3f} s, acc {r.conv_acc:.3f}, wall {wall:.2f} s, "
        f"launches {launches}")
    if (not deferred or admitted < 1 or admitted + len(deferred) != opened
            or any(e[3] != 0.0 for e in deferred)
            or r.calls_by_kind.get("push_deferred", 0) != 0
            or launches != {"pack_int4": admitted,
                            "unpack_int4": admitted}):
        raise AssertionError(f"participation 0.5: {opened} open, "
                             f"{admitted} admitted, {len(deferred)} "
                             f"deferred, launches {launches}")
    engine_launches += admitted
    for kernel in ("pack_int4", "unpack_int4"):
        results[f"{kernel}[mnist-cnn]"]["engine_launches"] = engine_launches
    torch.cuda.empty_cache()

    # (c) the batch engine on the host: the sweep's fast tiers, then the
    # fleet at scale
    build.reset_launches()
    t0 = time.perf_counter()
    sweep = sim_scale.run(fast=True, device=dev)
    big = sim_scale._cell(10_000, 200, 0.25, 8, "int8", device=dev)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    for cell in sweep["cells"] + [big]:
        print(json.dumps({"sim_scale": cell}), flush=True)
    log(f"[11c] sim_scale: {len(sweep['cells'])} fast cells and the 10k x "
        f"200 cell (full churn, participation 0.25, 8 clusters, int8): "
        f"{big['iterations']} iterations, {big['ps_updates']} PS updates, "
        f"{big['meter_events']} meter events, wall {big['wall_s']} s; "
        f"{wall:.1f} s in all, launches {launches}")
    if big["wall_s"] >= 60.0 or big["iterations"] <= 10_000 * 100 \
            or launches:
        raise AssertionError(f"the 10k x 200 cell: {big}, launches "
                             f"{launches}")
    log(f"[11] phase wall {time.perf_counter() - t_phase:.1f} s")


def two_tier(torch, dev, results) -> None:
    """Phase 12: the two-tier Level-B round and the placed gather.  (a)
    the two-tier round unplaced at lm100m x 4 pods in 2 clusters, gates
    open, against its own twins bitwise, and the grouped pack and unpack
    on the ``(2,) + leaf`` partial tree; (b) the two-tier trainer; (c)
    four ranks on this card over gloo, placed rounds and trainer against
    the unplaced ones."""
    from repro_torch.config import HermesConfig, OptimizerConfig
    from repro_torch.core.gup import gup_gate
    from repro_torch.dist import hermes_sync as hs
    from repro_torch.dist import wire
    from repro_torch.kernels import build
    from repro_torch.kernels.pack import cost as pack_cost
    from repro_torch.kernels.pack import (
        pack_int4_group_cuda, pack_int4_group_plain, unpack_int4_group_cuda,
        unpack_int4_group_plain)
    from repro_torch.launch import placed_audit
    from repro_torch.launch.train import _preset, train_hermes
    from repro_torch.models.lm import init_lm
    from repro_torch.utils.trees import (
        flatten_up_to, tree_flatten, tree_leaves, tree_map)

    t_phase = time.perf_counter()
    cfg = _preset("lm100m")
    w = init_lm(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    pods = tree_map(lambda g: g[None] + 1e-3 * torch.randn(
        (PODS,) + tuple(g.shape), generator=gen, device=dev), w)
    meta = [torch.empty(g.shape, device="meta") for g in tree_leaves(w)]
    noise = wire.GeneratorNoise(12, dev)
    losses = torch.tensor([2.1, 2.2, 2.0, 2.3], device=dev)
    L = torch.tensor(3.4, device=dev)
    on = torch.ones(PODS, dtype=torch.bool, device=dev)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(a), tree_leaves(b)))

    # (a) the round's twins, bitwise, with the gates forced open by a loss
    # history the round's losses beat
    log("[12a] two-tier round at lm100m x 4 pods, 2 clusters, gates open")
    expected_bytes = {"int4": (257_132_592, 128_566_296),
                      "int8": (506_473_008, 253_236_504)}
    for mode in ("none", "int8", "int4"):
        cfgs = {c: HermesConfig(compression=mode, n_clusters=c)
                for c in (1, 2)}
        gup = hs.hermes_pod_state(cfgs[2], PODS, dev)
        for level in (3.0, 3.2):
            _, gup = gup_gate(gup, torch.full((PODS,), level, device=dev),
                              cfgs[2])
        kw = dict(round_step=1, noise=noise)
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        sync = hs.hermes_cluster_round(pods, gup, losses, w, L, cfgs[2], **kw)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        dp = hs.hermes_cluster_dispatch(pods, gup, losses, w, L, cfgs[2],
                                        **kw)
        slow_billed = sum(wire.payload_nbytes(p) for p in flatten_up_to(
            tree_flatten(w)[1], dp["pending"]["cluster_payload"]))
        cm = hs.hermes_cluster_commit(pods, dp["pending"], w, cfg=cfgs[2])
        split = same([sync["w_global"], sync["pod_params"], sync["error"]
                      or []], [cm["w_global"], cm["pod_params"],
                               dp["error"] or []])
        del dp["pending"]
        dead = hs.hermes_cluster_commit(
            pods, hs.hermes_cluster_dispatch(pods, gup, losses, w, L,
                                             cfgs[2], **kw)["pending"],
            w, cfg=cfgs[2], live=torch.tensor([True, True, True, False],
                                              device=dev))
        shut = hs.hermes_cluster_round(
            pods, gup, losses, w, L, cfgs[2],
            live=torch.tensor([True, True, False, False], device=dev), **kw)
        drop = same([dead["w_global"], dead["pod_params"]],
                    [shut["w_global"], shut["pod_params"]]) \
            and dead["gates"].tolist() == [True, True, False, False]
        del dead, shut, cm
        one = hs.hermes_cluster_round(pods, gup, losses, w, L, cfgs[1], **kw)
        flat = hs.hermes_round(pods, gup, losses, w, L, cfgs[1], **kw)
        delegate = same([one["w_global"], one["pod_params"]],
                        [flat["w_global"], flat["pod_params"]])
        del one, flat
        fast = PODS * sum(b for *_, b in wire.wire_operand_specs(meta, mode,
                                                                 PODS))
        slow = 2 * sum(b for *_, b in wire.cluster_wire_operand_specs(
            meta, mode, 2))
        moved = sum(float((a - b).abs().max()) > 0 for a, b in
                    zip(tree_leaves(sync["w_global"]), tree_leaves(w)))
        log(f"    {mode:4s} round {ms:7.1f} ms (wall), launches {launches}; "
            f"bitwise: dispatch + commit {split}, one cluster == "
            f"hermes_round {delegate}, dead gated member drops its "
            f"cluster {drop}; fast tier {fast:,} B, slow tier {slow:,} B "
            f"(pending cluster payload {slow_billed:,} B); "
            f"{moved}/{len(meta)} leaves moved")
        want = expected_bytes.get(mode, (fast, slow))
        if not (split and delegate and drop and bool(sync["gates"].all())
                and (fast, slow) == want and slow_billed == slow
                and moved == len(meta)):
            raise AssertionError(f"two-tier {mode} round at lm100m")
        if mode == "int4" and (launches.get("pack_int4") != 2
                               or launches.get("unpack_int4") != 3):
            raise AssertionError(f"two-tier int4 launches {launches}")
        del sync
    # the slow tier's re-encode: grouped pack and unpack on the (2,) + leaf
    # partial tree, against their plain versions
    fmt = wire.get_format("int4")
    cnoise = noise.fold(hs.CLUSTER_FOLD)
    leaves = []
    for i, g in enumerate(tree_leaves(w)):
        part = 1e-3 * torch.randn((2,) + tuple(g.shape), generator=gen,
                                  device=dev)
        q, _, _, ax, d, _ = fmt._quantize(part, (1, i), cnoise)
        leaves.append((q, d, ax))
    wires = pack_int4_group_plain(leaves)
    unpack_leaves = [(p, d, ax) for p, (_, d, ax) in zip(wires, leaves)]
    for name, kernel, kern, plain, inputs, lv in (
            ("pack_int4[cluster]", "pack_int4",
             lambda: pack_int4_group_cuda(leaves),
             lambda: pack_int4_group_plain(leaves),
             [q.narrow(ax, 0, d) for q, d, ax in leaves], leaves),
            ("unpack_int4[cluster]", "unpack_int4",
             lambda: unpack_int4_group_cuda(unpack_leaves),
             lambda: unpack_int4_group_plain(unpack_leaves), wires,
             unpack_leaves)):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version")
        flops, moved_b = costed(name, pack_cost(kernel, [
            (t.shape, d, ax) for t, d, ax in lv]), inputs, got)
        bound_ms, bound_by = bound(flops, moved_b, (torch.int8,))
        build.reset_launches()
        kern()
        per_pass = build.LAUNCHES[kernel]
        wall_ms = time_ms(torch, kern, reps=20)
        ms = device_ms(torch, kern)
        plain_ms = time_ms(torch, plain, reps=3, warmup=1)
        results[name] = {
            "name": name, "route": "cuda", "source": WIRE_SOURCE,
            "replaces": REPLACES[kernel], "launches": None,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "wall_ms": wall_ms, "launches_per_pass": per_pass}
        log(f"    {name:22s} equal=True  kernel {ms:.4f} ms [wall "
            f"{wall_ms:.4f}; {per_pass} launches a pass]  plain "
            f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}; "
            f"{moved_b:,} B)  {bound_ms / ms:5.1%} of the bound")
        if per_pass != 1:
            raise AssertionError(f"{name}: {per_pass} launches a pass")
        del got, want
    del leaves, wires, unpack_leaves, pods, w
    torch.cuda.empty_cache()

    # (b) the two-tier trainer at lm100m, int8 async (int4 sync is (c)'s
    # unplaced run), then lmtiny on the card against the CPU (plain
    # versions, one noise source)
    opt = OptimizerConfig(name="adamw", lr=3e-4)
    for mode, async_rounds, steps in (("int8", True, 6),):
        build.reset_launches()
        t0 = time.perf_counter()
        out = train_hermes(cfg, steps=steps, batch=8, seq=128, pods=PODS,
                           opt_cfg=opt,
                           hcfg=HermesConfig(alpha=-1.3, lam=2,
                                             compression=mode, n_clusters=2,
                                             async_rounds=async_rounds),
                           log_every=10 ** 6, seed=0, device=dev)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        finite = all(math.isfinite(x) for x in
                     [out["global_loss"]] + out["pod_losses"])
        log(f"[12b] lm100m 2 clusters {mode} "
            f"{'async' if async_rounds else 'sync'}: {steps} steps, "
            f"{out['rounds']} rounds, {out['merges']} merges (dispatched "
            f"{out['dispatched']}, committed {out['committed']}), global "
            f"loss {out['global_loss']:.4f}, {out['ms_per_step']:.1f} "
            f"ms/step, {out['ms_per_round']:.1f} ms/round, wall {wall:.1f} "
            f"s, launches {launches}; gates per round "
            f"{[g for _, _, g in out['history']]}")
        if (not finite or out["merges"] < 1 or not out["drained"]
                or out["dispatched"] != out["committed"]):
            raise AssertionError(f"two-tier trainer {mode}: {out}")
    cpu_noise = wire.GeneratorNoise(0, torch.device("cpu"))
    for mode, async_rounds in (("int4", False), ("int8", True)):
        small = {}
        for label, device in (("card", dev), ("cpu", torch.device("cpu"))):
            small[label] = train_hermes(
                _preset("lmtiny"), steps=8, batch=4, seq=32, pods=4,
                opt_cfg=OptimizerConfig(name="adamw", lr=3e-3),
                hcfg=HermesConfig(alpha=-0.8, lam=2, compression=mode,
                                  n_clusters=2, async_rounds=async_rounds),
                log_every=10 ** 6, device=device, noise=cpu_noise)
        a, b = small["card"], small["cpu"]
        same_gates = [g for _, _, g in a["history"]] == \
            [g for _, _, g in b["history"]]
        rel = abs(a["global_loss"] - b["global_loss"]) / abs(b["global_loss"])
        log(f"    lmtiny 2 clusters {mode} card vs CPU: gates equal="
            f"{same_gates}, merges {a['merges']}/{b['merges']}, global loss "
            f"rel gap {rel:.2e}")
        # as phase 5's small runs: AdamW amplifies the matmuls' ~1e-6
        # order gap to ~2e-4 of the loss over 8 steps
        if not same_gates or a["merges"] != b["merges"] or rel > 1e-3:
            raise AssertionError(f"lmtiny two-tier {mode} on the card "
                                 f"disagrees with the CPU run")
    torch.cuda.empty_cache()

    # (c) placed: 4 ranks on this card over gloo, against the unplaced
    # rounds and trainer that this process runs first (then frees); that
    # unplaced trainer is the two-tier int4 sync main path, its launch
    # counters zeroed just before it and read just after
    t0 = time.perf_counter()
    audit = placed_audit.audit(
        "lm100m", ranks=4, n_pods=PODS, n_clusters=2,
        formats=("int4", "int8"), cases=placed_audit.CASES,
        train=dict(steps=6, batch=8, seq=128, lr=3e-4, compression="int4",
                   async_rounds=False), device=dev, deterministic=True)
    bad = []
    for key, case in audit["cases"].items():
        gathers = [c == case["expected"] for c in case["collectives"]]
        per_rank = [sum(b for *_, b in ph) for ph in
                    case["collectives"][0].values()]
        log(f"[12c] placed {key}: bitwise {case['equal']}, gathers as the "
            f"specs {gathers}, bytes a rank {per_rank}, merged "
            f"{case['merged']}, launches a rank {case['launches'][0]}, "
            f"{case['seconds']:.1f} s")
        if not (case["equal"] and all(gathers) and all(
                m == case["unplaced_merged"] for m in case["merged"])):
            bad.append(key)
    for key, kernel in (("int4/flat", "dequant_merge_packed"),
                        ("int8/flat", "dequant_merge")):
        n = audit["cases"][key]["launches"][0].get(kernel, 0)
        if n < 1:
            bad.append(f"{key} launched no {kernel}")
        results[kernel]["placed_launches"] = n
    for kernel in ("pack_int4", "unpack_int4"):
        results[kernel]["placed_launches"] = \
            audit["cases"]["int4/cluster"]["launches"][0].get(kernel, 0)
    want = audit["train"]["unplaced"]
    log(f"[12b] lm100m 2 clusters int4 sync (deterministic algorithms): "
        f"{len(want['history'])} rounds, {want['merges']} merges, global "
        f"loss {want['global_loss']:.4f}, {want['ms_per_step']:.1f} "
        f"ms/step, {want['ms_per_round']:.1f} ms/round, launches "
        f"{want['launches']}; gates per round "
        f"{[g for _, _, g in want['history']]}")
    for kernel in ("pack_int4", "unpack_int4"):
        if want["launches"].get(kernel, 0) < 1 or want["merges"] < 1:
            raise AssertionError(f"the two-tier trainer never launched "
                                 f"{kernel} or never merged")
        results[f"{kernel}[cluster]"]["launches"] = want["launches"][kernel]
    for rank, got in enumerate(audit["train"]["placed"]):
        gates = [g for _, _, g in got["history"]] == \
            [g for _, _, g in want["history"]]
        gap = max([abs(a[1] - b[1]) for a, b in zip(got["history"],
                                                    want["history"])]
                  + [abs(got["global_loss"] - want["global_loss"])]
                  + [abs(a - b) for a, b in zip(got["pod_losses"],
                                                want["pod_losses"])])
        log(f"    placed lm100m trainer rank {rank}: gates equal {gates}, "
            f"merges {got['merges']}/{want['merges']}, losses bitwise "
            f"{gap == 0.0} (largest gap {gap:.3g}), "
            f"{got['ms_per_step']:.1f} ms/step, {got['ms_per_round']:.1f} "
            f"ms/round, launches {got['launches']}")
        if not gates or got["merges"] != want["merges"]:
            bad.append(f"placed trainer rank {rank}")
    log(f"    audit {time.perf_counter() - t0:.1f} s (unplaced "
        f"{audit['unplaced_s']:.1f} s)")
    if bad:
        raise AssertionError(f"placed runs differ: {bad}")
    log(f"[12] phase wall {time.perf_counter() - t_phase:.1f} s")


def elastic(torch, dev, results) -> None:
    """Phase 13: elastic membership at lm100m x 4 pods.  (a) masked ==
    shrunk over many draws (the merge's denominator, then whole rounds),
    and the shrink and rejoin proofs unplaced, with every resize timed;
    (b) the placed elastic cases and proofs on four ranks of this card."""
    from repro_torch.config import HermesConfig
    from repro_torch.dist import hermes_sync as hs
    from repro_torch.dist import wire
    from repro_torch.kernels import build
    from repro_torch.launch import elastic as el
    from repro_torch.launch import placed_audit
    from repro_torch.launch.train import _preset
    from repro_torch.models.lm import init_lm
    from repro_torch.utils.trees import tree_leaves, tree_map

    t_phase = time.perf_counter()
    w = init_lm(_preset("lm100m"), 0, dev)
    meta = [torch.empty(g.shape, device="meta") for g in tree_leaves(w)]
    tree_bytes = sum(g.numel() * g.element_size() for g in tree_leaves(w))

    def lm100m(n_pods, cfg, seed, device):
        gen = torch.Generator(device=device).manual_seed(13 + seed)
        pods = tree_map(lambda g: g[None] + 1e-3 * torch.randn(
            (n_pods,) + tuple(g.shape), generator=gen, device=device), w)
        return pods, w, hs.hermes_pod_state(cfg, n_pods, device)

    # every resize timed, every merge counted, through the module's names
    walls = {"elastic_shrink": [], "elastic_grow": []}
    merges = [0]
    real = {k: getattr(el, k) for k in walls}
    real_merge = hs.hermes_merge

    def timed(name):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*args, **kw)
            torch.cuda.synchronize()
            walls[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    def merge(*args, **kw):
        merges[0] += 1
        return real_merge(*args, **kw)

    total = dict.fromkeys(WIRE_ROWS, 0)
    expected_bytes = {"int4": (192_849_444, 257_132_592),
                      "int8": (379_854_756, 506_473_008)}
    # the merge's denominator: a masked pod's zero weight must add nothing,
    # over many draws with two or more survivors open (a device reduction
    # regroups with the length)
    gen = torch.Generator(device=dev).manual_seed(24)
    L = torch.tensor(3.4, device=dev)
    differ = 0
    for i in range(DENOM_DRAWS):
        keep = [p for p in range(PODS) if p != i % PODS]
        losses = 0.2 + 4.0 * torch.rand(PODS, generator=gen, device=dev)
        gates = torch.rand(PODS, generator=gen, device=dev) < 0.75
        gates[i % PODS] = False
        if int(gates[keep].sum()) < 2:
            gates[keep] = True
        differ += not torch.equal(hs._merge_weights(gates, losses, L)[2],
                                  hs._merge_weights(gates[keep],
                                                    losses[keep], L)[2])
    log(f"[13a] merge denominator masked == shrunk: {differ} of "
        f"{DENOM_DRAWS} draws differ")
    if differ:
        raise AssertionError(f"the merge's denominator differs masked and "
                             f"shrunk in {differ} of {DENOM_DRAWS} draws")

    def masked_vs_shrunk(cfg, seed, noise, state, losses):
        """One round at 4 rows, pod ``seed % 4`` masked, against the round
        at the survivors' rows: whether every survivor opened and every
        tensor is bitwise."""
        dead = seed % PODS
        keep = [p for p in range(PODS) if p != dead]
        live = torch.tensor([p != dead for p in range(PODS)], device=dev)
        pods, wg, gup = state
        for level in (3.0, 3.2):
            gup = hs.gup_gate(gup, torch.full((PODS,), level, device=dev),
                              cfg)[1]
        losses = losses.clone()
        losses[dead] = float("nan")
        big = hs.hermes_round(
            pods, gup, losses, wg, L, cfg, live=live, round_step=5,
            noise=noise and noise(range(PODS)))
        small = hs.hermes_round(
            el.shrink_pod_tree(pods, keep), el.shrink_pod_tree(gup, keep),
            losses[keep], wg, L, cfg, round_step=5,
            noise=noise and noise(keep))
        return big["gates"].tolist() == live.tolist() and all(
            torch.equal(a, b) for a, b in zip(
                tree_leaves([big["w_global"], el.shrink_pod_tree(
                    [big["pod_params"], big["error"] or []], keep)]),
                tree_leaves([small["w_global"], [small["pod_params"],
                                                 small["error"] or []]])))

    el.elastic_shrink, el.elastic_grow = timed("elastic_shrink"), \
        timed("elastic_grow")
    hs.hermes_merge = merge
    try:
        for mode in ("none", "int8", "int4"):
            cfg = HermesConfig(alpha=-0.5, beta=0.1, lam=2, window=4,
                               compression=mode, min_live_pods=1,
                               rejoin_cost_rounds=0.5)
            noise = PodKeyedNoise(13, str(dev), PODS) \
                if mode == "int4" else None
            # the invariant under the proofs, with every survivor open
            # (the demo schedule opens one pod a round): a round at 4
            # rows with one pod masked is bitwise the round at 3 rows, at
            # lm100m with pod 1 masked and on the toy tree over many seeds
            held = masked_vs_shrunk(
                cfg, 1, noise, lm100m(PODS, cfg, 1, dev),
                torch.tensor([2.1, 2.2, 2.0, 2.3], device=dev))
            bad_seeds = [seed for seed in range(ROUND_SEEDS)
                         if not masked_vs_shrunk(
                             cfg, seed, noise and PodKeyedNoise(
                                 seed, str(dev), PODS),
                             el._toy_pod_state(PODS, cfg, seed, dev),
                             1.0 + 1.9 * torch.rand(
                                 PODS, generator=torch.Generator(
                                     device=dev).manual_seed(100 + seed),
                                 device=dev))]
            log(f"[13a] {mode:4s} masked == shrunk with 3 open gates: "
                f"lm100m {held}; toy tree, seeds that differ {bad_seeds} "
                f"of {ROUND_SEEDS}")
            if not held or bad_seeds:
                raise AssertionError(f"{mode}: a masked round differs from "
                                     f"the shrunk round")
            wire_b = tuple(n * sum(b for *_, b in wire.wire_operand_specs(
                meta, mode, n)) for n in (PODS - 1, PODS))
            for proof, kw in ((el.drop_pod_equivalence, {"drop": 1}),
                              (el.rejoin_pod_equivalence, {})):
                for v in walls.values():
                    v.clear()
                merges[0] = 0
                torch.cuda.synchronize()
                build.reset_launches()
                t0 = time.perf_counter()
                out = proof(n_pods=PODS, cfg=cfg, device=dev,
                            init_state=lm100m, pod_noise=noise, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {k: v for k, v in build.LAUNCHES.items() if v}
                for k in WIRE_ROWS:
                    total[k] += launches.get(k, 0)
                log(f"[13a] {proof.__name__} {mode:4s}: bitwise "
                    f"{out['bit_identical']}, {out['rounds']} rounds a "
                    f"path, {merges[0]} merged rounds (both paths), "
                    f"launches {launches}; elastic_shrink ms "
                    f"{[round(x, 3) for x in walls['elastic_shrink']]}, "
                    f"elastic_grow ms "
                    f"{[round(x, 3) for x in walls['elastic_grow']]}; "
                    f"wire at 3 / 4 pods {wire_b[0]:,} / {wire_b[1]:,} B; "
                    f"{wall:.1f} s")
                if not out["bit_identical"] or merges[0] < 2:
                    raise AssertionError(f"{proof.__name__} {mode}: {out}")
                if wire_b != expected_bytes.get(mode, wire_b):
                    raise AssertionError(f"{mode} wire bytes {wire_b}")
                if mode == "int4" and not all(
                        launches.get(k, 0) >= 1 for k in WIRE_ROWS[:3]):
                    raise AssertionError(f"int4 proofs launched {launches}")
                if mode == "int8" and launches.get("dequant_merge", 0) < 1:
                    raise AssertionError(f"int8 proofs launched {launches}")
                # one grouped launch a merge of the fp32 tree (14 leaves)
                if mode == "none" and \
                        launches.get("loss_weighted_update", 0) != merges[0]:
                    raise AssertionError(f"none proofs launched {launches} "
                                         f"for {merges[0]} merges")
                del out
    finally:
        el.elastic_shrink, el.elastic_grow = real["elastic_shrink"], \
            real["elastic_grow"]
        hs.hermes_merge = real_merge
    del w
    torch.cuda.empty_cache()

    # (b) placed: the resize on four ranks of this card over gloo against
    # the never-resized rounds that this process runs first
    t0 = time.perf_counter()
    audit = placed_audit.audit(
        "lm100m", ranks=4, n_pods=PODS, n_clusters=2,
        formats=("int8", "int4"), cases=(), elastic=placed_audit.ELASTIC,
        pod_noise=PodKeyedNoise(13, str(dev), PODS), device=dev)
    survivors = {"drop": [[0], [], [2], [3]]}
    bad = []
    for key, case in audit["elastic"].items():
        fmt, name = key.split("/")
        specs = [c == e for c, e in zip(case["collectives"],
                                        case["expected"])]
        merged = all(all(case["unplaced_merged"][r] == m
                         for r, m in got.items()) for got in case["merged"])
        grow = [ph.get("grow") for ph in case["collectives"]]
        held = case["rows"] == survivors.get(name, [[0], [1], [2], [3]])
        tiers = all(t.get("grown", t["start"]) == t["start"]
                    for t in case["tiers"])
        for launches in case["launches"]:
            for k in WIRE_ROWS:
                total[k] += launches.get(k, 0)
        log(f"[13b] placed {key}: bitwise {case['equal_per_rank']}, "
            f"rows {case['rows']}, gathers as the specs {specs}, merged "
            f"as the oracle {merged} ({sum(case['unplaced_merged'].values())}"
            f"/{len(case['unplaced_merged'])} rounds), members "
            f"{case['members'][0]}, grow {grow[0]}, tiers restored {tiers}, "
            f"launches a rank {case['launches']}, {case['seconds']:.1f} s; "
            f"shrink ms {[round(m.get('shrink', 0.0), 3) for m in case['ms']]}"
            f", grow ms {[round(m.get('grow', 0.0), 3) for m in case['ms']]}")
        if not (case["equal"] and all(specs) and merged and held and tiers):
            bad.append(key)
        if name != "drop" and grow != [[["pod/broadcast", "uint8",
                                         [tree_bytes], tree_bytes]]] * 4:
            bad.append(f"{key} grow {grow}")
        if name == "cluster_resize" and \
                case["cross_cluster_refused"] != [True] * 4:
            bad.append(f"{key} cross-cluster shrink not refused")
    for fmt, per in audit["proofs"].items():
        held = [r["drop"]["bit_identical"] and r["rejoin"]["bit_identical"]
                for r in per]
        log(f"[13b] placed drop and rejoin proofs {fmt}, each rank its own "
            f"rows: bitwise {held}")
        if len(held) != 4 or not all(held):
            bad.append(f"{fmt} placed proofs")
    log(f"    audit {time.perf_counter() - t0:.1f} s (unplaced "
        f"{audit['unplaced_s']:.1f} s); grow broadcast {tree_bytes:,} B")
    if tree_bytes != 498_680_832:
        bad.append(f"lm100m tree {tree_bytes} B")
    if bad:
        raise AssertionError(f"placed elastic cases differ: {bad}")
    for k in WIRE_ROWS:
        results[k]["elastic_launches"] = total[k]
        if total[k] < 1:
            raise AssertionError(f"phase 13 never launched {k}")
    log(f"[13] launches of rows 1-5 in phase 13 (unplaced, and every rank "
        f"of the placed cases): {total}")
    log(f"[13] phase wall {time.perf_counter() - t_phase:.1f} s")


def by_kv_head(torch, fn, q, k, v, *args, **kw):
    """``fn(q, k, v, *args, **kw)`` one KV head at a time (KV head j's keys
    and values with its query heads ``[G j, G j + G)``), the outputs
    joined on the head axis: for shapes whose scores over all heads at
    once would not fit the card (llava's 6144-query prefill, B 2: 17 GB
    of fp32 scores over its 56 heads, 2.1 GB over one KV head's 7)."""
    G = q.shape[2] // k.shape[2]
    return torch.cat([fn(q[:, :, j * G:(j + 1) * G], k[:, :, j:j + 1],
                         v[:, :, j:j + 1], *args, **kw)
                      for j in range(k.shape[2])], dim=2)


def flash_case(torch, dev, gen, label, B, Sq, H, K, D, Dv, q0, kvpos, dt,
               causal=True):
    """One flash attention case on the design the wrapper picks: q ``(B, Sq,
    H, D)`` from position ``q0`` over k / v ``(B, Skv, K, D / Dv)`` at
    ``kvpos`` (-1 unwritten), random N(0, 1) in ``dt``; held against the
    plain version (one KV head at a time where its fp32 scores over all
    heads pass 4 GiB), then timed (``device_ms``, the wall of
    back-to-back calls) beside the plain version, called as it was held,
    and one SDPA call with the same boolean mask; returns the ``kernels``
    entry."""
    from repro_torch.kernels.flash_attention import cost as flash_cost
    from repro_torch.kernels.flash_attention import (
        design, flash_attention_cuda, flash_attention_plain, visible)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16 = torch.bfloat16
    Skv = kvpos.numel()
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
               for shape in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, Dv)))
    qpos = torch.arange(q0, q0 + Sq, dtype=torch.int32, device=dev)
    kw = dict(causal=causal, scale=D ** -0.5)
    kind = design(Sq, D, dt, Dv)
    got = flash_attention_cuda(q, k, v, qpos, kvpos, **kw)
    torch.cuda.synchronize()

    def plain():
        if B * H * Sq * Skv * 4 <= 2 ** 32:
            return flash_attention_plain(q, k, v, qpos, kvpos, **kw)
        return by_kv_head(torch, flash_attention_plain, q, k, v, qpos,
                          kvpos, **kw)
    want = plain()
    gap = (got.float() - want.float()).abs()
    err = float(gap.max())
    # as phase 6: fp32 sums in another order (2e-5 is ~100 fp32 ulps of
    # these means of N(0, 1) values); bf16 one rounding of one fp32
    # result on each side, one bf16 ulp apart
    tol = 2e-5 + (2 ** -7 * want.float().abs() if dt == bf16 else 0)
    if bool((gap > tol).any()):
        raise AssertionError(f"flash {label} [{kind}]: max abs err "
                             f"{err} against its plain version")
    del want, gap
    torch.cuda.empty_cache()
    plain_ms = time_ms(torch, plain, reps=3, warmup=1)
    if got.shape != (B, Sq, H, Dv) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash {label} [{kind}]: shape "
                             f"{tuple(got.shape)} or not finite")
    # without a causal or window term the mask is one row: broadcast it
    mask = visible(qpos, kvpos, causal=causal, window=0).expand(Sq, Skv)
    pairs = int(mask.sum())
    # the keys and values this run's data needs: the slots some query sees
    # (seamless's self decode: 33 written of 1057)
    seen = int(mask.any(0).sum())
    flops, moved = flash_cost(q.shape, k.shape, dt, Dv, pairs=pairs,
                              seen=seen)
    dev_ms = device_ms(torch, lambda: flash_attention_cuda(
        q, k, v, qpos, kvpos, **kw))
    wall_ms = time_ms(torch, lambda: flash_attention_cuda(
        q, k, v, qpos, kvpos, **kw), reps=20)
    # SDPA wants the heads first and, for GQA, each KV head repeated
    # G times (``enable_gqa`` where the build takes it)
    G = H // K
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2) if G > 1
              else t.transpose(1, 2) for t in (k, v))
    try:
        lib = sdpa(qt, kt, vt, attn_mask=mask, scale=D ** -0.5)
        lib_err = float((lib.transpose(1, 2).float() - got.float())
                        .abs().max())
        del lib
        lib_ms = device_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                               scale=D ** -0.5))
    except RuntimeError as e:  # a yardstick only: the port never calls it
        lib_err, lib_ms = None, None
        log(f"      SDPA at D {D} / Dv {Dv}: {e}")
    entry = kernel_entry("flash_attention", err, dev_ms, plain_ms, flops,
                         moved, (dt,), lib_ms)
    entry.update(design=kind, wall_ms=wall_ms, dims=[D, Dv],
                 shape=[B, Sq, Skv, H, K], causal=causal,
                 source=ATTENTION_SOURCE if kind == "flash_prefill"
                 else MODEL_SOURCE)
    log(f"    flash {label:18s} D {D}/Dv {Dv} G {G} [{kind}] err "
        f"{err:.2e}  kernel {dev_ms:8.4f} ms (wall {wall_ms:.4f})  plain "
        f"{plain_ms:8.4f} ms  bound "
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}; "
        f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB, {pairs:,} visible "
        f"pairs)  {entry['bound_ms'] / dev_ms:6.1%} of the bound  SDPA "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} (gap to the "
        f"kernel {'n/a' if lib_err is None else f'{lib_err:.1e}'})")
    del q, k, v, got, mask, qt, kt, vt
    return entry


def mla_flash(torch, dev, results) -> None:
    """Phase 14a: flash attention at MLA's head dims, D (nope + rope)
    against Dv (v): deepseek-v2-lite's (192, 128) on each design at its
    serving shapes (B 4, 16 heads, a 1057-slot cache: prompt 1024 + 32 new
    tokens + 1), dsv2-smoke's (24, 16) on the SIMT and decode kernels;
    each against its plain version, timed beside SDPA and the bound."""
    gen = torch.Generator(device=dev).manual_seed(14)
    i32 = dict(dtype=torch.int32, device=dev)
    f32, bf16 = torch.float32, torch.bfloat16

    def written(n, upto):
        kvpos = torch.arange(n, **i32)
        kvpos[upto:] = -1
        return kvpos

    # (label, B, Sq, H, D, Dv, first query position, KV positions, dtype):
    # H = K, as MLA expands one key and value per head
    cases = [("mla decode Sq1", 4, 1, 16, 192, 128, 1024, written(1057, 1025),
              bf16),
             ("mla decode Sq16", 4, 16, 16, 192, 128, 1009,
              written(1057, 1025), bf16),
             ("mla prefill bf16", 4, 1024, 16, 192, 128, 0,
              written(1057, 1024), bf16),
             ("mla prefill fp32", 4, 1024, 16, 192, 128, 0,
              written(1057, 1024), f32)]
    for dt, name in ((bf16, "bf16"), (f32, "fp32")):
        cases += [(f"smoke prefill {name}", 2, 37, 4, 24, 16, 0,
                   written(48, 37), dt),
                  (f"smoke decode {name}", 2, 1, 4, 24, 16, 40,
                   written(48, 41), dt)]
    log("[14a] flash attention at MLA's head dims (D / Dv) against the "
        "plain version")
    timed = {}
    for label, B, Sq, H, D, Dv, q0, kvpos, dt in cases:
        timed[label] = flash_case(torch, dev, gen, label, B, Sq, H, H, D, Dv,
                                  q0, kvpos, dt)
    torch.cuda.empty_cache()
    keys = ("design", "max_abs_err", "ms", "wall_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "source")
    # row 8c: deepseek-v2-lite's bf16 prefill on top, the rest beneath it
    main_entry = dict(timed["mla prefill bf16"], name="flash_attention[mla]")
    for sub, label in (("decode", "mla decode Sq1"),
                       ("decode_sq16", "mla decode Sq16"),
                       ("prefill_fp32", "mla prefill fp32"),
                       ("smoke_prefill", "smoke prefill bf16"),
                       ("smoke_prefill_fp32", "smoke prefill fp32"),
                       ("smoke_decode", "smoke decode bf16"),
                       ("smoke_decode_fp32", "smoke decode fp32")):
        main_entry[sub] = {key: timed[label][key] for key in keys}
    results["flash_attention[mla]"] = main_entry


def mla_serve(torch, dev, results) -> None:
    """Phase 14b: deepseek-v2-lite-16b at full width through
    ``launch.steps``' prefill and decode setups: bf16 parameters drawn on
    the card, batch 4, prompt 1024, 32 greedy tokens, attention on the
    flash kernels, the sorted MoE dispatch; the first and last layers' MLA
    attention and one layer's MoE held against their plain versions."""
    from dataclasses import replace
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        design, flash_attention_cuda, flash_attention_plain)
    from repro_torch.launch import steps
    from repro_torch.launch.serve import prompt_tokens
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.utils.trees import tree_leaves, tree_map

    cfg = get_config("deepseek-v2-lite-16b")
    B, P, G = 4, 1024, 32
    shape = ShapeConfig("serve", P + G + 1, B, "prefill")
    kw = dict(impl="kernel", moe_impl="sorted", seed=0, device=dev)
    pre = steps.make_prefill_setup(cfg, shape, **kw)
    dec = steps.make_decode_setup(cfg, replace(shape, kind="decode"), **kw)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()    # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cache = pre.init_state(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n = sum(x.numel() for x in leaves)
    if n != cfg.param_count() or n != 16_210_324_992 or \
            {x.dtype for x in leaves} != {torch.bfloat16}:
        raise AssertionError(f"deepseek-v2-lite: {n} parameters of "
                             f"{ {x.dtype for x in leaves} }")
    prompt = torch.from_numpy(prompt_tokens(cfg, B, P, 0)).to(dev)
    nope, rope = cfg.resolved_head_dim, cfg.mla.rope_head_dim
    D, Dv = nope + rope, cfg.mla.v_head_dim
    build.reset_launches()
    t0 = time.perf_counter()
    logits, cache = pre.step_fn(params, cache, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first = logits
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(G):
        logits, cache = dec.step_fn(params, cache, tok, P + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()    # the whole process's
    Lyr = cfg.num_layers
    want = {"flash_attention": Lyr * (1 + G),
            design(P, D, torch.bfloat16, Dv): Lyr,
            "flash_decode": Lyr * G, "flash_decode_combine": Lyr * G}
    flash = {k: launches.get(k, 0) for k in
             ("flash_attention", "flash_prefill", "flash_simt",
              "flash_decode", "flash_decode_combine")}
    finite = bool(torch.isfinite(first.float()).all()) and \
        bool(torch.isfinite(logits.float()).all())
    log(f"[14b] deepseek-v2-lite-16b ({n:,} bf16 parameters, drawn on the "
        f"card in {init_s:.1f} s), B {B}, prompt {P}, {G} new tokens: "
        f"prefill {prefill_s:.3f} s, decode {B * G / decode_s:.1f} tok/s "
        f"({decode_s:.3f} s), peak {peak / 1e9:.2f} GB (of it "
        f"{held / 1e9:.2f} GB that earlier phases hold), flash launches "
        f"{flash} (want {want}), finite {finite}, tokens "
        f"{torch.cat(out, dim=1)[0, :8].tolist()}")
    if not finite or peak > 40e9 or \
            any(launches.get(k, 0) != m for k, m in want.items()):
        raise AssertionError("deepseek-v2-lite serve at full width")
    results["flash_attention[mla]"]["launches"] = launches["flash_attention"]
    results["flash_attention[mla]"]["launches_by_design"] = flash

    # the first and the last layer's MLA attention, kernel (flash_prefill)
    # against its plain version, fed one input: the prompt's normed
    # embedding, through each layer's own projections.  The random init
    # gives q entries a standard deviation of ~11 (``dense_init`` scales
    # wq (d, H, 192) by H^-1/2), so scores reach the hundreds and an fp32
    # rounding of a score moves a softmax weight visibly: each side is
    # held to the exact (fp64) attention of the same bf16 q, k, v, the
    # kernel within twice the plain version's distance plus one bf16
    # rounding of the output
    x = L.embed(params["embedding"], prompt, torch.bfloat16)
    pos = torch.arange(P, dtype=torch.int32, device=dev)
    for li in (0, Lyr - 1):
        lp = tree_map(lambda t: t[li], params["layers"])
        h = L.apply_norm(lp["norm1"], x)
        q_nope, q_rope, c_kv, k_rope = A._mla_qkv(lp["mixer"], h, cfg, pos)
        k, v = A._mla_expand(lp["mixer"], c_kv, k_rope, torch.bfloat16)
        q = torch.cat([q_nope, q_rope], dim=-1)
        got = flash_attention_cuda(q, k, v, pos, pos, scale=D ** -0.5)
        ref = flash_attention_plain(q, k, v, pos, pos, scale=D ** -0.5)
        exact = attention_fp64(torch, q, k, v, pos, pos, 0)
        gap = float((got.float() - ref.float()).abs().max())
        k64 = float((got.double() - exact).abs().max())
        p64 = float((ref.double() - exact).abs().max())
        top = float(exact.abs().max())
        ok = bool(torch.isfinite(got).all()) and \
            k64 <= 2 * p64 + 2 ** -8 * top
        log(f"[14b] layer {li} MLA attention: kernel vs plain max abs err "
            f"{gap:.3e}; from fp64: kernel {k64:.3e}, plain {p64:.3e} (max "
            f"|out| {top:.3g}, q std {float(q.float().std()):.3g}), held "
            f"{ok}")
        if not ok:
            raise AssertionError(f"layer {li} MLA attention differs")
        del exact
    del q, k, v, got, ref, h, q_nope, q_rope, c_kv, k_rope

    # one layer's MoE: the sorted dispatch at full capacity (nothing
    # dropped) against the dense oracle, fp32 (TF32 off)
    mp = tree_map(lambda t: t[0].float(), params["layers"]["mlp"])
    xm = torch.randn((4, 32, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(15), device=dev)
    dense = M.moe_dense(mp, xm, cfg)
    srt = M.moe_sorted(mp, xm, cfg, capacity=4 * 32 * cfg.moe.top_k)
    gap = float((srt - dense).abs().max())
    scale = float(dense.abs().max())
    log(f"[14b] layer 0 MoE, sorted at full capacity vs dense, fp32: max "
        f"abs err {gap:.3e} (max |out| {scale:.3g})")
    # the same fp32 products, summed in other orders: 1e-5 of the largest
    if not gap <= 1e-5 * scale:
        raise AssertionError("sorted MoE differs from the dense oracle")
    del params, cache, logits, first, mp, xm, dense, srt, x, leaves
    torch.cuda.empty_cache()


def zoo_paths(torch, dev) -> None:
    """Phase 14c and 14d: qwen3-8b served at full width through
    ``launch.serve`` (fp32 parameters, bf16 compute, ``flash_prefill`` at
    D 128), and ``launch.steps``' train setup at dsv2-smoke in bf16 with
    fp32 master weights."""
    import numpy as np
    from repro_torch.config import OptimizerConfig, ParallelConfig, ShapeConfig
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.launch.serve import serve
    from repro_torch.utils.trees import tree_leaves

    cfg = get_config("qwen3-8b")
    B, P, G = 4, 1024, 32
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out = serve(cfg, batch=B, prompt_len=P, gen=G, device=dev,
                keep_logits=True)
    launches = {k: build.LAUNCHES[k] for k in
                ("flash_attention", "flash_prefill", "flash_simt",
                 "flash_decode", "flash_decode_combine")}
    Lyr = cfg.num_layers
    want = {"flash_attention": Lyr * (1 + G), "flash_prefill": Lyr,
            "flash_simt": 0, "flash_decode": Lyr * G,
            "flash_decode_combine": Lyr * G}
    finite = bool(torch.isfinite(out["prefill_logits"].float()).all()) and \
        bool(torch.isfinite(out["decode_logits"].float()).all())
    log(f"[14c] qwen3-8b ({cfg.param_count():,} fp32 parameters, bf16 "
        f"compute), B {B}, prompt {P}, {G} new tokens: prefill "
        f"{out['prefill_s']:.3f} s, decode {out['decode_tok_per_s']:.1f} "
        f"tok/s, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
        f"launches {launches}, finite {finite}")
    if launches != want or not finite:
        raise AssertionError(f"qwen3-8b serve: launches {launches}, want "
                             f"{want}, finite {finite}")
    del out
    torch.cuda.empty_cache()

    tcfg = get_smoke_config("deepseek-v2-lite-16b")
    setup = steps.make_train_setup(
        tcfg, ShapeConfig("train", 32, 4, "train"), ParallelConfig(),
        OptimizerConfig(name="adamw", lr=3e-3), device=dev)
    state = setup.init_state(0)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, tcfg.vocab_size, (4, 32)))
             .to(dev) for k in ("tokens", "targets")}
    losses = []
    for _ in range(8):
        state, loss = setup.step_fn(state, batch)
        losses.append(float(loss))
    dtypes = sorted({str(t.dtype) for t in tree_leaves(state["params"])})
    masters = sorted({str(t.dtype)
                      for t in tree_leaves(state["opt"]["master"])})
    log(f"[14d] train setup at {tcfg.name}, bf16 parameters {dtypes}, "
        f"master {masters}: 8 steps on one batch, losses "
        f"{[round(x, 4) for x in losses]}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and dtypes == ["torch.bfloat16"] and masters == ["torch.float32"]):
        raise AssertionError("the bf16 train setup does not reduce the loss")


def mla_and_zoo(torch, dev, results) -> None:
    """Phase 14: MLA's flash head dims, deepseek-v2-lite-16b and qwen3-8b
    served at full width, the bf16 train setup."""
    t_phase = time.perf_counter()
    mla_flash(torch, dev, results)
    mla_serve(torch, dev, results)
    zoo_paths(torch, dev)
    log(f"[14] phase wall {time.perf_counter() - t_phase:.1f} s")


def encdec_vlm_flash(torch, dev, results) -> None:
    """Phase 15a: flash attention at the encoder-decoder's and the vision
    model's serving shapes, each against its plain version (the 6144-query
    prefill one KV head at a time) and timed beside SDPA with the same
    mask and the bound: seamless-m4t's non-causal encoder prefill (bf16, D
    64, B 4, 1024 x 1024, 16 heads on 16), its cross decode (Sq 1 over the
    1024 encoder keys, non-causal) and its self-attention decode at the
    serve's last step (Sq 1 at position 32 over the 1057-slot cache, 33
    written); llava-next-34b's G 7 at D 128 (56 heads on 8) in prefill (B
    2, 1024 queries; and the serve's 6144) and in decode (Sq 1 over a
    6176-slot cache, 6145 written)."""
    gen = torch.Generator(device=dev).manual_seed(15)
    bf16 = torch.bfloat16

    def written(n, upto):
        kvpos = torch.arange(n, dtype=torch.int32, device=dev)
        kvpos[upto:] = -1
        return kvpos

    # (label, B, Sq, H, K, D, first query position, KV positions, causal)
    cases = [("encoder prefill", 4, 1024, 16, 16, 64, 0, written(1024, 1024),
              False),
             ("cross decode", 4, 1, 16, 16, 64, 1, written(1024, 1024),
              False),
             ("self decode", 4, 1, 16, 16, 64, 32, written(1057, 33), True),
             ("vlm prefill", 2, 1024, 56, 8, 128, 0, written(1024, 1024),
              True),
             ("vlm prefill 6144", 2, 6144, 56, 8, 128, 0,
              written(6144, 6144), True),
             ("vlm decode", 2, 1, 56, 8, 128, 6144, written(6176, 6145),
              True)]
    log("[15a] flash attention at the encoder-decoder's and the vision "
        "model's shapes against the plain version")
    timed = {}
    for label, B, Sq, H, K, D, q0, kvpos, causal in cases:
        timed[label] = flash_case(torch, dev, gen, label, B, Sq, H, K, D, D,
                                  q0, kvpos, bf16, causal=causal)
        torch.cuda.empty_cache()
    keys = ("design", "max_abs_err", "ms", "wall_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "source", "shape", "causal")
    # rows 8d / 8e: the prefill on top, the rest beneath it
    for name, top, subs in (
            ("flash_attention[encdec]", "encoder prefill",
             (("decode", "cross decode"), ("self_decode", "self decode"))),
            ("flash_attention[vlm]", "vlm prefill",
             (("prefill_6144", "vlm prefill 6144"),
              ("decode", "vlm decode")))):
        entry = dict(timed[top], name=name)
        for sub, label in subs:
            entry[sub] = {key: timed[label][key] for key in keys}
        results[name] = entry


def flash_launches(build):
    return {k: build.LAUNCHES[k] for k in
            ("flash_attention", "flash_prefill", "flash_simt",
             "flash_decode", "flash_decode_combine")}


def encdec_blockwise(torch, dev, cfg, params, frames) -> None:
    """seamless-m4t-large-v2 in bf16, block by block: each encoder block,
    then each decoder block at the BOS step, runs through the kernels
    (``impl="kernel"``) and through the model's plain attention (``naive``)
    on the same input, the kernel path's output of the block before; the
    decoder's cross keys and values are the kernel path's encoder output.
    The end-to-end gap is not held: the random-init 24 + 24-layer stack
    turns a one-ulp difference into other values (on a CPU at d 64-256,
    24 + 24 layers, even in fp32)."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp(min=1e-30))

    B, P = frames.shape[:2]
    bf16 = torch.bfloat16
    # bf16 activations: the attention outputs of the two paths are one
    # rounding of fp32 values apart (one bf16 ulp, 2^-8 of a value), and a
    # block carries that through its residual sum and MLP: 2^-6 of the
    # block's largest output, the same of the largest logit
    tol = 2.0 ** -6
    worst = {"encoder": 0.0, "decoder": 0.0}
    with torch.no_grad():
        x = lm._with_positions(frames.to(bf16))
        pos = torch.arange(P, device=dev)
        for lp in lm._unstack(params["encoder"], cfg.num_encoder_layers):
            outs = [lm.apply_block(lp, x, cfg, kind="dense", positions=pos,
                                   impl=impl, causal=False)[0]
                    for impl in ("kernel", "naive")]
            worst["encoder"] = max(worst["encoder"], rel(*outs))
            x = outs[0]
        enc_out = x
        y = L.embed(params["embedding"], torch.zeros(
            (B, 1), dtype=torch.int64, device=dev), bf16)
        y = y + L.sinusoidal_at(torch.zeros(1, dtype=torch.int32,
                                            device=dev), cfg.d_model).to(bf16)
        pos0 = torch.zeros(1, dtype=torch.int64, device=dev)
        for li, _, lp in lm._layers(params, cfg):
            cross = lm._cross_kv(lp["cross"], enc_out)
            outs = []
            for impl in ("kernel", "naive"):
                c = A.init_kv_cache(cfg, B, 2, dtype=bf16, device=dev)
                outs.append(lm.apply_block(
                    lp, y, cfg, kind="dense", positions=pos0, impl=impl,
                    cache=c, pos=0, cross_kv=cross)[0])
            worst["decoder"] = max(worst["decoder"], rel(*outs))
            y = outs[0]
        logits = [L.unembed(params["embedding"],
                            L.apply_norm(params["final_norm"], o))
                  for o in outs]
        worst["logits"] = rel(*logits)
    log(f"[15b] block by block, kernels against the plain attention on the "
        f"same input, bf16: largest gap of an encoder block's output "
        f"{worst['encoder']:.3g}, of a decoder block's at the BOS step "
        f"{worst['decoder']:.3g}, of the BOS logits from the last block "
        f"{worst['logits']:.3g}, each relative to its largest magnitude "
        f"(tolerance {tol:g})")
    if max(worst.values()) > tol:
        raise AssertionError(f"seamless block by block: {worst}")


def seamless_serve(torch, dev, results) -> None:
    """Phase 15b: seamless-m4t-large-v2 at full width and depth (24
    encoder and 24 decoder layers) through ``launch.serve``: fp32
    parameters drawn on the card, bf16 compute, batch 4, 1024 frames, 32
    greedy tokens, with the launch counters zeroed just before and read
    just after (24 non-causal ``flash_prefill``; BOS and 32 steps of 24
    self and 24 cross decode calls); then held block by block."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import prompt_frames, serve
    from repro_torch.models.lm import init_lm
    from repro_torch.utils.trees import tree_leaves

    cfg = get_config("seamless-m4t-large-v2")
    B, P, G = 4, 1024, 32
    t0 = time.perf_counter()
    params = init_lm(cfg, 0, dev, draw_on=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(x.numel() for x in tree_leaves(params))
    if n != cfg.param_count() or n != 1_632_253_952:
        raise AssertionError(f"seamless: {n} parameters, config says "
                             f"{cfg.param_count()}")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out = serve(cfg, batch=B, prompt_len=P, gen=G, device=dev,
                params=params, keep_logits=True)
    launches = flash_launches(build)
    Le, Ld = cfg.num_encoder_layers, cfg.num_layers
    calls = 2 * Ld * (1 + G)
    want = {"flash_attention": Le + calls, "flash_prefill": Le,
            "flash_simt": 0, "flash_decode": calls,
            "flash_decode_combine": calls}
    finite = bool(torch.isfinite(out["prefill_logits"].float()).all()) and \
        bool(torch.isfinite(out["decode_logits"].float()).all())
    log(f"[15b] {cfg.name} ({n:,} fp32 parameters drawn on the card in "
        f"{init_s:.3f} s, bf16 compute), B {B}, {P} frames, {G} new "
        f"tokens: prefill {out['prefill_s']:.3f} s, decode "
        f"{out['decode_tok_per_s']:.1f} tok/s ({out['decode_s']:.3f} s), "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
        f"{launches} (want {want}), finite {finite}, tokens "
        f"{out['tokens'][0, :8].tolist()}")
    if launches != want or not finite or out["tokens"].shape != (B, G + 1):
        raise AssertionError(f"seamless serve: launches {launches}, want "
                             f"{want}, finite {finite}")
    results["flash_attention[encdec]"]["launches"] = \
        launches["flash_attention"]
    results["flash_attention[encdec]"]["launches_by_design"] = launches
    del out
    frames = torch.from_numpy(prompt_frames(cfg, B, P, 0)).to(dev)
    encdec_blockwise(torch, dev, cfg, params, frames)
    del params, frames
    torch.cuda.empty_cache()


def llava_serve(torch, dev, results) -> None:
    """Phase 15c: llava-next-34b at full width, 16 of its 60 layers (all 60
    take 68.8 GB in bf16, over this script's 40 GB ceiling), through
    ``launch.steps``' prefill and decode setups: bf16 parameters drawn on
    the card, batch 2, seq 6144 by the reference's ``input_specs`` rule
    (2880 patch embeddings + 3264 tokens), then 32 greedy tokens into a
    6176-slot cache, with the launch counters zeroed just before and read
    just after (16 ``flash_prefill``, 16 x 32 decode and combine); the
    first and last layers' attention held as phase 14b holds MLA's."""
    from dataclasses import replace
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain)
    from repro_torch.launch import steps
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.utils.trees import tree_leaves, tree_map

    full = get_config("llava-next-34b")
    cfg = replace(full, num_layers=16)
    B, S, G = 2, 6144, 32
    spec = steps.make_prefill_setup(cfg, ShapeConfig("p", S, B, "prefill"),
                                    device=dev).arg_specs[2]
    shape = ShapeConfig("serve", S + G, B, "prefill")
    kw = dict(impl="kernel", seed=0, device=dev)
    pre = steps.make_prefill_setup(cfg, shape, **kw)
    dec = steps.make_decode_setup(cfg, replace(shape, kind="decode"), **kw)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cache = pre.init_state(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n = sum(x.numel() for x in leaves)
    if n != cfg.param_count() or {x.dtype for x in leaves} != \
            {torch.bfloat16}:
        raise AssertionError(f"llava: {n} parameters, config says "
                             f"{cfg.param_count()}")
    g = torch.Generator(device=dev).manual_seed(16)
    F = spec["frontend_embeds"].shape[1]
    batch = {"frontend_embeds": torch.randn(
        spec["frontend_embeds"].shape, generator=g, device=dev).to(
            torch.bfloat16),
        "tokens": torch.randint(0, cfg.vocab_size, spec["tokens"].shape,
                                generator=g, device=dev)}
    build.reset_launches()
    t0 = time.perf_counter()
    logits, cache = pre.step_fn(params, cache, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first = logits
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(G):
        logits, cache = dec.step_fn(params, cache, tok, S + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = flash_launches(build)
    peak = torch.cuda.max_memory_allocated()
    Lyr = cfg.num_layers
    want = {"flash_attention": Lyr * (1 + G), "flash_prefill": Lyr,
            "flash_simt": 0, "flash_decode": Lyr * G,
            "flash_decode_combine": Lyr * G}
    finite = bool(torch.isfinite(first.float()).all()) and \
        bool(torch.isfinite(logits.float()).all())
    log(f"[15c] {cfg.name}, {Lyr} of {full.num_layers} layers at full width "
        f"({n:,} bf16 parameters drawn on the card in {init_s:.3f} s; all "
        f"{full.num_layers}: {full.param_count():,}), B {B}, {F} patch "
        f"embeddings + {S - F} tokens, {G} new tokens: prefill "
        f"{prefill_s:.3f} s, decode {B * G / decode_s:.1f} tok/s "
        f"({decode_s:.3f} s), peak {peak / 1e9:.2f} GB (of it "
        f"{held / 1e9:.2f} GB that earlier phases hold), launches "
        f"{launches} (want {want}), finite {finite}, tokens "
        f"{torch.cat(out, dim=1)[0, :8].tolist()}")
    if not finite or peak > 40e9 or launches != want or F != 2880:
        raise AssertionError("llava-next-34b serve at full width")
    results["flash_attention[vlm]"]["launches"] = launches["flash_attention"]
    results["flash_attention[vlm]"]["launches_by_design"] = launches

    # the first and the last layer's attention, kernel (flash_prefill, G 7)
    # against its plain version, fed one input: the normed embeddings of
    # all 6144 positions (2880 patch embeddings, then the tokens), through
    # each layer's projections and RoPE.  The plain version and the fp64
    # yardstick run one KV head at a time (over all heads their scores
    # would take 17 and 34 GB).  Held as phase 14b: each side against the
    # fp64 attention of the same bf16 q, k, v, the kernel within twice
    # the plain version's distance plus one bf16 rounding of the output
    x = lm._embed_inputs(params, batch, cfg)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    for li in (0, Lyr - 1):
        lp = tree_map(lambda t: t[li], params["layers"])
        q, k, v = A._project_qkv(lp["mixer"], L.apply_norm(lp["norm1"], x),
                                 cfg, pos)
        got = flash_attention_cuda(q, k, v, pos, pos)
        ref = by_kv_head(torch, flash_attention_plain, q, k, v, pos, pos)
        torch.cuda.empty_cache()
        exact = by_kv_head(torch, lambda *a: attention_fp64(torch, *a, 0),
                           q, k, v, pos, pos)
        torch.cuda.empty_cache()
        gap = float((got.float() - ref.float()).abs().max())
        k64 = float((got.double() - exact).abs().max())
        p64 = float((ref.double() - exact).abs().max())
        top = float(exact.abs().max())
        ok = bool(torch.isfinite(got).all()) and \
            k64 <= 2 * p64 + 2 ** -8 * top
        log(f"[15c] layer {li} attention (G 7, all {S} positions): "
            f"kernel vs plain max abs err {gap:.3e}; from fp64: kernel "
            f"{k64:.3e}, plain {p64:.3e} (max |out| {top:.3g}), held {ok}")
        if not ok:
            raise AssertionError(f"llava layer {li} attention differs")
        del q, k, v, got, ref, exact
    del params, cache, logits, first, x, leaves, batch
    torch.cuda.empty_cache()


def encdec_vlm_train(torch) -> None:
    """Phase 15d: ``launch.steps``' train setup at seamless-smoke and
    llava-smoke in bf16 with fp32 master weights, 8 AdamW steps on one
    batch drawn by the setup's own specs (frames; patch embeddings and
    tokens by the ``input_specs`` rule)."""
    from repro_torch.config import OptimizerConfig, ParallelConfig, ShapeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps

    dev = torch.device("cuda", 0)
    for arch in ("seamless-m4t-large-v2", "llava-next-34b"):
        cfg = get_smoke_config(arch)
        setup = steps.make_train_setup(
            cfg, ShapeConfig("train", 32, 4, "train"), ParallelConfig(),
            OptimizerConfig(name="adamw", lr=3e-3), device=dev)
        g = torch.Generator(device=dev).manual_seed(17)
        batch = {k: (torch.randint(0, cfg.vocab_size, s.shape, generator=g,
                                   device=dev) if k in ("tokens", "targets")
                     else torch.randn(s.shape, generator=g,
                                      device=dev).to(s.dtype))
                 for k, s in setup.arg_specs[1].items()}
        state = setup.init_state(0)
        losses = []
        for _ in range(8):
            state, loss = setup.step_fn(state, batch)
            losses.append(float(loss))
        log(f"[15d] train setup at {cfg.name}, batch "
            f"{ {k: tuple(v.shape) for k, v in batch.items()} }: 8 steps, "
            f"losses {[round(x, 4) for x in losses]}")
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"{cfg.name}: the train setup does not "
                                 f"reduce the loss")


def encdec_and_vlm(torch, dev, results) -> None:
    """Phase 15: the encoder-decoder and the vision model."""
    t_phase = time.perf_counter()
    encdec_vlm_flash(torch, dev, results)
    seamless_serve(torch, dev, results)
    llava_serve(torch, dev, results)
    encdec_vlm_train(torch)
    log(f"[15] phase wall {time.perf_counter() - t_phase:.1f} s")


def wire_audits(torch, dev, results) -> None:
    """Phase 16: the audits of the Hermes wire on the card: the analyzer's
    round targets on two gloo ranks, ``launch.hermes_dryrun`` (a) and (b)
    at qwen3-8b, and the bf16 merges timed at its tree."""
    from repro_torch.dist import wire
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.dequant_merge import (
        dequant_merge_group_cuda, dequant_merge_packed_group_cuda)
    from repro_torch.kernels.dequant_merge import cost as merge_cost
    from repro_torch.kernels.loss_weighted_update import cost as lwu_cost
    from repro_torch.kernels.loss_weighted_update import (
        loss_weighted_update_group_cuda, loss_weighted_update_group_plain)
    from repro_torch.dist import hermes_sync as hs
    from repro_torch.launch import analyze, hermes_dryrun
    from repro_torch.launch import placed_audit as pa
    from repro_torch.launch.placed_audit import _config
    from repro_torch.models.lm import init_lm
    from repro_torch.utils.trees import tree_flatten

    # (a) the round targets: the open and closed round, the async halves,
    # admission and the train step, each rank's collectives held to the rule
    t0 = time.perf_counter()
    per_rank = analyze.run_round_targets(device=dev)
    reports = (analyze.check_hermes_round(per_rank)
               + analyze.check_async_halves(per_rank)
               + analyze.check_admission(per_rank)
               + analyze.check_train_step(per_rank))
    hoist = analyze.selftest_fp32_hoist(per_rank)
    dropped = analyze.selftest_dropped_donation(dev)
    donating = [r.label for r in reports
                if "donation-aliasing" in r.rules]
    if sorted(donating) != sorted(
            [k for k in per_rank[0] if k.startswith("hermes_commit")]
            + [k for k in per_rank[0] if k.startswith("train_step")]):
        raise AssertionError(f"the donation halves ran on {donating}")
    log(f"[16] analyzer round targets on {analyze.N_PODS} gloo ranks of the "
        f"card: {', '.join(r.label for r in reports)} clean (donation "
        f"aliased in place: {', '.join(donating)}); the fp32-hoist fixture "
        f"raised {hoist['classes']}, the functional commit "
        f"{dropped['classes']}; {time.perf_counter() - t0:.1f} s")

    # (b) hermes_dryrun: the full-depth bills on meta tensors, then the
    # round at full width executed on two ranks, launches counted
    arch, layers = "qwen3-8b", 1
    t0 = time.perf_counter()
    bills = hermes_dryrun.full_width_bills(arch)
    log(f"    {arch} bills at full depth ({bills['parameters']:,} "
        f"parameters, bf16): " + ", ".join(
            f"{f} {b['billed_bytes']:,} B ({b['bytes_per_element']:.4f} "
            f"B/elt)" for f, b in bills["formats"].items())
        + f"; block_axis hint drift {bills['block_axis_hint_drift']}")
    gc.collect()
    torch.cuda.empty_cache()
    build.reset_launches()
    run = hermes_dryrun.executed(arch, layers=layers, device=dev)
    parent = {k: v for k, v in build.LAUNCHES.items() if v}
    launches = {k: parent.get(k, 0) + run["rank_launches"].get(k, 0)
                for k in set(parent) | set(run["rank_launches"])}
    peak = run["peak_bytes"]
    for fmt, e in run["formats"].items():
        flat = e["flat"]["collectives"]["flat_round"]
        closed = e["closed"]["collectives"]
        log(f"    {fmt:4s} open round: {flat['gather_bytes']:,} B gathered "
            f"a rank in {flat['cross_pod_collectives']} collectives = the "
            f"bill of the tree that ran ({e['shipped_bill']:,}; "
            f"payload_bytes {e['payload_bytes']:,}), "
            f"{e['bytes_per_element']:.4f} B/elt, control "
            f"{flat['control_bytes']} B; closed rounds "
            f"{[c['control_bytes'] for c in closed.values()]} B of gate "
            f"exchange only; placed == unplaced bitwise")
    log(f"    executed: {run['cut']}, {run['parameters']:,} parameters, "
        f"{run['seconds']:.1f} s (unplaced {run['unplaced_seconds']:.1f}); "
        f"launches (this process + the ranks) {launches}; peak "
        f"{peak['unplaced'] / 1e9:.2f} GB unplaced, ranks "
        f"{[round(r / 1e9, 2) for r in peak['ranks']]} GB, the phase "
        f"{peak['phase'] / 1e9:.2f} GB; {time.perf_counter() - t0:.1f} s")
    if peak["phase"] > 40e9:
        raise AssertionError(f"the wire audit's peak {peak} over 40 GB")
    for name in ("dequant_merge_packed", "dequant_merge",
                 "loss_weighted_update"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"the qwen3-8b rounds never launched {name}")
    # the open none and fp16 rounds, in the unplaced run and on each rank
    # (a closed round merges nothing): one grouped launch a none merge of
    # the bf16 tree, one an fp16 merge's decode-fallback run (the two
    # vocabulary tables alone, then the rest)
    job = {"preset": arch, "seed": 0, "layers": layers, "dtype": "bfloat16"}
    runs = {"none": 1, "fp16": len(hs.fallback_runs(
        [2 * x.numel() * x.element_size()
         for x in tree_flatten(pa._w_global(job, pa.META))[0]]))}
    want = sum(runs[f] * sum(run["formats"][f]["flat"]["merged"])
               * (1 + hermes_dryrun.N_PODS) for f in runs)
    if launches["loss_weighted_update"] != want:
        raise AssertionError(f"the none / fp16 rounds launched "
                             f"loss_weighted_update "
                             f"{launches['loss_weighted_update']} times, "
                             f"{want} expected ({runs} a merge)")

    # (c) the bf16 merges at the same tree, two pods, gates open: each
    # held bitwise to its plain version and timed on the card's clock
    g_leaves = tree_flatten(init_lm(_config(job), 0, dev, draw_on=dev,
                                    dtype=torch.bfloat16))[0]
    n_pods = 2
    gen = torch.Generator(device=dev).manual_seed(16)
    deltas = [1e-3 * torch.randn((n_pods,) + tuple(g.shape), generator=gen,
                                 device=dev, dtype=torch.bfloat16)
              for g in g_leaves]
    axes = [wire.block_axis(d.shape) for d in deltas]
    w2 = torch.tensor([1 / 3.1, 1 / 3.2], device=dev)
    w1 = torch.tensor(1 / 3.4, device=dev)
    denom = w1 + w2.sum()
    push = torch.tensor(True, device=dev)
    n = sum(g.numel() for g in g_leaves)
    for name, fmt in (("dequant_merge_packed", "int4"),
                      ("dequant_merge", "int8"),
                      ("loss_weighted_update", "none")):
        if fmt == "none":
            pods = [(g[None] + d) for g, d in zip(g_leaves, deltas)]
            ins = g_leaves + pods
            kern = lambda: loss_weighted_update_group_cuda(  # noqa: E731
                list(zip(g_leaves, pods)), w1, w2, denom, push)
            plain = lambda: loss_weighted_update_group_plain(  # noqa: E731
                list(zip(g_leaves, pods)), w1, w2, denom, push)
            cost = lwu_cost([(g.shape, g.dtype, p.dtype)
                             for g, p in zip(g_leaves, pods)], n_pods)
        else:
            pays = wire.get_format(fmt).encode_group(
                deltas, [(0, i) for i in range(len(deltas))],
                wire.GeneratorNoise(16, dev))
            key = "q_packed" if fmt == "int4" else "q"
            leaves = [(g, p[key], p["scales"], ax)
                      for g, p, ax in zip(g_leaves, pays, axes)]
            ins = g_leaves + [t for p in pays for t in p.values()]
            group = (dequant_merge_packed_group_cuda if fmt == "int4"
                     else dequant_merge_group_cuda)
            oracle = (ref.dequant_merge_packed_ref if fmt == "int4"
                      else ref.dequant_merge_ref)
            kern = lambda: group(leaves, w2, denom, push)  # noqa: E731
            plain = lambda: [oracle(  # noqa: E731
                g, q, sc, w2, denom, push, axis=ax)
                for g, q, sc, ax in leaves]
            cost = merge_cost([(g.shape, g.dtype, q.shape, sc.shape)
                               for g, q, sc, _ in leaves], n_pods)
        got = kern()
        err = 0.0
        for a, b in zip(got, plain()):
            if not torch.equal(a, b):
                raise AssertionError(f"bf16 {name} differs from its plain "
                                     f"version at {tuple(a.shape)}")
        flops, moved = costed(name, cost, ins, got)
        del got
        bound_ms, bound_by = bound(flops, moved, {t.dtype for t in ins})
        build.reset_launches()
        kern()
        per_pass = build.LAUNCHES[name]
        ms = device_ms(torch, kern, reps=5)
        plain_ms = time_ms(torch, plain, reps=2, warmup=1)
        label = f"{name}[{arch} bf16]"
        results[label] = {
            "name": label, "route": "cuda", "source": WIRE_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "launches_per_pass": per_pass}
        log(f"    {label}: equal=True  kernel {ms:.3f} ms ({per_pass} "
            f"launches a pass)  plain {plain_ms:.3f} ms  bound "
            f"{bound_ms:.3f} ms ({bound_by}; {moved / 1e9:.3f} GB)  "
            f"{bound_ms / ms:5.1%} of the bound; {launches[name]} launches "
            f"on the rounds above")
        del kern, plain, ins
        if fmt == "none":
            del pods
        else:
            del pays, leaves
        torch.cuda.empty_cache()
    del g_leaves, deltas
    torch.cuda.empty_cache()


def donation(torch, dev, results) -> None:
    """Phase 17a: donation as in-place updates at lm100m x 4 pods, fp32,
    async int4 rounds.  ``train_hermes`` runs a few steps through the
    donating pod step and commit, its wire kernels counted; then one pod
    step and one commit, each donating and functional on the same inputs
    (cloned first), held bitwise equal, the donating one's outputs in the
    donated storage under the donation rule, and each path's peak and the
    call's rise in ``max_memory_allocated`` printed."""
    from repro_torch.analysis import (
        DonationAliasing, analyze, donated_leaf_ranges, trace_aliasing)
    from repro_torch.config import HermesConfig, OptimizerConfig
    from repro_torch.core.gup import gup_gate
    from repro_torch.dist import hermes_sync as hs
    from repro_torch.dist import wire
    from repro_torch.kernels import build
    from repro_torch.launch import train as T
    from repro_torch.models.lm import init_lm
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.utils.trees import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = T._preset("lm100m")
    hcfg = HermesConfig(alpha=-0.8, lam=2, compression="int4",
                        async_rounds=True)
    opt_cfg = OptimizerConfig(name="adamw", lr=3e-4)
    build.reset_launches()
    out = T.train_hermes(cfg, steps=4, batch=8, seq=128, pods=PODS,
                         opt_cfg=opt_cfg, hcfg=hcfg, log_every=10 ** 6,
                         device=dev)
    launches = {k: build.LAUNCHES[k] for k in WIRE_ROWS}
    log(f"[17a] train_hermes lm100m x {PODS} pods, async int4, 4 steps "
        f"through the donating pod step and commit: {out['rounds']} rounds, "
        f"{out['committed']} committed, drained {out['drained']}, global "
        f"loss {out['global_loss']:.4f}, {out['ms_per_step']:.1f} ms a "
        f"step; wire launches {launches}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not (out["drained"] and out["dispatched"] == out["committed"] >= 1
            and math.isfinite(out["global_loss"])):
        raise AssertionError(f"the donating trainer: {out}")
    for k in ("pack_int4", "unpack_int4", "dequant_merge_packed"):
        if launches[k] < 1:
            raise AssertionError(f"the donating int4 rounds never "
                                 f"launched {k}")
        results[k]["donation_launches"] = launches[k]
    del out
    gc.collect()
    torch.cuda.empty_cache()

    def clone(tree):
        return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                        else x, tree)

    def same(a, b):
        return all(torch.equal(x, y) if isinstance(x, torch.Tensor)
                   else x == y for x, y in zip(tree_leaves(a),
                                               tree_leaves(b)))

    def traced(label, fn, args, donated):
        """``fn(*args)`` with its storages and peak: ``(result, rise,
        peak)``, the donation rule applied to argnums ``donated`` (None:
        the functional twin, whose rule must name the rebuild)."""
        before = torch.cuda.memory_allocated(dev)
        ranges = donated_leaf_ranges(args, donated or (0,))
        result, aliasing = trace_aliasing(fn, *args, device=dev)
        rule = DonationAliasing({f"arg{k}": range(*v)
                                 for k, v in ranges.items()})
        rep = analyze([rule], aliasing=aliasing, label=label, fail=False)
        if rep.ok != (donated is not None):
            raise AssertionError(f"{label}: donation rule "
                                 f"{[str(v) for v in rep.violations]}")
        return result, aliasing.peak_rise, before + aliasing.peak_rise

    opt = make_optimizer(opt_cfg)
    w = init_lm(cfg, 0, dev, draw_on=dev)
    tree_gb = PODS * sum(x.numel() * x.element_size()
                         for x in tree_leaves(w)) / 1e9
    gen = torch.Generator(device=dev).manual_seed(17)
    pods = tree_map(lambda g: g[None] + 1e-3 * torch.randn(
        (PODS,) + tuple(g.shape), generator=gen, device=dev), w)
    state = opt.init(pods)
    stacked = {k: torch.randint(0, cfg.vocab_size, (PODS, 8, 128),
                                generator=gen, device=dev)
               for k in ("tokens", "targets")}
    peaks = {}
    with torch.no_grad():
        d_pods, d_state = clone(pods), clone(state)
    torch.cuda.synchronize()
    (got, got_state, got_loss), rise, peak = traced(
        "pod_step[donating]", T.make_pod_step(cfg, opt),
        (d_pods, d_state, stacked), (0, 1))
    peaks["pod_step"] = {"donating": (rise, peak)}
    if got is not d_pods or got_state is not d_state:
        raise AssertionError("the donating pod step returned new trees")
    del got, got_state
    (f_pods, f_state, f_loss), rise, peak = traced(
        "pod_step[functional]", T.make_pod_step(cfg, opt, donate=False),
        (pods, state, stacked), None)
    peaks["pod_step"]["functional"] = (rise, peak)
    if not (torch.equal(got_loss, f_loss) and same(d_pods, f_pods)
            and same(d_state, f_state)):
        raise AssertionError("the donating pod step differs from the "
                             "functional one")
    del pods, state, d_state, f_state, f_pods, stacked
    gc.collect()
    torch.cuda.empty_cache()

    # a dispatch whose every gate opens (a loss history the losses beat),
    # then its commit, donating and functional
    gup = hs.hermes_pod_state(hcfg, PODS, dev)
    for level in (3.0, 3.2):
        _, gup = gup_gate(gup, torch.full((PODS,), level, device=dev), hcfg)
    losses = 2.0 + 0.05 * torch.arange(PODS, device=dev,
                                       dtype=torch.float32)
    dispatch, commit = T.make_async_round_fns(hcfg)
    dp = dispatch(d_pods, gup, losses, w, torch.tensor(3.4, device=dev),
                  None, round_step=1, noise=wire.GeneratorNoise(17, dev))
    pending = dp["pending"]
    if not hs.pending_merges(pending):
        raise AssertionError("the phase's dispatch opened no gate")
    with torch.no_grad():
        c_pods = clone(d_pods)
    torch.cuda.synchronize()
    want, rise, peak = traced(
        "hermes_commit[functional]", lambda p, pend, g:
        hs.hermes_cluster_commit(p, pend, g, cfg=hcfg),
        (c_pods, dict(pending), w), None)
    peaks["commit"] = {"functional": (rise, peak)}
    leaves = tree_leaves(d_pods)
    got, rise, peak = traced("hermes_commit[donating]", commit,
                             (d_pods, pending, w), (0,))
    peaks["commit"]["donating"] = (rise, peak)
    if pending or any(x is not y for x, y in zip(
            tree_leaves(got["pod_params"]), leaves)):
        raise AssertionError("the donating commit kept its pending or "
                             "returned new pods")
    if not (same(got["pod_params"], want["pod_params"])
            and same(got["w_global"], want["w_global"])):
        raise AssertionError("the donating commit differs from the "
                             "functional one")
    for what, p in peaks.items():
        d, f = p["donating"], p["functional"]
        log(f"    {what}: donating rise {d[0] / 1e9:.3f} GB (peak "
            f"{d[1] / 1e9:.3f}), functional rise {f[0] / 1e9:.3f} GB (peak "
            f"{f[1] / 1e9:.3f}): {(f[0] - d[0]) / 1e9:.3f} GB saved; one "
            f"pod-stacked fp32 tree is {tree_gb:.3f} GB")
    log(f"    bitwise equal, outputs in the donated storage, the rule "
        f"passes the donating calls and names the functional ones; "
        f"[17a] {time.perf_counter() - t_phase:.1f} s")
    del got, want, d_pods, c_pods, dp, pending, w, gup
    gc.collect()
    torch.cuda.empty_cache()


def restart(torch, dev) -> None:
    """Phase 17b: ``launch.elastic.run_demo``, the checkpoint restart onto
    a smaller DeviceMesh: 8 gloo ranks share the card, qwen3-8b's smoke
    model trains on a (2, 4) mesh, is checkpointed and restored onto
    (1, 4)."""
    from repro_torch.launch import elastic as el
    t0 = time.perf_counter()
    out = el.run_demo(device=dev)
    log(f"[17b] run_demo on 8 gloo ranks of the card: mesh "
        f"{out['phase1_mesh']} losses "
        f"{[round(x, 4) for x in out['phase1_losses']]}, restored at step "
        f"{out['resumed_from_step']} onto {out['phase2_mesh']}: losses "
        f"{[round(x, 4) for x in out['phase2_losses']]}, loss_continuous "
        f"{out['loss_continuous']}, realloc {out['realloc']}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (out["phase1_mesh"] == [2, 4] and out["phase2_mesh"] == [1, 4]
            and out["resumed_from_step"] == 5 and out["loss_continuous"]
            and all(math.isfinite(x) for x in out["phase1_losses"]
                    + out["phase2_losses"])):
        raise AssertionError(f"run_demo on the card: {out}")


def donation_and_restart(torch, dev, results) -> None:
    """Phase 17: donation (a), then the checkpoint restart (b)."""
    t_phase = time.perf_counter()
    donation(torch, dev, results)
    restart(torch, dev)
    log(f"[17] phase wall {time.perf_counter() - t_phase:.1f} s")


def attention_split(torch, cell, card, step_ms) -> None:
    """The flash kernels' share of a dry-run step on the card: the step's
    own ``flash_attention`` calls, recorded in one run of it, replayed
    alone on the card's clock (``device_ms``) beside their bound on
    ``HW_H100``, and the rest of the step beside the rest of its count."""
    from repro_torch.kernels import ops
    from repro_torch.roofline.analysis import HW_H100

    calls, real = [], ops.flash_attention

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    ops.flash_attention = record
    try:
        cell.setup.step_fn(*cell.args)
    finally:
        ops.flash_attention = real
    flash_ms = device_ms(torch, lambda: [real(*a, **kw) for a, kw in calls],
                         reps=3)
    flash_b = sum(b for op, b in card.bytes_by_op.items()
                  if op.startswith("kernel:flash"))
    others = card.launches - sum(n for op, n in card.launches_by_op.items()
                                 if op.startswith("kernel:flash"))
    # every kernel of these steps is a flash kernel; bf16 throughout
    peak = HW_H100.peak(torch.bfloat16)
    flash_bound = 1e3 * max(flash_b / HW_H100.hbm_bw,
                            card.kernel_flops / peak)
    rest_bound = 1e3 * max((card.bytes - flash_b) / HW_H100.hbm_bw,
                           (card.flops - card.kernel_flops) / peak)
    log(f"[18c] {cell.shape.name}: its {len(calls)} flash_attention calls "
        f"alone {flash_ms:.2f} ms of the step's {step_ms:.2f} "
        f"({flash_ms / step_ms:.1%}), against their bound "
        f"{flash_bound:.2f} ms ({flash_bound / flash_ms:.1%} of it); the "
        f"rest of the step {step_ms - flash_ms:.2f} ms against its bound "
        f"{rest_bound:.2f} ms, {others} other ops  "
        f"[{nvidia_smi_line()}]")
    if len(calls) != cell.cfg.num_layers:
        raise AssertionError(f"{len(calls)} flash calls in a step of "
                             f"{cell.cfg.num_layers} layers")


def dryrun_counts(torch, dev, results) -> None:
    """Phase 18: the dry run's cost half at qwen3-8b (``launch.dryrun``).
    (a) The three cells at full width, depth and batch, counted on
    ``meta`` tensors at the dry run's defaults (blocked attention, auto to
    decode; the layer repeat), each ``ok``, its FLOPs, bytes and bound on
    ``HW_H100``.  (b) Executed on the card, cut only where the 40 GB hold
    forces it (``reduced``): prefill_32k at batch 1 and decode_32k at
    batch 4 with ``impl="kernel"`` (``flash_prefill``, ``flash_decode`` +
    ``flash_decode_combine`` inside the step, all 36 layers), train_4k at
    1 of 36 layers and batch 1 (blocked attention, as the reference
    trains).  Each is counted on the card (every layer) and must equal the
    ``meta`` count of the same cut cell, FLOPs, bytes and launches by op;
    then its step is timed on the card's clock (``device_ms``), beside the
    bound, its dominant term and the model-FLOPs share at that time, and
    its peak ``max_memory_allocated`` beside the count's argument + temp
    bytes.  (c) The serve cells' time split by :func:`attention_split`."""
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline.analysis import (
        HW_H100, model_flops, record_cost, roofline_terms)

    t_phase = time.perf_counter()
    arch, hold = "qwen3-8b", 40e9
    out = ROOT / "results" / "torch" / "smoke_dryrun"
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        t0 = time.perf_counter()
        rec = D.run_cell(arch, shape, "single", str(out), save_ops=False)
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {arch} {shape}: {rec}")
        c = rec["cost"]
        t = roofline_terms(record_cost(rec), HW_H100)
        mem = rec["memory"]
        log(f"[18a] {arch} {shape} on meta (depths "
            f"{rec['depths_counted']}): {c['flops']:.4e} FLOPs, "
            f"{c['bytes accessed']:.4e} B, {c['launches']} launches; bound "
            f"{t['bound_s']:.4f} s ({t['dominant']}); argument "
            f"{mem['argument_size_in_bytes'] / 1e9:.2f} GB, temp "
            f"{mem['temp_size_in_bytes'] / 1e9:.2f} GB; "
            f"{time.perf_counter() - t0:.1f} s")

    cells = (("prefill_32k", dict(batch=1, impl="kernel"),
              {"flash_prefill": 36}),
             ("decode_32k", dict(batch=4, impl="kernel"),
              {"flash_decode": 36, "flash_decode_combine": 36}),
             ("train_4k", dict(batch=1, layers=1, impl="blocked"), {}))
    for shape, kw, kernels in cells:
        t0 = time.perf_counter()
        meta = D.count_cell(D.make_cell(arch, shape, **kw))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        cell = D.make_cell(arch, shape, device=dev, **kw)
        torch.cuda.synchronize()
        args_bytes = torch.cuda.memory_allocated() - base
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        card = D.count_cell(cell)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        rise = torch.cuda.max_memory_allocated() - before
        peak = torch.cuda.max_memory_allocated() - base
        if card.counts() != meta.counts():
            a, b = card.counts(), meta.counts()
            raise AssertionError(f"{shape}: the card's count differs from "
                                 f"meta: " + str({k: (a[k], b[k]) for k in a
                                                  if a[k] != b[k]}))
        for name, n in kernels.items():
            if launches[name] != n:
                raise AssertionError(f"{shape}: {name} launched "
                                     f"{launches[name]} times, want {n}")
            entry = results.setdefault(name, {"name": name})
            entry["dryrun_launches"] = {
                **entry.get("dryrun_launches", {}), shape: n}
        ms = device_ms(torch, lambda: cell.setup.step_fn(*cell.args),
                       reps=2 if shape == "prefill_32k" else 3)
        t = roofline_terms(card, HW_H100)
        tokens = cell.shape.global_batch * (1 if cell.kind == "decode"
                                            else cell.shape.seq_len)
        mf = model_flops(cell.cfg.param_count(active_only=True), tokens,
                         kind="train" if cell.kind == "train" else "fwd")
        share = mf / (1e-3 * ms) / HW_H100.peak_flops
        m = meta.memory
        est = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
        log(f"[18b] {arch} {shape} on the card, reduced {cell.reduced}, "
            f"launches {({k: v for k, v in launches.items() if v})}: "
            f"counts equal meta's ({card.flops:.4e} FLOPs, "
            f"{card.bytes:.4e} B, {card.launches} launches); step "
            f"{ms:.2f} ms (device_ms) against the bound "
            f"{1e3 * t['bound_s']:.2f} ms ({t['dominant']}), "
            f"{1e3 * t['bound_s'] / ms:.1%} of it; model-FLOPs share "
            f"{share:.2%}; peak {peak / 1e9:.3f} GB against the count's "
            f"argument + temp {est / 1e9:.3f} GB (gap "
            f"{(peak - est) / 1e9:+.3f} GB; arguments allocated "
            f"{args_bytes / 1e9:.3f} against "
            f"{m['argument_size_in_bytes'] / 1e9:.3f}, the step's rise "
            f"{rise / 1e9:.3f} against temp "
            f"{m['temp_size_in_bytes'] / 1e9:.3f}); "
            f"{time.perf_counter() - t0:.1f} s  [{nvidia_smi_line()}]")
        if peak > hold:
            raise AssertionError(f"{shape}: peak {peak / 1e9:.2f} GB over "
                                 f"the {hold / 1e9:.0f} GB hold")
        if kernels:
            attention_split(torch, cell, card, ms)
        del cell, card, meta
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[18] phase wall {time.perf_counter() - t_phase:.1f} s")


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
    from repro_torch.kernels.dequant_merge import cost as merge_cost
    from repro_torch.kernels.loss_weighted_update import cost as lwu_cost
    from repro_torch.kernels.pack import cost as pack_cost
    from repro_torch.kernels.quantize import cost as qz_cost
    from repro_torch.kernels.loss_weighted_update import (
        loss_weighted_update_group_cuda, loss_weighted_update_group_plain)
    from repro_torch.kernels.pack import (
        pack_int4_group_cuda, pack_int4_group_plain, unpack_int4_group_cuda,
        unpack_int4_group_plain)
    from repro_torch.kernels.quantize import (
        dequantize_int8_cuda, quantize_int8_cuda)
    from repro_torch.launch.train import _preset, train_hermes
    from repro_torch.models.lm import init_lm
    from repro_torch.utils.trees import tree_flatten, tree_map

    t_start = time.perf_counter()
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

    # name: (kernel, plain version, the module's cost of a pass,
    #        one PyTorch call computing the same function or None)
    merge_leaves = {
        fmt_name: [(g.shape, g.dtype, p[key].shape, p["scales"].shape)
                   for g, p in zip(g_leaves, pays)]
        for fmt_name, pays, key in (("int4", payloads, "q_packed"),
                                    ("int8", payloads8, "q"))}
    cases = {
        # pack and unpack: one grouped launch over every leaf, tails
        # included, as the round's encode
        "pack_int4": (lambda: pack_int4_group_cuda(pack_leaves),
                      lambda: pack_int4_group_plain(pack_leaves),
                      pack_cost("pack_int4", [(q.shape, d, ax) for q, d, ax
                                              in pack_leaves]), None),
        "unpack_int4": (lambda: unpack_int4_group_cuda(unpack_leaves),
                        lambda: unpack_int4_group_plain(unpack_leaves),
                        pack_cost("unpack_int4", [
                            (p.shape, d, ax) for p, d, ax in unpack_leaves]),
                        None),
        # the merges and the loss-weighted update: one grouped launch over
        # every leaf, as the round
        "dequant_merge_packed": (
            lambda: dequant_merge_packed_group_cuda(
                [(g, p["q_packed"], p["scales"], ax)
                 for g, p, ax in zip(g_leaves, payloads, axes)],
                w2, denom, push),
            lambda: [ref.dequant_merge_packed_ref(
                g, p["q_packed"], p["scales"], w2, denom, push, axis=ax)
                for g, p, ax in zip(g_leaves, payloads, axes)],
            merge_cost(merge_leaves["int4"], PODS), None),
        "loss_weighted_update": (
            lambda: loss_weighted_update_group_cuda(
                list(zip(g_leaves, pods_f32)), w1, w2, denom, push),
            lambda: loss_weighted_update_group_plain(
                list(zip(g_leaves, pods_f32)), w1, w2, denom, push),
            lwu_cost([(g.shape, g.dtype, p.dtype)
                      for g, p in zip(g_leaves, pods_f32)], PODS), None),
        "dequant_merge": (
            lambda: dequant_merge_group_cuda(
                [(g, p["q"], p["scales"], ax)
                 for g, p, ax in zip(g_leaves, payloads8, axes)],
                w2, denom, push),
            lambda: [ref.dequant_merge_ref(
                g, p["q"], p["scales"], w2, denom, push, axis=ax)
                for g, p, ax in zip(g_leaves, payloads8, axes)],
            merge_cost(merge_leaves["int8"], PODS), None),
        "quantize_int8": (
            lambda: [t for d in deltas for t in quantize_int8_cuda(d)],
            lambda: [t for d in deltas for t in ref.quantize_int8_ref(d)],
            tuple(map(sum, zip(*[qz_cost("quantize_int8", d.shape)
                                 for d in deltas]))), None),
        "dequantize_int8": (
            lambda: [dequantize_int8_cuda(q, sc, d.shape)
                     for (q, sc), d in zip(flat8, deltas)],
            lambda: [ref.dequantize_int8_ref(q, sc, d.shape)
                     for (q, sc), d in zip(flat8, deltas)],
            tuple(map(sum, zip(*[qz_cost("dequantize_int8", d.shape)
                                 for d in deltas]))),
            # int8 x fp32 promotes to fp32 in one elementwise kernel
            lambda: [torch.mul(q, sc) for q, sc in flat8]),
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
    for name, (kern, plain, cost, library) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(float((a.to(torch.float32) - b.to(torch.float32))
                        .abs().max()) for a, b in zip(got, want))
        if not exact:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        flops, moved = costed(name, cost, inputs[name], got)
        bound_ms, bound_by = bound(flops, moved,
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
    # ``inputs`` and the cases' closures hold every tensor above (6.8 GB)
    del cases, inputs, pack_leaves, unpack_leaves, payloads, payloads8
    del flat8, pods_f32, deltas
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
    del outs, new_global

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

    # the flat API loop's last leaf and its round trip stay bound too
    del w_global, g_leaves, g, q, sc, back, half, x, over
    torch.cuda.empty_cache()
    for phase, run in ((6, lambda: serving_kernels(torch, dev, results)),
                       (7, lambda: serving_paths(torch, dev, results)),
                       (8, lambda: analyzer(torch, dev, results)),
                       (9, lambda: level_a(torch, dev, results)),
                       (10, lambda: trainer_and_studies(torch, dev, smi)),
                       (11, lambda: fleet_engine(torch, dev, results)),
                       (12, lambda: two_tier(torch, dev, results)),
                       (13, lambda: elastic(torch, dev, results)),
                       (14, lambda: mla_and_zoo(torch, dev, results)),
                       (15, lambda: encdec_and_vlm(torch, dev, results)),
                       (16, lambda: wire_audits(torch, dev, results)),
                       (17, lambda: donation_and_restart(torch, dev,
                                                         results)),
                       (18, lambda: dryrun_counts(torch, dev, results))):
        gc.collect()
        log(f"--- phase {phase} starts at {time.perf_counter() - t_start:.1f}"
            f" s, {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        run()
    log(f"--- all phases done at {time.perf_counter() - t_start:.1f} s")

    # ---- 19. result lines -------------------------------------------------
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
