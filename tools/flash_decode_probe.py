#!/usr/bin/env python3
"""Card time of the split-KV decode kernel against its split count, on an
NVIDIA card:

    PYTHONPATH=src python tools/flash_decode_probe.py

For recurrentgemma-2b's decode shape (B 4, 10 query heads of 256 on one
KV head, 2048 slots), the same with one query head, a single block (B 1,
one 32-key tile: the latency of one block's chain), and lm100m's shape
(B 8, 12 heads of 64 on 4, 577 slots), in bf16 and fp32, it launches the
split kernel alone with 1, 2, 4 and 8 tiles a split and prints the mean
kernel time per call (``torch.profiler``, 20 calls) of each.  The
wrapper takes the split count from ``decode_plan``; this shows what the
other counts would cost.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa


def kernel_us(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if "flash_decode_kernel" in e.key) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_decode_probe: needs an NVIDIA card")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    for dt in (torch.bfloat16, torch.float32):
        for B, Skv, H, K, D in ((4, 2048, 10, 1, 256), (4, 2048, 1, 1, 256),
                                (1, 32, 10, 1, 256), (8, 577, 12, 4, 64)):
            q = torch.randn(B, 1, H, D, device=dev).to(dt)
            k, v = (torch.randn(B, Skv, K, D, device=dev).to(dt)
                    for _ in range(2))
            qp = torch.tensor([Skv], dtype=torch.int32, device=dev)
            kp = torch.arange(Skv, dtype=torch.int32, device=dev)
            groups = fa.decode_plan(B, 1, H, K, Skv)[0]
            tiles = -(-Skv // fa.DECODE_TILE)
            row = []
            for per_split in (1, 2, 4, 8):
                splits = -(-tiles // per_split)
                n = B * H * splits
                scratch = torch.empty(n * (D + 2), device=dev)

                def run():
                    build.launch(
                        "flash_decode", dev, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), qp.data_ptr(), kp.data_ptr(),
                        scratch[n * D:].data_ptr(), scratch.data_ptr(), None,
                        fa._DTYPES[dt], B, 1, Skv, H, K, D, D, groups,
                        per_split, splits, 1, 2048, D ** -0.5)

                row.append(f"{per_split} tiles x {splits} splits "
                           f"{kernel_us(run):.2f} us")
            print(str(dt).removeprefix("torch."), (B, Skv, H, K, D),
                  "; ".join(row), flush=True)


if __name__ == "__main__":
    main()
