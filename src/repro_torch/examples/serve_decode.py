"""Batched serving example: prefill + decode with a KV cache (the
reference's ``examples/serve_decode.py``).

Serves the smoke configs of qwen3-8b (GQA + qk-norm), rwkv6-3b and
recurrentgemma-2b through ``launch.serve``: on a card through the
kernels (``impl="kernel"``), on the CPU through their plain versions.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import serve


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for arch in ("qwen3-8b", "rwkv6-3b", "recurrentgemma-2b"):
        cfg = get_smoke_config(arch)
        out = serve(cfg, batch=4, prompt_len=32, gen=16, device=args.device)
        print(f"{arch:20s} prefill={round(out['prefill_s'], 3)}s "
              f"decode={round(out['decode_s'], 3)}s "
              f"({round(out['decode_tok_per_s'], 1)} tok/s)")


if __name__ == "__main__":
    main()
