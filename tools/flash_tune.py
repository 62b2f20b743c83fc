#!/usr/bin/env python3
"""Variants of the SIMT flash kernel (``flash_simt``), built side by side
and held against the plain version and timed on one card.  On an NVIDIA
card:

    python tools/flash_tune.py base reorder noloads
    python tools/flash_tune.py '{"blocks2": {"subs": [["kFaBlocks = 3",
        "kFaBlocks = 2"]]}}'

Each variant is the SIMT section of ``csrc/model_kernels.cu`` with text
substituted (``subs``: pairs of old and new source text), built with the
repository's ``nvcc`` flags into ``build/flash_tune/`` (one ``nvcc`` per
variant, started together) and loaded with ``ctypes``.  Named variants:
``base`` (the source as it is), ``reorder`` (each 16-byte load's four FMAs
in the order d + 3 .. d: a reordered q.k chain, which the large-score
cases must catch) and ``noloads`` (no shared load in either product: the
fragments are constants, so the outputs are wrong; it shows how fast the
kernel's structure runs when shared memory costs nothing), ``nomask``,
``noshuffle`` and ``nocopy`` (each drops one piece of a tile's work, for
timing only), ``keys64`` and ``threads256`` (other tilings).  ``--sass``
adds the instruction mix of the first variant's fp32 D 64 kernel: its
main loop outside the two product loops, and each product loop's body,
from ``cuobjdump -sass``.  Prints JSON
lines: each variant's registers and spills from ``ptxas``; each check
case's error against the plain version (relative to the largest output
for the large-score cases, where q and k are N(0, 45^2)); then, at
lm100m, MLA fp32 and recurrentgemma-2b fp32 prefill, each variant's card
time per call (``--reps`` means of 20 queued calls), its share of the
fp32 FFMA bound (67 TFLOP/s) and SDPA's time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_tune"
RULE = "// " + "-" * 75 + "\n"
NAMED = {
    "base": [],
    "reorder": [["sc[i][j] = fmaf(qd[e], kd[j][e], sc[i][j]);",
                 "sc[i][j] = fmaf(qd[3 - e], kd[j][3 - e], sc[i][j]);"]],
    "noloads": [
        ["fa_load<4>(Qs + (ty * TM + i) * LDQ + d, qd);",
         "qd[0] = qd[1] = qd[2] = qd[3] = __int_as_float(d + i + 0x3f000000);"],
        ["fa_load<4>(ks + (tx + KL * j) * LDK + d, kd[j]);",
         "kd[j][0] = kd[j][1] = kd[j][2] = kd[j][3] = "
         "__int_as_float(d + j + 0x3f000000);"],
        ["fa_load<VW>(vs + (c + e) * LDV + VW * (tx + KL * u), vc + VW * u);",
         "for (int w = 0; w < VW; ++w) "
         "vc[VW * u + w] = __int_as_float(c + e + u + w + 0x3f000000);"],
        ["fa_load<4>(Ps + (ty * TM + i) * LDP + c, pc[i]);",
         "pc[i][0] = pc[i][1] = pc[i][2] = pc[i][3] = "
         "__int_as_float(c + i + 0x3f000000);"]],
    # each of these drops one piece of a tile's work (wrong outputs)
    "nomask": [["if (masked) {", "if (false) {"]],
    "noshuffle": [["off >= 1; off >>= 1)\n        mx",
                   "off >= KL; off >>= 1)\n        mx"],
                  ["off >= 1; off >>= 1)\n        rs",
                   "off >= KL; off >>= 1)\n        rs"]],
    "nocopy": [["fa_copy4(dst + c * LD + x, s < Skv ? src + s * stride + x : "
                "src,\n               s < Skv);", ""]],
    # other tilings (launch errors where the shared memory does not fit)
    "keys64": [["kFaKeys = 32;", "kFaKeys = 64;"],
               ["kFaBlocks = 3;", "kFaBlocks = 2;"]],
    "threads256": [["kFaThreads = 128;", "kFaThreads = 256;"],
                   ["kFaBlocks = 3;", "kFaBlocks = 2;"]],
}


def simt_source(build) -> str:
    """The SIMT section of ``model_kernels.cu`` with what it needs: the
    includes, the dtype helpers and the C launcher ``launch_flash_simt``."""
    src = build.source("model_kernels").read_text()
    head = src[:src.index("namespace {") + len("namespace {")]
    helpers = src[src.index("template <typename T> __device__ "
                            "__forceinline__ float to_f32"):
                  src.index(RULE + "// Flash attention, SIMT")]
    section = src[src.index(RULE + "// Flash attention, SIMT"):
                  src.index(RULE + "// Flash attention, split-KV decode")]
    tail = src[src.index("// dtype: 0 float32, 1 bfloat16"):]
    launcher = tail[:tail.index("\n}\n") + 3]
    return (head + "\n" + helpers + section + "}  // namespace\n"
            "extern \"C\" {\n" + launcher + "}\n")


def loop_mix(build, so: Path, kernel: str) -> dict:
    """Instruction counts of the kernel whose mangled name holds
    ``kernel``: the main loop (the least loop around a ``BAR.SYNC`` that
    holds two FFMA loops), outside its two product loops, and each product
    loop's body (run D / 16 and keys / 8 times a tile at unroll 4 and
    2)."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if kernel in f.split("\n")[0])
    ins = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)]
    loops = []
    for i, (addr, op) in enumerate(ins):
        if op.startswith("BRA"):
            m = re.search(r"BRA[^;]*?(0x[0-9a-f]+)\s*;",
                          body[body.index(f"/*{addr:04x}*/"):])
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))

    def mix(lo, hi):
        ops = [op.split(".")[0] for a, op in ins if lo <= a <= hi]
        return {"all": len(ops), "FFMA": ops.count("FFMA"),
                "LDS": ops.count("LDS")}

    def inside(lp):
        return [o for o in loops if lp[0] < o[0] and o[1] < lp[1]
                and mix(*o)["FFMA"] > 0]

    main = min((lp for lp in loops if len(inside(lp)) >= 2 and any(
        op.startswith("BAR") for a, op in ins if lp[0] <= a <= lp[1])),
        key=lambda lp: lp[1] - lp[0])
    inner = sorted(inside(main), key=lambda lp: -mix(*lp)["FFMA"])[:2]
    rest = mix(*main)
    for lp in inner:
        rest = {k: rest[k] - mix(*lp)[k] for k in rest}
    return {"main_loop_outside_products": rest,
            "product_loop_bodies": [mix(*lp) for lp in inner]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+",
                    help="named variants, or a JSON object of name -> "
                         "{\"subs\": [[old, new], ...]}")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_tune: needs an NVIDIA card")
    from flash_probe import card_line, device_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention_plain, visible)

    variants = {}
    for arg in args.variants:
        if arg.startswith("{"):
            variants.update({k: v["subs"] for k, v in json.loads(arg).items()})
        else:
            variants[arg] = NAMED[arg]
    base = simt_source(build)
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in variants.items():
        text = base
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"flash_tune: {name}: no {old!r} in the "
                                 f"source")
            text = text.replace(old, new)
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        jobs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        usage = []
        for line in log.splitlines():
            m = re.search(r"flash_attention_kernelI(\w+?)EEEv", line)
            if m:
                usage.append(m.group(1).replace("13__nv_bfloat16", "bf16")
                             .replace("Li", " ").replace("E", ""))
            elif usage and ("registers" in line or "spill" in line):
                usage[-1] += " |" + re.sub(r"\s+", " ", line.split(":")[-1])
        print(json.dumps({"variant": name, "rc": proc.returncode,
                          "ptxas": usage}), flush=True)
        if proc.returncode != 0:
            print(log[-3000:], flush=True)
            continue
        fn = getattr(ctypes.CDLL(str(so)), "launch_flash_simt")
        fn.argtypes = build.LIBRARIES["model_kernels"]["flash_simt"]
        fn.restype = ctypes.c_int
        fns[name] = fn

    if args.sass:
        first = next(iter(variants))
        print(json.dumps({"sass": first, **loop_mix(
            build, OUT / f"{first}.so", "IfLi64ELi64E")}), flush=True)

    dev = torch.device("cuda")
    i32 = dict(dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)

    def call(fn, q, k, v, qp, kp, window, causal=True):
        B, Sq, H, D = q.shape
        Skv, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
        out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                 kp.data_ptr(), out.data_ptr(),
                 0 if q.dtype == torch.float32 else 1, B, Sq, Skv, H, K, D,
                 Dv, int(causal), int(window), D ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch error {err}")
        return out

    def inputs(B, Sq, Skv, H, K, D, Dv, dt, sigma=1.0):
        q, k = (sigma * torch.randn(shape, generator=gen, device=dev)
                for shape in ((B, Sq, H, D), (B, Skv, K, D)))
        v = torch.randn((B, Skv, K, Dv), generator=gen, device=dev)
        return q.to(dt), k.to(dt), v.to(dt)

    print(json.dumps({"card": card_line(),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    # (B, Sq, Skv, H, K, D, Dv, causal, window, q0, written, dtype, sigma)
    checks = []
    for dt in (torch.float32, torch.bfloat16):
        for D, Dv in ((16, 16), (32, 32), (24, 16)):
            checks.append((2, 37, 77, 4, 2, D, Dv, True, 0, 40, 77, dt, 1.0))
    for D, Dv in ((64, 64), (128, 128), (192, 128), (256, 256)):
        f32 = torch.float32
        checks += [(2, 37, 37, 6, 2, D, Dv, True, 0, 0, None, f32, 1.0),
                   (1, 150, 200, 4, 1, D, Dv, True, 100, 0, 150, f32, 1.0),
                   (2, 100, 100, 4, 4, D, Dv, False, 0, 0, None, f32, 1.0),
                   (1, 300, 300, 4, 2, D, Dv, True, 0, 0, None, f32, 45.0),
                   (1, 300, 300, 4, 2, D, Dv, True, 128, 0, None, f32,
                    45.0)]
    for case in checks:
        B, Sq, Skv, H, K, D, Dv, causal, window, q0, written, dt, sigma = \
            case
        q, k, v = inputs(B, Sq, Skv, H, K, D, Dv, dt, sigma)
        qp = torch.arange(q0, q0 + Sq, **i32)
        kp = torch.arange(Skv, **i32)
        if written is not None:
            kp[written:] = -1
        want = flash_attention_plain(q, k, v, qp, kp, causal=causal,
                                     window=window).float()
        errs = {}
        for name, fn in fns.items():
            try:
                got = call(fn, q, k, v, qp, kp, window, causal).float()
            except RuntimeError as e:   # a tiling that does not fit
                errs[name] = str(e)
                continue
            gap = float((got - want).abs().max())
            errs[name] = gap / float(want.abs().max()) if sigma > 1 else gap
        print(json.dumps({"case": [B, Sq, Skv, H, K, D, Dv, causal, window,
                                   q0, written, str(dt)[6:], sigma],
                          "err": errs}), flush=True)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, B, Sq, Skv, H, K, D, Dv, window, written in (
            ("lm100m prefill", 8, 512, 577, 12, 4, 64, 64, 0, 512),
            ("mla prefill fp32", 4, 1024, 1057, 16, 16, 192, 128, 0, 1024),
            ("rg prefill fp32", 4, 2560, 2560, 10, 1, 256, 256, 2048,
             None)):
        q, k, v = inputs(B, Sq, Skv, H, K, D, Dv, torch.float32)
        qp = torch.arange(Sq, **i32)
        kp = torch.arange(Skv, **i32)
        if written is not None:
            kp[written:] = -1
        want = flash_attention_plain(q, k, v, qp, kp, causal=True,
                                     window=window)
        mask = visible(qp, kp, causal=True, window=window)
        bound_ms = 1e3 * 2 * B * H * int(mask.sum()) * (D + Dv) / 67e12
        row = {"case": label, "bound_ms": bound_ms}
        for name, fn in fns.items():
            try:
                err = float((call(fn, q, k, v, qp, kp, window) - want)
                            .abs().max())
            except RuntimeError as e:
                row[name] = str(e)
                continue
            ms = [device_ms(torch, lambda: call(fn, q, k, v, qp, kp,
                                                window))
                  for _ in range(args.reps)]
            row[name] = {"err": err, "ms": ms, "share": bound_ms / min(ms)}
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["sdpa_ms"] = device_ms(torch, lambda: sdpa(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        print(json.dumps(row), flush=True)
        del q, k, v, want, mask, qt, kt, vt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
