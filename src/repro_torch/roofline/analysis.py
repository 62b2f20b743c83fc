"""Roofline terms of a counted dry-run cell (the reference's
``roofline/analysis.py``).

    compute term    = FLOPs / peak FLOP/s               (per device)
    memory term     = bytes / HBM bandwidth             (per device)
    collective term = collective bytes / link bandwidth (per device)

The reference parses each cell's saved HLO for the numerators; a port
record carries its own counts (``launch/dryrun.py``: the step counted as
it runs, ``analysis/cost.py``), so :func:`analyze_cell` reads them from
the record.  The formula, the keys and the model-FLOPs table are the
reference's.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

from repro_torch.analysis.cost import StepCost


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float        # per chip, bf16
    hbm_bw: float            # bytes/s per chip
    ici_bw: float            # bytes/s per link
    hbm_bytes: float         # capacity per chip
    #: dense peak operations a second by operand type, where known
    peak_ops: Tuple[Tuple[str, float], ...] = ()

    def peak(self, dtype) -> float:
        """The dense peak rate for operands of ``dtype`` (a torch dtype or
        its name)."""
        return dict(self.peak_ops)[str(dtype).removeprefix("torch.")]


#: TPU v5e, the reference's (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s a
#: link of ICI), kept for parity with its tables
HW_V5E = Hardware(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                  ici_bw=50e9, hbm_bytes=16 * 2 ** 30)

#: NVIDIA H100 SXM (data sheet): 989 TFLOP/s dense bf16 (fp16 the same,
#: fp32 67 outside the tensor cores, TF32 off, int8 1979 TOP/s), 3.35 TB/s
#: of HBM3, 80 GB.  ``ici_bw`` is NVLink 4's 450 GB/s a direction: the
#: data sheet's 900 GB/s counts both directions of all 18 links, and a
#: collective's operand bytes leave the card in one.
HW_H100 = Hardware(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                   ici_bw=450e9, hbm_bytes=80e9,
                   peak_ops=(("float32", 67e12), ("bfloat16", 989e12),
                             ("float16", 989e12), ("int8", 1979e12)))

#: tokens a cell's step processes (the reference's table)
TOKENS = {"train_4k": 4096 * 256, "prefill_32k": 32768 * 32,
          "decode_32k": 128, "long_500k": 1}


def model_flops(params: int, tokens: int, *, kind: str = "train") -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (forward-only)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * params * tokens


def roofline_terms(cost, hw: Hardware = HW_H100,
                   *, devices: int = 1) -> Dict[str, float]:
    """The three terms of ``cost`` (a :class:`StepCost`, or anything with
    ``flops``, ``bytes`` and ``collective_bytes``) on ``hw``."""
    compute_t = cost.flops / hw.peak_flops
    memory_t = cost.bytes / hw.hbm_bw
    collective_t = cost.collective_bytes / hw.ici_bw
    dominant = max(
        ("compute", compute_t), ("memory", memory_t),
        ("collective", collective_t), key=lambda kv: kv[1])[0]
    total = max(compute_t, memory_t, collective_t)
    return {
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": collective_t,
        "dominant": dominant,
        "bound_s": total,
        "compute_fraction": compute_t / total if total > 0 else 0.0,
        "flops": cost.flops,
        "bytes": cost.bytes,
        "collective_bytes": cost.collective_bytes,
    }


def record_cost(rec: Dict) -> StepCost:
    """The :class:`StepCost` a dry-run record carries."""
    c = rec["cost"]
    return StepCost(flops=c["flops"], bytes=c["bytes accessed"],
                    collective_bytes=c.get("collective_bytes", 0.0),
                    collective_counts=dict(c.get("collective_counts", {})),
                    collective_bytes_by_kind=dict(
                        c.get("collective_bytes_by_kind", {})),
                    dot_flops=c.get("dot_flops", 0.0),
                    conv_flops=c.get("conv_flops", 0.0),
                    kernel_flops=c.get("kernel_flops", 0.0))


def analyze_cell(record_path: str, hw: Hardware = HW_H100
                 ) -> Optional[Dict]:
    """Read one dry-run record; return it with its ``roofline`` terms."""
    with open(record_path) as f:
        rec = json.load(f)
    if rec.get("status") != "ok" or "cost" not in rec:
        return rec
    cost = record_cost(rec)
    devices = rec.get("devices", 1)
    terms = roofline_terms(cost, hw, devices=devices)

    # MODEL_FLOPS / counted FLOPs (useful-compute ratio)
    tokens = TOKENS[rec["shape"]]
    if "batch" in rec.get("reduced", {}):
        old, new = rec["reduced"]["batch"]
        tokens = tokens * new // old
    kind = rec.get("kind", "train")
    n = rec.get("params_active") or rec.get("params")
    mf = model_flops(n, tokens, kind="train" if kind == "train" else "fwd")
    per_dev_mf = mf / devices
    terms["model_flops_per_dev"] = per_dev_mf
    terms["useful_ratio"] = per_dev_mf / cost.flops if cost.flops else 0.0
    terms["mfu_at_bound"] = (per_dev_mf / hw.peak_flops) / terms["bound_s"] \
        if terms["bound_s"] > 0 else 0.0
    terms["collectives"] = cost.collective_counts
    terms["collective_bytes_by_kind"] = cost.collective_bytes_by_kind
    rec["roofline"] = terms
    return rec
