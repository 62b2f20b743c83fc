"""The roofline (``repro_torch.roofline``) and the dry run's cells
(``repro_torch.launch.dryrun``) against the reference on the CPU.

The reference's ``launch/dryrun.py``, and ``roofline/report.py`` that
imports it, set ``XLA_FLAGS`` to 512 host devices when imported, so this
module never imports them: it reads ``repro.config`` and
``repro.roofline.analysis`` directly, and runs the rest in a child
process with ``REPRO_DRYRUN_DEVICES=1``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_parity import CHILD_ENV

from repro.analysis.hlo_parse import HloCost
from repro.config import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.roofline.analysis import HW_V5E as JHW_V5E
from repro.roofline.analysis import model_flops as jmodel_flops
from repro.roofline.analysis import roofline_terms as jroofline_terms

from repro_torch.analysis.cost import StepCost
from repro_torch.config import SHAPES
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import dryrun as D
from repro_torch.models.lm import init_lm
from repro_torch.roofline import analysis as A
from repro_torch.roofline import insert_tables as I
from repro_torch.roofline import report as R

ROOT = Path(__file__).resolve().parents[1]

#: rows for ``to_markdown``: an ok cell (terms of each size class), a
#: skipped one, a missing one
ROWS = [
    {"arch": "qwen3-8b", "shape": "train_4k", "status": "ok",
     "memory": {"argument_size_in_bytes": 3 * 2 ** 30,
                "temp_size_in_bytes": 2 ** 29},
     "roofline": {"compute_s": 1.5, "memory_s": 2.5e-3,
                  "collective_s": 4e-7, "dominant": "compute",
                  "useful_ratio": 0.75, "mfu_at_bound": 0.4321}},
    {"arch": "qwen3-8b", "shape": "long_500k", "status": "skip(full-attn)"},
    {"arch": "yi-6b", "shape": "decode_32k", "status": "missing"},
]
SECONDS = [2.5, 1.0, 0.999, 1e-3, 9.99e-4, 1e-6, 0.0]


@pytest.fixture(scope="module")
def reference_dryrun():
    """The reference's ``applicable_shapes``, ``arch_optimizer``,
    ``fmt_s`` and ``to_markdown``, from a child process."""
    code = f"""
import json, dataclasses
from repro.launch.dryrun import applicable_shapes, arch_optimizer
from repro.roofline.report import fmt_s, to_markdown
archs = {ASSIGNED_ARCHS!r}
print(json.dumps({{
    "shapes": {{a: applicable_shapes(a) for a in archs}},
    "optimizers": {{a: dataclasses.asdict(arch_optimizer(a)) for a in archs}},
    "fmt_s": [fmt_s(x) for x in {SECONDS!r}],
    "markdown": to_markdown(json.loads({json.dumps(json.dumps(ROWS))})),
}}))
"""
    env = {**os.environ, **CHILD_ENV, "REPRO_DRYRUN_DEVICES": "1",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_shapes_equal_the_reference():
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind)
            for k, s in SHAPES.items()} == \
        {k: (s.name, s.seq_len, s.global_batch, s.kind)
         for k, s in JSHAPES.items()}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cells_and_optimizers_equal_the_reference(reference_dryrun, arch):
    assert get_config(arch).supports_long_context == \
        jget_config(arch).supports_long_context
    assert [list(c) for c in D.applicable_shapes(arch)] == \
        reference_dryrun["shapes"][arch]
    opt = D.arch_optimizer(arch)
    want = reference_dryrun["optimizers"][arch]
    assert {k: getattr(opt, k) for k in ("name", "lr", "momentum")} == \
        {k: want[k] for k in ("name", "lr", "momentum")}


def test_fmt_s_and_markdown_equal_the_reference(reference_dryrun):
    assert [R.fmt_s(x) for x in SECONDS] == reference_dryrun["fmt_s"]
    assert R.to_markdown(ROWS) == reference_dryrun["markdown"]


@pytest.mark.parametrize("kind", ["train", "fwd"])
def test_model_flops_equal_the_reference(kind):
    for params, tokens in ((8_190_735_360, 4096 * 256), (3, 1)):
        assert A.model_flops(params, tokens, kind=kind) == \
            jmodel_flops(params, tokens, kind=kind)


@pytest.mark.parametrize("fields", [
    dict(flops=6.85e16, bytes=1.3e15, collective_bytes=0.0),
    dict(flops=1e9, bytes=5e12, collective_bytes=2e9),
    dict(flops=0.0, bytes=0.0, collective_bytes=0.0)])
def test_roofline_terms_equal_the_reference(fields):
    """The same formula and keys on an ``HloCost`` and a ``StepCost`` of
    equal fields, on the reference's v5e."""
    want = jroofline_terms(HloCost(**fields), JHW_V5E, devices=256)
    got = A.roofline_terms(StepCost(**fields), A.HW_V5E, devices=256)
    assert got == want
    assert A.HW_V5E.__dict__ | {"peak_ops": ()} == \
        {**JHW_V5E.__dict__, "peak_ops": ()}


def test_h100_rates():
    """The data sheet's numbers, and the operand-type peaks the kernel
    bounds read."""
    hw = A.HW_H100
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_bytes) == (989e12, 3.35e12,
                                                        80e9)
    assert hw.peak(torch.bfloat16) == hw.peak_flops
    assert (hw.peak("float32"), hw.peak("int8")) == (67e12, 1979e12)


# param_count(active_only) - the reference's approximation, per arch:
# RWKV6's time-mix and channel-mix, the hybrid's RG-LRU blocks, the
# encoder-decoder's cross-attention, MLA's norm and RoPE key, and every
# stack's norms (the reference counts none of them)
GAPS = {"rwkv6-3b": 237245440, "phi3-mini-3.8b": 199680,
        "qwen3-8b": 308224, "yi-6b": 266240, "granite-34b": 2174976,
        "llava-next-34b": 867328, "seamless-m4t-large-v2": 100911104,
        "grok-1-314b": 792576, "deepseek-v2-lite-16b": 3665408,
        "recurrentgemma-2b": 236341760}


def meta_counts(arch: str):
    """(all, active) parameters of the ``meta`` tree: a routed expert leaf
    (its expert axis after the layer axis) counts ``top_k / num_experts``
    of itself as active."""
    cfg = get_config(arch)
    tree = init_lm(cfg, 0, "meta")
    total = active = 0
    for path, x in D._paths(tree):
        n = x.numel()
        total += n
        routed = cfg.moe is not None and path.split("/")[-1] in (
            "wi", "wg", "wo") and "/mlp/" in path
        active += n * cfg.moe.top_k // cfg.moe.num_experts if routed else n
    return total, active


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_count_is_the_meta_tree(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    total, active = meta_counts(arch)
    assert cfg.param_count() == total
    assert cfg.param_count(active_only=True) == active
    assert total - jcfg.param_count() == GAPS[arch]
    assert active - jcfg.param_count(active_only=True) == GAPS[arch]


def test_run_cell_record_has_the_reference_keys(tmp_path):
    """qwen3-8b's train cell cut to 1 layer and batch 1 on ``meta``; a
    full-attention arch's long cell is skipped; the report reads it."""
    rec = D.run_cell("qwen3-8b", "train_4k", "single", str(tmp_path),
                     batch=1, layers=1)
    assert rec["status"] == "ok", rec.get("traceback")
    for key in ("arch", "shape", "mesh", "kind", "devices", "params",
                "params_active", "status", "memory", "cost", "total_s"):
        assert key in rec
    assert rec["devices"] == 1
    assert rec["reduced"] == {"batch": [256, 1], "layers": [36, 1]}
    assert set(rec["memory"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes"}
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    with open(rec["ops_file"]) as f:
        ops = json.load(f)
    assert sum(ops["bytes_by_op"].values()) == rec["cost"]["bytes accessed"]
    # the production mesh's rules shard the arguments over 256 devices
    assert 0 < rec["argument_bytes_per_device"] < \
        rec["memory"]["argument_size_in_bytes"]
    skip = D.run_cell("qwen3-8b", "long_500k", "single", str(tmp_path))
    assert skip["status"] == "skip(full-attn)"
    row = A.analyze_cell(str(tmp_path / "qwen3-8b__train_4k__single.json"))
    t = row["roofline"]
    assert t["dominant"] in ("compute", "memory")
    # 6 N D of the counted step: one layer's parameters, batch 1
    assert rec["params"] == rec["params_active"] == 1_437_610_240
    assert t["model_flops_per_dev"] == 6 * rec["params"] * 4096
    table = R.to_markdown(R.collect(str(tmp_path)))
    assert "| qwen3-8b | train_4k | ok |" in table
    assert "| qwen3-8b | long_500k | skip(full-attn) |" in table
    doc = tmp_path / "doc.md"
    doc.write_text("# x\n<!-- BASELINE_TABLE -->\n<!-- OPT_TABLE -->\n")
    I.insert(str(doc), str(tmp_path), str(tmp_path / "none"))
    text = doc.read_text()
    assert table in text and "<!--" not in text


def test_main_exits_nonzero_when_a_cell_fails(tmp_path, monkeypatch):
    """A cell that raises is written as ``fail`` and ``main`` returns 1, so
    a scripted sweep sees it in the exit code."""
    def broken(*args, **kw):
        raise RuntimeError("no setup")

    monkeypatch.setattr(D, "make_cell", broken)
    assert D.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                   "--outdir", str(tmp_path)]) == 1
    with open(tmp_path / "qwen3-8b__decode_32k__single.json") as f:
        rec = json.load(f)
    assert rec["status"] == "fail" and "no setup" in rec["error"]
