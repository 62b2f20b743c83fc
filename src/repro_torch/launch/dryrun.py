"""The dry run's cost half: count one step of every (arch x shape x mesh)
cell (the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell on a 256- or 512-device
production mesh and reads ``memory_analysis()``, ``cost_analysis()`` and
the HLO text, which its roofline parses.  The port counts the step as it
runs (``analysis/cost.py``): one step of ``launch/steps.py``'s setup
under a :class:`~repro_torch.analysis.cost.CostCounter`, its FLOPs,
bytes, launches by op, collectives and memory, on ``meta`` tensors by
default, so a full-size cell allocates nothing.  The whole step is
counted on one device (``devices`` 1); ``mesh`` picks
``launch/mesh.py:arch_rules`` on the production mesh's shape, and the
record adds ``argument_bytes_per_device``: each argument leaf over the
mesh axes its rule shards it on, where they divide.  No partitioner is
run.

The counts are those of the same work the reference lowers: ``impl``
``"blocked"`` attention for train and prefill, ``"auto"`` for decode; a
decode step is at the last slot of a full cache (position ``S - 1``).
On ``cpu`` or ``cuda`` the step runs on data (zeros, the cache's
positions filled), and counts the same integers as on ``meta``.

On ``meta`` a deep stack is counted by layer repeat, the counterpart of
the reference's trip-count multiply: the cost is linear in the count of
each layer kind (the dense stack's one kind, the hybrid's recurrent and
attention blocks, the encoder-decoder's two stacks), so the step is
counted at the fewest depths that fix that line and evaluated at the
config's depth (:func:`count_by_repeat`; the tests hold it equal to the
layer-by-layer count).  Executed cells count every layer.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh both] [--device meta]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from fractions import Fraction
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.cost import StepCost, count_cost
from repro_torch.config import (
    SHAPES, ModelConfig, OptimizerConfig, ShapeConfig,
)
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.dist.sharding import AxisRules, MeshShape
from repro_torch.launch.mesh import (
    arch_parallel_config, arch_rules, make_production_mesh,
)
from repro_torch.launch.steps import StepSetup, build_setup, opt_rules
from repro_torch.models.lm import block_kind, param_axes
from repro_torch.utils.trees import tree_flatten, tree_map

OUTDIR = "results/torch/dryrun"


def applicable_shapes(arch: str) -> List[Tuple[str, str]]:
    """[(shape_name, kind)] for an arch; long_500k only for sub-quadratic."""
    cfg = get_config(arch)
    cells = [("train_4k", "train"), ("prefill_32k", "prefill"),
             ("decode_32k", "decode")]
    if cfg.supports_long_context:
        cells.append(("long_500k", "decode"))
    return cells


def arch_optimizer(arch: str) -> OptimizerConfig:
    if arch in ("grok-1-314b", "granite-34b", "llava-next-34b"):
        return OptimizerConfig(name="sgdm", lr=1e-2, momentum=0.9)
    return OptimizerConfig(name="adamw", lr=3e-4)


def default_impl(kind: str) -> str:
    """The attention the reference's dry run lowers for ``kind``."""
    return "auto" if kind == "decode" else "blocked"


@dataclasses.dataclass
class Cell:
    """One cell ready to count: the setup, its positional arguments (on
    the cell's device) and the donated argument (the train state, the
    serving cache)."""
    arch: str
    shape: ShapeConfig
    kind: str
    cfg: ModelConfig
    setup: StepSetup
    args: Tuple
    donate: Tuple[int, ...]
    reduced: Dict[str, Any]


def _fill_positions(cache, pos: int) -> None:
    """Every ``pos`` leaf of a cache as a step at ``pos`` finds it: the
    ``slots`` positions up to ``pos`` written, each in slot ``p % slots``
    (a linear cache of ``pos + 1`` slots holds ``0..pos`` in order, a
    ring the window's last positions)."""
    def fill(tree):
        if isinstance(tree, list):
            for x in tree:
                fill(x)
        elif isinstance(tree, dict):
            for k, x in tree.items():
                if k == "pos" and isinstance(x, torch.Tensor):
                    slots = x.shape[-1]
                    p = torch.arange(pos - slots + 1, pos + 1,
                                     device=x.device)
                    x[..., p % slots] = p.to(x.dtype)
                else:
                    fill(x)
    fill(cache)


def _zeros(spec, device):
    return torch.zeros(spec.shape, dtype=spec.dtype, device=device)


def make_cell(arch: str, shape: Union[str, ShapeConfig], *, device="meta",
              impl: Optional[str] = None, batch: Optional[int] = None,
              layers: Optional[int] = None, optimized: bool = False,
              cfg: Optional[ModelConfig] = None) -> Cell:
    """The setup and arguments of one cell (``shape`` a name of
    :data:`SHAPES` or a shape of its own); ``batch`` and ``layers`` cut it
    (listed in ``reduced``), ``cfg`` replaces the arch's config (its
    smoke config, say)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    kind = shape.kind
    reduced: Dict[str, Any] = {}
    if batch is not None and batch != shape.global_batch:
        reduced["batch"] = [shape.global_batch, batch]
        shape = dataclasses.replace(shape, global_batch=batch)
    if layers is not None and layers != cfg.num_layers:
        reduced["layers"] = [cfg.num_layers, layers]
        cfg = dataclasses.replace(cfg, num_layers=layers)
    dev = torch.device(device)
    setup = build_setup(kind, cfg, shape,
                        arch_parallel_config(arch, optimized=optimized),
                        arch_optimizer(arch), impl=impl or default_impl(kind),
                        device=dev)
    specs = setup.arg_specs
    if kind == "train":
        args = (setup.init_state(), tree_map(
            lambda s: _zeros(s, dev), specs[1]))
        donate = (0,)
    else:
        params, cache = setup.init_state()
        if kind == "prefill":
            args = (params, cache, tree_map(lambda s: _zeros(s, dev),
                                            specs[2]))
        else:
            pos = shape.seq_len - 1
            if dev.type != "meta":
                _fill_positions(cache, pos)
            args = (params, cache, _zeros(specs[2], dev), pos)
        donate = (1,)
    return Cell(arch, shape, kind, cfg, setup, args, donate, reduced)


def count_cell(cell: Cell) -> StepCost:
    """One step of ``cell``, counted layer by layer."""
    return count_cost(cell.setup.step_fn, *cell.args, donate=cell.donate)[1]


# -- the layer-repeat shortcut -------------------------------------------------

def _kind_counts(cfg: ModelConfig) -> Dict[str, int]:
    """How many layers of each kind ``cfg`` stacks (the encoder-decoder's
    encoder blocks as their own kind)."""
    out: Dict[str, int] = {}
    for i in range(cfg.num_layers):
        k = block_kind(cfg, i)
        out[k] = out.get(k, 0) + 1
    if cfg.is_encoder_decoder:
        out["encoder"] = cfg.num_encoder_layers
    return out


def _rows(cfgs: Sequence[ModelConfig], kinds: Sequence[str]
          ) -> List[List[Fraction]]:
    """``[1, n_k ...]`` of each config: the line's unknowns' weights."""
    return [[Fraction(1)] + [Fraction(_kind_counts(c).get(k, 0))
                             for k in kinds] for c in cfgs]


def _depths(cfg: ModelConfig) -> List[ModelConfig]:
    """The shallowest configs that fix the line ``base + sum_k n_k c_k``:
    depths 1, 2, ... kept where they add a kind's count the earlier ones
    do not determine (the dense stack: 1 and 2; a hybrid of pattern
    (rec, rec, attn): 1, 2, 3), and for the encoder-decoder each stack
    grown on its own."""
    kinds = sorted(_kind_counts(cfg))
    if cfg.is_encoder_decoder:
        return [dataclasses.replace(cfg, num_layers=d, num_encoder_layers=e)
                for d, e in ((1, 1), (2, 1), (1, 2))]
    out: List[ModelConfig] = []
    for d in range(1, cfg.num_layers + 1):
        c = dataclasses.replace(cfg, num_layers=d)
        if np.linalg.matrix_rank(np.array(_rows(out + [c], kinds),
                                          dtype=float)) > len(out):
            out.append(c)
        if len(out) == len(kinds) + 1:
            break
    return out


def _flat(cost: StepCost) -> Dict[str, float]:
    """The additive fields of a count as one vector."""
    v = {"flops": cost.flops, "bytes": cost.bytes,
         "dot_flops": cost.dot_flops, "conv_flops": cost.conv_flops,
         "kernel_flops": cost.kernel_flops,
         "collective_bytes": cost.collective_bytes}
    v.update({f"bytes_by_op/{k}": x for k, x in cost.bytes_by_op.items()})
    v.update({f"launches_by_op/{k}": x
              for k, x in cost.launches_by_op.items()})
    v.update({f"collective_counts/{k}": x
              for k, x in cost.collective_counts.items()})
    v.update({f"collective_bytes_by_kind/{k}": x
              for k, x in cost.collective_bytes_by_kind.items()})
    v.update({f"memory/{k}": x for k, x in cost.memory.items()})
    return v


def _solve(rows: List[List[Fraction]], rhs: List[Fraction]
           ) -> List[Fraction]:
    """Gauss-Jordan on an exact square system."""
    n = len(rows)
    m = [r[:] + [b] for r, b in zip(rows, rhs)]
    for c in range(n):
        p = next(i for i in range(c, n) if m[i][c] != 0)
        m[c], m[p] = m[p], m[c]
        m[c] = [x / m[c][c] for x in m[c]]
        for i in range(n):
            if i != c and m[i][c] != 0:
                m[i] = [a - m[i][c] * b for a, b in zip(m[i], m[c])]
    return [r[-1] for r in m]


def count_by_repeat(cell: Cell, **cell_kw
                    ) -> Tuple[StepCost, List[int]]:
    """The count of ``cell`` from shallow copies of it: each shallow
    config (:func:`_depths`) is counted, the line ``base + sum_k n_k
    c_k`` over the layer kinds is solved exactly from the counts and
    evaluated at the cell's depth.  Returns the count and the depths
    counted.  The arguments and outputs grow on the line too, and so
    does a train step's peak (each layer keeps its saved activations for
    the backward); a serving step's peak is one layer's transients over
    the step's own whatever the depth, the largest of the shallow
    counts' peaks."""
    shallow = _depths(cell.cfg)
    kinds = sorted(_kind_counts(cell.cfg))
    if len(shallow) < len(kinds) + 1:
        return count_cell(cell), [cell.cfg.num_layers]
    vecs = [_flat(count_cell(make_cell(cell.arch, cell.shape, cfg=cfg,
                                       **cell_kw)))
            for cfg in shallow]
    rows = _rows(shallow, kinds)
    at = _rows([cell.cfg], kinds)[0]
    total: Dict[str, int] = {}
    for key in sorted(set().union(*vecs)):
        ys = [v.get(key, 0) for v in vecs]
        if key == "memory/temp_size_in_bytes" and cell.kind != "train":
            total[key] = max(ys)
            continue
        coef = _solve(rows, [Fraction(y) for y in ys])
        x = sum(a * b for a, b in zip(coef, at))
        if x.denominator != 1:
            raise ArithmeticError(f"{key}: layer repeat gives {x}")
        total[key] = int(x)
    out = StepCost(**{k: total.get(k, 0) for k in (
        "flops", "bytes", "dot_flops", "conv_flops", "kernel_flops",
        "collective_bytes")})
    for key, x in total.items():
        field, _, name = key.partition("/")
        if name and x:
            getattr(out, field)[name] = x
    return out, [c.num_layers for c in shallow]


# -- per-device argument bytes under the mesh's rules --------------------------

def _cache_axes(path: str, nd: int) -> Tuple:
    """The reference's cache sharding (``launch/steps.py:_cache_shardings``)
    as logical axes of one cache leaf."""
    if path.endswith("wkv"):
        spec = [None] * nd
        spec[nd - 4] = "batch"
        return tuple(spec)
    if path.endswith("pos"):
        return (None,) * nd
    if path.endswith("c_kv") or path.endswith("k_rope"):
        return (None, "batch", "cache_seq", None) if nd == 4 else \
            ("batch", "cache_seq", None)
    if nd == 5:
        return (None, "batch", "cache_seq", "kv_heads", None)
    if nd == 4:
        return ("batch", "cache_seq", "kv_heads", None)
    if nd == 3:
        return ("batch", None, None) if path.endswith("conv") else \
            (None, "batch", None)
    if nd == 2:
        return ("batch", None)
    return (None,) * nd


def _paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, x in enumerate(tree)
                for p in _paths(x, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _shard_bytes(t, axes, rules: AxisRules, mesh: MeshShape) -> int:
    """``t``'s bytes on one device: each dimension over the product of
    the mesh axes its logical axis takes, where that product divides it."""
    n = t.numel() * t.element_size()
    for dim, entry in zip(t.shape, rules.spec(axes)):
        names = () if entry is None else (entry,) \
            if isinstance(entry, str) else entry
        parts = 1
        for name in names:
            parts *= mesh.axis_size(name)
        if parts > 1 and dim % parts == 0:
            n //= parts
    return n


def argument_bytes_per_device(cell: Cell, rules: AxisRules,
                              mesh: MeshShape) -> int:
    """The cell's arguments on one device of ``mesh`` under ``rules``:
    parameters by their logical axes, the optimizer's state by ZeRO-1's
    rules, the batch over ("batch", "seq", "act_embed"), the cache as
    the reference shards it."""
    axes, _ = tree_flatten(param_axes(cell.cfg))
    total = 0

    def over(tree, r):
        leaves, _ = tree_flatten(tree)
        return sum(_shard_bytes(t, a, r, mesh) for t, a in zip(leaves, axes))

    def tensors(pairs):
        return [(p, t) for p, t in pairs if isinstance(t, torch.Tensor)]

    if cell.kind == "train":
        state, batch = cell.args
        total += over(state["params"], rules)
        orules = opt_rules(rules, arch_parallel_config(cell.arch))
        total += sum(over(v, orules) for k, v in state["opt"].items()
                     if k != "step")
    else:
        params, cache, batch = cell.args[:3]
        total += over(params, rules)
        for path, t in tensors(_paths(cache)):
            total += _shard_bytes(t, _cache_axes(path, t.ndim), rules, mesh)
    if isinstance(batch, dict):
        for _, t in tensors(_paths(batch)):
            total += _shard_bytes(t, ("batch", "seq", "act_embed")[:t.ndim],
                                  rules, mesh)
    else:
        total += _shard_bytes(batch, ("batch", "seq"), rules, mesh)
    return total


# -- one cell, and the sweep -----------------------------------------------------

def cell_name(arch: str, shape_name: str, mesh_kind: str) -> str:
    return f"{arch}__{shape_name}__{mesh_kind}"


def run_cell(arch: str, shape_name: str, mesh_kind: str, outdir: str, *,
             device="meta", impl: Optional[str] = None,
             batch: Optional[int] = None, layers: Optional[int] = None,
             save_ops: bool = True, optimized: bool = False,
             counts: Optional[Dict] = None) -> Dict:
    """Count one cell; returns (and writes) the record.  On ``meta`` the
    count is by layer repeat; executed cells count every layer.  The
    meshes of a cell count one step: ``counts``, a dict the caller keeps
    across calls, holds each count for the next mesh."""
    kind = dict(applicable_shapes(arch)).get(shape_name)
    if kind is None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skip(full-attn)"}
    multi_pod = mesh_kind == "multi"
    mesh = make_production_mesh(multi_pod=multi_pod)
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "kind": kind,
        "devices": 1}
    t0 = time.time()
    try:
        kw = dict(device=device, impl=impl, optimized=optimized)
        cell = make_cell(arch, shape_name, batch=batch, layers=layers, **kw)
        # the parameters of the step counted (a cut stack's own)
        rec.update(params=cell.cfg.param_count(),
                   params_active=cell.cfg.param_count(active_only=True))
        if cell.reduced:
            rec["reduced"] = cell.reduced
        counts = {} if counts is None else counts
        key = (arch, shape_name, str(device), impl, batch, layers, optimized)
        if key not in counts:
            counts[key] = count_by_repeat(cell, **kw) \
                if torch.device(device).type == "meta" \
                else (count_cell(cell), [cell.cfg.num_layers])
        cost, depths = counts[key]
        rules = arch_rules(cell.cfg, mesh, arch_parallel_config(
            arch, optimized=optimized), multi_pod=multi_pod,
            decode=kind == "decode", batch=shape.global_batch)
        rec.update(status="ok", impl=impl or default_impl(kind),
                   device=torch.device(device).type, depths_counted=depths,
                   memory=dict(cost.memory), cost=cost.to_json(),
                   argument_bytes_per_device=argument_bytes_per_device(
                       cell, rules, mesh))
        if save_ops:
            os.makedirs(outdir, exist_ok=True)
            ops_path = os.path.join(
                outdir, cell_name(arch, shape_name, mesh_kind) + ".ops.json")
            with open(ops_path, "w") as f:
                json.dump({"bytes_by_op": dict(sorted(
                    cost.bytes_by_op.items())),
                    "launches_by_op": dict(sorted(
                        cost.launches_by_op.items()))}, f, indent=1)
            rec["ops_file"] = ops_path
    except Exception as e:
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    rec["total_s"] = round(time.time() - t0, 1)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, cell_name(arch, shape_name, mesh_kind)
                           + ".json"), "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--outdir", default=OUTDIR)
    ap.add_argument("--no-hlo", action="store_true",
                    help="do not write the cells' ops files")
    ap.add_argument("--optimized", action="store_true",
                    help="the reference's microbatching for the "
                         "HBM-heaviest archs (arch_parallel_config)")
    ap.add_argument("--device", default="meta",
                    choices=["meta", "cpu", "cuda"])
    ap.add_argument("--impl", default=None,
                    help="attention impl (default: blocked, auto to decode)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells: List[Tuple[str, str, str]] = []
    if args.all:
        for arch in ASSIGNED_ARCHS:
            for shape_name, _ in applicable_shapes(arch):
                for m in meshes:
                    cells.append((arch, shape_name, m))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for m in meshes:
            cells.append((args.arch, args.shape, m))

    ok = fail = 0
    t0 = time.time()
    counts: Dict = {}
    slowest = (0.0, "")
    for arch, shape_name, m in cells:
        path = os.path.join(args.outdir,
                            cell_name(arch, shape_name, m) + ".json")
        if args.all and os.path.exists(path):
            with open(path) as f:
                prev = json.load(f)
            if prev.get("status") == "ok":
                print(f"[cached] {arch} {shape_name} {m}")
                ok += 1
                continue
        rec = run_cell(arch, shape_name, m, args.outdir, device=args.device,
                       impl=args.impl, batch=args.batch, layers=args.layers,
                       save_ops=not args.no_hlo, optimized=args.optimized,
                       counts=counts)
        tag = rec["status"]
        ok += tag == "ok"
        fail += tag == "fail"
        slowest = max(slowest, (rec.get("total_s", 0.0),
                                f"{arch} {shape_name} {m}"))
        print(f"[{tag}] {arch} {shape_name} {m} count={rec.get('total_s')}s "
              f"{rec.get('error', '')}", flush=True)
        mm = rec.get("memory") or {}
        if "temp_size_in_bytes" in mm:
            print(f"        mem: args={mm['argument_size_in_bytes']/2**30:.2f}"
                  f"GiB temp={mm['temp_size_in_bytes']/2**30:.2f}GiB "
                  f"out={mm['output_size_in_bytes']/2**30:.2f}GiB "
                  f"flops={rec['cost']['flops']:.4g}", flush=True)
    print(f"dry-run complete: {ok} ok, {fail} fail in "
          f"{time.time() - t0:.1f} s; slowest {slowest[1]} "
          f"{slowest[0]} s")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
