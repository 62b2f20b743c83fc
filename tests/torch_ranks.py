"""Targets for ranks that the port's tests spawn through
``repro_torch.launch.spawn.spawn_ranks``.  A spawned process imports its
target by module name, so the targets live here, in a module that
imports torch and the port alone (no jax: each of the ranks starts
quickly)."""
import torch

from repro_torch.config import ParallelConfig
from repro_torch.configs import get_smoke_config
from repro_torch.dist import sharding as S
from repro_torch.launch.mesh import arch_rules
from repro_torch.models.lm import init_lm, param_axes
from repro_torch.utils.trees import tree_flatten


def fails_on_rank(rank, world, job):
    """Every rank but ``job["rank"]`` returns; that one raises."""
    if rank == job["rank"]:
        raise ValueError(f"rank {rank} fails on purpose")
    return {"rank": rank}


def _name(placement) -> str:
    return f"shard{placement.dim}" if placement.is_shard() else \
        "replicate" if placement.is_replicate() else str(placement)


def mesh_placements(rank, world, job):
    """qwen3-8b's smoke model on a ``job["shape"]`` (data, model)
    DeviceMesh of every rank, under ``arch_rules`` at batch 16: each
    leaf's spec and its ``AxisRules.sharding`` placements, the local
    shape of the leaf placed with ``distribute_tensor`` and whether
    ``constrain`` to full replication gives the leaf back; and
    ``constrain`` of a (16, 32) batch,
    of a DTensor back to replication, and with no mesh bound."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    torch.set_num_threads(1)
    cfg = get_smoke_config("qwen3-8b")
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(job["shape"]),
                      mesh_dim_names=("data", "model"))
    rules = arch_rules(cfg, S.mesh_shape(mesh), ParallelConfig(),
                       batch=16).bind(mesh)
    params = init_lm(cfg, 0, "cpu")
    axes, _ = tree_flatten(param_axes(cfg))
    leaves, _ = tree_flatten(params)
    shardings, _ = tree_flatten(S.param_sharding_tree(param_axes(cfg), rules))
    out = {"leaves": []}
    for a, x, sh in zip(axes, leaves, shardings):
        d = distribute_tensor(x, sh.mesh, sh.placements)
        out["leaves"].append({
            "spec": [list(e) if isinstance(e, tuple) else e
                     for e in rules.spec(a)],
            "placements": [_name(p) for p in sh.placements],
            "direct": [_name(p) for p in rules.sharding(a).placements],
            "local": list(d.to_local().shape),
            "whole": bool(torch.equal(S.constrain(d, rules).to_local(), x))})
    batch = torch.arange(16 * 32).reshape(16, 32)
    c = S.constrain(batch, rules, "batch", "seq")
    out["batch_local"] = c.to_local().tolist()
    back = S.constrain(c, rules, None, None)
    out["batch_back"] = bool(torch.equal(back.to_local(), batch))
    unbound = S.AxisRules(rules.rules, mesh=rules.mesh)
    out["identity"] = S.constrain(batch, unbound, "batch") is batch
    return out
