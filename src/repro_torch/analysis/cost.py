"""The cost of a step, counted as it runs (the cost walk of the
reference's ``analysis/hlo_parse.py``).

The reference compiles a step and walks the optimized HLO: dot and
convolution FLOPs from operand shapes, the HBM bytes of each top-level
op (its operands read and its result written once), the collectives'
operand bytes, and each while loop's body multiplied by its
``known_trip_count``, because ``compiled.cost_analysis()`` counts a loop
body once.  Eager PyTorch has no compiled module: :func:`count_cost` runs
the step under a :class:`CostCounter`, a ``TorchDispatchMode`` that sees
every aten op the step dispatches, forward and backward:

* FLOPs from ``torch.utils.flop_counter``'s formulas (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, SDPA and their backward formulas into
  ``dot_flops``, the convolutions into ``conv_flops``);
* bytes: each op's tensor inputs plus its outputs, by op name in
  ``bytes_by_op``.  An eager op is its own launch, which reads its inputs
  and writes its outputs through memory: the counterpart of the
  reference's charge per fusion.  Views and metadata ops (``view``,
  ``expand``, ``permute``, ``detach``, ...) move nothing and are skipped,
  as the reference skips ``bitcast``, ``tuple`` and the like; so are
  allocations that write nothing (``empty``) and copies from a host
  tensor (on the CPU they are no op at all);
* launches: one a charged op, by op name in ``launches_by_op``;
* collectives: ``analysis/collectives.py:count_collectives``' log of the
  ``torch.distributed`` calls, one record each, its tier (``pod``,
  ``intra``, ``cluster``) where the reference reads replica groups;
* the port's CUDA kernels launch through ``ctypes`` and are invisible to
  a dispatch mode: each entry of ``kernels/ops.py`` charges itself as one
  unit, ``kernel:<name>``, with its module's ``cost`` (FLOPs into
  ``kernel_flops``), and its own ops inside are not charged
  (:func:`charge_kernel`).  On ``meta`` tensors an entry only charges and
  returns empty outputs of the right shapes.

Loops need no multiplication: eager runs every iteration, so every
launch is seen.  The one multiply is the dry run's layer-repeat shortcut
(``launch/dryrun.py``), which tests hold equal to the counted stack.

Memory, the counterpart of ``compiled.memory_analysis()``: the
arguments' storage, the outputs' storage, the outputs that live in a
donated argument's storage (found by storage, as
``analysis/donation.py`` finds them), and the peak of live storage the
step allocated (each new storage tracked from the op that made it to its
release, by a finalizer on the storage).  ``generated_code_size_in_bytes``
has no counterpart and is left out.

Counted on ``meta`` tensors nothing is allocated, so a full-size step
costs only its dispatch; the same step on CPU or CUDA tensors counts the
same integers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode_stack,
)
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.collectives import count_collectives, records

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.float16: 2, torch.bfloat16: 2, torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}

#: ops that move no bytes: views, aliases and metadata (the reference's
#: ``bitcast`` / ``tuple`` / ``get-tuple-element`` / ``parameter``), and
#: allocations that write nothing
SKIPPED = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "t",
    "transpose", "permute", "as_strided", "detach", "alias", "squeeze",
    "unsqueeze", "select", "slice", "narrow", "unbind", "split",
    "split_with_sizes", "chunk", "diagonal", "unfold", "view_as",
    "view_as_real", "view_as_complex", "lift_fresh", "lift_fresh_copy",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_local_scalar_dense",
})


def shape_bytes(shape: Sequence[int], dtype: torch.dtype) -> int:
    """Bytes of an array of ``shape`` and ``dtype``."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * DTYPE_BYTES[dtype]


def shape_dims(shape: Sequence[int]) -> List[int]:
    """The dims of ``shape`` as ints (the reference reads them off an HLO
    type string)."""
    return [int(d) for d in shape]


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors(tree, out: Optional[List[torch.Tensor]] = None
            ) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in order (the
    dispatch's arguments and outputs, a step's arguments)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensors(x, out)
    return out


@dataclasses.dataclass
class StepCost:
    """The reference's ``HloCost`` fields, plus ``kernel_flops`` (the CUDA
    kernels' own counts, inside ``flops``), ``launches_by_op`` and
    ``memory`` (``argument_size_in_bytes``, ``output_size_in_bytes``,
    ``alias_size_in_bytes``, ``temp_size_in_bytes``)."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    dot_flops: float = 0.0
    conv_flops: float = 0.0
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_ops: List[Dict] = dataclasses.field(default_factory=list)
    kernel_flops: float = 0.0
    launches_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    memory: Dict[str, int] = dataclasses.field(default_factory=dict)

    def charge(self, op: str, b: float):
        self.bytes += b
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + b

    def add(self, other: "StepCost", times: float = 1):
        """``times`` x ``other`` into this cost (memory is not additive
        and is left alone)."""
        self.flops += other.flops * times
        self.bytes += other.bytes * times
        self.collective_bytes += other.collective_bytes * times
        self.dot_flops += other.dot_flops * times
        self.conv_flops += other.conv_flops * times
        self.kernel_flops += other.kernel_flops * times
        for k, v in other.collective_counts.items():
            self.collective_counts[k] = self.collective_counts.get(k, 0) + \
                int(v * times)
        for k, v in other.collective_bytes_by_kind.items():
            self.collective_bytes_by_kind[k] = \
                self.collective_bytes_by_kind.get(k, 0) + v * times
        for k, v in other.bytes_by_op.items():
            self.bytes_by_op[k] = self.bytes_by_op.get(k, 0) + v * times
        for k, v in other.launches_by_op.items():
            self.launches_by_op[k] = self.launches_by_op.get(k, 0) + \
                int(v * times)
        self.collective_ops.extend(
            other.collective_ops * max(1, int(times)))

    @property
    def launches(self) -> int:
        return sum(self.launches_by_op.values())

    def counts(self) -> Dict[str, Any]:
        """The integers a run is compared on: FLOPs of each kind, bytes,
        and bytes and launches by op."""
        return {"flops": self.flops, "dot_flops": self.dot_flops,
                "conv_flops": self.conv_flops,
                "kernel_flops": self.kernel_flops, "bytes": self.bytes,
                "bytes_by_op": dict(sorted(self.bytes_by_op.items())),
                "launches_by_op": dict(sorted(self.launches_by_op.items())),
                "collective_bytes": self.collective_bytes,
                "collective_counts": dict(self.collective_counts)}

    def to_json(self) -> Dict[str, Any]:
        """The record's ``cost``: the reference's keys of
        ``cost_analysis()`` (``flops``, ``bytes accessed``) and the
        counted fields."""
        return {"flops": float(self.flops),
               "bytes accessed": float(self.bytes),
               "dot_flops": float(self.dot_flops),
               "conv_flops": float(self.conv_flops),
               "kernel_flops": float(self.kernel_flops),
               "collective_bytes": float(self.collective_bytes),
               "collective_counts": dict(self.collective_counts),
               "collective_bytes_by_kind": dict(
                   self.collective_bytes_by_kind),
               "launches": self.launches}


def _storage_key(t: torch.Tensor) -> int:
    """A storage's identity on any device (``donation.py:_storage`` reads
    its address, which is 0 for every ``meta`` storage)."""
    return t.untyped_storage()._cdata


def active() -> Optional["CostCounter"]:
    """The innermost counter counting now (on this thread's stack of
    dispatch modes), or None."""
    return next((m for m in reversed(_get_current_dispatch_mode_stack())
                 if isinstance(m, CostCounter)), None)


class CostCounter(TorchDispatchMode):
    """Charges every aten op dispatched under it into ``cost`` and tracks
    the storage it allocates (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self._suspended = 0
        self._lock = threading.Lock()
        self._known: Dict[int, int] = {}      # storage -> bytes, live
        self._live = 0
        self._peak = 0
        self._open = True

    # -- memory ---------------------------------------------------------
    def adopt(self, tensors) -> None:
        """Storages that exist before the step (its arguments): not
        allocated by it."""
        for t in tensors:
            self._known.setdefault(_storage_key(t), -1)

    def _track(self, outs: List[torch.Tensor]) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            n = st.nbytes()
            with self._lock:
                self._known[key] = n
                self._live += n
                self._peak = max(self._peak, self._live)
            weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        with self._lock:
            n = self._known.pop(key, -1)
            if n > 0 and self._open:
                self._live -= n

    # -- charging -------------------------------------------------------
    @contextlib.contextmanager
    def unit(self, name: str, flops: int, nbytes: int):
        """Charge one launch of ``name`` with ``flops`` and ``nbytes``, and
        charge nothing of what runs inside (its storage is still
        tracked)."""
        c = self.cost
        c.flops += flops
        c.kernel_flops += flops
        c.charge(name, nbytes)
        c.launches_by_op[name] = c.launches_by_op.get(name, 0) + 1
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in ("lift_fresh", "lift_fresh_copy"):
            # a view makes no storage; a constant from host data is not
            # the step's
            return out
        ins = tensors(kwargs, tensors(args))
        outs = tensors(out)
        if name in ("_to_copy", "copy_") and ins and outs:
            src = ins[-1] if name == "copy_" else ins[0]
            if (src.device.type == "cpu" and outs[0].device.type != "cpu"
                    and src.dtype == outs[0].dtype):
                # a host-to-device copy: on the CPU no op at all, and no
                # storage (a cast on the way is the CPU's cast too, and
                # is charged)
                return out
        self._track(outs)
        if self._suspended or name in SKIPPED:
            return out
        c = self.cost
        packet = func.overloadpacket
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            c.flops += f
            if "convolution" in name:
                c.conv_flops += f
            else:
                c.dot_flops += f
        c.charge(name, sum(map(tensor_bytes, ins))
                 + sum(map(tensor_bytes, outs)))
        c.launches_by_op[name] = c.launches_by_op.get(name, 0) + 1
        return out


def charge_kernel(name: str, cost: Callable[[], Tuple[int, int]],
                  meta: Callable[[], Any], run: Callable[[], Any],
                  on_meta: bool):
    """An entry of ``kernels/ops.py`` under the active counter: charge
    ``kernel:<name>`` once with ``cost()`` (FLOPs, bytes), then return
    ``meta()`` (empty outputs of the right shapes) on ``meta`` tensors, or
    ``run()`` (the kernel on a card, the plain version on the CPU) with
    its own ops uncharged.  Outside a counter it is ``run()``."""
    counter = active()
    if counter is None:
        return run()
    counter._suspended += 1
    try:
        flops, nbytes = cost()
    finally:
        counter._suspended -= 1
    with counter.unit(f"kernel:{name}", int(flops), int(nbytes)):
        return meta() if on_meta else run()


def _fill_collectives(cost: StepCost, log: Sequence, groups,
                      computation: str) -> None:
    for rec in records(log, groups):
        kind = rec["kind"]
        b = sum(op["bytes"] for op in rec["operands"])
        cost.collective_ops.append({**rec, "computation": computation,
                                    "operand_bytes": int(b)})
        cost.collective_bytes += b
        cost.collective_counts[kind] = cost.collective_counts.get(kind, 0) + 1
        cost.collective_bytes_by_kind[kind] = \
            cost.collective_bytes_by_kind.get(kind, 0) + b


def count_cost(fn: Callable, *args, donate: Sequence[int] = (),
               groups=None, **kw) -> Tuple[Any, StepCost]:
    """Run ``fn(*args, **kw)`` under a :class:`CostCounter`; return its
    output and the :class:`StepCost` of the run.  ``donate`` names the
    positional arguments donated (the train state, a serving cache):
    outputs in their storage are ``alias_size_in_bytes``.  ``groups`` (a
    ``launch.mesh.PodGroups``) names the collectives' tiers."""
    arg_leaves = tensors(kw, tensors(args))
    donated = {_storage_key(t) for i in donate for t in tensors(args[i])}
    log: List = []
    restore = count_collectives(log)
    counter = CostCounter()
    counter.adopt(arg_leaves)
    try:
        with counter:
            out = fn(*args, **kw)
    finally:
        restore()
        counter._open = False
    cost = counter.cost
    _fill_collectives(cost, log, groups, getattr(fn, "__name__", "step"))

    def unique_bytes(leaves) -> Dict[int, int]:
        return {_storage_key(t): t.untyped_storage().nbytes()
                for t in leaves}

    outs = unique_bytes(tensors(out))
    cost.memory = {
        "argument_size_in_bytes": sum(unique_bytes(arg_leaves).values()),
        "output_size_in_bytes": sum(outs.values()),
        "alias_size_in_bytes": sum(n for k, n in outs.items()
                                   if k in donated),
        "temp_size_in_bytes": counter._peak,
    }
    return out, cost
