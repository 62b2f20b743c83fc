"""Donation rule: a donated buffer must come back as an output's storage
(the reference's ``analysis/donation.py``).

The reference donates with ``jax.jit(..., donate_argnums=...)``, a
request that XLA may drop silently, and reads the compiled module's
``input_output_alias`` header to prove each donated parameter aliases an
output.  Eager PyTorch has no such header: a function donates by writing
its results into its arguments' own tensors.  So the port proves it on a
run: :func:`trace_aliasing` reads every input leaf's storage pointer
before the call and every output leaf's after it, and
:class:`DonationAliasing` holds each donated leaf to reappear among the
outputs' storages.  A function that rebuilds its tree (the functional
commit's ``torch.where``, AdamW's ``apply``) gives fresh storages and
fails the rule.  On the card the record also keeps the call's rise in
``torch.cuda.max_memory_allocated``: what a dropped donation costs.

Named violation class: ``dropped-donation``.
"""
from __future__ import annotations

import dataclasses
from typing import (
    Any, Callable, Dict, FrozenSet, Iterable, List, Optional, Sequence,
    Tuple,
)

import torch

from repro_torch.analysis.core import Rule, Target, Violation, register_rule


def _leaves(tree: Any, out: List[Any]) -> List[Any]:
    """Leaves in ``jax.tree.leaves``' order: dict values by sorted key,
    list and tuple items in order, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _leaves(x, out)
    elif tree is not None:
        out.append(tree)
    return out


def donated_leaf_ranges(example_args: Sequence[Any],
                        donate_argnums: Iterable[int]
                        ) -> Dict[int, Tuple[int, int]]:
    """The flat leaf range of each donated positional argument (the
    reference's ``donated_param_numbers``): the arguments flatten
    depth-first, and argnum ``k`` covers the half-open range
    ``[leaves(args[:k]), + leaves(args[k]))``."""
    counts = [len(_leaves(a, [])) for a in example_args]
    starts = [0]
    for c in counts:
        starts.append(starts[-1] + c)
    return {int(k): (starts[int(k)], starts[int(k)] + counts[int(k)])
            for k in donate_argnums}


def _storage(x: Any) -> Optional[int]:
    """The address of a tensor leaf's storage; None for a leaf with none
    (a Python number)."""
    if not isinstance(x, torch.Tensor):
        return None
    return x.untyped_storage().data_ptr()


@dataclasses.dataclass
class Aliasing:
    """One call's storages: ``inputs`` a pointer a flat input leaf (None
    where the leaf has no storage), ``outputs`` every output leaf's, and
    on the card ``peak_rise``, the bytes by which the call raised
    ``torch.cuda.max_memory_allocated`` over what was allocated before it
    (None on the CPU)."""
    inputs: Tuple[Optional[int], ...]
    outputs: FrozenSet[int]
    peak_rise: Optional[int] = None

    def to_json(self) -> Dict[str, Any]:
        return {"inputs": list(self.inputs), "outputs": sorted(self.outputs),
                "peak_rise": self.peak_rise}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Aliasing":
        return cls(tuple(d["inputs"]), frozenset(d["outputs"]),
                   d["peak_rise"])


def trace_aliasing(fn: Callable, *args, device=None) -> Tuple[Any, Aliasing]:
    """Call ``fn(*args)`` and return ``(its result, the Aliasing of the
    call)``.  With ``device`` a card, the peak counter is reset first and
    read after a synchronize."""
    inputs = tuple(_storage(x) for x in _leaves(args, []))
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    result = fn(*args)
    rise = None
    if cuda:
        torch.cuda.synchronize(device)
        rise = torch.cuda.max_memory_allocated(device) - before
    outputs = frozenset(p for p in map(_storage, _leaves(result, []))
                        if p is not None)
    return result, Aliasing(inputs, outputs, rise)


@register_rule
class DonationAliasing(Rule):
    """Every donated input leaf with a storage must reappear as an output
    leaf's storage.

    ``donated`` maps a label to the flat input leaf numbers it donates
    (build it with :func:`donated_leaf_ranges`); ``min_aliased`` relaxes
    full coverage to a count for a label.  The target carries the call's
    :class:`Aliasing` (``Target.aliasing``); without one nothing can be
    proven and every label is reported."""

    name = "donation-aliasing"

    def __init__(self, donated: Dict[str, Iterable[int]], *,
                 min_aliased: Optional[Dict[str, int]] = None):
        self.donated = {k: tuple(v) for k, v in donated.items()}
        self.min_aliased = dict(min_aliased or {})

    def check(self, target: Target) -> List[Violation]:
        al = target.aliasing
        out: List[Violation] = []
        for label, leaves in self.donated.items():
            if al is None:
                out.append(self.violation(
                    "dropped-donation",
                    f"donated buffer {label!r}: the target carries no "
                    f"storage record of its call", label=label))
                continue
            held = [i for i in leaves if al.inputs[i] is not None]
            missing = [i for i in held if al.inputs[i] not in al.outputs]
            aliased = len(held) - len(missing)
            need = self.min_aliased.get(label, len(held))
            if aliased < need:
                out.append(self.violation(
                    "dropped-donation",
                    f"donated buffer {label!r}: leaves {missing} come back "
                    f"in no output's storage, the call rebuilt them "
                    f"({aliased}/{len(held)} aliased, need >= {need})",
                    label=label, missing=missing, aliased=aliased,
                    peak_rise=al.peak_rise))
        return out
