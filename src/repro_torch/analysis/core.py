"""Rule registry + the single ``analyze(rules, ...)`` entry point (the
reference's ``analysis/core.py``).

A rule inspects one :class:`Target` statically and returns
:class:`Violation` records with a **named violation class**; ``analyze``
raises :class:`AnalysisError` (an ``AssertionError``, so pytest and the
audit callers treat it like an inline assert) listing every violation.
The reference's rules read lowered HLO; eager PyTorch has none, so a
target carries the kernels' launch specs (``kernels/build.py:
LaunchSpec``) and the collectives a rank issued in its place, beside the
python callable whose source the AST rules read, and for the donation
rule the storages of one call (``analysis.donation.Aliasing``).  Nothing
here launches a kernel or imports a device runtime.

Adding a rule::

    @register_rule
    class MyRule(Rule):
        name = "my-rule"
        def check(self, target: Target) -> List[Violation]:
            ...
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type


@dataclasses.dataclass
class Violation:
    """One broken invariant: ``rule`` is the rule name, ``cls`` the named
    violation class (e.g. ``tile-misaligned``, ``host-sync-in-loop``),
    ``detail`` whatever structured evidence the rule collected."""
    rule: str
    cls: str
    message: str
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __str__(self) -> str:
        return f"[{self.rule}/{self.cls}] {self.message}"


class AnalysisError(AssertionError):
    """Raised by :func:`analyze` when any rule reports violations."""

    def __init__(self, label: str, violations: Sequence[Violation]):
        self.label = label
        self.violations = list(violations)
        lines = [f"analysis failed for {label}: "
                 f"{len(self.violations)} violation(s)"]
        lines += [f"  {v}" for v in self.violations]
        super().__init__("\n".join(lines))


@dataclasses.dataclass
class Target:
    """What a rule sees: the python callable (``fn``, with
    ``example_args``) for the AST rules, the kernel launch specs
    (``launches``) for the tile lint, and the collectives one rank
    issued (``collectives``: ``analysis.collectives.records``) for the
    collective-placement rule, and the storages of one call
    (``aliasing``: ``analysis.donation.Aliasing``) for the donation
    rule."""
    fn: Optional[Callable] = None
    example_args: Tuple = ()
    label: str = "<target>"
    launches: Tuple[Any, ...] = ()
    collectives: Tuple[Dict[str, Any], ...] = ()
    aliasing: Any = None


class Rule:
    """Base class: subclasses set ``name`` and implement ``check``."""

    name = "rule"

    def check(self, target: Target) -> List[Violation]:
        raise NotImplementedError

    def violation(self, cls: str, message: str, **detail) -> Violation:
        return Violation(rule=self.name, cls=cls, message=message,
                         detail=detail)


RULE_REGISTRY: Dict[str, Type[Rule]] = {}


def register_rule(cls: Type[Rule]) -> Type[Rule]:
    """Class decorator: adds the rule class to the registry by ``name``."""
    if cls.name in RULE_REGISTRY and RULE_REGISTRY[cls.name] is not cls:
        raise ValueError(f"analysis rule {cls.name!r} already registered")
    RULE_REGISTRY[cls.name] = cls
    return cls


@dataclasses.dataclass
class Report:
    label: str
    violations: List[Violation]
    rules: List[str]

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_if_failed(self) -> "Report":
        if self.violations:
            raise AnalysisError(self.label, self.violations)
        return self

    def to_json(self) -> Dict[str, Any]:
        return {"label": self.label, "ok": self.ok, "rules": self.rules,
                "violations": [dataclasses.asdict(v)
                               for v in self.violations]}


def analyze(rules: Sequence[Rule], *, fn: Optional[Callable] = None,
            example_args: Tuple = (), launches: Sequence[Any] = (),
            collectives: Sequence[Dict[str, Any]] = (),
            aliasing: Any = None, label: Optional[str] = None,
            fail: bool = True) -> Report:
    """Run ``rules`` over one target; the analyzer's one entry point.

    ``fn``/``example_args`` feed the rules that read source, ``launches``
    (launch specs) the tile lint, ``collectives`` (counted records) the
    collective placement, ``aliasing`` (one call's storages) the
    donation rule.  With ``fail=True`` (default) any
    violation raises :class:`AnalysisError` naming every violation class;
    ``fail=False`` returns the :class:`Report` for callers that
    aggregate."""
    target = Target(fn=fn, example_args=tuple(example_args),
                    label=label or getattr(fn, "__name__", "<target>"),
                    launches=tuple(launches),
                    collectives=tuple(collectives), aliasing=aliasing)
    violations: List[Violation] = []
    for rule in rules:
        violations.extend(rule.check(target))
    report = Report(label=target.label, violations=violations,
                    rules=[r.name for r in rules])
    if fail:
        report.raise_if_failed()
    return report
