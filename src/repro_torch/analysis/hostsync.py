"""Host-sync guard: keep the round loop free of per-round stalls (the
reference's ``analysis/retrace.py``, its ``host-sync-in-loop`` half).

**host-sync-in-loop**: a device-to-host read inside a ``for``/``while``
loop.  PyTorch's surface for it: ``bool()``/``int()``/``float()``/
``complex()`` on a tensor, ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``np.asarray``/``np.array`` of a tensor, and
``torch.cuda.synchronize()`` or any ``.synchronize()``.  Each blocks the
host until the card has run everything queued before it, so once per
round it empties the card's queue (the bug the reference once shipped
was ``bool(any_push)`` every round).  The loop's one sanctioned choke point
is the ``allow``-listed fetcher (``_host_fetch`` in ``launch.train``);
values assigned from it are host values and may be cast freely.

The reference's other class, ``weak-type-arg`` (a python scalar splitting
a jit cache), has no counterpart in eager PyTorch, which keeps no trace
cache to split.

The scan is AST-only: nothing runs and nothing is imported.  It reads the
function's own body; a call into a helper is not followed.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Any, List, Optional, Sequence, Set

from repro_torch.analysis.core import Rule, Target, Violation, register_rule

HOST_CASTS = ("bool", "int", "float", "complex")
HOST_ATTRS = ("item", "tolist", "cpu", "numpy", "synchronize")
NUMPY_NAMES = ("np", "numpy")


def _call_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _call_name(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return None


def _is_allowed(name: Optional[str], allow: Sequence[str]) -> bool:
    if name is None:
        return False
    return name in allow or name.split(".")[-1] in allow


def _host_safe(node: ast.AST, host: Set[str], allow: Sequence[str]) -> bool:
    """Is this expression derived from host values (safe to cast)?"""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in host
    if isinstance(node, (ast.Attribute, ast.Subscript)):
        return _host_safe(node.value, host, allow)
    if isinstance(node, ast.Call):
        return _is_allowed(_call_name(node.func), allow)
    if isinstance(node, ast.BinOp):
        return (_host_safe(node.left, host, allow)
                and _host_safe(node.right, host, allow))
    if isinstance(node, ast.UnaryOp):
        return _host_safe(node.operand, host, allow)
    return False


def _names(t: ast.AST) -> List[str]:
    if isinstance(t, ast.Name):
        return [t.id]
    if isinstance(t, (ast.Tuple, ast.List)):
        return [n for e in t.elts for n in _names(e)]
    if isinstance(t, ast.Starred):
        return _names(t.value)
    return []


class _LoopScan:
    """Sequential scan of one function body: tracks which names were
    assigned from an allow-listed fetcher, flags host syncs inside loops."""

    def __init__(self, rule: "HostSyncGuard", fn_name: str):
        self.rule = rule
        self.fn_name = fn_name
        self.violations: List[Violation] = []

    def _track(self, stmt: ast.stmt, host: Set[str]) -> None:
        if (isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call)
                and _is_allowed(_call_name(stmt.value.func),
                                self.rule.allow)):
            for t in stmt.targets:
                host.update(_names(t))

    def _add(self, call: ast.Call, what: str, why: str) -> None:
        self.violations.append(self.rule.violation(
            "host-sync-in-loop",
            f"{self.fn_name}:{call.lineno}: {what} inside the round loop "
            f"{why}; route it through the allow-listed fetcher "
            f"{list(self.rule.allow)} or keep it on the device",
            line=call.lineno, call=what))

    def _flag(self, call: ast.Call, host: Set[str]) -> None:
        allow = self.rule.allow
        name = _call_name(call.func)
        if _is_allowed(name, allow):
            return
        if isinstance(call.func, ast.Name) and call.func.id in HOST_CASTS:
            if not all(_host_safe(a, host, allow) for a in call.args):
                self._add(call, f"{call.func.id}(...)",
                          "reads a device value on the host every round "
                          "(the bool(any_push) bug class)")
        elif isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr in HOST_ATTRS and not _host_safe(call.func.value, host,
                                                     allow):
                self._add(call, f"{name}()",
                          "blocks the host on the card's queue")
            elif (attr in ("asarray", "array")
                  and _call_name(call.func.value) in NUMPY_NAMES
                  and not all(_host_safe(a, host, allow)
                              for a in call.args)):
                self._add(call, f"{name}(...)",
                          "copies a device value to the host every round")

    def _flag_calls_in(self, node: ast.AST, host: Set[str]) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._flag(sub, host)

    def scan(self, stmts: Sequence[ast.stmt], in_loop: bool,
             host: Set[str]) -> None:
        for stmt in stmts:
            self._track(stmt, host)
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                header = stmt.iter if hasattr(stmt, "iter") else stmt.test
                if in_loop:
                    self._flag_calls_in(header, host)
                self.scan(stmt.body, True, host)
                self.scan(stmt.orelse, True, host)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested defs run when called: a fresh scope and loop state
                self.scan(stmt.body, False, set())
            elif isinstance(stmt, ast.If):
                if in_loop:
                    self._flag_calls_in(stmt.test, host)
                self.scan(stmt.body, in_loop, host)
                self.scan(stmt.orelse, in_loop, host)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                if in_loop:
                    for item in stmt.items:
                        self._flag_calls_in(item.context_expr, host)
                self.scan(stmt.body, in_loop, host)
            elif isinstance(stmt, ast.Try):
                self.scan(stmt.body, in_loop, host)
                for h in stmt.handlers:
                    self.scan(h.body, in_loop, host)
                self.scan(stmt.orelse, in_loop, host)
                self.scan(stmt.finalbody, in_loop, host)
            elif in_loop:
                self._flag_calls_in(stmt, host)


@register_rule
class HostSyncGuard(Rule):
    """AST pass over ``target.fn``'s loops for device-to-host reads.

    ``allow`` names the sanctioned fetchers; values assigned from them
    count as host values for the cast checks.
    """

    name = "host-sync-guard"

    def __init__(self, *, allow: Sequence[str] = ("_host_fetch",)):
        self.allow = tuple(allow)

    def _scan_fn(self, fn: Any) -> List[Violation]:
        fn = inspect.unwrap(fn)
        try:
            tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        except (OSError, TypeError, SyntaxError):
            return []   # no retrievable source (lambda/compiled): skip
        scan = _LoopScan(self, getattr(fn, "__name__", "<fn>"))
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan.scan(node.body, False, set())
        return scan.violations

    def check(self, target: Target) -> List[Violation]:
        return [] if target.fn is None else self._scan_fn(target.fn)
