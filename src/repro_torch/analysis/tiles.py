"""Kernel tile lint: static launch-spec and source checks for the port's
CUDA kernels (the reference's ``analysis/pallas.py``, ``PallasTileLint``).

The reference traces each ``pallas_call`` and reads its BlockSpecs and
kernel-body dtypes.  A CUDA kernel has neither: its tiling is the
arithmetic of its C launcher and the offsets it computes from
``blockIdx``.  So every kernel module repeats that arithmetic in a pure
``launch_spec`` (``kernels/build.py:LaunchSpec``: grid, threads, dynamic
shared memory, each operand's array and per-block tile), and this rule
reads those specs and the ``.cu`` sources.  It launches nothing and needs
no card.

Named violation classes, with their Hopper meanings:

* ``tile-misaligned``: a tiled dimension (tile smaller than the array)
  whose tile does not divide the array's extent, so the last block of
  that dimension is partial and has to be masked on every launch.
* ``tile-below-minimum``: the Hopper minimums standing in for the TPU's
  ``(8k, 128)`` tile.  A tile's contiguous (last) extent times its
  element size must be a whole number of 128-byte segments (one warp's
  coalesced access: four 32-byte sectors), and a block's thread count a
  whole number of 32-thread warps.  A last dimension taken at the
  array's full extent is exempt, as in the reference; so is an operand
  read or written one value per block (``Operand.gather``: the
  quantization scales), which is a gather, not a tile.
* ``low-precision-accumulate``: the kernel sums in fp16 or bf16.  The
  rule finds every accumulation in the kernel's source and in the
  ``__device__`` helpers of the same source that it calls (``+=``,
  ``-=``, a variable assigned from an add or FMA of itself, or an array
  handed to a helper that updates it through a read-write ``asm``
  operand, as a ``wgmma`` accumulator is), reads each accumulated
  variable's declared type where it is declared, resolves template
  parameters through the spec, and fires on a 16-bit float.  The spec's
  ``accumulator`` must name one of them: its type is read from the
  source, never from the spec.
* ``pack-pairing-drift``: the Python constants ``BLOCK`` / ``HALF`` /
  ``LANE`` differ across ``dist/wire.py``, ``kernels/pack.py``,
  ``kernels/dequant_merge.py`` and ``kernels/quantize.py``, or from the
  ``constexpr`` values ``kBlock`` / ``kHalf`` / ``kThreads`` of
  ``csrc/wire_kernels.cu``; or a launch spec's ``constants``, or its
  threads (``threads_of``), differ from its source's ``constexpr``
  values.  Any of these puts the packed layout or a block's tiling out of
  step with what the kernel indexes.
"""
from __future__ import annotations

import ast
import operator
import re
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.analysis.core import Rule, Target, Violation, register_rule

SEGMENT_BYTES = 128   # one warp's coalesced access: four 32-byte sectors
WARP = 32
ITEMSIZE = {"float64": 8, "float32": 4, "int32": 4, "uint32": 4,
            "bfloat16": 2, "float16": 2, "int8": 1, "uint8": 1, "bool": 1}
LOW_PRECISION = ("float16", "bfloat16")
# C type -> dtype name
C_TYPES = {"float": "float32", "double": "float64", "int": "int32",
           "__nv_bfloat16": "bfloat16",
           "nv_bfloat16": "bfloat16", "__nv_bfloat162": "bfloat16",
           "__half": "float16", "half": "float16", "__half2": "float16"}
_ADD_FNS = ("fmaf", "fma", "__fmaf_rn", "__fadd_rn", "__fsub_rn", "__hadd",
            "__hsub", "__hfma", "__hadd2", "__hsub2", "__hfma2")
_QUALIFIERS = ("const", "static", "volatile", "register", "constexpr",
               "__shared__", "extern", "unsigned", "signed")
_KEYWORDS = ("return", "if", "else", "for", "while", "do", "switch",
             "case", "goto", "break", "continue", "sizeof")


# -- reading a CUDA source -----------------------------------------------

def _strip_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    return re.sub(r"//[^\n]*", "", src)


def constexprs(src: str) -> Dict[str, int]:
    """Every integer ``constexpr`` of a source, evaluated in order (an
    expression may use the ones before it: ``kHalf = kBlock / 2``)."""
    out: Dict[str, int] = {}
    for name, expr in re.findall(
            r"\bconstexpr\s+(?:int|unsigned|long long|long|size_t)\s+"
            r"(\w+)\s*=\s*([^;]+);", _strip_comments(src)):
        value = eval_c(expr, out)
        if value is not None:
            out[name] = value
    return out


_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub,
           ast.Mult: operator.mul, ast.Div: operator.floordiv,
           ast.FloorDiv: operator.floordiv, ast.Mod: operator.mod}


def eval_c(expr: str, names: Mapping[str, int]) -> Optional[int]:
    """An integer C expression of literals, known names, + - * / % and
    parentheses (``/`` truncates, as C's does for these non-negative
    values); None when it holds anything else."""
    try:
        tree = ast.parse(expr.strip(), mode="eval")
    except SyntaxError:
        return None

    def ev(n):
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return n.value
        if isinstance(n, ast.Name) and n.id in names:
            return names[n.id]
        if isinstance(n, ast.BinOp) and type(n.op) in _BINOPS:
            return _BINOPS[type(n.op)](ev(n.left), ev(n.right))
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -ev(n.operand)
        raise ValueError(ast.dump(n))

    try:
        return ev(tree.body)
    except (ValueError, ZeroDivisionError):
        return None


def _matching(text: str, start: int, open_: str, close: str) -> int:
    """Index just past the bracket that closes ``text[start]``."""
    depth = 0
    for i in range(start, len(text)):
        if text[i] == open_:
            depth += 1
        elif text[i] == close:
            depth -= 1
            if depth == 0:
                return i + 1
    raise ValueError(f"unbalanced {open_}{close}")


def kernel_text(src: str, function: str) -> Optional[Tuple[str, str]]:
    """``(parameters, body)`` of the ``__global__`` function ``function``
    in ``src``, or None when the source defines no such kernel."""
    src = _strip_comments(src)
    for m in re.finditer(r"__global__", src):
        head_end = src.find("{", m.end())
        if head_end < 0:
            return None
        head = src[m.end():head_end]
        name = re.search(rf"\b{re.escape(function)}\s*\(", head)
        if name is None or ";" in head[:name.start()]:
            continue
        p0 = m.end() + name.end() - 1
        p1 = _matching(src, p0, "(", ")")
        b0 = src.find("{", p1)
        return src[p0 + 1:p1 - 1], src[b0 + 1:_matching(src, b0, "{", "}") - 1]
    return None


def declarations(params: str, body: str) -> Dict[str, str]:
    """Declared C type of each name in a kernel's parameters and body
    (``float m[RM], l[RM], acc[RM][DN]`` declares three floats)."""
    out: Dict[str, str] = {}
    chunks = params.split(",") + re.split(r"[;{}()]", body)
    for chunk in chunks:
        chunk = chunk.replace("__restrict__", " ")
        words = chunk.replace("*", " ").replace("&", " ").split()
        while words and words[0] in _QUALIFIERS:
            words = words[1:]
        if len(words) < 2 or not re.fullmatch(r"[A-Za-z_]\w*", words[0]) \
                or words[0] in _KEYWORDS:
            continue
        rest = chunk[chunk.find(words[0]) + len(words[0]):]
        depth, start = 0, 0
        for i, ch in enumerate(rest + ","):
            if ch in "[(<":
                depth += 1
            elif ch in "])>":
                depth -= 1
            elif ch == "," and depth == 0:
                name = re.match(r"[\s*&]*([A-Za-z_]\w*)", rest[start:i])
                if name:
                    out.setdefault(name.group(1), words[0])
                start = i + 1
    return out


# an assignment: a name, its indices, then =, += or -= (not ==, <=, *=, ...)
_ASSIGN = re.compile(r"([A-Za-z_]\w*)\s*(?:\[[^\[\]=;]*\])*\s*"
                     r"(\+=|-=|(?<![=!<>+\-*/%&|^])=(?!=))")
_ADD_CALL = re.compile(rf"\b({'|'.join(_ADD_FNS)})\s*\(")


def accumulations(body: str) -> List[str]:
    """The variables a kernel body sums into: ``x += e``, ``x -= e``, or
    ``x = ...`` whose right side reads ``x`` through an add, a subtract
    or an add / FMA intrinsic."""
    out = set()
    for stmt in re.split(r"[;{}]", body):
        hits = list(_ASSIGN.finditer(stmt))
        for k, m in enumerate(hits):
            name, op = m.group(1), m.group(2)
            end = hits[k + 1].start() if k + 1 < len(hits) else len(stmt)
            rhs = stmt[m.end():end]
            if op != "=" or (re.search(rf"\b{name}\b", rhs) and (
                    _ADD_CALL.search(rhs) or re.search(r"[+-]", rhs))):
                out.add(name)
    return sorted(out)


def _split_top(text: str) -> List[str]:
    """``text`` split at its top-level commas."""
    out, depth, start = [], 0, 0
    for i, ch in enumerate(text + ","):
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        elif ch == "," and depth == 0:
            out.append(text[start:i])
            start = i + 1
    return out


def _param_name(param: str) -> Optional[str]:
    """The name a C parameter declares (``float (&d)[32]`` declares d)."""
    ref = re.search(r"\(\s*[&*]\s*([A-Za-z_]\w*)\s*\)", param)
    if ref:
        return ref.group(1)
    name = re.search(r"([A-Za-z_]\w*)\s*(?:\[[^\]]*\]\s*)*$", param.strip())
    return name.group(1) if name else None


def asm_updaters(src: str) -> Dict[str, List[int]]:
    """``__device__`` helpers of ``src`` that update a parameter through a
    read-write ``asm`` operand (``"+f"(d[0])``): name -> the indices of
    those parameters."""
    src = _strip_comments(src)
    out: Dict[str, List[int]] = {}
    for m in re.finditer(r"__device__", src):
        brace, semi = src.find("{", m.end()), src.find(";", m.end())
        if brace < 0 or 0 <= semi < brace:
            continue
        head = src[m.end():brace]
        name = re.search(r"([A-Za-z_]\w*)\s*\(", head)
        if name is None:
            continue
        p0 = m.end() + name.end() - 1
        params = [_param_name(x) for x in
                  _split_top(src[p0 + 1:_matching(src, p0, "(", ")") - 1])]
        body = src[brace:_matching(src, brace, "{", "}")]
        updated = set(re.findall(r'"\+[a-z]"\s*\(\s*([A-Za-z_]\w*)', body))
        idx = [i for i, p in enumerate(params) if p in updated]
        if idx:
            out[name.group(1)] = idx
    return out


def call_accumulations(body: str, updaters: Mapping[str, List[int]]
                       ) -> List[str]:
    """The variables a kernel body hands to an :func:`asm_updaters`
    helper in an updated position (``wgmma_rs(o[cb], a, desc)``: o)."""
    out = set()
    for name, idx in updaters.items():
        for m in re.finditer(rf"\b{re.escape(name)}\s*\(", body):
            p0 = m.end() - 1
            args = _split_top(body[p0 + 1:_matching(body, p0, "(", ")") - 1])
            for i in idx:
                root = (re.match(r"\s*&?\s*([A-Za-z_]\w*)", args[i])
                        if i < len(args) else None)
                if root:
                    out.add(root.group(1))
    return sorted(out)


def device_functions(src: str) -> Dict[str, Tuple[str, str]]:
    """Every ``__device__`` function of ``src`` that has a body: name ->
    ``(parameters, body)``."""
    src = _strip_comments(src)
    out: Dict[str, Tuple[str, str]] = {}
    for m in re.finditer(r"__device__", src):
        brace, semi = src.find("{", m.end()), src.find(";", m.end())
        if brace < 0 or 0 <= semi < brace:
            continue
        name = re.search(r"([A-Za-z_]\w*)\s*\(", src[m.end():brace])
        if name is None:
            continue
        p0 = m.end() + name.end() - 1
        p1 = _matching(src, p0, "(", ")")
        out.setdefault(name.group(1), (
            src[p0 + 1:p1 - 1],
            src[brace + 1:_matching(src, brace, "{", "}") - 1]))
    return out


def called_helpers(body: str, helpers: Mapping[str, Tuple[str, str]]
                   ) -> List[str]:
    """The :func:`device_functions` a kernel body calls, directly or
    through one another (``merge_tiles<true, I>(...)`` calls
    merge_tiles)."""
    seen: List[str] = []
    todo = [body]
    while todo:
        text = todo.pop()
        for name in helpers:
            if name not in seen and re.search(
                    rf"\b{re.escape(name)}\s*(?:<[^;{{}}()]*>)?\s*\(",
                    text):
                seen.append(name)
                todo.append(helpers[name][1])
    return seen


def _dtype(ctype: Optional[str], template: Mapping[str, str]) -> str:
    """A declared C type as a dtype name, template parameters resolved."""
    ctype = template.get(ctype, ctype) or "?"
    return C_TYPES.get(ctype, ctype)


# -- the rule ----------------------------------------------------------------

@register_rule
class KernelTileLint(Rule):
    """Lint every launch spec of ``target.launches`` against its source;
    ``check_constants`` adds the wire path's BLOCK / HALF / LANE /
    ``kThreads`` pairing."""

    name = "kernel-tile"

    def __init__(self, *, check_constants: bool = False):
        self.check_constants = check_constants

    # -- tiles ------------------------------------------------------------
    def _lint_operand(self, label: str, op) -> List[Violation]:
        out: List[Violation] = []
        array, tile = tuple(op.array), tuple(op.tile)
        where = f"{label}:{op.name}"
        if len(array) != len(tile):
            return [self.violation(
                "tile-misaligned", f"{where}: tile {list(tile)} has another "
                f"rank than the array {list(array)}", operand=op.name)]
        tiled = [i for i in range(len(array)) if tile[i] != array[i]]
        for i in tiled:
            if tile[i] <= 0 or array[i] % tile[i]:
                out.append(self.violation(
                    "tile-misaligned",
                    f"{where}: tile dim {i} = {tile[i]} does not tile array "
                    f"dim {array[i]} ({op.dtype}{list(array)} vs tile "
                    f"{list(tile)})", operand=op.name, dim=i,
                    tile=list(tile), array=list(array), dtype=op.dtype))
        run = tile[-1] * ITEMSIZE[op.dtype] if tile else 0
        if tile and (len(array) - 1) in tiled and not op.gather \
                and run % SEGMENT_BYTES:
            out.append(self.violation(
                "tile-below-minimum",
                f"{where}: a tile row is {tile[-1]} x {op.dtype} = {run} B, "
                f"not whole {SEGMENT_BYTES}-B segments", operand=op.name,
                tile=list(tile), dtype=op.dtype, bytes=run))
        return out

    # -- source -----------------------------------------------------------
    def _lint_source(self, label: str, spec, src: str) -> List[Violation]:
        out: List[Violation] = []
        found = kernel_text(src, spec.function)
        if found is None:
            return [self.violation(
                "pack-pairing-drift", f"{label}: {spec.source} defines no "
                f"__global__ {spec.function}", function=spec.function)]
        params, body = found
        helpers = device_functions(src)
        updaters = asm_updaters(src)
        kernel_types = declarations(params, body)
        accs: Dict[str, str] = {}
        # the kernel's body and every __device__ helper it calls, each
        # accumulation typed where it is declared
        for p, b in [(params, body)] + [helpers[n] for n in
                                        called_helpers(body, helpers)]:
            types = {**kernel_types, **declarations(p, b)}
            for name in set(accumulations(b)) | set(
                    call_accumulations(b, updaters)):
                dtype = _dtype(types.get(name), spec.template)
                if accs.get(name) not in LOW_PRECISION:
                    accs[name] = dtype
        for name, dtype in sorted(accs.items()):
            if dtype in LOW_PRECISION:
                out.append(self.violation(
                    "low-precision-accumulate",
                    f"{label}: {spec.function} accumulates {name} in "
                    f"{dtype}; accumulate in fp32 and cast on the way out",
                    variable=name, dtype=dtype))
        if spec.accumulator is not None and spec.accumulator not in accs:
            out.append(self.violation(
                "pack-pairing-drift",
                f"{label}: the spec's accumulator {spec.accumulator!r} is "
                f"not summed in {spec.function} (it sums {sorted(accs)})",
                accumulator=spec.accumulator))
        values = constexprs(src)
        for name, want in spec.constants.items():
            if values.get(name) != want:
                out.append(self.violation(
                    "pack-pairing-drift",
                    f"{label}: the spec assumes {name} = {want}, "
                    f"{Path(spec.source).name} has {values.get(name)}",
                    constant=name, spec=want, source=values.get(name)))
        if spec.threads_of is not None:
            want = eval_c(spec.threads_of, values)
            if want != spec.threads:
                out.append(self.violation(
                    "pack-pairing-drift",
                    f"{label}: the spec launches {spec.threads} threads, "
                    f"the source's {spec.threads_of} is {want}",
                    threads=spec.threads, source=want))
        return out

    def _lint_spec(self, label: str, spec) -> List[Violation]:
        label = f"{label}#{spec.kernel}"
        out: List[Violation] = []
        for op in spec.operands:
            out.extend(self._lint_operand(label, op))
        if spec.threads % WARP:
            out.append(self.violation(
                "tile-below-minimum",
                f"{label}: {spec.threads} threads a block is not whole "
                f"{WARP}-thread warps", threads=spec.threads))
        out.extend(self._lint_source(label, spec,
                                     Path(spec.source).read_text()))
        return out

    # -- wire constants ---------------------------------------------------
    def _lint_constants(self) -> List[Violation]:
        from repro_torch.dist import wire
        from repro_torch.kernels import build
        from repro_torch.kernels import dequant_merge as dqm
        from repro_torch.kernels import pack as pk
        from repro_torch.kernels import quantize as qz

        out: List[Violation] = []
        modules = {"dist.wire": wire, "kernels.pack": pk,
                   "kernels.dequant_merge": dqm, "kernels.quantize": qz}
        block = wire.BLOCK
        for const, want in (("BLOCK", block), ("HALF", block // 2),
                            ("LANE", None)):
            seen = {k: getattr(m, const) for k, m in modules.items()
                    if hasattr(m, const)}
            if const == "HALF":
                seen["dist.wire.Int4Format"] = wire.Int4Format.HALF
            if len(set(seen.values())) > 1 or \
                    (want is not None and any(v != want
                                              for v in seen.values())):
                out.append(self.violation(
                    "pack-pairing-drift",
                    f"{const} constants diverged: {seen}"
                    + ("" if want is None else f" (want {want})"),
                    constant=const, values=seen))
        src = constexprs(build.source("wire_kernels").read_text())
        for name, want in (("kBlock", block), ("kHalf", block // 2),
                           ("kThreads", build.WIRE_THREADS)):
            if src.get(name) != want:
                out.append(self.violation(
                    "pack-pairing-drift",
                    f"wire_kernels.cu has {name} = {src.get(name)}, the "
                    f"Python side {want}", constant=name,
                    source=src.get(name), python=want))
        return out

    def check(self, target: Target) -> List[Violation]:
        out: List[Violation] = []
        for spec in target.launches:
            out.extend(self._lint_spec(target.label, spec))
        if self.check_constants:
            out.extend(self._lint_constants())
        return out

