"""Layer 1 of the static-contract gate: a custom AST lint pass over
``src/repro_torch`` — counterpart of ``repro.analysis.lint``.

The reference's eight rules keep its codes (``RPR0xx``, stable: allow
markers and CI logs name them) and take their PyTorch meaning. They guard
what the runtime audit (:mod:`repro_torch.analysis.audit`) cannot see from
the paths it runs — the conventions that keep the query path free of hidden
host syncs, the sentinel contract ``ids == -1 ⇔ dists == +inf`` true, and
the hand kernels in one package, *as the code is edited*:

  RPR001  tensor-branch        Python ``if``/``while``/ternary/``assert``
                               on a ``torch.*`` expression or a tensor
                               method result (``.any()``, ``.all()``,
                               ``.sum()``, …) in ``engine/``, ``kernels/``,
                               ``core/`` or ``quant/`` — on the card an
                               implicit ``Tensor.__bool__`` sync, and a
                               branch no CUDA graph can capture.
  RPR002  host-sync            ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                               ``.numpy()``, ``bool``/``int``/``float`` of
                               a call result, or ``torch.cuda.synchronize``
                               on the ``engine/``/``kernels/`` hot path —
                               each one waits for the device.
  RPR003  distance-fill        float literals ≥ 1e30 anywhere, or
                               ``torch.full``-style fills ≥ 1e6 — distance
                               padding must be ``float("inf")``/``torch.inf``.
  RPR004  id-sentinel          negative int literals other than ``-1`` used
                               as fills or compared against.
  RPR005  cache-static-unhashable  a ``functools.cache``/``lru_cache``
                               function with a list/dict/set default — the
                               memo keys on its arguments, and the default
                               cannot be hashed.
  RPR006  import-time-torch    module-scope ``torch.*`` calls that make a
                               tensor or touch CUDA — ``import repro_torch``
                               must work without a card (``torch.device``,
                               ``torch.finfo``, ``torch.iinfo`` are metadata).
  RPR007  kernel-outside-kernels  ``ctypes``, ``torch.utils.cpp_extension``,
                               ``triton``, an ``nvcc`` subprocess, or a
                               ``Kernel``/``.lib()`` launch handle outside
                               ``repro_torch/kernels`` — hand kernels live in
                               one package; everything else goes through
                               ``kernels.ops``.
  RPR008  private-build-poke   private names of ``kernels._build``
                               (``_LIBRARY_LOADS``, …) outside
                               ``repro_torch/analysis`` and
                               ``repro_torch/kernels`` — use
                               ``library_loads()``, ``launch_counts()`` or
                               ``RetraceGuard``.

Findings are suppressed line by line with an *explained* inline marker::

    if g and not bool(live.any()):  # repro: allow[RPR002] host-driven group loop

(the marker may also sit on the line above). A marker with no reason is
itself a finding (``RPR000``): the gate's contract is zero *unexplained*
findings, not zero comments.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable

# rule catalog: code -> (slug, one-line description). Stable — never renumber.
RULES = {
    "RPR000": ("unexplained-allow", "allowlist marker without a reason"),
    "RPR001": ("tensor-branch", "Python control flow on a tensor expression"),
    "RPR002": ("host-sync", "device→host sync on the engine/kernel hot path"),
    "RPR003": ("distance-fill", "distance padding that is not +inf"),
    "RPR004": ("id-sentinel", "id sentinel literal that is not -1"),
    "RPR005": ("cache-static-unhashable", "memoized function with an unhashable default"),
    "RPR006": ("import-time-torch", "module-import-time tensor or CUDA call"),
    "RPR007": ("kernel-outside-kernels", "hand-kernel machinery outside repro_torch/kernels"),
    "RPR008": ("private-build-poke", "private kernels._build name outside analysis/kernels"),
}

# module scopes (path fragments relative to the src root)
_BRANCH_SCOPES = ("repro_torch/engine/", "repro_torch/kernels/", "repro_torch/core/",
                  "repro_torch/quant/")
_HOT_SCOPES = ("repro_torch/engine/", "repro_torch/kernels/")
_KERNEL_SCOPE = "repro_torch/kernels/"
_BUILD_SCOPES = ("repro_torch/analysis/", "repro_torch/kernels/")

# torch calls that return static metadata or host facts, not tensors
_METADATA_FNS = {
    "torch.device", "torch.dtype", "torch.finfo", "torch.iinfo", "torch.Size",
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.get_default_dtype", "torch.promote_types", "torch.can_cast",
    "torch.is_grad_enabled", "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "torch.cuda.get_device_properties",
    "torch.cuda.get_device_name",
}
# tensor methods whose result is a tensor a branch would read through __bool__
_TENSOR_METHODS = {
    "any", "all", "sum", "max", "min", "amax", "amin", "mean", "prod", "eq", "ne",
    "lt", "le", "gt", "ge", "isfinite", "isnan", "isinf", "nonzero", "count_nonzero",
    "equal", "allclose", "item",
}
# receivers whose methods are host values, never tensors
_HOST_MODULES = {"np", "numpy", "math", "os", "re", "json", "itertools", "functools"}
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
# fills: name -> position of the fill value among the call's arguments
_FILL_FNS = {"torch.full": 1, "torch.full_like": 1, "np.full": 1, "np.full_like": 1}
_FILL_METHODS = {"new_full": 1, "fill_": 0, "masked_fill": 1, "masked_fill_": 1}
_FILL_KWARGS = ("fill_value", "value")
_MEMO_DECORATORS = {"functools.cache", "cache", "functools.lru_cache", "lru_cache"}

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\[(RPR\d{3})\]\s*(.*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} [{RULES[self.code][0]}] {self.message}"


def _fn_name(node: ast.expr) -> str:
    """Dotted name of a call target ('torch.full', 'x.any', ...)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_torch_call(call: ast.Call) -> bool:
    name = _fn_name(call.func)
    return name.startswith("torch.") and name not in _METADATA_FNS


def _is_tensor_method(call: ast.Call) -> bool:
    func = call.func
    if not isinstance(func, ast.Attribute) or func.attr not in _TENSOR_METHODS:
        return False
    root = func.value
    while isinstance(root, ast.Attribute):
        root = root.value
    return not (isinstance(root, ast.Name) and root.id in _HOST_MODULES)


def _neg_int(node: ast.expr):
    """The value of a negative-int literal (-2, -999, ...), else None."""
    if (
        isinstance(node, ast.UnaryOp)
        and isinstance(node.op, ast.USub)
        and isinstance(node.operand, ast.Constant)
        and type(node.operand.value) is int
    ):
        return -node.operand.value
    if isinstance(node, ast.Constant) and type(node.value) is int and node.value < 0:
        return node.value
    return None


def _float_const(node: ast.expr):
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    if isinstance(node, ast.Constant) and type(node.value) is float:
        return node.value
    return None


def _fill_arg(node: ast.Call):
    """The fill value of a ``torch.full``-style call, else None."""
    name = _fn_name(node.func)
    pos = _FILL_FNS.get(name)
    if pos is None and isinstance(node.func, ast.Attribute):
        pos = _FILL_METHODS.get(node.func.attr)
    if pos is None:
        return None, name
    fill = node.args[pos] if len(node.args) > pos else None
    for kw in node.keywords:
        if kw.arg in _FILL_KWARGS:
            fill = kw.value
    return fill, name


class _Linter(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath.replace("\\", "/")
        self.findings: list[Finding] = []
        self._depth = 0  # function nesting (0 = runs at import time)

    def _in(self, scopes) -> bool:
        return any(s in self.relpath for s in scopes)

    def emit(self, node: ast.AST, code: str, message: str) -> None:
        self.findings.append(Finding(self.relpath, node.lineno, code, message))

    # -- scope tracking: decorators and defaults run at import time ----------
    def visit_FunctionDef(self, node):
        self._check_memo_defaults(node)
        for dec in node.decorator_list:
            self.visit(dec)
        for default in (*node.args.defaults, *node.args.kw_defaults):
            if default is not None:
                self.visit(default)
        self._depth += 1
        for stmt in node.body:
            self.visit(stmt)
        self._depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._depth += 1
        self.generic_visit(node)
        self._depth -= 1

    # -- RPR001: control flow on tensor values -------------------------------
    def _check_branch_test(self, test: ast.expr, kind: str) -> None:
        if not self._in(_BRANCH_SCOPES):
            return
        for sub in ast.walk(test):
            if isinstance(sub, ast.Call) and (_is_torch_call(sub) or _is_tensor_method(sub)):
                self.emit(
                    test, "RPR001",
                    f"{kind} test calls `{_fn_name(sub.func)}` — branching on a tensor "
                    f"syncs the host with the device and cannot be captured in a CUDA "
                    f"graph; use torch.where, or decide from shapes and static arguments",
                )
                return

    def visit_If(self, node):
        self._check_branch_test(node.test, "if")
        self.generic_visit(node)

    def visit_While(self, node):
        self._check_branch_test(node.test, "while")
        self.generic_visit(node)

    def visit_IfExp(self, node):
        self._check_branch_test(node.test, "ternary")
        self.generic_visit(node)

    def visit_Assert(self, node):
        self._check_branch_test(node.test, "assert")
        self.generic_visit(node)

    # -- call-shaped rules ---------------------------------------------------
    def visit_Call(self, node):
        name = _fn_name(node.func)

        # RPR002: host syncs on the hot path
        if self._in(_HOT_SCOPES):
            if (isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS
                    and not node.args):
                self.emit(
                    node, "RPR002",
                    f"`.{node.func.attr}()` waits for the device on the hot path — "
                    f"keep results on the device through the tail",
                )
            elif name == "torch.cuda.synchronize":
                self.emit(node, "RPR002",
                          "`torch.cuda.synchronize` on the hot path serializes the stream")
            elif name in ("float", "int", "bool") and len(node.args) == 1 and isinstance(
                node.args[0], (ast.Call, ast.Subscript)
            ):
                self.emit(
                    node, "RPR002",
                    f"`{name}(...)` over an expression result is a host sync when the "
                    f"argument is a tensor",
                )

        # RPR003/RPR004: torch.full-style fills
        fill, fill_name = _fill_arg(node)
        if fill is not None:
            fv = _float_const(fill)
            if fv is not None and abs(fv) >= 1e6:
                self.emit(
                    node, "RPR003",
                    f"distance padding `{fill_name}(..., {fv!r})` — pad with "
                    f"float('inf') so invalid slots satisfy dists == +inf",
                )
            iv = _neg_int(fill)
            if iv is not None and iv != -1:
                self.emit(
                    node, "RPR004",
                    f"id fill `{fill_name}(..., {iv})` — the id sentinel is -1 "
                    f"(ids == -1 ⇔ dists == +inf)",
                )

        # RPR007: kernel machinery outside kernels/
        if not self._in((_KERNEL_SCOPE,)):
            if name.startswith(("torch.utils.cpp_extension.", "ctypes.", "triton.")):
                self.emit(node, "RPR007", f"`{name}` outside repro_torch/kernels")
            elif name.split(".")[-1] == "Kernel" or (
                isinstance(node.func, ast.Attribute) and node.func.attr == "lib"
            ):
                self.emit(
                    node, "RPR007",
                    f"kernel handle `{name}()` outside repro_torch/kernels — launch "
                    f"through repro_torch.kernels.ops",
                )
            elif name.startswith("subprocess.") and any(
                isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                and "nvcc" in sub.value or isinstance(sub, ast.Name) and sub.id == "nvcc_path"
                for sub in ast.walk(node)
            ):
                self.emit(node, "RPR007", "an nvcc subprocess outside repro_torch/kernels")

        # RPR006: import-time tensor or CUDA work
        if self._depth == 0 and _is_torch_call(node):
            self.emit(
                node, "RPR006",
                f"module-import-time `{name}` call — a tensor made (or CUDA touched) "
                f"at import binds a device before the caller chooses one; build it "
                f"lazily inside a function",
            )

        self.generic_visit(node)

    # -- RPR003 (bare pseudo-inf literals) -----------------------------------
    def visit_Constant(self, node):
        if type(node.value) is float and abs(node.value) >= 1e30:  # repro: allow[RPR003] the rule's own detection threshold
            self.emit(
                node, "RPR003",
                f"pseudo-infinity literal {node.value!r} — use float('inf') (the "
                f"sentinel contract checks +inf exactly)",
            )
        self.generic_visit(node)

    # -- RPR004 (sentinel comparisons) ---------------------------------------
    def visit_Compare(self, node):
        for comp in node.comparators:
            iv = _neg_int(comp)
            if iv is not None and iv != -1:
                self.emit(
                    node, "RPR004",
                    f"comparison against {iv} — the id sentinel is -1; a second magic "
                    f"negative id silently escapes every `ids == -1` mask",
                )
        self.generic_visit(node)

    # -- RPR008: private names of kernels._build -----------------------------
    def visit_Attribute(self, node):
        if (
            isinstance(node.value, ast.Name) and node.value.id == "_build"
            and node.attr.startswith("_") and not node.attr.startswith("__")
            and not self._in(_BUILD_SCOPES)
        ):
            self.emit(
                node, "RPR008",
                f"private `_build.{node.attr}` — use library_loads(), launch_counts() "
                f"or repro_torch.analysis.RetraceGuard",
            )
        self.generic_visit(node)

    # -- imports (RPR007, RPR008) --------------------------------------------
    def visit_Import(self, node):
        if not self._in((_KERNEL_SCOPE,)):
            for a in node.names:
                if a.name.split(".")[0] in ("ctypes", "triton") or a.name.startswith(
                    "torch.utils.cpp_extension"
                ):
                    self.emit(node, "RPR007", f"import `{a.name}` outside repro_torch/kernels")
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if not self._in((_KERNEL_SCOPE,)) and (
            mod.split(".")[0] in ("ctypes", "triton")
            or mod.startswith("torch.utils.cpp_extension")
            or mod == "torch.utils" and any(a.name == "cpp_extension" for a in node.names)
        ):
            self.emit(node, "RPR007", f"import from `{mod}` outside repro_torch/kernels")
        if mod.endswith("kernels._build") and not self._in(_BUILD_SCOPES):
            for a in node.names:
                if a.name.startswith("_"):
                    self.emit(
                        node, "RPR008",
                        f"private `{a.name}` imported from kernels._build — use "
                        f"library_loads(), launch_counts() or RetraceGuard",
                    )
        self.generic_visit(node)

    # -- RPR005: unhashable defaults of memoized functions -------------------
    def _check_memo_defaults(self, fn) -> None:
        memo = any(
            _fn_name(dec.func if isinstance(dec, ast.Call) else dec) in _MEMO_DECORATORS
            for dec in fn.decorator_list
        )
        if not memo:
            return
        positional = [*fn.args.posonlyargs, *fn.args.args]
        pairs = list(zip(positional[len(positional) - len(fn.args.defaults):],
                         fn.args.defaults))
        pairs += [(a, d) for a, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults)
                  if d is not None]
        for arg, default in pairs:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                self.emit(
                    fn, "RPR005",
                    f"argument `{arg.arg}` of memoized `{fn.name}` has an unhashable "
                    f"{type(default).__name__.lower()} default — the memo's key hash "
                    f"raises on the first defaulted call",
                )


def _collect_allows(src: str, relpath: str) -> tuple[dict, list[Finding]]:
    """Parse `# repro: allow[RPRxxx] reason` markers. Returns
    ({line: {code, ...}}, findings for reason-less markers)."""
    allows: dict[int, set[str]] = {}
    bad: list[Finding] = []
    for lineno, text in enumerate(src.splitlines(), start=1):
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        code, reason = m.group(1), m.group(2).strip()
        if not reason:
            # a reasonless marker suppresses NOTHING — the finding it meant
            # to silence still fires, plus the RPR000 for the bare marker
            bad.append(
                Finding(
                    relpath, lineno, "RPR000",
                    f"allow[{code}] without a reason — the gate's contract is zero "
                    f"UNEXPLAINED findings; say why this line is exempt",
                )
            )
        else:
            allows.setdefault(lineno, set()).add(code)
    return allows, bad


def lint_source(src: str, relpath: str) -> list[Finding]:
    """Lint one module's source text; relpath scopes the per-package rules."""
    tree = ast.parse(src)
    linter = _Linter(relpath)
    linter.visit(tree)
    allows, findings = _collect_allows(src, relpath)

    def allowed(f: Finding) -> bool:
        return any(f.code in allows.get(ln, ()) for ln in (f.line, f.line - 1))

    findings += [f for f in linter.findings if not allowed(f)]
    return sorted(findings, key=lambda f: (f.path, f.line, f.code))


def lint_paths(paths: Iterable[str | Path], root: str | Path | None = None) -> list[Finding]:
    """Lint every ``*.py`` under ``paths``; findings carry paths relative to
    ``root`` (default: each argument's parent)."""
    findings: list[Finding] = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        base = Path(root) if root is not None else p.parent
        for f in files:
            try:
                rel = f.relative_to(base)
            except ValueError:
                rel = f
            findings += lint_source(f.read_text(), str(rel))
    return sorted(findings, key=lambda f: (f.path, f.line, f.code))
