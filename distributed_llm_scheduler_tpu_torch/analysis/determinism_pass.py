"""Pass — repo-wide determinism lint (DET001-DET005).

The bitwise-reproducibility battery (digest tests, virtual-clock
serving, schedule identity) only holds if every source of
nondeterminism is funneled through the injectable seams.  This pass
AST-walks the tree and flags the escape hatches:

======  ==========================================================
DET001  wall-clock read (``time.time()``, ``datetime.now()``, ...)
        anywhere but ``obs/clockutil.py`` — the one module allowed
        to touch the host clock (``resolve_clock`` is the seam)
DET002  global/unseeded RNG (``random.*``, ``np.random.*``) in the
        determinism-critical trees ``serve/``, ``sched/``, ``obs/``
DET003  iteration directly over a ``set``/``frozenset`` — ordering
        is hash-seed dependent, so anything it feeds (a digest, a
        schedule, emitted order) is too; iterate ``sorted(...)``
DET004  ``id()``-keyed container — keys differ across processes,
        so the structure cannot cross a process boundary
DET005  environment read outside ``utils/config.py`` and
        ``utils/env.py`` — the modules allowed to consult
        ``os.environ`` (``env_str`` / ``env_flag`` are the seams)
======  ==========================================================

Deliberate violations carry an inline justification marker the lint
recognizes::

    t0 = time.perf_counter()  # dls-lint: allow(DET001) wall-clock bench

either on the flagged line or the line directly above it; a whole
file opts out of a code with a top-level marker::

    # dls-lint: allow-file(DET001) measurement harness, wall time IS
    #   the quantity under test

Markers name the code(s) they allow — a marker never blanket-disables
the lint.

PyTorch port of ``distributed_llm_scheduler_tpu.analysis.
determinism_pass``: the same rules and messages, over the port's seams.
The port keeps its environment seam in ``utils/env.py`` (``utils/
config.py`` re-exports it), so DET005 exempts both; with no argument
:func:`analyze_determinism` walks the port's own package.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from .diagnostics import AnalysisReport, Severity

#: files exempt per code (the designated seam modules)
_SEAM_FILES = {
    "DET001": ("obs/clockutil.py",),
    "DET005": ("utils/config.py", "utils/env.py"),
}

_ALLOW_RE = re.compile(r"dls-lint:\s*allow\(([A-Z0-9,\s]+)\)")
_ALLOW_FILE_RE = re.compile(r"dls-lint:\s*allow-file\(([A-Z0-9,\s]+)\)")

_CLOCK_TIME_FNS = frozenset({
    "time", "time_ns", "perf_counter", "perf_counter_ns", "monotonic",
    "monotonic_ns", "process_time", "process_time_ns", "clock_gettime",
    "clock_gettime_ns",
})
_CLOCK_DATETIME_FNS = frozenset({"now", "utcnow", "today"})
_RNG_FNS = frozenset({
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "normal", "rand",
    "randn", "permutation", "seed", "default_rng", "getrandbits",
    "betavariate", "expovariate",
})
#: trees where unseeded RNG breaks digest reproducibility (DET002 scope)
_RNG_SCOPED_DIRS = frozenset({"serve", "sched", "obs"})
_ID_KEY_METHODS = frozenset({
    "add", "get", "setdefault", "discard", "remove", "pop",
})


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _allowed_lines(source: str) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """(lineno -> allowed codes, file-level allowed codes).  A line
    marker covers its own line and the line below it."""
    per_line: Dict[int, Set[str]] = {}
    file_codes: Set[str] = set()
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _ALLOW_FILE_RE.search(line)
        if m:
            file_codes.update(
                c.strip() for c in m.group(1).split(",") if c.strip()
            )
            continue
        m = _ALLOW_RE.search(line)
        if m:
            codes = {
                c.strip() for c in m.group(1).split(",") if c.strip()
            }
            per_line.setdefault(lineno, set()).update(codes)
            per_line.setdefault(lineno + 1, set()).update(codes)
    return per_line, file_codes


class _DetVisitor(ast.NodeVisitor):
    def __init__(self, relpath: str, rng_scoped: bool):
        self.relpath = relpath
        self.rng_scoped = rng_scoped
        # (code, lineno, message)
        self.findings: List[Tuple[str, int, str]] = []

    def _hit(self, code: str, node: ast.AST, msg: str) -> None:
        self.findings.append((code, node.lineno, msg))

    # -- DET001 / DET002 / DET005 (calls) / DET004 -------------------------
    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        if dotted:
            head, _, tail = dotted.rpartition(".")
            if head in ("time",) and tail in _CLOCK_TIME_FNS:
                self._hit(
                    "DET001", node,
                    f"wall-clock read {dotted}() — inject a clock via "
                    "obs.clockutil.resolve_clock instead",
                )
            elif (
                tail in _CLOCK_DATETIME_FNS
                and head.split(".")[-1] in ("datetime", "date")
            ):
                self._hit(
                    "DET001", node,
                    f"wall-clock read {dotted}() — inject a clock via "
                    "obs.clockutil.resolve_clock instead",
                )
            elif self.rng_scoped and tail in _RNG_FNS and (
                head == "random"
                or head.endswith("np.random")
                or head.endswith("numpy.random")
                or head in ("np.random", "numpy.random")
            ):
                self._hit(
                    "DET002", node,
                    f"global RNG call {dotted}() — thread an explicit "
                    "seeded generator through instead",
                )
            elif dotted in ("os.getenv", "os.environ.get", "environ.get"):
                self._hit(
                    "DET005", node,
                    f"environment read {dotted}() — route it through "
                    "utils.config (env_str/env_flag)",
                )
        elif isinstance(node.func, ast.Name) and node.func.id == "getenv":
            self._hit(
                "DET005", node,
                "environment read getenv() — route it through "
                "utils.config (env_str/env_flag)",
            )
        # DET004: id(x) handed to a keyed-container method
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _ID_KEY_METHODS
        ):
            for arg in node.args[:1]:
                if self._is_id_call(arg):
                    self._hit(
                        "DET004", node,
                        f"id()-keyed container ({node.func.attr}) — "
                        "keys are process-local; use a stable identity",
                    )
        self.generic_visit(node)

    @staticmethod
    def _is_id_call(node: ast.AST) -> bool:
        return (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "id"
        )

    # -- DET005 (subscript read of os.environ) -----------------------------
    def visit_Subscript(self, node: ast.Subscript) -> None:
        if isinstance(node.ctx, ast.Load):
            dotted = _dotted(node.value)
            if dotted in ("os.environ", "environ") or (
                dotted and dotted.endswith(".environ")
            ):
                self._hit(
                    "DET005", node,
                    f"environment read {dotted}[...] — route it "
                    "through utils.config (env_str/env_flag)",
                )
        # DET004: container[id(x)] in any context
        sl = node.slice
        if self._is_id_call(sl):
            self._hit(
                "DET004", node,
                "id()-keyed subscript — keys are process-local; use a "
                "stable identity",
            )
        self.generic_visit(node)

    # -- DET004 (dict literal keyed by id()) -------------------------------
    def visit_Dict(self, node: ast.Dict) -> None:
        for key in node.keys:
            if key is not None and self._is_id_call(key):
                self._hit(
                    "DET004", node,
                    "dict literal keyed by id() — keys are "
                    "process-local; use a stable identity",
                )
        self.generic_visit(node)

    # -- DET003 (iterating a set) ------------------------------------------
    def _check_iter(self, it: ast.AST) -> None:
        if isinstance(it, ast.Set) or isinstance(it, ast.SetComp):
            self._hit(
                "DET003", it,
                "iteration over a set literal — order is hash-seed "
                "dependent; iterate sorted(...)",
            )
        elif (
            isinstance(it, ast.Call)
            and isinstance(it.func, ast.Name)
            and it.func.id in ("set", "frozenset")
        ):
            self._hit(
                "DET003", it,
                f"iteration over {it.func.id}(...) — order is "
                "hash-seed dependent; iterate sorted(...)",
            )

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node: Any) -> None:
        for gen in node.generators:
            self._check_iter(gen.iter)
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp


def _lint_file(path: Path, relpath: str) -> List[Tuple[str, int, str]]:
    try:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=str(path))
    except (OSError, SyntaxError, UnicodeDecodeError):
        return []
    per_line, file_codes = _allowed_lines(source)
    parts = Path(relpath).parts
    visitor = _DetVisitor(
        relpath, rng_scoped=bool(_RNG_SCOPED_DIRS & set(parts))
    )
    visitor.visit(tree)
    out = []
    norm = relpath.replace("\\", "/")
    for code, lineno, msg in visitor.findings:
        if any(norm.endswith(seam) for seam in _SEAM_FILES.get(code, ())):
            continue
        if code in file_codes or code in per_line.get(lineno, ()):
            continue
        out.append((code, lineno, msg))
    return out


def analyze_determinism(
    root: Any = None,
    *,
    paths: Optional[Iterable[Any]] = None,
) -> AnalysisReport:
    """AST-lint Python sources for determinism hazards.

    ``root`` (default: this package's own tree) is walked recursively;
    ``paths`` lints an explicit file list instead (fixture tests).
    Relative paths in messages are against ``root`` (or the file's
    parent for bare ``paths``).
    """
    rep = AnalysisReport()
    if paths is not None:
        # full path as the label: directory parts stay visible so the
        # DET002 serve/sched/obs scoping applies to fixtures too
        targets = [(Path(p), Path(p).as_posix()) for p in paths]
    else:
        base = Path(root) if root is not None else Path(__file__).parent.parent
        targets = [
            (p, p.relative_to(base).as_posix())
            for p in sorted(base.rglob("*.py"))
            if "__pycache__" not in p.parts
        ]
    for path, relpath in targets:
        for code, lineno, msg in _lint_file(path, relpath):
            rep.add(
                code,
                Severity.ERROR,
                f"{relpath}:{lineno}: {msg}",
                node=relpath,
                data={"line": lineno},
            )
    return rep
