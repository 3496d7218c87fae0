"""Static concurrency lint: codebase-specific AST rules R1-R5.

Layer 1 of the concurrency-correctness subsystem (layer 2 is the runtime
witness in :mod:`repro_torch.analysis.lockwitness`).  The rules encode the
invariants documented in ``docs/CONCURRENCY.md``; they are deliberately
*lexical* — they analyse one function body at a time and do not chase
calls — so a clean report means the obvious shape of each invariant
holds, while the witness covers the inter-procedural cases at test time.

Rules
-----
R1  every public mutator on ``JobQueue`` (and ``_on_revoked``, the
    cross-thread entry point) performs its ``self`` mutations and
    ``emit`` calls inside a ``with self._api_lock:`` block.
R2  no ``transport.call`` / ``call_many`` / socket ``send``/``sendall``/
    ``recv`` lexically inside a ``with <lock>:`` block, except under
    the queue's ``_api_lock`` (held across transport by design).
R3  no ``emit`` and no call through a local callback variable lexically
    under a held lock (other than ``_api_lock``) — subscriber callbacks
    fire outside ``EventLog._lock``, always.
R4  every ``threading.Lock()`` / ``threading.RLock()`` construction goes
    through :func:`repro_torch.analysis.lockwitness.named_lock` /
    ``named_rlock`` so the witness can attribute orders.
R5  no wall-clock ``time.time()`` / ``time.sleep()`` in the scheduling
    core (files that should route timing through the ``Clock``
    abstraction); ``time.monotonic`` / ``perf_counter`` are fine.

Suppression: append ``# lint: allow(Rn) <reason>`` on the offending
line (or the line directly above).  A pragma without a reason does not
suppress — every escape hatch must say why.
"""
from __future__ import annotations

import ast
import builtins
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

RULES: Dict[str, str] = {
    "R1": "JobQueue mutator must hold self._api_lock",
    "R2": "transport/socket call inside a lock critical section",
    "R3": "emit/callback invocation under a non-API lock",
    "R4": "raw threading.Lock/RLock — use analysis.lockwitness.named_lock",
    "R5": "wall-clock time.time()/sleep() in Clock-abstracted core",
}

PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\((R[1-5])\)\s*(\S.*)?$")

# R2: method names that reach a transport or socket
_TRANSPORT_ATTRS = {"call", "call_many", "send", "sendall", "recv"}
# R1: container/observable mutations on self-rooted receivers
_MUTATOR_ATTRS = {"append", "appendleft", "remove", "pop", "popleft",
                  "extend", "clear", "insert", "add", "discard",
                  "update", "emit"}
_INSORT_FUNCS = {"insort", "insort_left", "insort_right", "heappush",
                 "heappop"}
# R5 applies to the scheduling core only — rpc link-latency simulation
# and runtime wall-clock timestamps are out of scope by design.
_R5_BASENAMES = {"queue.py", "engine.py", "policy.py", "scheduler.py",
                 "api.py", "events.py", "tenancy.py", "actor.py"}
_BUILTINS = frozenset(dir(builtins))


@dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _is_lock_expr(node: ast.expr) -> Optional[str]:
    """Return the lock's attribute/name when ``node`` looks like a lock
    (``self._api_lock``, ``host.lock``, ``self._send_lock``, ``self._block``)."""
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    else:
        return None
    if name.lower().endswith("lock") or name.lower().endswith("block"):
        return name
    return None


def _roots_at_self(node: ast.expr) -> bool:
    """True when the expression chain bottoms out at ``self``."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        if isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Attribute):
            node = node.value
        else:
            node = node.value
    return isinstance(node, ast.Name) and node.id == "self"


class _Pragmas:
    def __init__(self, source: str) -> None:
        self._by_line: Dict[int, Tuple[str, str]] = {}
        for i, line in enumerate(source.splitlines(), start=1):
            m = PRAGMA_RE.search(line)
            if m:
                self._by_line[i] = (m.group(1), (m.group(2) or "").strip())

    def suppresses(self, line: int, rule: str) -> bool:
        for ln in (line, line - 1):
            got = self._by_line.get(ln)
            # a reason is mandatory: bare allow() pragmas don't count
            if got and got[0] == rule and got[1]:
                return True
        return False


class _ModuleScope:
    """Names safe to call under a lock for R3: builtins, module-level
    imports/defs/classes/assignments, and (filled per-function) nested
    function definitions."""

    def __init__(self, tree: ast.Module) -> None:
        self.names: Set[str] = set(_BUILTINS)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                self.names.add(node.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.names.add((a.asname or a.name).split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    self.names.add(a.asname or a.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.names.add(t.id)
            elif isinstance(node, ast.AnnAssign):
                if isinstance(node.target, ast.Name):
                    self.names.add(node.target.id)


def _local_defs(func: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not func:
            out.add(node.name)
    return out


def _walk_pruned(node: ast.AST):
    """``ast.walk`` that does not descend into nested function/lambda
    bodies — code in a nested def runs later, outside the lexical
    critical section being inspected."""
    for child in ast.iter_child_nodes(node):
        yield child
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield from _walk_pruned(child)


def _time_import_aliases(tree: ast.Module) -> Tuple[Set[str], Set[str]]:
    """(module aliases for ``time``, bare names bound to time.time/sleep)."""
    mods: Set[str] = set()
    bare: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    mods.add(a.asname or "time")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in ("time", "sleep"):
                    bare.add(a.asname or a.name)
    return mods, bare


# ------------------------------------------------------------------ #
class _FileLinter:
    def __init__(self, path: str, source: str) -> None:
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.pragmas = _Pragmas(source)
        self.scope = _ModuleScope(self.tree)
        self.findings: List[Finding] = []
        import os
        self.basename = os.path.basename(path)

    def add(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if not self.pragmas.suppresses(line, rule):
            self.findings.append(Finding(self.path, line, rule, message))

    def run(self) -> List[Finding]:
        self._rule_r4_r5()
        self._rule_r2_r3()
        self._rule_r1()
        self.findings.sort(key=lambda f: (f.line, f.rule))
        return self.findings

    # -- R4 + R5 (module-wide scans) ------------------------------- #
    def _rule_r4_r5(self) -> None:
        time_mods, time_bare = _time_import_aliases(self.tree)
        r5 = self.basename in _R5_BASENAMES
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute):
                if fn.attr in ("Lock", "RLock") and \
                        isinstance(fn.value, ast.Name) and \
                        fn.value.id == "threading":
                    self.add(node, "R4",
                             f"raw threading.{fn.attr}() — construct via "
                             f"lockwitness.named_"
                             f"{'r' if fn.attr == 'RLock' else ''}lock()")
                elif r5 and fn.attr in ("time", "sleep") and \
                        isinstance(fn.value, ast.Name) and \
                        fn.value.id in time_mods:
                    self.add(node, "R5",
                             f"{fn.value.id}.{fn.attr}() — use the Clock "
                             f"abstraction (monotonic/SimClock)")
            elif isinstance(fn, ast.Name):
                if r5 and fn.id in time_bare:
                    self.add(node, "R5",
                             f"{fn.id}() — use the Clock abstraction")

    # -- R2 + R3 (inside lock critical sections) ------------------- #
    def _walk_functions(self):
        class_stack: List[str] = []

        def visit(node):
            if isinstance(node, ast.ClassDef):
                class_stack.append(node.name)
                for child in node.body:
                    yield from visit(child)
                class_stack.pop()
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield (class_stack[-1] if class_stack else None), node
                for child in node.body:
                    yield from visit(child)
            else:
                for child in ast.iter_child_nodes(node):
                    yield from visit(child)

        for top in self.tree.body:
            yield from visit(top)

    def _rule_r2_r3(self) -> None:
        for cls, func in self._walk_functions():
            safe_calls = self.scope.names | _local_defs(func)
            arg_names = {a.arg for a in (
                func.args.posonlyargs + func.args.args
                + func.args.kwonlyargs)}
            for with_node, lockname in self._lock_withs(func):
                api = lockname == "_api_lock" or (
                    cls == "Instance" and lockname == "_lock")
                if api:
                    continue    # _api_lock: transport-under-lock by design
                for stmt in with_node.body:
                    for node in _walk_pruned(stmt):
                        if not isinstance(node, ast.Call):
                            continue
                        fn = node.func
                        if isinstance(fn, ast.Attribute):
                            if fn.attr in _TRANSPORT_ATTRS:
                                self.add(node, "R2",
                                         f".{fn.attr}() while holding "
                                         f"{lockname} — hoist outside the "
                                         f"critical section")
                            elif fn.attr == "emit":
                                self.add(node, "R3",
                                         f".emit() under {lockname} — "
                                         f"events must be emitted outside "
                                         f"non-API locks")
                        elif isinstance(fn, ast.Name) and \
                                fn.id not in safe_calls:
                            # a call through a parameter/local reaches
                            # arbitrary subscriber code; under a lock
                            # that is a deadlock vector
                            kind = ("parameter" if fn.id in arg_names
                                    else "local variable")
                            self.add(node, "R3",
                                     f"call through {kind} '{fn.id}' "
                                     f"under {lockname} — callbacks "
                                     f"run outside locks")

    def _lock_withs(self, func: ast.AST):
        for node in _walk_pruned(func):
            if isinstance(node, ast.With):
                for item in node.items:
                    name = _is_lock_expr(item.context_expr)
                    if name:
                        yield node, name
                        break

    # -- R1 (JobQueue mutators) ------------------------------------ #
    def _rule_r1(self) -> None:
        for top in ast.walk(self.tree):
            if isinstance(top, ast.ClassDef) and top.name == "JobQueue":
                for item in top.body:
                    if not isinstance(item, ast.FunctionDef):
                        continue
                    name = item.name
                    public = not name.startswith("_")
                    if not (public or name == "_on_revoked"):
                        continue
                    if name == "__init__":
                        continue
                    self._check_mutator(item)

    def _check_mutator(self, func: ast.FunctionDef) -> None:
        # lines covered by a `with self._api_lock:` block
        covered: List[ast.With] = []
        for node in ast.walk(func):
            if isinstance(node, ast.With):
                for it in node.items:
                    ce = it.context_expr
                    if isinstance(ce, ast.Attribute) and \
                            ce.attr == "_api_lock":
                        covered.append(node)

        def under_lock(n: ast.AST) -> bool:
            ln = getattr(n, "lineno", 0)
            for w in covered:
                if w.lineno <= ln <= (w.end_lineno or w.lineno):
                    return True
            return False

        for node in _walk_pruned(func):
            mut = self._mutation_desc(node)
            if mut and not under_lock(node):
                self.add(node, "R1",
                         f"{func.name}(): {mut} outside "
                         f"'with self._api_lock:'")

    @staticmethod
    def _mutation_desc(node: ast.AST) -> Optional[str]:
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)) \
                        and _roots_at_self(t):
                    return "assignment to self state"
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)) \
                        and _roots_at_self(t):
                    return "del on self state"
        elif isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute):
                if isinstance(fn.value, ast.Name) and \
                        fn.value.id == "self" and \
                        fn.attr.startswith("_") and \
                        not fn.attr.startswith("__"):
                    return f"helper call self.{fn.attr}()"
                if fn.attr in _MUTATOR_ATTRS and _roots_at_self(fn.value):
                    return f"mutation .{fn.attr}() on self state"
                if fn.attr in _INSORT_FUNCS and any(
                        isinstance(a, (ast.Attribute, ast.Subscript))
                        and _roots_at_self(a) for a in node.args):
                    return f"{fn.attr}() into self state"
        return None


# ------------------------------------------------------------------ #
def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Lint one source blob (the unit tests drive this directly)."""
    return _FileLinter(path, source).run()


def lint_file(path: str) -> List[Finding]:
    with open(path, "r") as fh:
        return lint_source(fh.read(), path)


def lint_paths(paths: List[str]) -> List[Finding]:
    import os
    findings: List[Finding] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for f in sorted(files):
                    if f.endswith(".py"):
                        findings.extend(lint_file(os.path.join(root, f)))
        elif p.endswith(".py"):
            findings.extend(lint_file(p))
    return findings
