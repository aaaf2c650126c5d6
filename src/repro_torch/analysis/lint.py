"""AST lint for the port's hot-path hazards (counterpart of
``repro.analysis.lint``).

Static rules over the `src/repro_torch` tree, scoped as the reference
scopes them, to **hot-path code**: step/run/prefill/decode functions and
the closures nested inside ``make_*`` / ``_build_*`` factories
(:func:`hot_functions`, the reference's own).  A host sync in a test or a
CLI entry point is fine; the same call inside a per-step function is a
device->host round trip every step.

Rules:

  * ``host-sync-in-step`` — the reference's calls (``float(x)`` /
    ``int(x)``, ``.item()``, ``.tolist()``, ``.block_until_ready()``,
    ``np.asarray`` / ``np.array``, ``jax.device_get``) and the port's own:
    ``.cpu()``, ``.numpy()`` and ``torch.cuda.synchronize()``.
  * ``np-on-traced`` — ``np.*`` computation on non-constants inside
    hot-path code (host math on what may be a device value), as the
    reference's, with its whitelist of shape/dtype-level helpers.
  * ``generator-reuse`` (counterpart of ``prng-key-reuse``) — a
    ``torch.Generator`` seeded twice with the same expression in one hot
    function (the same draws where independent ones were meant), or
    ``torch.manual_seed`` (the global generator) in hot code.
  * ``tile-misalign`` (counterpart of ``pallas-tile-misalign``) — in a
    file that imports ``triton``, a ``block`` / ``tile`` integer constant
    (a keyword argument, or an assignment to such a name) of 8 or more
    that is not a power of two: a Triton block is a power of two.

The reference's ``missing-donation`` has no torch form (torch has no
``jit`` with ``donate_argnums``); `repro_torch.analysis.audit`'s in-place
check covers the property.  Every finding is keyed ``path:qualname``
(line numbers carried for display only), so the baseline survives
unrelated edits.
"""
from __future__ import annotations

import ast
import os
from pathlib import Path

from repro_torch.analysis.findings import Finding, Report

HOT_NAME_HINTS = ("step", "run", "body", "prefill", "decode", "train",
                  "kernel", "fwd", "bwd", "loop")
FACTORY_HINTS = ("make_", "_build_", "build_")
# host-sync callables when applied to traced values (bool() is excluded:
# it is overwhelmingly applied to compile-time python values like axis sets)
HOST_SYNC_CALLS = {"float", "int"}
HOST_SYNC_ATTRS = {"item", "tolist", "block_until_ready", "cpu", "numpy"}
HOST_SYNC_DOTTED = ("np.asarray", "numpy.asarray", "np.array",
                    "numpy.array", "jax.device_get",
                    "torch.cuda.synchronize")
# np.* helpers that are shape/config-level, not data-path
NP_WHITELIST = {"prod", "dtype", "int32", "int64", "float32", "float64",
                "bool_", "uint32", "shape", "ndim", "iinfo", "finfo",
                "ceil", "floor", "log2", "sqrt", "maximum", "minimum"}
TILE_HINTS = ("block", "tile")

REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_ROOTS = ("src/repro_torch",)
SKIP_DIRS = {"analysis", "__pycache__", "csrc"}


def _f(rule, where, detail, line=0):
    return Finding(pass_name="lint", rule=rule, where=where, detail=detail,
                   line=line)


def is_hot_name(name: str) -> bool:
    low = name.lower()
    return any(h in low for h in HOT_NAME_HINTS)


def is_factory_name(name: str) -> bool:
    return any(name.startswith(h) for h in FACTORY_HINTS)


def _dotted(node) -> str:
    """'torch.cuda.synchronize' for an Attribute/Name chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# ---------------------------------------------------------------------------
# per-function rules
# ---------------------------------------------------------------------------

def check_host_sync(fn: ast.FunctionDef, where: str) -> list:
    findings = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        dn = _dotted(node.func)
        detail = None
        if isinstance(node.func, ast.Name) \
                and node.func.id in HOST_SYNC_CALLS and node.args \
                and not isinstance(node.args[0], ast.Constant):
            detail = f"{node.func.id}(...) forces a device->host sync"
        elif dn in HOST_SYNC_DOTTED:
            detail = (f"{dn}(...) pulls a device value to host"
                      if "synchronize" not in dn else
                      f"{dn}() waits for the device")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in HOST_SYNC_ATTRS:
            detail = f".{node.func.attr}() forces a device->host sync"
        if detail:
            findings.append(_f("host-sync-in-step", where, detail,
                               line=node.lineno))
    return findings


def check_np_on_traced(fn: ast.FunctionDef, where: str) -> list:
    """np.<fn>(x) on non-constant args inside hot-path code."""
    findings = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        dn = _dotted(node.func)
        if not dn.startswith(("np.", "numpy.")):
            continue
        tail = dn.split(".", 1)[1]
        if tail.split(".")[0] in NP_WHITELIST \
                or tail in ("asarray", "array"):  # host-sync rule's turf
            continue
        if node.args and not all(
                isinstance(a, (ast.Constant, ast.Tuple)) for a in node.args):
            findings.append(_f(
                "np-on-traced", where,
                f"{dn}(...) on a non-constant inside hot-path code — "
                f"untraced host math", line=node.lineno))
    return findings


def check_generator_reuse(fn: ast.FunctionDef, where: str) -> list:
    """Two ``.manual_seed(<same expression>)`` calls in one hot function,
    or ``torch.manual_seed`` (the global generator) there."""
    findings = []
    seeds: dict = {}
    for node in sorted((n for n in ast.walk(fn) if isinstance(n, ast.Call)),
                       key=lambda n: (n.lineno, n.col_offset)):
        dn = _dotted(node.func)
        if dn == "torch.manual_seed":
            findings.append(_f(
                "generator-reuse", where,
                "torch.manual_seed(...) reseeds the global generator inside "
                "hot-path code", line=node.lineno))
            continue
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr == "manual_seed" and node.args):
            continue
        key = ast.dump(node.args[0])
        if key in seeds:
            findings.append(_f(
                "generator-reuse", where,
                f"a generator seeded again with "
                f"'{ast.unparse(node.args[0])}' — the same draws twice",
                line=node.lineno))
        seeds.setdefault(key, node.lineno)
    return findings


def _power_of_two(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def check_tile_misalign(tree: ast.Module, path: str) -> list:
    """In a file that imports triton: ``block`` / ``tile`` integer
    constants (keywords, and assignments to such names) of 8 or more must
    be powers of two."""
    imports_triton = any(
        isinstance(n, (ast.Import, ast.ImportFrom)) and "triton" in ast.dump(n)
        for n in ast.walk(tree))
    if not imports_triton:
        return []
    findings = []

    def ints(value) -> list:
        if isinstance(value, ast.Constant) and isinstance(value.value, int) \
                and not isinstance(value.value, bool):
            return [value.value]
        if isinstance(value, ast.Tuple):
            return [e.value for e in value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, int)]
        return []

    def flag(name, value, line):
        for v in ints(value):
            if v >= 8 and not _power_of_two(v):
                findings.append(_f(
                    "tile-misalign", f"{path}:{name}",
                    f"tile constant {v} is not a power of two (a Triton "
                    f"block)", line=line))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg and any(h in kw.arg.lower() for h in TILE_HINTS):
                    flag(kw.arg, kw.value, node.lineno)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) \
                        and any(h in t.id.lower() for h in TILE_HINTS):
                    flag(t.id, node.value, node.lineno)
    return findings


# ---------------------------------------------------------------------------
# hot-path scoping + the file pass
# ---------------------------------------------------------------------------

def hot_functions(tree: ast.Module):
    """(qualname, FunctionDef) for hot-path functions: step-named
    functions anywhere, and every function nested inside a factory.
    A factory itself (``make_*``/``_build_*``) is NOT scanned directly —
    its body runs once at build time; only the closures it returns are
    per-step code."""
    out = []

    def visit(node, prefix, inside_factory):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                factory = inside_factory or is_factory_name(child.name)
                if not is_factory_name(child.name) and (
                        is_hot_name(child.name)
                        or (inside_factory
                            and not child.name.startswith("_init"))):
                    out.append((qual, child))
                visit(child, qual + ".", factory)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", inside_factory)
            else:
                visit(child, prefix, inside_factory)

    visit(tree, "", False)
    # dedupe nested hits (a hot fn inside a hot fn reports once, outermost)
    seen: set = set()
    uniq = []
    for qual, fn in out:
        if any(qual != q and qual.startswith(q + ".") for q, _ in out):
            continue
        if qual not in seen:
            seen.add(qual)
            uniq.append((qual, fn))
    return uniq


def lint_file(path: str, rel: str) -> list:
    with open(path) as fh:
        src = fh.read()
    tree = ast.parse(src, filename=path)
    findings = check_tile_misalign(tree, rel)
    for qual, fn in hot_functions(tree):
        where = f"{rel}:{qual}"
        findings += check_generator_reuse(fn, where)
        findings += check_host_sync(fn, where)
        findings += check_np_on_traced(fn, where)
    return findings


def run(roots=DEFAULT_ROOTS, repo_root: str | None = None) -> Report:
    """Lint every ``.py`` file under ``roots`` (relative to ``repo_root``,
    default this checkout's root)."""
    rep = Report()
    base = str(repo_root or REPO_ROOT)
    n_files = 0
    for root in roots:
        top = os.path.join(base, root)
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d not in SKIP_DIRS]
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, base)
                try:
                    rep.findings += lint_file(path, rel)
                except SyntaxError as e:
                    rep.findings.append(_f("unparseable", rel, str(e)))
                n_files += 1
    rep.info["lint"] = {"files": n_files,
                        "findings": len(rep.findings)}
    return rep
