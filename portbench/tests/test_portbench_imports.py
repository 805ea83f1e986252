"""The harness, the reference and what they load import no JAX: an import
graph over the sources' syntax trees, top-level names compared whole."""

import ast
import os

from portbench.harness.guard import BANNED, loaded

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LOCAL = ("portbench", "video_distillation_torch")


def _imports(path, package):
    """(absolute module names) a source imports, relative ones resolved."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.split(".")
                base = base[:len(base) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
                out += [mod] + [f"{mod}.{a.name}" for a in node.names]
            else:
                out += [node.module] + [f"{node.module}.{a.name}"
                                        for a in node.names]
    return out


def _source(module):
    """The file of a local module or package, or None."""
    base = os.path.join(ROOT, *module.split("."))
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(path):
            return path
    return None


def closure(paths):
    """Every module name imported from ``paths`` and, transitively, from the
    local modules they import."""
    seen, names, todo = set(), set(), list(paths)
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        package = rel[:-len(".__init__")] if rel.endswith("__init__") else rel
        for name in _imports(path, package):
            names.add(name)
            if name.split(".")[0] in LOCAL:
                src = _source(name)
                if src:
                    todo.append(src)
    return names


def _bench_sources(sub=""):
    out = []
    for d, _, files in os.walk(os.path.join(ROOT, "portbench", sub)):
        if os.path.basename(d) == "tests":
            continue
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_harness_and_what_it_loads_import_no_jax():
    tops = {n.split(".")[0] for n in closure(_bench_sources())}
    assert "video_distillation_torch" in tops
    assert not tops & set(BANNED), tops & set(BANNED)


def test_reference_imports_nothing_of_the_program():
    tops = {n.split(".")[0] for n in closure(_bench_sources("reference"))}
    assert not tops & (set(BANNED) | {"video_distillation_torch"}), tops


def test_names_are_compared_whole():
    import sys
    sys.modules["video_distillation_tpux"] = sys
    try:
        assert "video_distillation_tpux" not in loaded()
        assert loaded(["video_distillation_tpux"]) == ["video_distillation_tpux"]
    finally:
        del sys.modules["video_distillation_tpux"]
