"""The benchmark measures the port alone: neither JAX nor the JAX package
``flair_for_aigle_tpu`` may be loaded. Module names are compared by their
top-level name (the part before the first dot) as a whole word, since the
port's name, ``flair_for_aigle_tpu_torch``, begins with the JAX package's.
"""

from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "flair_for_aigle_tpu"})


def top_level(module_name: str) -> str:
    return module_name.split(".", 1)[0]


def is_forbidden(module_name: str) -> bool:
    return top_level(module_name) in FORBIDDEN


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names of forbidden modules in ``sys.modules`` (or the
    given names), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names if is_forbidden(n)})


def imports_of(path: str) -> list[str]:
    """The module names a Python source imports (absolute imports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def forbidden_imports(root: str) -> dict[str, list[str]]:
    """{source path: forbidden module names it imports} under ``root``."""
    found = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                bad = [m for m in imports_of(path) if is_forbidden(m)]
                if bad:
                    found[path] = bad
    return found
