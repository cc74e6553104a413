"""The fence between the benchmark, the program and the JAX package.

`loaded_banned()` lists the modules of `sys.modules` whose top-level name
(the part before the first dot, compared whole) is JAX's, jaxlib's, flax's
or the JAX package's; `metaworld_tpu_torch` is another name and passes.
`reference_imports()` lists every import in `reference/` that leaves it
for anything but torch, numpy and the standard library."""

from __future__ import annotations

import ast
import pathlib
import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "metaworld_tpu"})
REFERENCE_MAY_IMPORT = frozenset({"torch", "numpy", "__future__"}) | frozenset(
    sys.stdlib_module_names)
HERE = pathlib.Path(__file__).resolve().parent


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_banned(modules=None) -> list[str]:
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if top(m) in BANNED)


def reference_imports(root: pathlib.Path = HERE / "reference") -> list[str]:
    """'file: module' of each import in the reference that is neither its
    own (mwbench.reference...) nor torch, numpy or the standard library."""
    bad = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                if n.startswith("mwbench.reference") or n == "mwbench.reference":
                    continue
                if top(n) not in REFERENCE_MAY_IMPORT:
                    bad.append(f"{path.relative_to(root.parent)}: {n}")
    return bad
