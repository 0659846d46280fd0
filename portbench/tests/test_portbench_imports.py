"""No module of the benchmark imports JAX or the JAX package, and the
references import nothing of the program: top-level module names compared
whole (the program's name begins with the JAX package's)."""

import ast
import os

BANNED = {"jax", "jaxlib", "flax", "optax", "surfacenetworks_tpu"}
PROGRAM = "surfacenetworks_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere(root):
    found = {(p, m) for p in _sources(os.path.join(root, "portbench")) for m in _imports(p) if m in BANNED}
    assert not found


def test_references_import_nothing_of_the_program(root):
    ref = os.path.join(root, "portbench", "reference")
    found = {(p, m) for p in _sources(ref) for m in _imports(p) if m == PROGRAM or m in BANNED}
    assert not found
    # and nothing of the harness outside the references, which imports the program
    for p in _sources(ref):
        tree = ast.parse(open(p).read(), p)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), (p, node.module)
