"""Import rules of the PyTorch port.

The port and chip_smoke.py must import nothing of JAX or of the JAX
package, and the port's runtime stands on the standard library, numpy and
torch alone at import time (anything else is imported inside the function
that needs it).
"""

import ast
import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import localai_tpu_torch as port  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PKG_DIR = Path(port.__file__).resolve().parent
PKG = port.__name__
SOURCES = (sorted(PKG_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]
           + sorted((REPO / "scripts").glob("*.py")))
# packages the machine with the card does not have
ABSENT_ON_CARD = {"aiohttp", "pydantic", "yaml", "safetensors", "tokenizers",
                  "transformers", "jinja2", "grpc", "ml_dtypes"}


def _port_modules() -> list[str]:
    return [PKG] + sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, PKG + "."))


def test_every_module_imports_without_jax():
    """In a fresh interpreter where importing jax or the JAX package
    fails, every module of the port and chip_smoke import — and pull in
    no package the card's machine lacks."""
    code = (
        "import json, sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'localai_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch, numpy\n"
        "before = set(sys.modules)\n"
        "for m in json.loads(sys.argv[1]):\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    mods = _port_modules() + ["chip_smoke"]
    res = subprocess.run(
        [sys.executable, "-c", code, json.dumps(mods)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr
    new = json.loads(res.stdout.strip().splitlines()[-1])
    assert not {m.split(".")[0] for m in new} & ABSENT_ON_CARD
    assert len(mods) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name
                         if p.parent == REPO else
                         str(p.relative_to(PKG_DIR if PKG_DIR in p.parents
                                           else REPO)))
def test_sources_never_reach_jax(path):
    src = path.read_text()
    assert not re.search(r"\blocalai_tpu\.", src), \
        "refers to a module of the JAX package"
    for node in ast.walk(ast.parse(src)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "localai_tpu"), n


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if PKG_DIR in p.parents],
                         ids=lambda p: str(p.relative_to(PKG_DIR)))
def test_module_level_imports_are_stdlib_numpy_torch(path):
    allowed = set(sys.stdlib_module_names) | {"numpy", "torch", PKG}
    tree = ast.parse(path.read_text())
    for node in tree.body:  # module level only: lazy imports are fine
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops = [node.module.split(".")[0]]
        else:
            continue
        for top in tops:
            assert top in allowed or top == "__future__", top


def test_constrained_decoding_modules_are_covered():
    """The host side of constrained decoding (``functions/``, the C trie
    walk's loader in ``native/``, ``api/inference.py``) is among the
    modules and sources the rules above check."""
    mods = set(_port_modules())
    for m in ("functions", "functions.constraint", "functions.fsm",
              "functions.jsonschema", "functions.parse", "functions.tools",
              "native", "api.inference"):
        assert f"{PKG}.{m}" in mods, m
    rel = {str(p.relative_to(PKG_DIR)) for p in SOURCES
           if PKG_DIR in p.parents}
    assert {"native/__init__.py", "functions/constraint.py",
            "api/inference.py"} <= rel
