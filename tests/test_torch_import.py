"""The PyTorch/CUDA port imports neither JAX nor the JAX package, nor the
libraries the card's machine lacks that the JAX package's evaluation
consumers use (PIL, safetensors, sklearn, transformers).

``dino_video_summarization_transformer_tpu_torch`` starts with the JAX
package's name, so every check matches whole module names."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

import conftest

PORT = "dino_video_summarization_transformer_tpu_torch"
JAX_PKG = "dino_video_summarization_transformer_tpu"
PORT_DIR = os.path.join(conftest.REPO_ROOT, PORT)


ABSENT_ON_CARD = ("PIL", "safetensors", "sklearn", "transformers")


def _forbidden(name: str, mods=("jax", JAX_PKG)) -> bool:
    return any(name == m or name.startswith(m + ".") for m in mods)


def _port_files():
    files = [os.path.join(conftest.REPO_ROOT, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(os.path.relpath(f, conftest.REPO_ROOT) for f in files)


def test_import_leaves_jax_out():
    """Import every module of the port in a fresh interpreter (this test
    process has JAX loaded by conftest): no JAX, no JAX package, no PyYAML
    and no native decoder get loaded."""
    mods = [PORT] + [m.name for m in pkgutil.walk_packages(
        [PORT_DIR], prefix=PORT + ".")]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'yaml', "
        f"'{JAX_PKG}', *{ABSENT_ON_CARD!r}) or m.startswith(('jax.', '{JAX_PKG}.'))]\n"
        f"lib = sys.modules['{PORT}.data.video']._LIB\n"
        "print(bad, lib)\n"
        "sys.exit(1 if bad or lib is not None else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=conftest.REPO_ROOT,
                          env=conftest.cpu_subprocess_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(mods) > 15


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_import_statement(path):
    with open(os.path.join(conftest.REPO_ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("path", _port_files())
def test_no_import_of_what_the_card_lacks(path):
    """No import statement anywhere in a port file (lazy ones included)
    names PIL, safetensors, sklearn or transformers."""
    with open(os.path.join(conftest.REPO_ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n, ABSENT_ON_CARD)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_forbidden_matches_whole_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden(JAX_PKG) and _forbidden(JAX_PKG + ".ops.fused_block")
    assert not _forbidden(PORT) and not _forbidden(PORT + ".ops")
    assert not _forbidden("jaxlib_like") and not _forbidden("numpy")
