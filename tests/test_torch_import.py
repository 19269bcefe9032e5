"""The PyTorch/CUDA port imports neither JAX nor the JAX package, nor the
libraries the card's machine lacks that the JAX package's evaluation
consumers use (safetensors, sklearn; PIL, transformers and nltk only
inside the functions that read images or caption).

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


ABSENT_ON_CARD = ("PIL", "safetensors", "sklearn", "transformers", "nltk")


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


# optional packages a port path may load where it uses them (image files,
# the HF captioner, METEOR's WordNet), never at a module's import
LAZY_ONLY = ("PIL", "transformers", "nltk")


def _import_names(node):
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module or ""]
    return []


@pytest.mark.parametrize("path", _port_files())
def test_no_import_of_what_the_card_lacks(path):
    """No import statement anywhere in a port file names safetensors or
    sklearn; PIL, transformers and nltk are imported only inside a function
    (lazily, where an image is read or a captioner or metric needs them)."""
    with open(os.path.join(conftest.REPO_ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    lazy = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            lazy.update(id(n) for n in ast.walk(fn))
    for node in ast.walk(tree):
        names = _import_names(node)
        bad = [n for n in names if _forbidden(n, ABSENT_ON_CARD)
               and not (_forbidden(n, LAZY_ONLY) and id(node) in lazy)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


# the parallel modules and the world launcher: every rank of a
# world imports them, so each is walked above and a spawned rank is checked
# below
PARALLEL = ("mesh", "launch", "tp", "tp_fused", "zero", "state", "worlds")


@pytest.mark.parametrize("mod", PARALLEL)
def test_parallel_modules_are_checked(mod):
    path = os.path.join(PORT, "parallel", f"{mod}.py")
    assert path in _port_files()
    assert f"{PORT}.parallel.{mod}" in [m.name for m in pkgutil.walk_packages(
        [PORT_DIR], prefix=PORT + ".")]


def test_world_ranks_leave_jax_out():
    """A rank of a world spawned from this process (which has JAX loaded)
    imports the port's parallel modules and no JAX, no JAX package."""
    from dino_video_summarization_transformer_tpu_torch.parallel import launch, worlds

    mods = [f"{PORT}.parallel.{m}" for m in PARALLEL]
    for loaded in launch.run_world(worlds.imported, 2, mods + ["jax", JAX_PKG]):
        assert set(mods) <= set(loaded), loaded
        assert not [m for m in loaded if _forbidden(m)], loaded


def test_forbidden_matches_whole_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden(JAX_PKG) and _forbidden(JAX_PKG + ".ops.fused_block")
    assert not _forbidden(PORT) and not _forbidden(PORT + ".ops")
    assert not _forbidden("jaxlib_like") and not _forbidden("numpy")
