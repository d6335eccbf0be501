"""The port must run where JAX is absent: ``hpmn_tpu_torch`` and
``chip_smoke.py`` import neither ``jax``, ``optax``, ``orbax``,
``ml_collections``, ``chex`` nor anything of ``hpmn_tpu``, at import time
or inside a function. Every module of the port is imported, the training
driver's (``train.train``, ``train.optim``, ``train.checkpoint``,
``train.evaluate``, ``train.metrics``, ``data.loader``,
``utils.asserts``) among them."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ml_collections", "optax", "orbax", "chex",
             "hpmn_tpu")
DRIVER = ("train.train", "train.optim", "train.checkpoint", "train.evaluate",
          "train.metrics", "data.loader", "utils.asserts")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = (
        "import pkgutil, sys, hpmn_tpu_torch\n"
        "for m in pkgutil.walk_packages(hpmn_tpu_torch.__path__, "
        "'hpmn_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "ours = [n for n in sys.modules if n.startswith('hpmn_tpu_torch')]\n"
        f"assert all('hpmn_tpu_torch.' + m in ours for m in {DRIVER!r})\n"
        "print(len(ours))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 36  # every submodule was imported


def test_no_source_of_the_port_names_jax():
    files = sorted((ROOT / "hpmn_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)
