"""The port must run where JAX is absent: ``hpmn_tpu_torch`` and
``chip_smoke.py`` import neither ``jax``, ``optax``, ``orbax``,
``ml_collections``, ``chex``, ``ml_dtypes``, ``tensorboardX``,
``tensorboard`` nor anything of ``hpmn_tpu``, at import time
or inside a function. Every module of the port is imported, the training
driver's (``train.train``, ``train.optim``, ``train.checkpoint``,
``train.evaluate``, ``train.metrics``, ``data.loader``,
``utils.asserts``) and the real-data layer's and the baselines'
(``data.preprocess``, ``data.native``, ``data.native_batcher``, the three
``data.process_*`` CLIs, ``models.gru4rec``, ``models.rum``), the
serving bundles' (``serving.history``, the ``tools.export_bundle`` and
``tools.serve_batch`` CLIs) and the daemon's and the AOT path's
(``serving.server``, ``serving.client``, ``serving.journal``,
``serving.sharded``, ``serving.fleet``, ``serving.aot``, ``ops.library``,
the ``tools.serve`` and ``tools.serve_fleet`` CLIs) and the remaining
families' (``models.extra_baselines``, the ``tools.compare_models`` CLI)
and parallelism's (``parallel`` and its ``distributed``, ``mesh``,
``embedding_sharding``, ``train_step`` and ``seq_parallel``) and the last
driver options' and tools' (``train.events``, the ``tools.sweep`` and
``tools.quality_gate`` CLIs) among them."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ml_collections", "optax", "orbax", "chex",
             "hpmn_tpu", "ml_dtypes", "tensorboardX", "tensorboard")
DRIVER = ("train.train", "train.optim", "train.checkpoint", "train.evaluate",
          "train.metrics", "data.loader", "utils.asserts", "data.preprocess",
          "data.native", "data.native_batcher", "data.process_amazon",
          "data.process_taobao", "data.process_xlong", "models.gru4rec",
          "models.rum", "serving.history", "tools.export_bundle",
          "tools.serve_batch", "serving.server", "serving.client",
          "serving.journal", "serving.sharded", "serving.fleet",
          "serving.aot", "ops.library", "tools.serve", "tools.serve_fleet",
          "models.extra_baselines", "tools.compare_models",
          "parallel", "parallel.distributed", "parallel.mesh",
          "parallel.embedding_sharding", "parallel.train_step",
          "parallel.seq_parallel", "train.events", "tools.sweep",
          "tools.quality_gate")


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
    assert int(out.stdout.split()[-1]) >= 60  # every submodule was imported


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


def test_the_clis_run_without_jax(tmp_path):
    """Each process_* CLI preprocesses a small log (taobao and xlong through
    the native parser) in a process that then holds no module of JAX."""
    with open(tmp_path / "reviews.json", "w") as f:
        for u in range(3):
            for t in range(6):
                f.write(f'{{"reviewerID": "U{u}", "asin": "A{t % 4}", '
                        f'"unixReviewTime": {t}}}\n')
    with open(tmp_path / "log.csv", "w") as f:
        for u in range(3):
            for t in range(25):
                f.write(f"u{u},i{t % 7},c{t % 3},pv,{t}\n")
    code = (
        "import sys\n"
        "from hpmn_tpu_torch.data import (native, process_amazon,"
        " process_taobao, process_xlong)\n"
        f"d = {str(tmp_path)!r}\n"
        "process_amazon.main(['--reviews', d + '/reviews.json', '--out',"
        " d + '/amazon.npz'])\n"
        "process_taobao.main(['--log', d + '/log.csv', '--out',"
        " d + '/taobao.npz'])\n"
        "process_xlong.main(['--log', d + '/log.csv', '--out',"
        " d + '/xlong.npz', '--min_events', '20', '--no-native'])\n"
        "assert native.available()\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert [line.split(":")[0].rsplit("/", 1)[-1]
            for line in out.stdout.splitlines()] == [
        "amazon.npz", "taobao.npz", "xlong.npz"]
