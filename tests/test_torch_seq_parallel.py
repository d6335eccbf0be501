"""The port's sequence parallelism (``hpmn_tpu_torch/parallel/
seq_parallel.py``, the seq axis of ``mesh.py``, ``train_step.py`` and
the driver) held to the JAX package's on the CPU.

Four gloo ranks (worker processes that import only torch, numpy and the
port) run every case once (module fixture, started before the JAX side
so that both run at once); the JAX side runs in this process on the fake
CPU devices of ``tests/conftest.py``, the Pallas kernel in interpret mode
for the ``pallas`` legs. Each test reads its case:

- ``sp_gru_sequence`` on 2 ranks (a (2, 2) grid: two seq groups) and on
  4 (one), with the plain chunk scan and with the kernels' wrapper
  (``cuda_gru.gru_sequence``, its plain versions here): the cases of
  ``test_sp_scan_matches_plain``, the indivisible fallback and a
  hypothesis sweep over drawn shapes, against JAX's ``sp_gru_sequence``
  under ``shard_map`` and against the plain scan: values within 1e-6,
  the x, weight and scale gradients (meaned over seq) within 2e-5; the
  kernels' batch-major wrapper from an h0 against
  ``pallas_gru_sequence``, the h0 gradient included;
- ``make_sp_steps`` on (2, 2) for hpmn (the plain and the kernels' chunk
  scan) and dien against JAX's ``make_sp_steps`` on four devices and
  against one process; ``make_shardmap_steps`` on (1, 2, 2) for
  psum/``jnp`` and a2a with batch_over_model/``pallas`` against JAX's
  composed step: parameters within 2e-5, logits within 1e-4;
- k = 2 steps per call against two calls, bit for bit;
- the grid's layout and groups; the guards;
- ``train()`` on 2 ranks through ``python -m torch.distributed.run`` with
  ``mesh.seq_parallel=2``: its mesh line, and its losses and metrics
  those of one process.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

import hpmn_tpu.ops.pallas_gru as pg
from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.data.schema import batch_from_numpy as j_batch_from_numpy
from hpmn_tpu.data.schema import dummy_batch
from hpmn_tpu.models import apply_model as j_apply_model
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.ops.gru import GRUParams as JGRUParams
from hpmn_tpu.ops.pallas_gru import pallas_gru_sequence
from hpmn_tpu.parallel import make_mesh as j_make_mesh
from hpmn_tpu.parallel import make_shardmap_steps as j_make_shardmap_steps
from hpmn_tpu.parallel import param_shardings as j_param_shardings
from hpmn_tpu.parallel import shard_batch as j_shard_batch
from hpmn_tpu.parallel.seq_parallel import (SEQ_AXIS, make_sp_mesh,
                                            make_sp_steps, sp_gru_sequence)
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import flat_from_model, model_from_flat
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.ops import cuda_gru
from hpmn_tpu_torch.ops.gru import GRUWeights, gru_sequence
from hpmn_tpu_torch.parallel import mesh as port_mesh
from hpmn_tpu_torch.parallel import seq_parallel as port_sp
from hpmn_tpu_torch.parallel import train_step as port_ts
from hpmn_tpu_torch.train import train as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
D_IN, D_M = 5, 32
N_ITEMS, N_CATS = 96, 24
B, T_STEP = 8, 16
# (name, B, T, n_seq, microbatches, masked, scaled, min_local_steps): the
# cases of the JAX test_sp_scan_matches_plain at n_seq 2 and 4 (4 with
# chunks of 6 steps, so that it pipelines) and its indivisible fallback.
SCAN_CASES = [
    (f"mb{mb}_{'m' if masked else 'f'}{'_s' if scaled else ''}_n{n}",
     8, 24, n, mb, masked, scaled, 4 if n == 4 else 8)
    for n in (2, 4)
    for mb, masked, scaled in ((1, True, False), (4, True, False),
                               (8, False, False), (4, True, True))] + [
    ("fallback", 4, 10, 4, 2, True, False, 8)]
# The hypothesis sweep's shapes, drawn once (the ranks compute them before
# the sweep runs) over the JAX property test's ranges.
_rng = np.random.default_rng(2026)
SWEEP = [(f"sweep{i}", int(_rng.integers(1, 7)), int(_rng.integers(1, 33)),
          int(_rng.choice([2, 4])), int(_rng.integers(1, 7)),
          bool(_rng.integers(2)), bool(_rng.integers(2)), 8)
         for i in range(8)]
INNERS = ("jnp", "pallas")
STEP_BASE = ["model.hpmn_layers=2", "train.steps_per_dispatch=1",
             "model.use_pallas=false", "train.lr=0.01"]
SP_STEPS = {"hpmn": ("amazon_hpmn", ["mesh.seq_parallel=2"]),
            "hpmn_pallas": ("amazon_hpmn", ["mesh.seq_parallel=2",
                                            "mesh.sp_inner=pallas"]),
            "dien": ("taobao_dien", ["mesh.seq_parallel=2"])}
COMPOSED = {"psum_jnp": ("psum", "jnp", False),
            "a2a_pallas_bom": ("a2a", "pallas", True)}
TRAIN = ["n_examples=600", "train.max_steps=20", "train.eval_every=10",
         "train.log_every=5", "train.batch_size=32",
         "train.steps_per_dispatch=1", "model.hpmn_layers=2",
         "model.use_pallas=false", "mesh.sp_inner=pallas",
         "mesh.seq_parallel=2"]

WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import (flat_from_sharded_model,
                                    sharded_model_from_flat)
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.ops import cuda_gru
from hpmn_tpu_torch.ops.gru import GRUWeights
from hpmn_tpu_torch.parallel import distributed
from hpmn_tpu_torch.parallel.mesh import make_mesh, shard_batch
from hpmn_tpu_torch.parallel.seq_parallel import (make_sp_steps,
                                                  sp_gru_sequence)
from hpmn_tpu_torch.parallel.train_step import make_shardmap_steps
from hpmn_tpu_torch.train.train import apply_overrides

rank, work = int(sys.argv[1]), sys.argv[2]
spec = json.load(open(os.path.join(work, "spec.json")))
distributed.initialize(spec["init"], spec["world"], rank, backend="gloo",
                       device="cpu")
z = np.load(os.path.join(work, "inputs.npz"))
out = {}
meshes = {2: make_mesh(1, 2), 4: make_mesh(1, 4)}
composed = make_mesh(2, 2)
for name, m in (("sp2", meshes[2]), ("sp4", meshes[4]),
                ("composed", composed)):
    groups = [m.model_group, m.seq_group, m.table_group]
    out[f"grid/{name}"] = np.asarray(
        [m.data_index, m.seq_index, m.model_index, *m.shape.values()])
    for g_name, g in zip(("model", "seq", "table"), groups):
        out[f"grid/{name}/{g_name}"] = np.asarray(
            dist.get_process_group_ranks(g) if g is not None else [-1])

# the scans
for name, b, t, n, mb, masked, scaled, min_local in spec["scans"]:
    mesh = meshes[n]
    w = GRUWeights(*(torch.from_numpy(z[f"s/{name}/{k}"]).requires_grad_()
                     for k in ("wx", "wh", "b")))
    x = torch.from_numpy(z[f"s/{name}/x"]).requires_grad_()
    mask = torch.from_numpy(z[f"s/{name}/mask"]) if masked else None
    a = (torch.from_numpy(z[f"s/{name}/scale"]).requires_grad_()
         if scaled else None)
    for inner_name in spec["inners"]:
        inner = cuda_gru.gru_sequence if inner_name == "pallas" else None
        h, hT = sp_gru_sequence(w, x, mask, a, n_shards=n, mesh=mesh,
                                microbatches=mb, min_local_steps=min_local,
                                inner=inner)
        loss = (h ** 2).sum() + (hT ** 2).sum()
        leaves = [x, *w] + ([a] if scaled else [])
        grads = torch.autograd.grad(loss, leaves)
        key = f"scan/{name}/{inner_name}"
        out[key + "/h"], out[key + "/hT"] = h.detach().numpy(), \
            hT.detach().numpy()
        for k, g in zip(("x", "wx", "wh", "b", "scale"), grads):
            g = g.clone()
            dist.all_reduce(g, group=mesh.seq_group)  # the mean over seq
            out[f"{key}/g_{k}"] = (g / n).numpy()


class SGD:
    def __init__(self, params, lr):
        self.params, self.lr = list(params), lr

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for p in self.params:
            p.sub_(self.lr * p.grad)


def setup(config, overrides, prefix, mesh):
    cfg = apply_overrides(configs.get_config(config), overrides)
    flat = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
    model = sharded_model_from_flat(cfg, flat, mesh, device="cpu")
    return cfg, model, SGD(model.parameters(), cfg.train.lr)


def rows(prefix, mesh, over=("data",)):
    arrays = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
    return shard_batch(mesh, batch_from_numpy(arrays, device="cpu"),
                       over=over)


def record(case, model, mesh, metrics, logits):
    for k, v in metrics.items():
        out[f"{case}/metric/{k}"] = np.asarray(v.item())
    for k, v in flat_from_sharded_model(model, mesh).items():
        out[f"{case}/param/{k}"] = v
    out[f"{case}/logits"] = logits.detach().numpy()


mesh = meshes[2]  # (data 2, seq 2)
for case, (config, extra) in spec["sp_steps"].items():
    prefix = "jd/" if config == "taobao_dien" else "j/"
    cfg, model, opt = setup(config, spec["base"] + extra, prefix, mesh)
    train_step, eval_step = make_sp_steps(cfg, model, opt, mesh)
    metrics = train_step(rows("b/", mesh))
    record(case, model, mesh, metrics, eval_step(model, rows("b/", mesh)))

for case, (mode, inner, bom) in spec["composed"].items():
    cfg, model, opt = setup("amazon_hpmn", spec["base"] + [
        "mesh.model_parallel=2", "mesh.seq_parallel=2",
        f"mesh.embedding_mode={mode}", f"mesh.sp_inner={inner}",
        "mesh.sp_min_local_steps=4", f"mesh.batch_over_model={bom}"],
        "j/", composed)
    train_step, eval_step = make_shardmap_steps(cfg, model, opt, composed)
    over = ("data", "model") if bom else ("data",)
    metrics = train_step(rows("bc/", composed, over))
    record(case, model, composed, metrics,
           eval_step(model, rows("bc/", composed, ("data", "model"))))

# k = 2 steps in one call against two calls
for k in (1, 2):
    cfg, model, opt = setup("amazon_hpmn", spec["base"] + [
        "mesh.seq_parallel=2"], "j/", mesh)
    train_step, _ = make_sp_steps(cfg, model, opt, mesh)
    b1, b2 = rows("b/", mesh), rows("b2/", mesh)
    ms = [train_step(b1), train_step(b2)] if k == 1 else [
        train_step([b1, b2])]
    out[f"multi{k}/loss"] = np.asarray(ms[-1]["loss"].item())
    for n, v in flat_from_sharded_model(model, mesh).items():
        out[f"multi{k}/param/{n}"] = v
np.savez(os.path.join(work, f"out{rank}.npz"), **out)
distributed.shutdown()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree):
    keys, leaves, _ = flatten_with_keys(tree)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


def _scan_data(case):
    """The case's GRU weights, x, mask and scale, from its name's seed."""
    name, b, t, _, _, masked, scaled, _ = case
    rng = np.random.default_rng(sum(map(ord, name)))
    s_x = (6.0 / (D_IN + 3 * D_M)) ** 0.5
    s_h = (6.0 / (4 * D_M)) ** 0.5
    f32 = np.float32
    out = {"wx": rng.uniform(-s_x, s_x, (D_IN, 3 * D_M)).astype(f32),
           "wh": rng.uniform(-s_h, s_h, (D_M, 3 * D_M)).astype(f32),
           "b": rng.uniform(-0.1, 0.1, 3 * D_M).astype(f32),
           "x": rng.standard_normal((b, t, D_IN)).astype(f32)}
    pads = rng.integers(0, t, size=b)
    out["mask"] = (np.arange(t)[None, :] >= pads[:, None]).astype(f32) \
        if masked else None
    out["scale"] = rng.uniform(0.1, 1.0, (b, t)).astype(f32) \
        if scaled else None
    return out


def _batch_arrays(seed, n_items=N_ITEMS, n_cats=N_CATS):
    b = dummy_batch(B, T_STEP, n_items, n_cats, seed=seed)
    return {f.name: np.asarray(getattr(b, f.name))
            for f in dataclasses.fields(b)}


def _j_step_cfg(config, seq_overrides):
    """The JAX config of a port step case (the same overrides)."""
    cfg = j_get_config(config)
    cfg.model.hpmn_layers = 2
    cfg.model.use_pallas = False
    cfg.train.steps_per_dispatch = 1
    cfg.mesh.embedding_mode = "replicated"
    for kv in seq_overrides:
        key, val = kv.split("=", 1)
        sec, field = key.split(".")
        old = getattr(getattr(cfg, sec), field)
        setattr(getattr(cfg, sec), field,
                val.lower() == "true" if isinstance(old, bool)
                else type(old)(val))
    return cfg


@pytest.fixture(scope="module")
def jax_params():
    """JAX's initial parameters of the step cases: amazon_hpmn (2
    layers), taobao_dien."""
    return {cfg: _flat(jax.device_get(j_init_model(
        jax.random.key(0), _j_step_cfg(cfg, []), N_ITEMS, N_CATS)))
        for cfg in ("amazon_hpmn", "taobao_dien")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_params):
    """Start the worker on 4 gloo ranks and the 2-rank train() CLI ->
    wait() -> ([each rank's outputs], the CLI's stdout)."""
    work = tmp_path_factory.mktemp("seq_parallel")
    inputs = {**{f"j/{k}": v for k, v in jax_params["amazon_hpmn"].items()},
              **{f"jd/{k}": v for k, v in jax_params["taobao_dien"].items()},
              **{f"b/{k}": v for k, v in _batch_arrays(9).items()},
              **{f"b2/{k}": v for k, v in _batch_arrays(10).items()},
              **{f"bc/{k}": v for k, v in _batch_arrays(4).items()}}
    for case in SCAN_CASES + SWEEP:
        for k, v in _scan_data(case).items():
            if v is not None:
                inputs[f"s/{case[0]}/{k}"] = v
    np.savez(work / "inputs.npz", **inputs)
    spec = {"init": f"tcp://127.0.0.1:{_free_port()}", "world": WORLD,
            "scans": SCAN_CASES + SWEEP, "inners": INNERS,
            "base": STEP_BASE, "sp_steps": SP_STEPS, "composed": COMPOSED}
    (work / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    logs = [open(work / f"log{r}.txt", "w+") for r in range(WORLD + 1)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(work)], cwd=ROOT, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    cli_out = open(work / "cli.txt", "w+")
    procs.append(subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "hpmn_tpu_torch.train.train",
         "--config", "amazon_hpmn", "--device", "cpu", "--set", *TRAIN],
        cwd=ROOT, env=env, stdout=cli_out, stderr=logs[WORLD]))
    done = {}

    def wait():
        if not done:
            for r, p in enumerate(procs):
                p.wait(timeout=300)
                logs[r].seek(0)
                assert p.returncode == 0, f"process {r}:\n" \
                    f"{logs[r].read()[-3000:]}"
            cli_out.seek(0)
            done["v"] = ([dict(np.load(work / f"out{r}.npz"))
                          for r in range(WORLD)], cli_out.read())
        return done["v"]

    yield wait
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in logs + [cli_out]:
        f.close()


# ------------------------------------------------------------------ scans

def _jax_sp_scan(case):
    """JAX's sp_gru_sequence of the case on n_seq devices -> (h, h_T,
    [dx, dwx, dwh, db(, dscale)]: the gradients of sum(h^2) + sum(h_T^2)
    meaned over seq)."""
    name, _, _, n, mb, _, scaled, min_local = case
    d = _scan_data(case)
    params = JGRUParams(*(jnp.asarray(d[k]) for k in ("wx", "wh", "b")))
    mask = None if d["mask"] is None else jnp.asarray(d["mask"])
    args = (params, jnp.asarray(d["x"])) + (
        (jnp.asarray(d["scale"]),) if scaled else ())
    mesh = make_sp_mesh(seq_parallel=n, devices=jax.devices()[:n])

    def f(*a):
        def loss(*a):
            h, hT = sp_gru_sequence(a[0], a[1], mask=mask,
                                    gate_scale=a[2] if scaled else None,
                                    n_shards=n, microbatches=mb,
                                    min_local_steps=min_local)
            return jnp.sum(h ** 2) + jnp.sum(hT ** 2), (h, hT)

        (_, (h, hT)), g = jax.value_and_grad(
            loss, argnums=tuple(range(len(a))), has_aux=True)(*a)
        return h, hT, jax.tree.map(lambda t: jax.lax.pmean(t, SEQ_AXIS), g)

    h, hT, g = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=tuple(P() for _ in args),
        out_specs=(P(), P(), P()), check_vma=False))(*args)
    grads = [g[1], g[0].wx, g[0].wh, g[0].b] + ([g[2]] if scaled else [])
    return np.asarray(h), np.asarray(hT), [np.asarray(t) for t in grads]


def _plain_scan(case):
    """The plain scan (the port's gru_sequence, one process) -> (h, h_T,
    the same gradients)."""
    d = _scan_data(case)
    w = GRUWeights(*(torch.from_numpy(d[k]).requires_grad_()
                     for k in ("wx", "wh", "b")))
    x = torch.from_numpy(d["x"]).requires_grad_()
    a = None if d["scale"] is None else \
        torch.from_numpy(d["scale"]).requires_grad_()
    mask = None if d["mask"] is None else torch.from_numpy(d["mask"])
    h, hT = gru_sequence(w, x, mask=mask, gate_scale=a)
    grads = torch.autograd.grad((h ** 2).sum() + (hT ** 2).sum(),
                                [x, *w] + ([a] if a is not None else []))
    return (h.detach().numpy(), hT.detach().numpy(),
            [g.numpy() for g in grads])


def _check_scan(outs, case):
    name, scaled = case[0], case[6]
    h, hT, grads = _jax_sp_scan(case)
    ph, phT, pgrads = _plain_scan(case)
    keys = ["x", "wx", "wh", "b"] + (["scale"] if scaled else [])
    for out in outs:
        for inner in INNERS:
            key = f"scan/{name}/{inner}"
            for want in ((h, hT), (ph, phT)):
                np.testing.assert_allclose(out[key + "/h"], want[0],
                                           atol=1e-6, rtol=0)
                np.testing.assert_allclose(out[key + "/hT"], want[1],
                                           atol=1e-6, rtol=0)
            for k, g, pg_ in zip(keys, grads, pgrads):
                for want in (g, pg_):
                    np.testing.assert_allclose(out[f"{key}/g_{k}"], want,
                                               atol=2e-5, rtol=2e-5,
                                               err_msg=f"{key} d{k}")


@pytest.mark.parametrize("case", SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_sp_scan_matches_jax_and_plain(ranks, case):
    """The T-sharded scan (both chunk scans) on every rank against JAX's
    on n_seq devices and the plain scan: h and h_T within 1e-6, the
    gradients of x, the weights and the scale (meaned over seq) within
    2e-5; the fallback (T = 10 over 4) runs the plain scan whole."""
    _check_scan(ranks()[0], case)


@settings(max_examples=len(SWEEP), deadline=None, derandomize=True)
@given(case=st.sampled_from(SWEEP))
def test_sp_schedule_sweep_matches_jax_and_plain(ranks, case):
    """The JAX property test's ranges (B 1-6, T 1-32, n_seq 2 or 4,
    microbatches 1-6, mask and scale on or off), the shapes drawn once so
    that the ranks computed them; indivisible T and short chunks fall
    back."""
    _check_scan(ranks()[0], case)


def test_kernel_wrapper_from_h0_matches_pallas():
    """``cuda_gru.gru_sequence`` (the ``pallas`` chunk scan: batch-major
    over GRUScan, here its plain versions) from an h0, masked and scaled,
    against ``pallas_gru_sequence`` in interpret mode: values within
    1e-6, the x, h0, weight and scale gradients within 2e-5."""
    case = ("h0", 4, 12, 2, 2, True, True, 8)
    d = _scan_data(case)
    h0 = np.random.default_rng(5).standard_normal((4, D_M)).astype(
        np.float32)
    loss = lambda h, hT: (h ** 2).sum() + (hT ** 2).sum()  # noqa: E731
    pg._INTERPRET = True
    try:
        def j_fn(wx, wh, b, x, h, a):
            return loss(*pallas_gru_sequence(
                JGRUParams(wx, wh, b), x, mask=jnp.asarray(d["mask"]),
                gate_scale=a, h0=h))

        j_args = [jnp.asarray(v) for v in (d["wx"], d["wh"], d["b"], d["x"],
                                           h0, d["scale"])]
        j_val, j_grads = jax.value_and_grad(j_fn, argnums=tuple(range(6)))(
            *j_args)
    finally:
        pg._INTERPRET = False
    t = [torch.from_numpy(np.asarray(v)).requires_grad_()
         for v in (d["wx"], d["wh"], d["b"], d["x"], h0, d["scale"])]
    h, hT = cuda_gru.gru_sequence(GRUWeights(*t[:3]), t[3], h0=t[4],
                                  mask=torch.from_numpy(d["mask"]),
                                  gate_scale=t[5])
    val = loss(h, hT)
    grads = torch.autograd.grad(val, t)
    assert abs(val.item() - float(j_val)) <= 1e-6 * abs(float(j_val))
    for name, got, want in zip(("wx", "wh", "b", "x", "h0", "scale"), grads,
                               j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5, err_msg=name)


# ------------------------------------------------------------------ steps

def _one_process_step(config, flat, batch):
    """The port's step on one process (SGD 1e-2, the plain scans) from
    the same weights -> (the parameters after it, the logits of every row
    after it)."""
    cfg = T.apply_overrides(configs.get_config(config), STEP_BASE)
    model = model_from_flat(cfg, flat, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    T.make_train_step(cfg, model, opt)(batch)
    logits = T.make_eval_step(cfg, "cpu")(model, batch)
    return flat_from_model(model), logits.numpy()


def _check_step(outs, case, want, logits, rows_of, loss=None):
    for r, out in enumerate(outs):
        keys = [k.split("/", 2)[2] for k in out
                if k.startswith(f"{case}/param/")]
        assert set(keys) == set(want)
        for k in keys:
            np.testing.assert_allclose(out[f"{case}/param/{k}"], want[k],
                                       atol=2e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(out[f"{case}/logits"], logits[rows_of(r)],
                                   atol=1e-4, rtol=0)
        if loss is not None:
            assert abs(float(out[f"{case}/metric/loss"]) - loss) < 1e-4


@pytest.mark.parametrize("case", list(SP_STEPS))
def test_sp_step_matches_jax_and_one_process(ranks, jax_params, case):
    """``make_sp_steps`` on a (data 2, seq 2) grid against JAX's on four
    devices and against the port's step on one process: the parameters
    after one SGD step within 2e-5, the logits of each rank's data row
    within 1e-4, the loss metric (the mean of the data rows' losses)
    within 1e-4 of JAX's."""
    config, extra = SP_STEPS[case]
    pallas = "mesh.sp_inner=pallas" in extra
    cfg = _j_step_cfg(config, extra)
    flat = jax_params[config]
    arrays = _batch_arrays(9)
    batch = j_batch_from_numpy(arrays)
    tx = optax.sgd(1e-2)
    params = jax.tree.map(jnp.asarray, j_init_model(
        jax.random.key(0), cfg, N_ITEMS, N_CATS))
    pg._INTERPRET = pallas
    try:
        mesh = make_sp_mesh(seq_parallel=2, devices=jax.devices()[:4])
        jit_train, jit_eval = make_sp_steps(cfg, tx, mesh)
        with mesh:
            p2, _, metrics = jit_train(params, tx.init(params))(
                params, tx.init(params), batch)
            logits = np.asarray(jit_eval(p2)(p2, batch))
    finally:
        pg._INTERPRET = False
    want = _flat(jax.device_get(p2))
    per = B // 2
    outs, _ = ranks()
    _check_step(outs, case, want, logits,
                lambda r: slice(r // 2 * per, (r // 2 + 1) * per),
                float(metrics["loss"]))
    one, one_logits = _one_process_step(
        config, flat, batch_from_numpy(arrays, device="cpu"))
    _check_step(outs, case, one, one_logits,
                lambda r: slice(r // 2 * per, (r // 2 + 1) * per))


@pytest.mark.parametrize("case", list(COMPOSED))
def test_composed_step_matches_jax(ranks, jax_params, case):
    """``make_shardmap_steps`` on the (data 1, seq 2, model 2) grid, the
    tables row-sharded and the scans T-sharded, against JAX's composed
    step on (1, 2, 2) devices: parameters (the tables gathered) within
    2e-5, each rank's logits and the loss metric within 1e-4."""
    mode, inner, bom = COMPOSED[case]
    cfg = _j_step_cfg("amazon_hpmn", [
        "mesh.model_parallel=2", "mesh.seq_parallel=2",
        f"mesh.embedding_mode={mode}", f"mesh.sp_inner={inner}",
        "mesh.sp_min_local_steps=4", f"mesh.batch_over_model={bom}"])
    arrays = _batch_arrays(4)
    batch = j_batch_from_numpy(arrays)
    tx = optax.sgd(1e-2)
    over = ("data", "model") if bom else ("data",)
    params0 = jax.tree.map(jnp.asarray, j_init_model(
        jax.random.key(0), cfg, N_ITEMS, N_CATS))
    pg._INTERPRET = inner == "pallas"
    try:
        mesh = j_make_mesh(model_parallel=2, seq_parallel=2,
                           devices=jax.devices()[:4])
        params = jax.device_put(params0, j_param_shardings(mesh, params0))
        opt_state = jax.device_put(tx.init(params),
                                   j_param_shardings(mesh, tx.init(params)))
        jit_train, _ = j_make_shardmap_steps(cfg, tx, mesh)
        p2, _, metrics = jit_train(params, opt_state)(
            params, opt_state, j_shard_batch(mesh, batch, over=over))
    finally:
        pg._INTERPRET = False
    p2 = jax.device_get(p2)
    logits, _ = j_apply_model(p2, cfg, batch)
    per = B // 2  # each rank's own rows: (data, model) = 2 cells
    _check_step(ranks()[0], case, _flat(p2), np.asarray(logits),
                lambda r: slice((r % 2) * per, (r % 2 + 1) * per),
                float(metrics["loss"]))


def test_two_steps_in_one_call_match_two_calls(ranks):
    for out in ranks()[0]:
        assert out["multi1/loss"] == out["multi2/loss"]
        for k in out:
            if k.startswith("multi1/param/"):
                np.testing.assert_array_equal(
                    out[k], out[k.replace("multi1", "multi2")])


def test_ranks_hold_the_same_parameters(ranks):
    outs = ranks()[0]
    for case in list(SP_STEPS) + list(COMPOSED):
        for k in outs[0]:
            if k.startswith(f"{case}/param/"):
                for out in outs[1:]:
                    np.testing.assert_array_equal(out[k], outs[0][k])


def test_grid_layout_and_groups(ranks):
    """rank = (d * n_seq + s) * n_model + m, as JAX's (data, seq, model)
    device array; the model group shares (d, s), the seq group (d, m),
    the table group m."""
    for r, out in enumerate(ranks()[0]):
        for name, (n_seq, n_model) in (("sp2", (2, 1)), ("sp4", (4, 1)),
                                       ("composed", (2, 2))):
            d, s, m = r // (n_seq * n_model), r // n_model % n_seq, \
                r % n_model
            shape = {"sp2": [2, 2], "sp4": [1, 4], "composed": [1, 2, 2]}
            assert list(out[f"grid/{name}"]) == [d, s, m, *shape[name]]
            at = lambda d_, s_, m_: (d_ * n_seq + s_) * n_model + m_  # noqa
            want = {"model": [at(d, s, i) for i in range(n_model)],
                    "seq": [at(d, i, m) for i in range(n_seq)],
                    "table": [i for i in range(WORLD) if i % n_model == m]}
            for g, ranks_ in want.items():
                assert list(out[f"grid/{name}/{g}"]) == ranks_, (name, g)


def test_mesh_shape_and_batch_rows_match_jax():
    """``Mesh.shape`` names JAX's axes; ``shard_batch`` gives the seq ranks
    of a cell the same rows, the rows JAX's mesh places there."""
    j_mesh = j_make_mesh(model_parallel=2, seq_parallel=2,
                         devices=jax.devices()[:8])
    assert port_mesh.Mesh(2, 2, 0, n_seq=2).shape == dict(j_mesh.shape)
    j_sp = make_sp_mesh(seq_parallel=2, devices=jax.devices()[:4])
    assert port_mesh.Mesh(2, 1, 0, n_seq=2).shape == dict(j_sp.shape)
    batch = batch_from_numpy(_batch_arrays(9), device="cpu")
    for over in (("data",), ("data", "model")):
        n_cells = 2 if over == ("data",) else 4
        per = B // n_cells
        for r in range(8):
            mesh = port_mesh.Mesh(2, 2, r, n_seq=2)
            cell = (mesh.data_index if over == ("data",)
                    else mesh.data_index * 2 + mesh.model_index)
            got = port_mesh.shard_batch(mesh, batch, over=over)
            np.testing.assert_array_equal(
                got.item_seq.numpy(),
                batch.item_seq.numpy()[cell * per:(cell + 1) * per])


def test_guards():
    """make_sp_steps takes replicated tables, no use_pallas and a (data,
    seq) grid; an unknown sp_inner raises on every path; the seq axis
    owns gru_seq_fn."""
    mesh = port_mesh.Mesh(1, 1, 0, n_seq=2)
    base = T.apply_overrides(configs.get_config("amazon_hpmn"), STEP_BASE)
    model = model_from_flat(base, _flat(jax.device_get(j_init_model(
        jax.random.key(0), _j_step_cfg("amazon_hpmn", []), N_ITEMS,
        N_CATS))), device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    for over, match in ((["mesh.embedding_mode=psum"], "replicated"),
                        (["model.use_pallas=true"], "use_pallas")):
        with pytest.raises(ValueError, match=match):
            port_sp.make_sp_steps(T.apply_overrides(base, over), model, opt,
                                  mesh)
    with pytest.raises(ValueError, match="make_sp_mesh"):
        port_sp.make_sp_steps(base, model, opt,
                              port_mesh.Mesh(1, 2, 0, n_seq=2))
    with pytest.raises(ValueError, match="sp_inner"):
        port_sp.resolve_sp_fn(T.apply_overrides(base, [
            "mesh.sp_inner=cuda"]), 2, mesh)
    with pytest.raises(ValueError, match="sp_inner"):
        port_sp.make_sp_steps(T.apply_overrides(base, [
            "mesh.sp_inner=Pallas"]), model, opt, mesh)
    with pytest.raises(ValueError, match="owned by the seq axis"):
        port_ts.make_shardmap_steps(base, model, opt, mesh,
                                    gru_seq_fn=gru_sequence)
    with pytest.raises(ValueError, match="use_pallas"):
        port_ts.make_shardmap_steps(T.apply_overrides(base, [
            "model.use_pallas=true"]), model, opt, mesh)


# ----------------------------------------------------------------- driver

def _log_numbers(lines):
    """{"step N loss", "step N VAL", "TEST": [(each number, its last
    digit's unit)]} of the driver's lines, the timings left out."""
    out = {}
    for line in lines:
        if line.startswith(("step", "TEST")):
            line = line.split(" ex/s")[0]
            words = line.split()
            out[" ".join(words[:3]) if words[0] == "step" else "TEST"] = [
                (float(v), 10.0 ** -len(v.split(".")[1]))
                for v in re.findall(r"-?\d+\.\d+", line)]
    return out


def test_train_on_two_ranks_matches_one_process(ranks):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    hpmn_tpu_torch.train.train ... mesh.seq_parallel=2`` (the (data 1,
    seq 2) branch, the kernels' chunk scan) prints the JAX driver's mesh
    line, and its losses, VAL and TEST metrics are those of train() on one
    process with the same config (which trains on its one device), as
    printed, within one unit of the last digit (1e-4 for the losses)."""
    _, out = ranks()
    lines = out.splitlines()
    assert "mesh: {'data': 1, 'seq': 2}, seq_parallel=2 (microbatches=4)" \
        in lines
    one = []
    T.train(T.apply_overrides(configs.get_config("amazon_hpmn"), TRAIN),
            log=one.append, device="cpu")
    got, want = _log_numbers(lines), _log_numbers(one)
    assert set(got) == set(want) and len(want) == 7
    for k in want:  # printed rounded: a rounding boundary moves one unit
        assert len(got[k]) == len(want[k])
        for (a, unit), (b, _) in zip(got[k], want[k]):
            assert abs(a - b) <= 1.5 * unit, (k, got[k], want[k])
