"""The port's data and model parallelism (``hpmn_tpu_torch/parallel/``)
held to the JAX package's on the CPU.

Four gloo ranks (worker processes that import only torch, numpy and the
port) form a 2 x 2 (data, model) grid; the JAX side runs in this process
on four of the 8 fake CPU devices of ``tests/conftest.py``, on a 2 x 2
mesh. The workers run every case once (module fixture) and write their
results; each test reads its case:

- the lookups (psum, the replicated-ids a2a, the bucketed exchange of each
  rank's own queries): the rows bit for bit and every table gradient
  within 1e-6 of its max abs, against JAX's lookups under ``shard_map``;
  the forced-overflow fallback equal to the a2a path;
- ``_bucket_slots`` (the layout and the overflow) and
  ``derive_capacity_factor`` against JAX's, in this process;
- the step, each rank's worth against ``make_shardmap_steps`` on four
  devices, amazon_hpmn with 2 layers and SGD 1e-2 (Adam's first step is
  about sign(g) lr, so reduction-order noise would flip it), psum, a2a
  and batch_over_model with ``l2_weight > 0``, and batch_over_model
  through the forced fallback: parameters within 2e-5, the reported loss
  within 1e-4 of the global loss, logits within 1e-4;
  clipping against JAX's GSPMD step (``make_sharded_steps``, the true
  global norm);
- k = 2 steps per call against two calls, with the overflow metric summed.
"""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.data.schema import batch_from_numpy as j_batch_from_numpy
from hpmn_tpu.data.schema import dummy_batch
from hpmn_tpu.models import apply_model as j_apply_model
from hpmn_tpu.models import loss_fn as j_loss_fn
from hpmn_tpu.parallel import (init_sharded_model, local_bucketed_lookup_fn,
                               local_lookup_fn, make_mesh, make_sharded_steps,
                               make_shardmap_steps, param_shardings,
                               shard_batch)
from hpmn_tpu.parallel import embedding_sharding as j_es
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu_torch.parallel import embedding_sharding as es

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
V, C, D = 40, 12, 4  # the lookup tables: rows (padded for 2 shards), width
N_ITEMS, N_CATS = 96, 24  # the step's vocab (divisible by 2)
B, T = 8, 12
STEP_OVERRIDES = ["model.hpmn_layers=2", "train.steps_per_dispatch=1",
                  "mesh.model_parallel=2", "mesh.a2a_capacity_factor=2.0",
                  "train.lr=0.01"]
MODES = {"psum": ("psum", False), "a2a": ("a2a", False),
         "bom": ("a2a", True)}
# The clip case: lr 1 and a clip at half the global gradient norm, so
# that a norm over one shard's table rows would move the update by more
# than the tolerance.
CLIP_LR, CLIP_SHARE = 1.0, 0.5

WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.models.embedding import Embedding
from hpmn_tpu_torch.convert import (flat_from_sharded_model,
                                    sharded_model_from_flat)
from hpmn_tpu_torch.parallel import distributed, embedding_sharding as es
from hpmn_tpu_torch.parallel.mesh import make_mesh, shard_batch
from hpmn_tpu_torch.parallel.train_step import make_shardmap_steps
from hpmn_tpu_torch.train.train import apply_overrides

rank, work = int(sys.argv[1]), sys.argv[2]
spec = json.load(open(os.path.join(work, "spec.json")))
distributed.initialize(spec["init"], spec["world"], rank, backend="gloo",
                       device="cpu")
mesh = make_mesh(2)
z = np.load(os.path.join(work, "inputs.npz"))
out = {}


def rows(a, over):
    # this rank's rows of a host batch (mesh.shard_batch's rule)
    n, i = ((mesh.n_data, mesh.data_index) if over == "data"
            else (mesh.size, mesh.rank))
    per = a.shape[0] // n
    return a[i * per:(i + 1) * per]


def shard(t):
    r = t.shape[0] // mesh.n_model
    return t[mesh.model_index * r:(mesh.model_index + 1) * r].clone()


def run_lookup(name, fn, over):
    emb = Embedding(1, 1, 1)
    emb.item = torch.nn.Parameter(shard(torch.from_numpy(z["lk_item"])))
    emb.cat = torch.nn.Parameter(shard(torch.from_numpy(z["lk_cat"])))
    ii = torch.from_numpy(rows(z["lk_ids_item"], over))
    ic = torch.from_numpy(rows(z["lk_ids_cat"], over))
    w = torch.from_numpy(rows(z["lk_w"], over))
    rows_ = fn(emb, ii, ic)
    (rows_ * w).sum().backward()
    out[name + "/rows"] = rows_.detach().numpy()
    out[name + "/g_item"] = emb.item.grad.numpy()
    out[name + "/g_cat"] = emb.cat.grad.numpy()
    flags = [int(f) for f in getattr(fn, "overflow_sink", [])]
    out[name + "/flags"] = np.asarray(flags + [-1])
    # the flag functions, on the bucketing each exchange runs
    if name == "a2a":
        flag = [es.replicated_ids_overflow(t, i.reshape(-1), mesh=mesh,
                                           capacity_factor=2.0)
                for t, i in ((emb.item, ii), (emb.cat, ic))]
    elif name in ("bucketed", "fallback"):
        cf = 2.0 if name == "bucketed" else 0.01
        flag = [es.exchange_overflow(
            i.reshape(-1), mesh=mesh, rows_per=t.shape[0],
            capacity=es._capacity(i.numel(), 2, cf))
            for t, i in ((emb.item, ii), (emb.cat, ic))]
    else:
        flag = []
    out[name + "/flag_fns"] = np.asarray([int(f) for f in flag] + [-1])


run_lookup("psum", es.local_lookup_fn(mesh, "psum"), "data")
run_lookup("a2a", es.local_lookup_fn(mesh, "a2a", 2.0), "data")
run_lookup("bucketed", es.local_bucketed_lookup_fn(mesh, 2.0), "model")
run_lookup("fallback", es.local_bucketed_lookup_fn(mesh, 0.01), "model")


class SGD:
    # SGD with the port Optimizer's global-norm clip (grad_sq_norm hook)
    def __init__(self, params, lr, clip):
        self.params, self.lr, self.clip = list(params), lr, clip
        self.grad_sq_norm = None

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params]
        if self.clip > 0:
            sq = (self.grad_sq_norm() if self.grad_sq_norm is not None
                  else sum(g.square().sum() for g in grads))
            norm = torch.sqrt(sq)
            scale = torch.where(norm < self.clip, 1.0, self.clip / norm)
            grads = [g * scale for g in grads]
        for p, g in zip(self.params, grads):
            p.sub_(self.lr * g)


def setup(overrides):
    cfg = apply_overrides(configs.get_config("amazon_hpmn"), overrides)
    flat = {k[2:]: z[k] for k in z.files if k.startswith("j/")}
    model = sharded_model_from_flat(cfg, flat, mesh, device="cpu")
    opt = SGD(model.parameters(), cfg.train.lr, cfg.train.grad_clip_norm)
    return cfg, model, opt


def batch(prefix, over):
    # the host's batch, then this rank's rows of it
    arrays = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
    axes = ("data", "model") if over == "model" else ("data",)
    return shard_batch(mesh, batch_from_numpy(arrays, device="cpu"),
                       over=axes)


for case, overrides in spec["steps"].items():
    cfg, model, opt = setup(overrides)
    over = "model" if case in ("bom", "fallback") else "data"
    train_step, eval_step = make_shardmap_steps(cfg, model, opt, mesh)
    metrics = train_step(batch("b/", over))
    for k, v in metrics.items():
        out[f"{case}/metric/{k}"] = np.asarray(v.item())
    for k, v in flat_from_sharded_model(model, mesh).items():
        out[f"{case}/param/{k}"] = v
    out[f"{case}/logits"] = eval_step(model, batch("b/", "model")).numpy()

# k = 2 in one call against two calls, the exchange forced to overflow
for k in (1, 2):
    cfg, model, opt = setup(spec["multistep"])
    train_step, _ = make_shardmap_steps(cfg, model, opt, mesh)
    b1, b2 = batch("b/", "model"), batch("b2/", "model")
    ms = [train_step(b1), train_step(b2)] if k == 1 else [train_step([b1, b2])]
    out[f"multi{k}/overflow"] = np.asarray([m["a2a_overflow"].item()
                                            for m in ms])
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


def _j_cfg(mode, bom, **train):
    cfg = j_get_config("amazon_hpmn")
    cfg.model.hpmn_layers = 2
    cfg.train.steps_per_dispatch = 1
    cfg.mesh.model_parallel = 2
    cfg.mesh.embedding_mode = mode
    cfg.mesh.batch_over_model = bom
    cfg.mesh.a2a_capacity_factor = 2.0
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _mesh():
    return make_mesh(model_parallel=2, devices=jax.devices()[:4])


def _batch_arrays(seed):
    b = dummy_batch(B, T, N_ITEMS, N_CATS, seed=seed)
    return {f.name: np.asarray(getattr(b, f.name))
            for f in dataclasses.fields(b)}


def _lookup_inputs():
    rng = np.random.default_rng(0)
    ids_i = rng.integers(0, V, (B, T)).astype(np.int32)
    ids_i[:, :3] = 0  # padding: one id repeated
    return {"lk_item": rng.standard_normal((V, D)).astype(np.float32),
            "lk_cat": rng.standard_normal((C, D)).astype(np.float32),
            "lk_ids_item": ids_i,
            "lk_ids_cat": rng.integers(0, C, (B, T)).astype(np.int32),
            "lk_w": rng.standard_normal((B, T, 2 * D)).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_params():
    cfg = _j_cfg("psum", False)
    params = init_sharded_model(jax.random.key(0), cfg, N_ITEMS, N_CATS,
                                _mesh())
    return jax.device_get(params)


@pytest.fixture(scope="module")
def clip(jax_params):
    """CLIP_SHARE of the step's global gradient norm."""
    cfg = _j_cfg("psum", False)
    batch = j_batch_from_numpy(_batch_arrays(5))
    g = jax.grad(lambda p: j_loss_fn(p, cfg, batch)[0])(jax_params)
    return CLIP_SHARE * float(optax.global_norm(g))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_params, clip):
    """Run the worker on 4 gloo ranks -> [each rank's outputs]."""
    work = tmp_path_factory.mktemp("parallel")
    inputs = {**_lookup_inputs(),
              **{f"j/{k}": v for k, v in _flat(jax_params).items()},
              **{f"b/{k}": v for k, v in _batch_arrays(5).items()},
              **{f"b2/{k}": v for k, v in _batch_arrays(6).items()}}
    np.savez(work / "inputs.npz", **inputs)
    steps = {case: STEP_OVERRIDES + [f"mesh.embedding_mode={m}",
                                     f"mesh.batch_over_model={bom}"]
             for case, (m, bom) in MODES.items()}
    steps["fallback"] = steps["bom"] + ["mesh.a2a_capacity_factor=0.01"]
    steps["clip"] = STEP_OVERRIDES + ["mesh.embedding_mode=psum",
                                      "mesh.batch_over_model=false",
                                      f"train.grad_clip_norm={clip}",
                                      f"train.lr={CLIP_LR}"]
    spec = {"init": f"tcp://127.0.0.1:{_free_port()}", "world": WORLD,
            "n_items": N_ITEMS, "n_cats": N_CATS, "steps": steps,
            "multistep": STEP_OVERRIDES + ["mesh.embedding_mode=a2a",
                                           "mesh.batch_over_model=true",
                                           "mesh.a2a_capacity_factor=0.01"]}
    (work / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(work)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    return [dict(np.load(work / f"out{r}.npz")) for r in range(WORLD)]


# ---------------------------------------------------------------- lookups

def _jax_lookup(name):
    """JAX's lookup of the same inputs on a 2 x 2 mesh -> (rows of every
    example, the table gradients of each device [4, R, d], data-major)."""
    x = _lookup_inputs()
    if name in ("psum", "a2a"):
        lk = local_lookup_fn(2, name, 2.0)
        ids = P("data")
    else:
        lk = local_bucketed_lookup_fn(
            2, capacity_factor=2.0 if name == "bucketed" else 0.01)
        ids = P(("data", "model"))
    dev = P(("data", "model"))

    @functools.partial(jax.shard_map, mesh=_mesh(),
                       in_specs=(P("model", None), P("model", None), ids,
                                 ids, ids),
                       out_specs=(ids, dev, dev), check_vma=False)
    def f(ti, tc, ii, ic, w):
        def loss(emb):
            rows = lk(emb, ii, ic)
            return jnp.sum(rows * w), rows

        (_, rows), g = jax.value_and_grad(loss, has_aux=True)(
            {"item": ti, "cat": tc})
        return rows, g["item"][None], g["cat"][None]

    rows, gi, gc = jax.jit(f)(x["lk_item"], x["lk_cat"], x["lk_ids_item"],
                              x["lk_ids_cat"], x["lk_w"])
    return np.asarray(rows), np.asarray(gi), np.asarray(gc)


def _rank_rows(name, r):
    """The example rows rank r holds in a lookup case."""
    if name in ("psum", "a2a"):
        per = B // 2
        return slice((r // 2) * per, (r // 2 + 1) * per)
    per = B // WORLD
    return slice(r * per, (r + 1) * per)


@pytest.mark.parametrize("name", ["psum", "a2a", "bucketed"])
def test_lookup_rows_and_table_grads_match_jax(ranks, name):
    rows, gi, gc = _jax_lookup(name)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"{name}/rows"],
                                      rows[_rank_rows(name, r)])
        for got, want in ((out[f"{name}/g_item"], gi[r]),
                          (out[f"{name}/g_cat"], gc[r])):
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        assert (out[f"{name}/flags"] == ([0, 0, -1] if name != "psum"
                                         else [-1])).all()
        assert (out[f"{name}/flag_fns"] == out[f"{name}/flags"]).all()


def test_forced_overflow_takes_the_exact_fallback(ranks):
    """Capacity factor 0.01 (one slot per owner): every exchange overflows
    on some rank, every rank takes the all_gather + psum fallback (flag
    1), and the rows and table gradients equal the a2a path's, and
    JAX's fallback's."""
    rows, gi, gc = _jax_lookup("fallback")
    for r, out in enumerate(ranks):
        assert (out["fallback/flags"] == [1, 1, -1]).all()
        assert (out["fallback/flag_fns"] == [1, 1, -1]).all()
        np.testing.assert_array_equal(out["fallback/rows"],
                                      out["bucketed/rows"])
        np.testing.assert_array_equal(out["fallback/rows"],
                                      rows[_rank_rows("fallback", r)])
        for key, want in (("g_item", gi[r]), ("g_cat", gc[r])):
            ref = out[f"bucketed/{key}"]
            assert np.abs(out[f"fallback/{key}"] - ref).max() \
                <= 1e-6 * np.abs(ref).max()
            assert np.abs(out[f"fallback/{key}"] - want).max() \
                <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("cap", [3, 2, 1])
def test_bucket_slots_match_jax(cap):
    """Stable sort permutation, slots (duplicates share one) and the
    overflow flag == JAX's ``_bucket_slots``."""
    ids = np.asarray([31, 5, 12, 7, 0, 25, 11, 39, 5, 5, 0, 12], np.int32)
    perm, slot, over = es._bucket_slots(torch.from_numpy(ids), 4, 10, cap)
    j_perm, j_slot, j_over = j_es._bucket_slots(jnp.asarray(ids), 4, 10, cap)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(j_perm))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(j_slot))
    assert bool(over) == bool(j_over)
    assert bool(over) == (cap < 3)  # owner 0 has 3 distinct ids: 0, 5, 7


def test_param_and_batch_shardings_match_jax(jax_params):
    """The tables row-sharded over "model", every other parameter
    replicated, as JAX's ``param_shardings``; the batch specs as JAX's
    ``batch_sharding``'s."""
    from hpmn_tpu.parallel import batch_sharding as j_batch_sharding
    from hpmn_tpu.parallel import param_shardings as j_param_shardings
    from hpmn_tpu_torch.configs import get_config
    from hpmn_tpu_torch.convert import jax_key, model_from_flat
    from hpmn_tpu_torch.parallel import mesh as port_mesh

    mesh = _mesh()
    model = model_from_flat(get_config("amazon_hpmn").with_model(
        hpmn_layers=2), _flat(jax_params), device="cpu")
    want = {k: tuple(v.spec) for k, v in _flat_specs(
        j_param_shardings(mesh, jax_params)).items()}
    got = port_mesh.param_shardings(None, model)
    assert {jax_key(n): s for n, s in got.items()} == {
        k: (port_mesh.ROW_SHARDED if s == ("model", None)
            else port_mesh.REPLICATED) for k, s in want.items()}
    assert sum(s == port_mesh.ROW_SHARDED for s in got.values()) == 2
    for stacked in (False, True):
        for over in (("data",), ("data", "model")):
            j = j_batch_sharding(mesh, stacked=stacked, over=over)
            p = port_mesh.batch_sharding(None, stacked=stacked, over=over)
            assert p == {f: tuple(getattr(j, f).spec) for f in p}


def _flat_specs(tree):
    keys, leaves, _ = flatten_with_keys(tree)
    return dict(zip(keys, leaves))


def test_capacity_and_derived_factor_match_jax():
    rng = np.random.default_rng(1)
    zipf = np.minimum(rng.zipf(1.3, 20000), 5000) - 1
    tables = [(zipf, 2500), (rng.integers(0, 800, 9000), 400)]
    for sizes in ([16, 1600], [4, 400, 1000]):
        assert es.derive_capacity_factor(tables, 2, sizes) == \
            j_es.derive_capacity_factor(tables, 2, sizes)
    assert es.derive_capacity_factor([(np.zeros(0), 4)], 2, [8]) == 2.0
    for n, s, f in ((37, 4, 2.0), (8, 2, 0.01), (1000, 8, 1.25)):
        assert es._capacity(n, s, f) == j_es._capacity(n, s, f)


# ------------------------------------------------------------------ steps

def _jax_step(case, jax_params, clip=0.0):
    mode, bom = {"clip": ("psum", False),
                 "fallback": MODES["bom"]}.get(case) or MODES[case]
    mesh = _mesh()
    over = ("data", "model") if bom else ("data",)
    batch = j_batch_from_numpy(_batch_arrays(5))
    if case == "clip":
        cfg = _j_cfg(mode, bom, grad_clip_norm=clip)
        cfg.model.use_pallas = False
        tx = optax.chain(optax.clip_by_global_norm(clip),
                         optax.sgd(CLIP_LR))
        make = make_sharded_steps
    else:
        cfg = _j_cfg(mode, bom)
        tx = optax.sgd(1e-2)
        make = make_shardmap_steps
    params = jax.device_put(jax_params, param_shardings(mesh, jax_params))
    opt_state = jax.device_put(tx.init(params),
                               param_shardings(mesh, tx.init(params)))
    p2, _, metrics = make(cfg, tx, mesh)[0](params, opt_state)(
        params, opt_state, shard_batch(mesh, batch, over=over))
    loss_ref, _ = j_loss_fn(jax_params, cfg, batch)
    logits_ref, _ = j_apply_model(jax.device_get(p2), cfg, batch)
    return (_flat(jax.device_get(p2)), float(metrics["loss"]),
            float(loss_ref), np.asarray(logits_ref))


@pytest.mark.parametrize("case", ["psum", "a2a", "bom", "fallback", "clip"])
def test_step_matches_jax(ranks, jax_params, clip, case):
    """Each rank's step against JAX's on four devices: the whole
    parameters after it (the tables gathered) within 2e-5, the reported
    loss within 1e-4 of the global loss (and of JAX's report), the logits
    of each rank's rows within 1e-4. "fallback" is the batch_over_model
    step with every exchange forced over capacity (the fallback, exact)
    against JAX's step without overflow; "clip" holds the global-norm clip
    to JAX's GSPMD step."""
    want, j_loss, loss_ref, logits = _jax_step(case, jax_params, clip)
    per = B // WORLD
    for r, out in enumerate(ranks):
        keys = [k.split("/", 2)[2] for k in out
                if k.startswith(f"{case}/param/")]
        assert set(keys) == set(want)  # convert.py's keys, whole tables
        for k in keys:
            np.testing.assert_allclose(out[f"{case}/param/{k}"], want[k],
                                       atol=2e-5, rtol=0, err_msg=k)
        loss = float(out[f"{case}/metric/loss"])
        assert abs(loss - loss_ref) < 1e-4 and abs(loss - j_loss) < 1e-4
        np.testing.assert_allclose(out[f"{case}/logits"],
                                   logits[r * per:(r + 1) * per], atol=1e-4,
                                   rtol=0)


def test_ranks_hold_the_same_dense_parameters(ranks):
    for case in MODES:
        for n in ranks[0]:
            if n.startswith(f"{case}/param/"):
                for out in ranks[1:]:
                    np.testing.assert_array_equal(out[n], ranks[0][n])


def test_two_steps_in_one_call_match_two_calls(ranks):
    """k = 2 per call == two calls (the same collectives in the same
    order), and a2a_overflow (every exchange forced over capacity) is
    summed over the call's steps: 2, where each call alone reports 1."""
    for out in ranks:
        assert list(out["multi1/overflow"]) == [1.0, 1.0]
        assert list(out["multi2/overflow"]) == [2.0]
        assert out["multi1/loss"] == out["multi2/loss"]
        for k in out:
            if k.startswith("multi1/param/"):
                np.testing.assert_array_equal(
                    out[k], out[k.replace("multi1", "multi2")])
