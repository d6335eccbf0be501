"""The port's real-data layer against the JAX package on the CPU:
``preprocess.py`` (``build_vocab``, ``process_log``, ``process_events``,
``process_csv_native``, ``save_preprocessed``/``load_preprocessed`` eager
and memory-mapped), the three ``process_*`` CLIs, the native parser and the
native batcher, ``make_datasets`` with ``data_dir``, and a short
``train()`` on a preprocessed directory. Every log is written here from a
seed, in the formats of tests/test_preprocess_clis.py and
tests/test_native_preprocess.py. Every array must be the JAX package's,
bit for bit (dtype, shape and values).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.data import native as j_native
from hpmn_tpu.data import preprocess as j_pre
from hpmn_tpu.data import process_amazon as j_amazon
from hpmn_tpu.data import process_taobao as j_taobao
from hpmn_tpu.data import process_xlong as j_xlong
from hpmn_tpu.data.synthetic import DatasetSpec as JSpec
from hpmn_tpu.train.train import make_datasets as j_make_datasets
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.data import (native, native_batcher, preprocess,
                                 process_amazon, process_taobao,
                                 process_xlong)
from hpmn_tpu_torch.data.schema import Batch, batch_from_numpy
from hpmn_tpu_torch.data.synthetic import DatasetSpec
from hpmn_tpu_torch.train import train as T

FIELDS = [f.name for f in dataclasses.fields(Batch)]


def _same(got, want):
    """Two dicts of arrays, bit for bit."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _write_amazon(d, n_users=15, n_items=40, seed=0):
    rng = np.random.default_rng(seed)
    asins = [f"B{i:06d}" for i in range(n_items)]
    with open(d / "meta.json", "w") as f:
        for i, a in enumerate(asins):
            f.write(json.dumps({"asin": a, "categories": [
                ["Electronics", f"Cat{i % 5}"]]}) + "\n")
        # the public dump's loose form, read through ast.literal_eval
        f.write(str({"asin": "B999999", "categories": [["Toys"]]}) + "\n")
    with open(d / "reviews.json", "w") as f:
        for u in range(n_users):
            for t in range(int(rng.integers(4, 12))):
                f.write(json.dumps({
                    "reviewerID": f"U{u}",
                    "asin": asins[int(rng.integers(0, n_items))],
                    "unixReviewTime": 1000 + 3 * t + u % 3}) + "\n")
        f.write(json.dumps({"reviewerID": "U0", "asin": "B999999",
                            "unixReviewTime": 2000}) + "\n")


def _write_behavior_log(path, n_users=25, seed=0):
    """UserBehavior rows (user,item,cat,behavior,ts), shuffled."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(n_users):
        for t in range(int(rng.integers(6, 20))):
            item = int(rng.integers(1, 60))
            btype = "pv" if rng.random() < 0.8 else "buy"
            rows.append((f"u{u}", f"i{item}", f"c{item % 7}", btype,
                         1500000 + t))
    rng.shuffle(rows)
    with open(path, "w") as f:
        for r in rows:
            f.write(",".join(map(str, r)) + "\n")
    return rows


def _write_xlong_log(path, n_long=3, seed=2):
    """4-column rows (user,item,cat,ts): n_long users of 40-60 events and
    two short ones."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for u in range(n_long):
            for t in range(int(rng.integers(40, 61))):
                item = int(rng.integers(1, 30))
                f.write(f"long{u},{item},{item % 4},{t * 10 + u}\n")
        for t in range(6):
            f.write(f"short,{t + 1},{t % 4},{t}\n")


# ----------------------------------------------------------- preprocess --

def test_build_vocab_matches_jax():
    rng = np.random.default_rng(0)
    tokens = [f"t{int(i)}" for i in rng.integers(0, 30, 200)] + [3, 3, 7]
    assert preprocess.build_vocab(tokens) == j_pre.build_vocab(tokens)


@pytest.mark.parametrize("min_events", [1, 5])
def test_process_log_matches_jax(min_events):
    rng = np.random.default_rng(1)
    rows = [(f"u{int(rng.integers(0, 12))}", f"i{int(rng.integers(0, 50))}",
             f"c{int(rng.integers(0, 6))}", int(rng.integers(0, 10 ** 6)))
            for _ in range(300)]
    _same(preprocess.process_log(rows, seq_len=16, seed=3,
                                 min_events=min_events),
          j_pre.process_log(rows, seq_len=16, seed=3, min_events=min_events))


def test_process_events_matches_jax():
    rng = np.random.default_rng(2)
    n = 500
    uid = rng.integers(0, 30, n).astype(np.int32)
    item = rng.integers(1, 80, n).astype(np.int32)
    cat = (item % 9 + 1).astype(np.int32)
    ts = rng.integers(0, 10 ** 9, n).astype(np.int64)
    _same(preprocess.process_events(uid, item, cat, ts, seq_len=20, seed=4),
          j_pre.process_events(uid, item, cat, ts, seq_len=20, seed=4))


def test_parse_csv_and_process_csv_native_match_jax(tmp_path):
    log = tmp_path / "ub.csv"
    rows = _write_behavior_log(log)
    assert native.available() and j_native.available()
    for col, keep in ((3, "pv"), (3, ""), (-1, "")):
        _same(native.parse_csv(str(log), col, keep),
              j_native.parse_csv(str(log), col, keep))
    ev = native.parse_csv(str(log), 3, "pv")
    kept = [r for r in rows if r[3] == "pv"]
    assert len(ev["uid"]) == len(kept)
    assert ev["n_items"] == len({r[1] for r in kept}) + 1  # 1-based
    assert sorted(ev["ts"].tolist()) == sorted(r[4] for r in kept)
    _same(preprocess.process_csv_native(str(log), 12, 3, "pv", seed=5),
          j_pre.process_csv_native(str(log), 12, 3, "pv", seed=5))
    with pytest.raises(FileNotFoundError):
        native.parse_csv(str(tmp_path / "missing.csv"))


@pytest.mark.parametrize("compressed", [False, True])
def test_load_preprocessed_matches_jax(tmp_path, compressed):
    """Eager, memory-mapped (uncompressed only) and "auto" loads == the JAX
    loader's, the real vocab sizes included; a sequence length other than
    the spec's raises."""
    rng = np.random.default_rng(6)
    rows = [(f"u{int(rng.integers(0, 10))}", f"i{int(rng.integers(0, 40))}",
             f"c{int(rng.integers(0, 5))}", int(rng.integers(0, 1000)))
            for _ in range(200)]
    preprocess.save_preprocessed(str(tmp_path / "xlong.npz"),
                                 preprocess.process_log(rows, 14),
                                 compressed=compressed)
    spec, j_spec = DatasetSpec("xlong", 14, 9, 9, 9), JSpec("xlong", 14, 9,
                                                            9, 9)
    for mmap in (False, "auto") + (() if compressed else (True,)):
        got = preprocess.load_preprocessed(str(tmp_path), spec, mmap=mmap)
        _same(got, j_pre.load_preprocessed(str(tmp_path), j_spec, mmap=mmap))
        mapped = isinstance(got["item_seq"], np.memmap)
        assert mapped == (mmap is True or (mmap == "auto" and not compressed))
    if compressed:
        with pytest.raises(ValueError, match="compressed"):
            preprocess.load_preprocessed(str(tmp_path), spec, mmap=True)
    with pytest.raises(ValueError, match="sequence length"):
        preprocess.load_preprocessed(
            str(tmp_path), dataclasses.replace(spec, seq_len=15))


# ---------------------------------------------------------------- CLIs --

def test_amazon_cli_matches_jax(tmp_path):
    _write_amazon(tmp_path)
    args = ["--reviews", str(tmp_path / "reviews.json"), "--meta",
            str(tmp_path / "meta.json"), "--seq_len", "20", "--seed", "1"]
    process_amazon.main(args + ["--out", str(tmp_path / "a" / "amazon.npz")])
    j_amazon.main(args + ["--out", str(tmp_path / "b" / "amazon.npz")])
    got = _npz(tmp_path / "a" / "amazon.npz")
    _same(got, _npz(tmp_path / "b" / "amazon.npz"))
    assert got["label"].mean() == 0.5 and got["item_seq"].shape[1] == 20


@pytest.mark.parametrize("no_native", [False, True])
def test_taobao_cli_matches_jax(tmp_path, no_native):
    _write_behavior_log(tmp_path / "UserBehavior.csv", seed=7)
    args = ["--log", str(tmp_path / "UserBehavior.csv"), "--seq_len", "30"]
    args += ["--no-native"] if no_native else []
    process_taobao.main(args + ["--out", str(tmp_path / "a.npz")])
    j_taobao.main(args + ["--out", str(tmp_path / "b.npz")])
    got = _npz(tmp_path / "a.npz")
    _same(got, _npz(tmp_path / "b.npz"))
    assert (got["seq_mask"].sum(1) > 0).all()


@pytest.mark.parametrize("no_native", [False, True])
def test_xlong_cli_matches_jax(tmp_path, no_native):
    _write_xlong_log(tmp_path / "xlong.csv")
    args = ["--log", str(tmp_path / "xlong.csv"), "--seq_len", "40",
            "--min_events", "20"] + (["--no-native"] if no_native else [])
    process_xlong.main(args + ["--out", str(tmp_path / "a.npz")])
    j_xlong.main(args + ["--out", str(tmp_path / "b.npz")])
    got = _npz(tmp_path / "a.npz")
    _same(got, _npz(tmp_path / "b.npz"))
    assert got["label"].shape[0] == 6  # the three long users, pos + neg


# -------------------------------------------------------------- batcher --

def _arrays(rng, N=999, T=37):
    return {"a2d_i32": rng.integers(0, 1 << 20, (N, T)).astype(np.int32),
            "a2d_f32": rng.normal(size=(N, T)).astype(np.float32),
            "a1d_i32": rng.integers(0, 99, N).astype(np.int32),
            "a1d_f64": rng.normal(size=N)}


def test_native_batcher_matches_numpy_gather():
    """The threaded gather == numpy's fancy indexing for each dtype and
    rank, with repeated indices; each native call counts one gather."""
    rng = np.random.default_rng(8)
    arrays = _arrays(rng)
    idx = rng.integers(0, 999, 128)  # with repeats
    assert len(set(idx.tolist())) < 128 and native_batcher.available()
    before = native_batcher.gathers
    got = native_batcher.gather(arrays, idx)
    assert native_batcher.gathers == before + 1
    _same(got, {k: a[idx] for k, a in arrays.items()})
    assert native_batcher.n_threads() >= 1


def test_native_batcher_out_of_range_keeps_numpy_semantics():
    """A negative index wraps and one past the end raises IndexError, as
    numpy does: such a call goes to numpy whole (no native gather counted),
    never to raw pointer reads."""
    a = np.arange(20, dtype=np.int32).reshape(10, 2)
    before = native_batcher.gathers
    _same(native_batcher.gather({"x": a}, np.array([-1, 2])),
          {"x": a[[-1, 2]]})
    with pytest.raises(IndexError):
        native_batcher.gather({"x": a}, np.array([3, 10]))
    assert native_batcher.gathers == before
    strided = np.arange(40, dtype=np.int32).reshape(10, 4)[:, ::2]
    _same(native_batcher.gather({"x": strided}, np.array([3, 1, 1])),
          {"x": strided[[3, 1, 1]]})
    assert native_batcher.gathers == before


def test_batch_from_numpy_takes_the_native_gather():
    """Row-sliced batches come from the native gather (counted) and equal
    the numpy oracle's rows; a whole-array batch gathers nothing."""
    rng = np.random.default_rng(9)
    n, t = 50, 12
    arrays = {f: rng.integers(0, 100, (n, t) if f in (
        "item_seq", "cat_seq", "neg_item_seq", "neg_cat_seq") else n
    ).astype(np.int32) for f in FIELDS}
    arrays["seq_mask"] = rng.integers(0, 2, (n, t)).astype(np.float32)
    arrays["label"] = rng.integers(0, 2, n).astype(np.float32)
    idx = np.array([5, 3, 3, 49, 0])
    before = native_batcher.gathers
    batch = batch_from_numpy(arrays, idx, device="cpu")
    assert native_batcher.gathers == before + 1
    for f in FIELDS:
        assert torch.equal(getattr(batch, f), torch.from_numpy(arrays[f][idx]))
    whole = batch_from_numpy(arrays, device="cpu")
    assert native_batcher.gathers == before + 1
    assert torch.equal(whole.item_seq, torch.from_numpy(arrays["item_seq"]))


def test_native_build_reports_the_compiler_error(tmp_path, monkeypatch):
    """A source g++ refuses raises with the compiler's stderr, not a quiet
    False; the build lands in the port's _build directory."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.build_native(str(bad))
    assert not list((tmp_path / "build").iterdir())  # no partial output
    good = tmp_path / "good.cpp"
    good.write_text('extern "C" int f() { return 7; }\n')
    path = native.build_native(str(good))
    assert path.startswith(str(tmp_path / "build"))
    assert native.build_native(str(good)) == path  # built once


# -------------------------------------------------------------- driver --

def _xlong_dir(tmp_path):
    _write_xlong_log(tmp_path / "xlong.csv", n_long=40, seed=11)
    process_xlong.main(["--log", str(tmp_path / "xlong.csv"), "--out",
                        str(tmp_path / "data" / "xlong.npz"),
                        "--seq_len", "1000", "--min_events", "20"])
    return str(tmp_path / "data")


def test_make_datasets_with_data_dir_matches_jax(tmp_path):
    """The splits and the spec (the data's vocab sizes) == JAX's."""
    data_dir = _xlong_dir(tmp_path)
    got = T.make_datasets(T.apply_overrides(configs.get_config("xlong_hpmn"),
                                            [f"data_dir={data_dir}"]))
    j_cfg = j_get_config("xlong_hpmn")
    j_cfg.data_dir = data_dir
    want = j_make_datasets(j_cfg)
    for g, w in zip(got[:3], want[:3]):
        _same(g, w)
    assert dataclasses.asdict(got[3]) == dataclasses.asdict(want[3])
    with np.load(f"{data_dir}/xlong.npz") as z:
        assert got[3].n_items == int(z["_n_items"]) < 50
        assert got[3].n_users == int(z["_n_users"])


def test_train_on_a_preprocessed_amazon_dir(tmp_path, capsys):
    """The CLI trains amazon_gru4rec on the Amazon CLI's output, its tables
    sized to the data, through the native gather, to its TEST line."""
    _write_amazon(tmp_path, n_users=60, n_items=50, seed=12)
    process_amazon.main(["--reviews", str(tmp_path / "reviews.json"),
                         "--meta", str(tmp_path / "meta.json"),
                         "--out", str(tmp_path / "data" / "amazon.npz")])
    n_items = int(np.load(tmp_path / "data" / "amazon.npz")["_n_items"])
    seen = {}
    init = T.init_model_for

    def spy(cfg, spec, device):
        seen["spec"] = spec
        return init(cfg, spec, device)

    before = native_batcher.gathers
    try:
        T.init_model_for = spy
        res = T.main(["--config", "amazon_gru4rec", "--device", "cpu",
                      "--set", f"data_dir={tmp_path / 'data'}",
                      "train.batch_size=16", "train.max_steps=6",
                      "train.eval_every=3", "train.log_every=3",
                      "train.steps_per_dispatch=1", "model.use_pallas=true"])
    finally:
        T.init_model_for = init
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("TEST auc ") for line in out) == 1
    assert np.isfinite(res["test"]["log_loss"])
    assert seen["spec"].n_items == n_items and seen["spec"].n_items < 100
    assert res["params"]["embedding.item"].shape[0] == n_items
    assert native_batcher.gathers > before + 6
