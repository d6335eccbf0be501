"""The driver's data, metrics and evaluation against the JAX package on the
CPU, on the same seeds and arrays:

- ``make_periodic_dataset``, ``train_val_test_split`` and the
  ``DataLoader``'s batches (shuffled epochs, process slices, ``one_epoch``
  padding and ``n_valid``, a resumed position): bit for bit;
- ``validate_batch`` takes the Batch contract (tensors or numpy) and
  refuses a wrong shape or id dtype;
- the metrics (exact and streaming AUC, GAUC, log-loss, calibration) on
  the same arrays: atol 1e-12 (the same numpy arithmetic);
- ``evaluate``, exact and streaming, one and three batches per call, with
  one stand-in numpy eval step fed to both: atol 1e-12.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hpmn_tpu.data import loader as j_loader
from hpmn_tpu.data import synthetic as j_synthetic
from hpmn_tpu.train import metrics as j_metrics
from hpmn_tpu.train.evaluate import evaluate as j_evaluate
from hpmn_tpu_torch.data import loader, synthetic
from hpmn_tpu_torch.data.schema import Batch
from hpmn_tpu_torch.train import evaluate, metrics
from hpmn_tpu_torch.utils.asserts import validate_batch

METRIC_TOL = 1e-12
SPEC = synthetic.DatasetSpec("taobao", seq_len=60, n_items=2000, n_cats=40,
                             n_users=50)
J_SPEC = j_synthetic.DatasetSpec("taobao", seq_len=60, n_items=2000,
                                 n_cats=40, n_users=50)
FIELDS = [f.name for f in dataclasses.fields(Batch)]


def _same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def _same_batch(got, want):
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("seed,n", [(0, 300), (5, 41)])
def test_periodic_dataset_and_split_match_jax(seed, n):
    got = synthetic.make_periodic_dataset(SPEC, n, seed=seed)
    want = j_synthetic.make_periodic_dataset(J_SPEC, n, seed=seed)
    _same_arrays(got, want)
    assert got["seq_mask"].min() == 1.0  # full histories
    for g, w in zip(synthetic.train_val_test_split(got),
                    j_synthetic.train_val_test_split(want)):
        _same_arrays(g, w)


@pytest.mark.parametrize("process_index,process_count", [(0, 1), (1, 2)])
def test_loader_batches_match_jax(process_index, process_count):
    """Three epochs of shuffled batches (the tail dropped), then the
    position saved mid-epoch and resumed in a fresh loader."""
    arrays = synthetic.make_ctr_dataset(SPEC, 101, seed=2)
    kw = dict(batch_size=8, shuffle=True, seed=3,
              process_index=process_index, process_count=process_count)
    mine, theirs = loader.DataLoader(arrays, **kw), \
        j_loader.DataLoader(arrays, **kw)
    assert mine.steps_per_epoch() == theirs.steps_per_epoch()
    it, j_it = iter(mine), iter(theirs)
    for _ in range(3 * mine.steps_per_epoch() + 2):
        _same_batch(next(it), next(j_it))
        assert mine.state_dict() == theirs.state_dict()
    resumed = loader.DataLoader(arrays, **kw)
    resumed.load_state_dict(mine.state_dict())
    r_it = iter(resumed)
    for _ in range(mine.steps_per_epoch() + 1):
        _same_batch(next(r_it), next(j_it))
    with pytest.raises(ValueError, match="global batch"):
        loader.DataLoader(arrays, batch_size=4).load_state_dict(
            mine.state_dict())


@pytest.mark.parametrize("n,process_count", [(45, 1), (45, 2), (16, 1)])
def test_loader_one_epoch_matches_jax(n, process_count):
    """Eval batches: in order, the last one padded by repeating the last
    example, n_valid counting the real rows, the same batch count on every
    process; the iterator's position untouched."""
    arrays = synthetic.make_ctr_dataset(SPEC, n, seed=4)
    for p in range(process_count):
        kw = dict(batch_size=8, shuffle=False, process_index=p,
                  process_count=process_count)
        mine, theirs = loader.DataLoader(arrays, **kw), \
            j_loader.DataLoader(arrays, **kw)
        pairs = list(mine.one_epoch())
        j_pairs = list(theirs.one_epoch())
        assert len(pairs) == len(j_pairs) == mine.epoch_batches()
        for (b, nv), (jb, jnv) in zip(pairs, j_pairs):
            assert nv == jnv
            _same_batch(b, jb)
        assert sum(nv for _, nv in pairs) == mine.n_local
        assert mine.state_dict() == {"epoch": 0, "step": 0, "seed": 0,
                                     "global_batch": 8 * process_count}


def test_validate_batch_takes_the_contract_and_refuses_the_rest():
    arrays = synthetic.make_ctr_dataset(SPEC, 6, seed=1)
    batch = next(iter(loader.DataLoader(arrays, 4, shuffle=True)))
    validate_batch(batch)  # tensors
    validate_batch(Batch(**{f: getattr(batch, f).numpy() for f in FIELDS}))
    bad = [dataclasses.replace(batch, cat_seq=batch.cat_seq[:, 1:]),
           dataclasses.replace(batch, label=batch.label[:3]),
           dataclasses.replace(batch, uid=batch.uid.long()),
           dataclasses.replace(batch, target_item=batch.target_item.float())]
    for b in bad:
        with pytest.raises(ValueError, match="batch"):
            validate_batch(b)


def _scores(n, seed, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(n) * 2
    if ties:
        logits = np.round(logits, 1)  # many tied scores
    labels = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    uids = rng.integers(0, 37, size=n)
    return logits.astype(np.float32), labels, uids


@pytest.mark.parametrize("ties", [False, True])
def test_metrics_match_jax(ties):
    logits, labels, uids = _scores(2000, 7, ties)
    for name in ("auc", "log_loss", "calibration"):
        np.testing.assert_allclose(
            getattr(metrics, name)(logits, labels),
            getattr(j_metrics, name)(logits, labels), atol=METRIC_TOL,
            rtol=0, err_msg=name)
    np.testing.assert_allclose(metrics.gauc(logits, labels, uids),
                               j_metrics.gauc(logits, labels, uids),
                               atol=METRIC_TOL, rtol=0)
    for bins, max_users in ((64, 0), (256, 5)):
        acc, j_acc = metrics.StreamingAUC(bins), j_metrics.StreamingAUC(bins)
        g, j_g = (metrics.StreamingGAUC(bins, max_users),
                  j_metrics.StreamingGAUC(bins, max_users))
        for lo in range(0, 2000, 300):  # in chunks, as eval feeds them
            sl = slice(lo, lo + 300)
            acc.update(logits[sl], labels[sl])
            j_acc.update(logits[sl], labels[sl])
            g.update(logits[sl], labels[sl], uids[sl])
            j_g.update(logits[sl], labels[sl], uids[sl])
        got, want = acc.result(), j_acc.result()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=METRIC_TOL,
                                       rtol=0, err_msg=k)
        np.testing.assert_allclose(g.result(), j_g.result(),
                                   atol=METRIC_TOL, rtol=0)


def _stand_in_logits(item_seq, target_item, label):
    """A numpy eval step: logits from the ids and (weakly) the label, so
    the AUC is neither 0.5 nor 1. Any leading axes."""
    s = (item_seq.astype(np.int64).sum(-1) * 31
         + target_item.astype(np.int64) * 7) % 97
    return (s / 10.0 - 4.8 + 1.5 * label).astype(np.float32)


def _port_step(model, batch):
    return torch.from_numpy(_stand_in_logits(
        batch.item_seq.numpy(), batch.target_item.numpy(),
        batch.label.numpy()))


def _jax_step(params, batch):
    return _stand_in_logits(np.asarray(batch.item_seq),
                            np.asarray(batch.target_item),
                            np.asarray(batch.label))


@pytest.mark.parametrize("streaming_bins,gauc_bins", [(0, 256), (128, 64),
                                                      (128, 0)])
@pytest.mark.parametrize("k", [1, 3])
def test_evaluate_matches_jax(streaming_bins, gauc_bins, k):
    arrays = synthetic.make_ctr_dataset(SPEC, 250, seed=9)
    arrays["uid"] = arrays["uid"] % 7  # several examples per user
    kw = dict(batch_size=32, shuffle=False)
    got = evaluate.evaluate(_port_step, None, loader.DataLoader(arrays, **kw),
                            streaming_bins, gauc_bins, 3,
                            steps_per_dispatch=k)
    want = j_evaluate(_jax_step, None,
                      j_loader.DataLoader(arrays, **kw), streaming_bins,
                      gauc_bins, 3, fused_eval=_jax_step,
                      steps_per_dispatch=k)
    assert got.keys() == want.keys()
    assert got["n"] == want["n"] == 250.0
    for key in want:
        if np.isnan(want[key]):
            assert np.isnan(got[key]), key
        else:
            np.testing.assert_allclose(got[key], want[key], atol=METRIC_TOL,
                                       rtol=0, err_msg=key)
    assert 0.55 < got["auc"] < 0.99
