"""Every kernel launch runs under its tensors' device.

The C launchers run their kernels on the CUDA runtime's current device and
size their grids by its SM count, so each wrapper makes the tensors' device
current around the C call (``ops/_build.py::on_device``). Here, on the
CPU, the seams ``cuda_gru._k1`` (K1), ``cuda_gru._k2`` (K2),
``cuda_gru_stride._k3`` (K3), ``cuda_gru_stride._k4`` (K4) and
``cuda_readout._k5`` (K5) are driven with tensors on the ``meta`` device
(shapes and no storage: a stand-in for a card that is not the current
one), ``torch.cuda.device`` replaced by a recorder and the C function by a
stand-in that notes which device was current when it was entered.
tests/test_torch_cuda.py launches K1, K2 and K5 on a second card while the
first is current.
"""

import contextlib

import pytest
import torch

from hpmn_tpu_torch.ops import _build, cuda_gru, cuda_gru_stride, cuda_readout
from hpmn_tpu_torch.ops.cuda_readout import ReadoutWeights
from hpmn_tpu_torch.ops.gru import GRUWeights

T, B, D_IN, D_M = 12, 5, 7, 32
META = torch.device("meta")


class _Devices:
    """Stands in for ``torch.cuda.device``: records the device each
    context makes current, and which is current now."""

    def __init__(self):
        self.current = None
        self.made_current = []

    @contextlib.contextmanager
    def __call__(self, device):
        prev, self.current = self.current, device
        self.made_current.append(device)
        try:
            yield
        finally:
            self.current = prev


@pytest.fixture
def devices(monkeypatch):
    rec = _Devices()
    monkeypatch.setattr(torch.cuda, "device", rec)
    return rec


def _fake(devices, seen):
    """A stand-in for a ``_*_fn`` factory: its C function notes the
    current device and returns cudaSuccess."""

    def factory(*_):
        def fn(*args):
            seen.append(devices.current)
            return 0
        return fn

    return factory


def _empty(*shape):
    return torch.empty(*shape, device=META)


def _weights():
    return GRUWeights(_empty(D_IN, 3 * D_M), _empty(D_M, 3 * D_M),
                      _empty(3 * D_M))


def test_k1_runs_under_the_tensors_device(devices, monkeypatch):
    seen = []
    monkeypatch.setattr(cuda_gru, "_ws_fn", _fake(devices, seen))
    x = _empty(T, B, D_IN)
    for scale in (None, _empty(T, B)):
        assert cuda_gru._k1(_weights(), x, _empty(T, B), None,
                            _empty(T, B, D_M), 7, scale_tm=scale) == 0
    assert seen == [META, META] and devices.current is None


def test_k2_runs_under_the_tensors_device(devices, monkeypatch):
    seen = []
    monkeypatch.setattr(cuda_gru, "_bwd_fn", _fake(devices, seen))
    x = _empty(T, B, D_IN)
    outs = (_empty(T, B, D_IN), _empty(B, D_M), _empty(1, D_IN, 3 * D_M),
            _empty(1, D_M, 3 * D_M), _empty(1, 3 * D_M))
    code, dg = cuda_gru._k2(_weights(), x, None, None, _empty(T, B, D_M),
                            _empty(T, B, D_M), outs, 7)
    assert code == 0 and dg.device == META
    assert seen == [META] and devices.current is None


def test_k3_runs_under_the_tensors_device(devices, monkeypatch):
    seen = []
    monkeypatch.setattr(cuda_gru_stride, "_fwd_fn", _fake(devices, seen))
    outs = (_empty(T // 3, B, D_M), _empty(1, B, D_M), _empty(B, D_M))
    assert cuda_gru_stride._k3(_weights(), _empty(T, B, D_IN), None, 3,
                               outs, 7) == 0
    assert seen == [META] and devices.current is None


def test_k4_runs_under_the_tensors_device(devices, monkeypatch):
    seen = []
    monkeypatch.setattr(cuda_gru_stride, "_bwd_fn", _fake(devices, seen))
    outs = (_empty(T, B, D_IN), _empty(B, D_M), _empty(1, D_IN, 3 * D_M),
            _empty(1, D_M, 3 * D_M), _empty(1, 3 * D_M))
    code, dg, hprev = cuda_gru_stride._k4(
        _weights(), _empty(T, B, D_IN), 3, _empty(1, B, D_M),
        _empty(T // 3, B, D_M), None, outs, 7, t_chunk=16)
    assert code == 0 and dg.device == hprev.device == META
    assert seen == [META] and devices.current is None


def test_k5_runs_under_the_tensors_device(devices, monkeypatch):
    seen = []
    monkeypatch.setattr(cuda_readout, "_kernel_fn", _fake(devices, seen))
    w = ReadoutWeights(_empty(D_M, 32), _empty(40, 32), _empty(32),
                       _empty(32))
    assert cuda_readout._k5(w, _empty(B, 3, D_M), _empty(B, 40),
                            _empty(B, D_M), 7) == 0
    assert seen == [META] and devices.current is None


def test_cpu_tensors_make_no_device_current(devices):
    """The seam tests' CPU stand-ins: no device is made current."""
    with _build.on_device(torch.zeros(2)):
        pass
    assert devices.made_current == []


def test_k1_takes_a_one_row_batch_transposed_from_batch_major():
    """A one-user scoring batch (the daemon's bucket of 1): the mask
    transposed from [1, T] is [T, 1] with the stride T, which
    ``.contiguous()`` keeps, and K1 never reads it; K1's checks take it,
    and still refuse a [T, B > 1] mask without a unit batch stride."""
    w = GRUWeights(torch.zeros(D_IN, 96), torch.zeros(D_M, 96),
                   torch.zeros(96))
    x = torch.zeros(T, 1, D_IN)
    mask = torch.ones(1, T).T.contiguous()
    assert mask.stride() == (1, T)
    cuda_gru._check_cuda_args(w, x, mask, None, "gru_scan_fwd", mask)
    x5 = torch.zeros(T, B, D_IN)
    with pytest.raises(ValueError, match="unit batch stride"):
        cuda_gru._check_cuda_args(w, x5, torch.ones(B, T).T, None,
                                  "gru_scan_fwd")
