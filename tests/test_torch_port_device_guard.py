"""Every kernel wrapper launches in the CUDA context of its tensor's
device, and every constant cache keeps one copy per device: a process
that drives several cards (the sharded bank, eval data parallelism) may
have another device current than the tensor's.

On the CPU the launch is mocked: ``torch.cuda.device`` records the
device it is entered with, and the library call (``_launch_here``)
records the device current when it runs. The ``meta`` device stands in
for a second device in the caches.
"""

import contextlib

import pytest
import torch

from speakerverification_tpu_torch.ops import frontend as tfrontend
from speakerverification_tpu_torch.ops import mel_frontend as mf
from speakerverification_tpu_torch.ops import quant_matmul as qm
from speakerverification_tpu_torch.ops import res2net_cascade as rc


@pytest.fixture
def current(monkeypatch):
    """The device a mocked ``torch.cuda.device`` made current (a list of
    one; None outside any)."""
    now = [None]
    entered = []

    @contextlib.contextmanager
    def device(d):
        entered.append(d)
        was, now[0] = now[0], d
        try:
            yield
        finally:
            now[0] = was
    monkeypatch.setattr(torch.cuda, "device", device)
    return now, entered


CASES = {
    "mel_frontend": (mf, lambda x: (x, None, None, 160, (0, 400))),
    "res2net_cascade": (rc, lambda x: (x, None, None, None, None, 2)),
    "quant_matmul": (qm, lambda x: (x, None, None, None, 1.0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_wrapper_launches_under_its_tensors_device(name, current,
                                                        monkeypatch):
    module, args = CASES[name]
    now, entered = current
    seen = []
    monkeypatch.setattr(module, "_launch_here",
                        lambda *a: seen.append(now[0]) or "launched")
    x = torch.zeros(2, 3, device="meta")
    assert module._launch(*args(x)) == "launched"
    assert entered == [x.device] and seen == [x.device]
    assert now[0] is None


def test_the_cascade_packs_once_per_device():
    w = torch.randn(7, 3, 64, 64)
    a = rc._packed_weights(w, torch.float32, torch.device("cpu"))
    b = rc._packed_weights(w, torch.float32, torch.device("meta"))
    assert a.device.type == "cpu" and b.device.type == "meta"
    assert set(rc._packed[w]) == {(torch.float32, torch.device("cpu")),
                                  (torch.float32, torch.device("meta"))}
    # the first device's copy is kept, not replaced
    assert rc._packed_weights(w, torch.float32, torch.device("cpu")) is a


def test_the_int8_gemm_packs_once_per_device():
    wq = torch.randint(-127, 128, (128, 512), dtype=torch.int8)
    a = qm._packed_weights(wq)
    assert set(qm._packed[wq]) == {torch.device("cpu")}
    assert qm._packed_weights(wq) is a
    wm = wq.to("meta")
    assert qm._packed_weights(wm).device.type == "meta"
    assert set(qm._packed[wm]) == {torch.device("meta")}


def test_mel_bases_and_packed_chunks_are_keyed_by_device():
    cfg = tfrontend.FrontendConfig()
    cs, fb = tfrontend.mel_constants(cfg, "cpu")
    cs_m, fb_m = tfrontend.mel_constants(cfg, "meta")
    assert cs.device.type == "cpu" and cs_m.device.type == "meta"
    assert tfrontend.mel_constants(cfg, "cpu")[0] is cs
    rows = tfrontend.window_rows(cfg)
    nb = 64                 # the kernel's DFT bins per column block (NB)
    mf._constants(cs, fb, rows, nb, cfg.hop_length)
    assert mf._packed[cs][1] == (tuple(rows), nb, cfg.hop_length, cs.device)
