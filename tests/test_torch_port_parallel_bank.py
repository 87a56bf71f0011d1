"""``ShardedSpeakerBank``: the bank's rows split over several devices of
one process (here the CPU named two or three times), against the JAX
package's ``ShardedSpeakerBank`` on virtual CPU devices and against the
port's one-device ``SpeakerBank``: the same indices (ties included) and
scores within 1e-6; enrollment past capacity and un-enrollment keep the
layout; the server's ``bank_devices`` builds one.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from speakerverification_tpu.evaluation import bank as jbank
from speakerverification_tpu_torch import serving as tserving
from speakerverification_tpu_torch.evaluation import bank as tbank

from test_torch_port_bank import _fake_app, _post, _seed, _spin, _stop


def _rows(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _sharded(embeds, labels=None, n_dev=2, **kw):
    return tbank.ShardedSpeakerBank(embeds, labels, devices=["cpu"] * n_dev,
                                    **kw)


def _same(got, ref, atol=1e-6):
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), atol=atol)


@pytest.mark.parametrize("k", [1, 5, 40])
def test_sharded_bank_matches_jax_sharded_bank(k):
    enrolled, queries = _rows(0, 300, 16), _rows(1, 9, 16)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("bank",))
    ref = jbank.ShardedSpeakerBank(enrolled, mesh=mesh, pad_rows_to=32)
    got = _sharded(enrolled, pad_rows_to=32)
    assert got.n_pad == ref.n_pad == 320 and got.shard_rows == 160
    _same(got.identify(queries, k=k), ref.identify(queries, k=k))


@pytest.mark.parametrize("n_dev", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_bank_equals_the_one_device_bank(n_dev, dtype):
    enrolled, queries = _rows(2, 1000, 32), _rows(3, 600, 32)
    enrolled[500] = enrolled[17]          # a tie across shards
    queries[0] = enrolled[17]
    one = tbank.SpeakerBank(enrolled, device="cpu", dtype=dtype,
                            pad_rows_to=64)
    many = _sharded(enrolled, n_dev=n_dev, dtype=dtype, pad_rows_to=64)
    assert many.dtype == dtype and many.nbytes == many.n_pad * 32 * (
        4 if dtype == torch.float32 else 2)
    for k in (1, 5):
        _same(many.identify(queries, k=k), one.identify(queries, k=k),
              atol=0)
    assert list(many.identify(queries[:1], k=2)[1][0]) == [17, 500]


def test_growth_and_removal_keep_the_layout():
    enrolled = _rows(4, 60, 8)
    one = tbank.SpeakerBank(enrolled, [f"s{i}" for i in range(60)],
                            device="cpu", pad_rows_to=16)
    many = _sharded(enrolled, [f"s{i}" for i in range(60)], pad_rows_to=16)
    assert many.n_pad == 64 and many.shard_rows == 32
    extra = _rows(5, 30, 8)
    idx = many.add(extra, [f"x{i}" for i in range(30)])
    one.add(extra, [f"x{i}" for i in range(30)])
    assert list(idx) == list(range(60, 90))
    assert many.n_pad == 96 and many.shard_rows == 48       # equal shards
    for i in (3, 88, 40):          # a move, the last row, a move
        assert many.remove(i) == one.remove(i)
    queries = _rows(6, 20, 8)
    _same(many.identify(queries, k=4), one.identify(queries, k=4), atol=0)
    assert [many.name(i) for i in range(many.n)] == [
        one.name(i) for i in range(one.n)]
    with pytest.raises(IndexError):
        many.remove(many.n)


def test_bank_device_list_counts_the_visible_devices():
    assert tserving.bank_device_list(torch.device("cpu"), 1) == [
        torch.device("cpu")]
    with pytest.raises(ValueError, match=r"serving.bank_devices=2 but only "
                                         r"1 device\(s\) visible"):
        tserving.bank_device_list(torch.device("cpu"), 2)


def test_server_with_bank_devices_serves_a_sharded_bank(tmp_path,
                                                        monkeypatch):
    """``serving.bank_devices: 2`` builds a ``ShardedSpeakerBank`` (the
    CPU named twice stands in for two cards); enrollment and
    identification go through it."""
    monkeypatch.setattr(tserving, "bank_device_list",
                        lambda device, n: [device] * n)
    _seed(tmp_path, rows=3)
    handler, batcher = _fake_app(tmp_path, device_bank=True, bank_devices=2,
                                 persist_enroll=False)
    httpd, batcher, port = _spin((handler, batcher))
    pcm = np.random.default_rng(15).normal(size=800).astype(np.float32)
    try:
        status, out = _post(port, "/enroll", {"pcm": pcm.tolist(),
                                              "name": "new"})
        assert status == 200 and out["enrolled"] == 4
        bank = handler.banks["device"]
        assert isinstance(bank, tbank.ShardedSpeakerBank)
        assert bank.n_dev == 2
        status, out = _post(port, "/identify", {"pcm": pcm.tolist(), "k": 2})
        assert status == 200 and out["speaker"] == "new"
        status, out = _post(port, "/unenroll", {"name": "new"})
        assert status == 200 and bank.n == 3
    finally:
        _stop(httpd, batcher)
