"""The port's speaker bank and the server's bank routes against the JAX
package, on the CPU.

``SpeakerBank(device="cpu")`` is held against JAX's ``SpeakerBank`` on
the same seeded rows: scores within 1e-6 (fp32 products of unit
vectors in another order) and the same indices, ties included (both
rank equal scores lower index first); bf16 storage ranks well-separated
speakers the same. The HTTP app's ``/enroll`` → ``/identify`` →
``/unenroll`` exchange and its persisted ``embeds.npy``/``classes.npy``
agree with the JAX app's on the same weights (scores within 1e-4, the
embedding tolerance of ``test_torch_port_serving.py``).
"""

import http.client
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speakerverification_tpu import serving as jserving
from speakerverification_tpu.evaluation import bank as jbank
from speakerverification_tpu.evaluation import evaluator as jevaluator
from speakerverification_tpu.inference import InferenceEngine as JEngine
from speakerverification_tpu.training.checkpoint import save_checkpoint
from speakerverification_tpu_torch import serving as tserving
from speakerverification_tpu_torch.evaluation import bank as tbank
from speakerverification_tpu_torch.evaluation import evaluator as tevaluator
from speakerverification_tpu_torch.inference import InferenceEngine

CPU = torch.device("cpu")
SR = 8000


def _bank(embeds, labels=None, **kw):
    return tbank.SpeakerBank(embeds, labels, device="cpu", **kw)


def _rows(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _same(got, ref, atol=1e-6):
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), atol=atol)


@pytest.mark.parametrize("k", [1, 3, 10])
def test_bank_matches_jax_with_padding(k):
    enrolled, queries = _rows(0, 300, 16), _rows(1, 7, 16)    # pads to 384
    got = _bank(enrolled, pad_rows_to=128)
    ref = jbank.SpeakerBank(enrolled, pad_rows_to=128)
    assert got.n_pad == ref.n_pad == 384
    _same(got.identify(queries, k=k), ref.identify(queries, k=k))


def test_bank_padding_never_wins_on_all_negative_scores():
    base = np.abs(_rows(2, 5, 8))
    bank = _bank(base, pad_rows_to=64)                        # 59 pad rows
    scores, idx = bank.identify(-base[:2], k=5)
    assert np.all(idx < 5) and np.all(scores > -1.5)
    _same((scores, idx),
          jbank.SpeakerBank(base, pad_rows_to=64).identify(-base[:2], k=5))


def test_bank_query_chunking_matches_one_shot():
    enrolled, queries = _rows(3, 50, 12), _rows(4, 21, 12)
    small = _bank(enrolled, pad_rows_to=64, query_buckets=(1, 4))
    big = _bank(enrolled, pad_rows_to=64, query_buckets=(32,))
    s1, i1 = small.identify(queries, k=2)                     # chunks of 4
    s2, i2 = big.identify(queries, k=2)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-6)


def test_bank_k_clamps_and_1d_query():
    rng = np.random.default_rng(5)
    bank = _bank(rng.normal(size=(3, 4)).astype(np.float32), ["a", "b", "c"],
                 pad_rows_to=8)
    q = rng.normal(size=4).astype(np.float32)
    scores, idx = bank.identify(q, k=10)
    assert scores.shape == (1, 3)
    assert bank.name(int(idx[0, 0])) in ("a", "b", "c")
    _same((scores, idx), jbank.SpeakerBank(
        bank._bank[:3].numpy(), pad_rows_to=8).identify(q, k=10))


def test_bank_bf16_storage_ranks_separated_speakers():
    enrolled = np.eye(8, dtype=np.float32) + 0.01 * _rows(6, 8, 8)
    got = _bank(enrolled, dtype=torch.bfloat16, pad_rows_to=8)
    ref = jbank.SpeakerBank(enrolled, dtype=jnp.bfloat16, pad_rows_to=8)
    s, i = got.identify(enrolled, k=3)
    rs, ri = ref.identify(enrolled, k=3)
    assert s.dtype == np.float32
    np.testing.assert_array_equal(i[:, 0], np.arange(8))
    np.testing.assert_array_equal(i[:, 0], np.asarray(ri)[:, 0])
    np.testing.assert_allclose(s, np.asarray(rs), atol=2 ** -8)


@pytest.mark.parametrize("k", [1, 2, 4, 6])
def test_duplicate_rows_tie_in_jax_order(k):
    """Rows 1, 4, 6 and 9 are the same speaker: every query of it ties
    four ways, and k cuts through the ties at k 1, 2 and 4 (torch.topk
    promises no order there; lax.top_k takes the lower index)."""
    rows = _rows(7, 12, 8)
    for r in (4, 6, 9):
        rows[r] = rows[1]
    queries = np.stack([rows[1], rows[0] + rows[1], -rows[1]])
    got = _bank(rows, pad_rows_to=16).identify(queries, k=k)
    ref = jbank.SpeakerBank(rows, pad_rows_to=16).identify(queries, k=k)
    _same(got, ref)
    assert list(got[1][0][:min(k, 4)]) == [1, 4, 6, 9][:min(k, 4)]


@pytest.mark.parametrize("seed", range(4))
def test_topk_lower_index_first_is_a_stable_sort(seed):
    """Quantized scores (many ties, some at the k-th place) rank as a
    stable descending sort does."""
    g = torch.Generator().manual_seed(seed)
    scores = torch.randint(-4, 5, (6, 97), generator=g).float() / 8
    for k in (1, 5, 30, 97):
        vals, idx = tbank.topk_lower_index_first(scores, k)
        ref = torch.sort(scores, dim=-1, descending=True, stable=True)
        assert torch.equal(idx, ref.indices[:, :k])
        assert torch.equal(vals, ref.values[:, :k])


def test_identify_with_bank_threshold_semantics():
    enrolled = np.eye(4, dtype=np.float32)
    labels = {0: "s0", 1: "s1", 2: "s2", 3: "s3"}
    q = np.stack([enrolled[1], -enrolled[2]])
    got = tbank.identify_with_bank(_bank(enrolled, labels, pad_rows_to=8), q,
                                   threshold=0.5)
    ref = jbank.identify_with_bank(jbank.SpeakerBank(enrolled, labels,
                                                     pad_rows_to=8), q,
                                   threshold=0.5)
    assert got[0] == ref[0] == ["s1", "unknown"]
    np.testing.assert_allclose(got[1], ref[1], atol=1e-6)
    with pytest.raises(ValueError, match="no enrolled"):
        tbank.identify_with_bank(_bank(np.zeros((0, 4), np.float32)), q)


def test_bank_input_validation():
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        _bank(np.zeros((2, 3, 4), np.float32))
    with pytest.raises(ValueError, match="bfloat16"):
        _bank(np.eye(3, dtype=np.float32), dtype=torch.float16)
    bank = _bank(np.eye(3, dtype=np.float32), pad_rows_to=8)
    with pytest.raises(ValueError, match="dim"):
        bank.identify(np.zeros((1, 7), np.float32))
    with pytest.raises(ValueError, match="names"):
        bank.add(np.ones((1, 3)), ["x"])
    with pytest.raises(IndexError):
        bank.remove(3)


def test_bank_add_and_remove_match_a_rebuild_and_jax():
    """In-place adds (within the padding, then past it) and swap-with-
    last removes give the bank a rebuild gives, and JAX's bank after the
    same edits."""
    base, extra, queries = _rows(8, 100, 16), _rows(9, 40, 16), \
        _rows(10, 5, 16)
    names = [f"s{i}" for i in range(100)]
    live = _bank(base, list(names), pad_rows_to=128)
    ref = jbank.SpeakerBank(base, list(names), pad_rows_to=128)
    new = [f"n{i}" for i in range(40)]
    assert list(live.add(extra[:7], new[:7])) == list(range(100, 107))
    assert live.n_pad == 128                                 # no growth
    live.add(extra[7:], new[7:])                             # grows
    assert live.n == 140 and live.n_pad == 256
    ref.add(extra[:7], new[:7])
    ref.add(extra[7:], new[7:])
    _same(live.identify(queries, k=4), ref.identify(queries, k=4))
    rebuilt = _bank(np.concatenate([base, extra]), pad_rows_to=128)
    _same(live.identify(queries, k=4), rebuilt.identify(queries, k=4))
    for idx in (3, 138, 50):
        assert live.remove(idx) == ref.remove(idx)
    assert live.remove(live.n - 1) is None and ref.remove(ref.n - 1) is None
    assert live._labels == ref._labels and live.n == ref.n == 136
    _same(live.identify(queries, k=4), ref.identify(queries, k=4))
    kept = np.concatenate([base, extra])
    order = list(range(140))
    for idx in (3, 138, 50):
        order[idx] = order[-1]
        order.pop()
    order.pop()
    _same(live.identify(queries, k=4),
          _bank(kept[order], pad_rows_to=128).identify(queries, k=4))


@pytest.mark.parametrize("device_bank", [False, True])
def test_predict_identity_matches_jax(tmp_path, device_bank):
    """Host scan and device bank, the same embed function on both sides."""
    from speakerverification_tpu_torch.data.audio import write_wav
    rng = np.random.default_rng(11)
    files = []
    for i in range(3):
        path = tmp_path / f"f{i}.wav"
        write_wav(path, (0.3 * rng.normal(size=SR)).astype(np.float32), SR)
        files.append(str(path))
    proj = rng.normal(size=(400, 6)).astype(np.float32)

    def embed(waves):
        return np.asarray(waves)[:, :400] @ proj

    spec = {"sample_rate": SR, "sentence_len": 0.25}
    enrolled = embed(np.stack([rng.normal(size=2000) for _ in range(5)])
                     .astype(np.float32))
    classes = {i: f"spk{i}" for i in range(5)}
    got = tevaluator.predict_identity(embed, files, enrolled, classes, spec,
                                      num_eval=2, threshold=0.1,
                                      device_bank=device_bank, num_workers=1)
    ref = jevaluator.predict_identity(embed, files, enrolled, classes, spec,
                                      num_eval=2, threshold=0.1,
                                      device_bank=device_bank, num_workers=1)
    assert got[0] == ref[0]
    np.testing.assert_allclose(got[1], ref[1], atol=1e-5)


# ---------------------------------------------------------------- server
def _post(port, path, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(obj),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _spin(app):
    handler, batcher = app
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, batcher, httpd.server_address[1]


def _stop(httpd, batcher):
    httpd.shutdown()
    httpd.server_close()
    batcher.close()


def _hparams(root, **serving):
    return {"seed": 0, "num_eval": 2, "save_folder": str(root / "save"),
            "audio_spec": {"sample_rate": SR, "channels": 1,
                           "sentence_len": 0.5, "win_len": 0.025,
                           "hop_len": 0.01},
            "n_mels": 40, "features": "melspectrogram",
            "model": {"name": "ECAPA_TDNN", "feature_type": "melspectrogram",
                      "nOut": 16, "channels": [16, 16, 16, 16, 48],
                      "kernel_sizes": [5, 3, 3, 3, 1],
                      "dilations": [1, 2, 3, 4, 1], "attention_channels": 4,
                      "res2net_scale": 2, "se_channels": 4},
            "criterion": {"name": "AAmSoftmax"}, "nClasses": 10,
            "serving": {"batch_utts": 2, "max_wait_ms": 5, **serving}}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A JAX-written best_state.msgpack of a small ECAPA with random
    weights, and the seed bank's PCM."""
    root = tmp_path_factory.mktemp("banks")
    jeng = JEngine(_hparams(root))
    rng = np.random.default_rng(12)
    import jax
    state = jeng.state.replace(params=jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape)
        .astype(np.float32), jeng.state.params))
    path = save_checkpoint(root / "best_state.msgpack", state)
    pcm = [rng.normal(size=2 * SR).astype(np.float32).tolist()
           for _ in range(3)]
    return path, pcm


def _exchange(app, mdir, pcm):
    """Seed a 2-speaker bank, enroll alice, identify (k 1 and 5),
    unenroll by name, identify again; returns the replies and the
    persisted artifacts after each change."""
    rng = np.random.default_rng(13)
    np.save(mdir / "embeds.npy", rng.normal(size=(2, 16)).astype(np.float32))
    np.save(mdir / "classes.npy", {0: "faraway", 1: "bob"},
            allow_pickle=True)
    httpd, batcher, port = _spin(app)
    out = []
    try:
        for path, obj in (
                ("/enroll", {"pcm": pcm[0], "name": "alice"}),
                ("/identify", {"pcm": pcm[0]}),
                ("/identify", {"pcm": pcm[1], "k": 5}),
                ("/enroll", {"pcm": pcm[2]}),                   # no name
                ("/identify", {"pcm": pcm[0], "k": 0}),
                ("/unenroll", {"name": "faraway"}),
                ("/unenroll", {"name": "nobody"}),
                ("/unenroll", {"index": 7}),
                ("/identify", {"pcm": pcm[0], "k": 3})):
            status, reply = _post(port, path, obj)
            out.append((status, reply))
            if path != "/identify" and status == 200:
                out.append((np.load(mdir / "embeds.npy"),
                            np.load(mdir / "classes.npy",
                                    allow_pickle=True).item()))
    finally:
        _stop(httpd, batcher)
    return out


def _agree(got, ref):
    if isinstance(ref, tuple) and isinstance(ref[0], np.ndarray):
        np.testing.assert_allclose(got[0], ref[0], atol=1e-4)
        assert got[1] == ref[1]
        return
    (gs, g), (rs, r) = got, ref
    assert gs == rs, (g, r)
    if gs != 200:
        return
    for key in r:
        if key in ("score",):
            assert g[key] == pytest.approx(r[key], abs=1e-4)
        elif key == "candidates":
            assert [c["speaker"] for c in g[key]] == \
                [c["speaker"] for c in r[key]]
            np.testing.assert_allclose([c["score"] for c in g[key]],
                                       [c["score"] for c in r[key]],
                                       atol=1e-4)
        else:
            assert g[key] == r[key], key


@pytest.mark.parametrize("device_bank", [False, True])
def test_enroll_identify_unenroll_agree_with_jax(tmp_path, weights,
                                                 device_bank):
    path, pcm = weights
    results = {}
    for side in ("jax", "port"):
        h = _hparams(tmp_path / side, device_bank=device_bank)
        h["initial_model_infer"] = str(path)
        if side == "jax":
            engine = JEngine(h)
            app = jserving.make_serving_app(engine, h)
        else:
            engine = InferenceEngine(h, device="cpu")
            app = tserving.make_serving_app(engine, h)
        results[side] = _exchange(app, engine.dirs["model"], pcm)
        if side == "port":
            banks = app[0].banks
            assert (banks["device"] is not None) == device_bank
    assert len(results["port"]) == len(results["jax"])
    for got, ref in zip(results["port"], results["jax"]):
        _agree(got, ref)
    statuses = [r[0] for r in results["port"] if isinstance(r[0], int)]
    assert statuses == [200, 200, 200, 400, 400, 200, 400, 400, 200]


class _FakeEngine:
    """Row i of a batch -> its first 8 samples (+0.01), normalized."""

    def __init__(self, root):
        self.dirs = {"model": root}
        self.device = CPU

    def embed_fn(self, waves):
        w = np.asarray(waves)
        if w.dtype == np.int16:
            w = w.astype(np.float32) / 32768.0
        e = w[:, :8].astype(np.float32) + 0.01
        return torch.from_numpy(e / np.linalg.norm(e, axis=1, keepdims=True))


def _fake_app(tmp_path, **serving):
    h = {"num_eval": 2, "audio_spec": {"sample_rate": SR,
                                       "sentence_len": 0.05},
         "serving": {"batch_utts": 4, "max_wait_ms": 20, **serving}}
    return tserving.make_serving_app(_FakeEngine(tmp_path), h)


def _seed(tmp_path, rows=1):
    np.save(tmp_path / "embeds.npy", np.eye(rows, 8, dtype=np.float32))
    np.save(tmp_path / "classes.npy", {i: f"seed{i}" for i in range(rows)},
            allow_pickle=True)


def test_concurrent_enrolls_are_serialized(tmp_path):
    """Eight parallel /enroll requests get distinct, gap-free indices and
    all land in the bank and its artifacts."""
    _seed(tmp_path)
    httpd, batcher, port = _spin(_fake_app(tmp_path, device_bank=True))
    rng = np.random.default_rng(14)
    pcms = [rng.normal(size=800).astype(np.float32).tolist()
            for _ in range(8)]
    try:
        with ThreadPoolExecutor(8) as ex:
            results = list(ex.map(lambda i: _post(
                port, "/enroll", {"pcm": pcms[i], "name": f"spk{i}"}),
                range(8)))
        assert all(st == 200 for st, _ in results)
        assert sorted(out["index"] for _, out in results) == list(range(1, 9))
        classes = np.load(tmp_path / "classes.npy", allow_pickle=True).item()
        assert len(classes) == 9 and len(np.load(tmp_path / "embeds.npy")) == 9
        assert sorted(classes) == list(range(9))
    finally:
        _stop(httpd, batcher)


def test_identify_enroll_storm_loses_no_enrollment(tmp_path):
    """Identifies and enrolls at once, more threads than cores and a
    short switch interval: every request succeeds, identifies name a
    speaker of the bank, and every enrollment lands in the bank, its
    labels and its artifacts."""
    import os
    import sys
    _seed(tmp_path)
    handler, batcher = _fake_app(tmp_path, device_bank=True)
    httpd, batcher, port = _spin((handler, batcher))
    rng = np.random.default_rng(17)
    pcms = [rng.normal(size=800).astype(np.float32).tolist()
            for _ in range(12)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            if i % 2 == 0:
                return _post(port, "/enroll", {"pcm": pcms[i // 2],
                                               "name": f"spk{i // 2}"})
            return _post(port, "/identify", {"pcm": pcms[0]})

        with ThreadPoolExecutor(2 * (os.cpu_count() or 1) + 4) as ex:
            results = list(ex.map(work, range(24)))
    finally:
        sys.setswitchinterval(old)
        _stop(httpd, batcher)
    assert all(st == 200 for st, _ in results), results
    names = {"seed0"} | {f"spk{j}" for j in range(12)}
    assert all(out["speaker"] in names for st, out in results[1::2])
    classes = np.load(tmp_path / "classes.npy", allow_pickle=True).item()
    assert set(classes.values()) == names and sorted(classes) == \
        list(range(13))
    assert len(np.load(tmp_path / "embeds.npy")) == 13
    bank = handler.banks["device"]
    assert bank.n == 13 and bank._labels is handler.banks["classes"]


def test_rwlock_readers_share_writers_exclude():
    lock = tserving._RWLock()
    peak, active, guard = {"readers": 0}, {"n": 0}, threading.Lock()

    def reader():
        with lock.read():
            with guard:
                active["n"] += 1
                peak["readers"] = max(peak["readers"], active["n"])
            time.sleep(0.05)
            with guard:
                active["n"] -= 1

    with ThreadPoolExecutor(4) as ex:
        list(ex.map(lambda _: reader(), range(4)))
    assert peak["readers"] >= 2                       # readers overlapped
    got_in = threading.Event()

    def writer():
        with lock.write():
            got_in.set()

    lock._acq_read()
    t = threading.Thread(target=writer)
    t.start()
    assert not got_in.wait(0.15)                      # excluded by a reader
    lock._rel_read()
    assert got_in.wait(2.0)
    t.join()


def test_bank_routes_errors_and_the_multi_gpu_refusal(tmp_path):
    """No artifacts: 400 naming them; k outside 1..100: 400;
    ``bank_devices`` above the devices visible (the CPU is one): 400 with
    JAX's message; growth past ``AUTO_DEVICE_BANK_MIN_ROWS`` promotes an
    ``auto`` bank."""
    pcm = np.random.default_rng(15).normal(size=800).astype(np.float32)
    httpd, batcher, port = _spin(_fake_app(tmp_path))
    try:
        status, out = _post(port, "/identify", {"pcm": pcm.tolist()})
        assert status == 400 and "embeds.npy" in out["error"]
        for k in (0, 101):
            status, out = _post(port, "/identify", {"pcm": pcm.tolist(),
                                                    "k": k})
            assert status == 400 and "k must be" in out["error"]
    finally:
        _stop(httpd, batcher)
    _seed(tmp_path, rows=3)
    httpd, batcher, port = _spin(_fake_app(tmp_path, device_bank=True,
                                           bank_devices=2))
    try:
        status, out = _post(port, "/identify", {"pcm": pcm.tolist()})
        assert status == 400 and out["error"] == (
            "serving.bank_devices=2 but only 1 device(s) visible")
    finally:
        _stop(httpd, batcher)
    n = tbank.AUTO_DEVICE_BANK_MIN_ROWS - 1
    np.save(tmp_path / "embeds.npy", _rows(16, n, 8))
    np.save(tmp_path / "classes.npy", {i: f"s{i}" for i in range(n)},
            allow_pickle=True)
    handler, batcher = _fake_app(tmp_path, persist_enroll=False)
    httpd, batcher, port = _spin((handler, batcher))
    try:
        status, out = _post(port, "/identify", {"pcm": pcm.tolist()})
        assert status == 200 and handler.banks["device"] is None
        status, out = _post(port, "/enroll", {"pcm": pcm.tolist(),
                                              "name": "last"})
        assert status == 200 and out["enrolled"] == n + 1
        assert handler.banks["device"] is not None       # promoted
        assert len(np.load(tmp_path / "embeds.npy")) == n  # not persisted
        status, out = _post(port, "/identify", {"pcm": pcm.tolist()})
        assert status == 200 and out["speaker"] == "last"
    finally:
        _stop(httpd, batcher)
