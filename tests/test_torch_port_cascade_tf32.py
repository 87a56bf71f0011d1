"""The cascade kernel's schedule and arithmetic, rehearsed on the CPU.

K2 (``csrc/res2net_cascade.cu``) tiles time across blocks: a block owns
a tile of output rows of one batch row and computes group ``i`` over the
tile widened by ``(s-1-i)*d`` rows per side, from the table that
``tile_schedule`` writes. These tests replay that table with the plain
arithmetic, block by block, reading each group's input only where the
previous group wrote it, and hold the result against the cascade
computed whole (float64, so any difference is the schedule's).

Its fp32 products are three TF32 products each (``hi*lo + lo*hi +
hi*hi`` of operands split into ``hi = tf32(v)``, ``lo = tf32(v - hi)``);
emulated here on the weights exactly as ``pack_weights`` lays them out
for the kernel (unpacked by the mma fragment layouts), they must meet
the kernel's fp32 tolerance, ``1e-5 * max|ref|``, and one TF32 product
must not. The same file checks that ``Res2NetBlock`` keeps its folded
weights only while its parameters and buffers are unchanged.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speakerverification_tpu_torch.models import layers as tl
from speakerverification_tpu_torch.ops import res2net_cascade as rc
from speakerverification_tpu_torch.ops.mel_frontend import tf32_split

TOL = 1e-5
GROUPS = 8
SLOTS = 132          # an H100's SMs: one block each


def _inputs(B, hidden, T, seed=0, amplitude=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = amplitude * rng.standard_normal((B, GROUPS * hidden, T))
    w = rng.standard_normal((GROUPS - 1, 3, hidden, hidden)) / np.sqrt(
        3 * hidden)
    cb = 0.1 * rng.standard_normal((GROUPS - 1, hidden))
    s = 0.5 + rng.random((GROUPS - 1, hidden))
    sh = 0.1 * rng.standard_normal((GROUPS - 1, hidden))
    return [torch.from_numpy(v.astype(dtype)) for v in (x, w, cb, s, sh)]


def _reflect(t, T):
    t = torch.where(t < 0, -t, t)
    return torch.where(t >= T, 2 * (T - 1) - t, t)


def _cascade(x, w, cb, s, sh, d):
    """The cascade over whole crops, in x's dtype (float64 here)."""
    H = w.shape[2]
    chunks = x.split(H, 1)
    outs, y = [chunks[0]], None
    for i in range(1, GROUPS):
        inp = chunks[i] if i == 1 else chunks[i] + y
        h = F.conv1d(F.pad(inp, (d, d), mode="reflect"),
                     w[i - 1].permute(2, 1, 0), dilation=d)
        y = torch.relu(h + cb[i - 1, :, None]) * s[i - 1, :, None] \
            + sh[i - 1, :, None]
        outs.append(y)
    return torch.cat(outs, 1)


def _replay(x, w, cb, s, sh, d, slots=SLOTS):
    """The kernel's blocks as ``tile_schedule`` lays them out, each with
    its own buffer: a group reads the previous group's output only at the
    rows the block holds (anything else is NaN and shows in the result)."""
    B, C, T = x.shape
    H = w.shape[2]
    table, stride = rc.tile_schedule(B, T, GROUPS, d, slots)
    assert table.shape[1] == 1 + 2 * GROUPS and stride % 32 == 8
    out = torch.full_like(x, float("nan"))
    for row in table.tolist():
        b, win = row[0], list(zip(row[1::2], row[2::2]))
        (S, S1), (o0, o1) = win[0], win[-1]
        assert S1 - S <= stride
        out[b, :H, o0:o1] = x[b, :H, o0:o1]
        held = torch.full((H, T), float("nan"), dtype=x.dtype)
        held[:, S:S1] = x[b, H:2 * H, S:S1]
        for i in range(1, GROUPS):
            lo, hi = win[i]
            assert hi - lo <= rc.MAX_COLS
            n = torch.arange(lo, hi)
            h = sum(w[i - 1, k].T @ held[:, _reflect(n + (k - 1) * d, T)]
                    for k in range(3))
            y = torch.relu(h + cb[i - 1, :, None]) * s[i - 1, :, None] \
                + sh[i - 1, :, None]
            out[b, i * H:(i + 1) * H, o0:o1] = y[:, o0 - lo:o1 - lo]
            if i + 1 < GROUPS:
                held = torch.full((H, T), float("nan"), dtype=x.dtype)
                held[:, lo:hi] = x[b, (i + 1) * H:(i + 2) * H, lo:hi] + y
    return out, table


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", ["2d+1", 9, 51, 201, 202, 1001])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_tile_schedule_replays_the_cascade(d, T, B):
    torch.set_num_threads(2)
    T = 2 * d + 1 if T == "2d+1" else T
    args = _inputs(B, 16, T, seed=T + d, dtype=np.float64)
    got, table = _replay(*args, d)
    want = _cascade(*args, d)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-12 * want.abs().max().item())
    # the plain version at fp32 agrees with the same float64 cascade
    plain = rc.res2net_cascade_plain(*(a.float() for a in args), d)
    assert ((plain.double() - want).abs().max() / want.abs().max()) <= TOL
    # every batch row's tiles split [0, T) evenly, in order
    for b in range(B):
        owned = [r[-2:] for r in table.tolist() if r[0] == b]
        assert owned[0][0] == 0 and owned[-1][1] == T
        assert all(p[1] == q[0] for p, q in zip(owned, owned[1:]))
        sizes = [hi - lo for lo, hi in owned]
        assert max(sizes) - min(sizes) <= 1


def test_group_windows_shrink_by_d_per_group():
    win = rc.group_windows(60, 111, 201, 8, 2)
    assert win == [(60 - 2 * (7 - i), 111 + 2 * (7 - i)) for i in range(8)]
    win = rc.group_windows(0, 51, 201, 8, 4)
    assert win[0] == (0, 51 + 28) and win[6] == (0, 55) and win[7] == (0, 51)
    assert rc.group_windows(150, 201, 201, 8, 3)[0] == (150 - 21, 201)


@pytest.mark.parametrize("hidden,B,d", [(128, 80, 2), (128, 80, 4),
                                        (64, 160, 2)])
def test_path_b_shape_runs_more_blocks_than_batch_rows(hidden, B, d):
    """At the serving shapes (T 201) the schedule splits each crop into
    tiles, so the launch has several blocks per batch row; the halo's
    recompute (rows computed over rows owned, groups 1 .. 7) stays near
    1.2x at d 2 and 1.4x at d 4."""
    table, stride = rc.tile_schedule(B, 201, GROUPS, d, SLOTS)
    n = table.shape[0] // B
    assert table.shape[0] == B * n and n >= 3
    rows = sum(hi - lo for r in table.tolist()
               for lo, hi in zip(r[3::2], r[4::2]))
    recompute = rows / (B * 201 * (GROUPS - 1))
    assert 1.1 <= recompute <= (1.3 if d == 2 else 1.5)
    assert stride >= max(r[2] - r[1] for r in table.tolist())


def test_tile_schedule_refuses_a_halo_wider_than_the_kernels_window():
    with pytest.raises(ValueError, match="too wide"):
        rc.tile_schedule(2, 300, GROUPS, 11, SLOTS)
    # a crop that fits one window takes any dilation
    table, _ = rc.tile_schedule(2, 120, GROUPS, 11, SLOTS)
    assert (table[:, 1::2] == 0).any() and (table[:, 2::2] <= 120).all()
    assert ((table[:, 2::2] - table[:, 1::2]) <= rc.MAX_COLS).all()


def _unpack(packed, dtype, H):
    """``pack_weights``' output back to ``w [s-1, 3, H_in, H_out]`` by
    the PTX fragment layouts (fp32: ``hi`` and ``lo``). Lane ``4 g + t``,
    register ``r`` holds row ``g + 8 (r % 2)`` (an output channel) and
    column ``t + 4 (r // 2)`` (m16n8k8 tf32), or columns ``2 t + 8
    (r // 2)`` and one more (m16n8k16 bf16), an input channel."""
    G = GROUPS - 1
    kc = rc.CHUNK_CHANNELS
    if dtype == torch.float32:
        ks, per = 8, 1
        v = packed.reshape(G, 3, H // kc, kc // ks, H // 16, 2, 32, 4)
        planes = [v[:, :, :, :, :, h] for h in range(2)]
    else:
        ks, per = 16, 2
        v = packed.contiguous().view(torch.bfloat16).reshape(
            G, 3, H // kc, kc // ks, H // 16, 32, 4, 2)
        planes = [v.float()]
    outs = []
    for p in planes:
        a = torch.full((G, 3, H, H), float("nan"))      # [.., out, in]
        for lane in range(32):
            g, t = divmod(lane, 4)
            for r in range(4):
                for e in range(per):
                    for cc in range(H // kc):
                        for s in range(kc // ks):
                            col = (cc * kc + s * ks + per * t
                                   + (ks // 2) * (r // 2) + e)
                            for mt in range(H // 16):
                                row = mt * 16 + g + 8 * (r % 2)
                                val = p[:, :, cc, s, mt, lane, r]
                                a[:, :, row, col] = val if per == 1 else val[..., e]
        outs.append(a.permute(0, 1, 3, 2))
    return outs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 128])
def test_packed_weights_round_trip(hidden, dtype):
    _, w, _, _, _ = _inputs(1, hidden, 8, seed=hidden)
    packed = rc.pack_weights(w, dtype)
    words = rc.CHUNK_CHANNELS * hidden * (2 if dtype == torch.float32 else 1 / 2)
    assert packed.shape == ((GROUPS - 1) * 3 * hidden // rc.CHUNK_CHANNELS,
                            words)
    got = _unpack(packed, dtype, hidden)
    if dtype == torch.float32:
        hi, lo = tf32_split(w)
        assert torch.equal(got[0], hi) and torch.equal(got[1], lo)
    else:
        assert torch.equal(got[0], w.bfloat16().float())


def _emulate(x, w, cb, s, sh, d, passes):
    """The kernel's fp32 arithmetic: each tap product as ``passes`` TF32
    products (1: hi*hi; 3: hi*lo + lo*hi + hi*hi) of the split input and
    the packed weights, summed in fp32; bias, ReLU, BN affine in fp32."""
    H = w.shape[2]
    w_hi, w_lo = _unpack(rc.pack_weights(w, torch.float32), torch.float32, H)
    chunks = x.split(H, 1)
    outs, y = [chunks[0]], None
    for i in range(1, GROUPS):
        inp = chunks[i] if i == 1 else chunks[i] + y
        a_hi, a_lo = tf32_split(F.pad(inp, (d, d), mode="reflect"))

        def conv(a, wt):
            return F.conv1d(a, wt[i - 1].permute(2, 1, 0), dilation=d)

        h = conv(a_hi, w_hi)
        if passes == 3:
            h = conv(a_hi, w_lo) + conv(a_lo, w_hi) + h
        y = torch.relu(h + cb[i - 1, :, None]) * s[i - 1, :, None] \
            + sh[i - 1, :, None]
        outs.append(y)
    return torch.cat(outs, 1)


def _rel_err(hidden, d, amplitude, passes):
    args = _inputs(4, hidden, 201, seed=hidden + d, amplitude=amplitude)
    ref = rc.res2net_cascade_plain(*args, d)
    got = _emulate(*args, d, passes)
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("amplitude", [1.0, 0.1])
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("hidden", [64, 128])
def test_three_tf32_products_meet_the_fp32_tolerance(hidden, d, amplitude):
    torch.set_num_threads(2)
    assert _rel_err(hidden, d, amplitude, passes=3) <= TOL


@pytest.mark.parametrize("amplitude", [1.0, 0.1])
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("hidden", [64, 128])
def test_one_tf32_product_fails_the_tolerance(hidden, d, amplitude):
    torch.set_num_threads(2)
    assert _rel_err(hidden, d, amplitude, passes=1) > 10 * TOL


def _block(hidden=16, d=2):
    torch.manual_seed(0)
    blk = tl.Res2NetBlock(GROUPS * hidden, GROUPS, 3, d, backend="pallas")
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    return blk.eval()


def _plain_out(blk, x):
    plain = tl.Res2NetBlock(blk.features, blk.scale, 3, blk.dilation,
                            backend="xla")
    plain.load_state_dict(blk.state_dict())
    with torch.no_grad():
        return plain.to(x.dtype).eval()(x)


def test_folded_weights_are_kept_while_nothing_changes():
    blk = _block()
    first = blk.folded()
    assert all(a is b for a, b in zip(first, blk.folded()))
    x = torch.randn(2, blk.features, 30)
    with torch.no_grad():
        blk(x)
    assert all(a is b for a, b in zip(first, blk.folded()))


@pytest.mark.parametrize("change", ["running_mean", "conv_weight",
                                    "load_state_dict", "train_step", "to"])
def test_a_changed_parameter_or_statistic_reaches_the_next_forward(change):
    blk = _block()
    x = torch.randn(2, blk.features, 30, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        before = blk(x)
    bn = blk.TDNNBlock_2.BatchNorm1d_0.BatchNorm_0
    with torch.no_grad():
        if change == "running_mean":
            bn.running_mean.add_(0.5)
        elif change == "conv_weight":
            blk.TDNNBlock_4.Conv1d_0.Conv_0.weight.mul_(1.5)
        elif change == "load_state_dict":
            other = _block()
            other.TDNNBlock_0.BatchNorm1d_0.BatchNorm_0.bias.add_(0.3)
            blk.load_state_dict(other.state_dict())
        elif change == "train_step":
            blk.train()(x)       # updates the running statistics
            blk.eval()
        else:
            blk.to(torch.float64)
            x = x.double()
    with torch.no_grad():
        after = blk(x)
    if change == "to":
        assert blk.folded()[0].dtype == torch.float64
    else:
        assert not torch.allclose(after, before)
    torch.testing.assert_close(after, _plain_out(blk, x), rtol=1e-5,
                               atol=1e-5)


def test_folded_and_packed_weights_under_inference_mode():
    """The engine runs under ``torch.inference_mode``: the folded weights
    are still plain tensors with a version counter, a changed statistic
    still reaches the next forward, and the wrapper's packed-weights
    cache takes an inference tensor."""
    blk = _block()
    x = torch.randn(2, blk.features, 30)
    with torch.inference_mode():
        before = blk(x)
        w = blk.folded()[0]
    assert not w.is_inference() and rc.state_version(w) >= 0
    with torch.no_grad():
        blk.TDNNBlock_1.BatchNorm1d_0.BatchNorm_0.running_var.mul_(2.0)
    with torch.inference_mode():
        after = blk(x)
        w_inf = torch.randn(GROUPS - 1, 3, 64, 64)
        packed = rc._packed_weights(w_inf, torch.float32, w_inf.device)
    assert not torch.allclose(after, before)
    torch.testing.assert_close(after, _plain_out(blk, x), rtol=1e-5,
                               atol=1e-5)
    assert rc.state_version(w_inf) == -1
    assert rc._packed_weights(w_inf, torch.float32, w_inf.device) is packed


def _edit_unseen(blk, how):
    """An in-place edit that no version counter records."""
    conv = blk.TDNNBlock_3.Conv1d_0.Conv_0
    if how == "data":
        conv.weight.data.mul_(1.5)
    else:        # the block lives in inference mode: no version at all
        with torch.inference_mode():
            conv.weight.mul_(1.5)


def _inference_block():
    with torch.inference_mode():
        return _block()


@pytest.mark.parametrize("how", ["data", "inference"])
def test_an_unrecorded_edit_stays_stale_until_invalidate_folded(how):
    """ROADMAP C.4: the folded weights miss a write through ``.data`` and
    any edit of an inference tensor; ``invalidate_folded`` makes the next
    forward fold the edited parameters."""
    blk = _block() if how == "data" else _inference_block()
    x = torch.randn(2, blk.features, 30, generator=torch.Generator()
                    .manual_seed(2))
    with torch.inference_mode():
        before = blk(x)
    _edit_unseen(blk, how)
    with torch.inference_mode():
        stale = blk(x)
    assert torch.equal(stale, before)
    blk.invalidate_folded()
    with torch.inference_mode():
        fresh = blk(x)
    assert not torch.allclose(fresh, before)
    torch.testing.assert_close(fresh, _plain_out(blk, x), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("how", ["data", "inference"])
def test_an_unrecorded_edit_keeps_the_packed_weights_until_invalidated(how):
    """The wrapper's packed-weights cache, keyed on the same version and
    storage, misses the same edits; ``invalidate_packed`` drops the entry
    and ``invalidate_folded`` drops the block's."""
    if how == "data":
        w = torch.randn(GROUPS - 1, 3, 64, 64)
    else:
        with torch.inference_mode():
            w = torch.randn(GROUPS - 1, 3, 64, 64)
    packed = rc._packed_weights(w, torch.float32, w.device)
    if how == "data":
        w.data.mul_(2.0)
    else:
        with torch.inference_mode():
            w.mul_(2.0)
    assert rc._packed_weights(w, torch.float32, w.device) is packed
    rc.invalidate_packed(w)
    fresh = rc._packed_weights(w, torch.float32, w.device)
    assert not torch.equal(fresh, packed)
    assert torch.equal(fresh, rc.pack_weights(w, torch.float32))

    blk = _block(hidden=64)
    folded_w = blk.folded()[0]
    kept = rc._packed_weights(folded_w, torch.float32, folded_w.device)
    blk.invalidate_folded()
    assert rc._packed_weights(folded_w, torch.float32,
                              folded_w.device) is not kept
    assert blk.folded()[0] is not folded_w
