"""K3's conv kernel (``csrc/quant_matmul.cu``) replayed on the CPU.

The kernel cannot run here, so its schedule (the wrapper's
``conv_grid``) and weight tiles (``pack_conv_weights``) are replayed
block by block in integers with a model of its loads (``row_chunks``),
its shared-memory operand layout (``core_offset``, read back the way the
``wgmma`` descriptors read it) and its staged stores (``store_chunks``),
from x's bytes at a chosen address, and the result is held bit for bit
against ``quant_matmul_plain``. Never-loaded shared memory holds NaN, so
a read of a byte the kernel does not load shows.
"""

import numpy as np
import pytest
import torch

from speakerverification_tpu_torch.ops import quant_matmul as qm

CM, CN, CK = qm.CONV_TILE
SBO = CK // 16 * 128          # the descriptors' stride byte offset
LBO = 128                     # ... and leading byte offset
CHUNK = 16                    # bytes of a copy chunk and a vector store


def row_chunks(seg, ncols, item, begin, end):
    """How the kernel loads one row's piece of a tile: ``ncols`` elements
    of ``item`` bytes from byte address ``seg``, where x spans the bytes
    ``[begin, end)``. Returns the piece's head (the place of its first
    element in its 16-byte chunk: the quantize reads the row from there)
    and, per 16-byte chunk that covers the piece, ``(address, whole)``:
    ``whole`` when the chunk lies inside x and moves as one 16-byte copy,
    else it straddles x's first or last byte and only x's elements are
    loaded."""
    first = seg - seg % CHUNK
    return (seg - first) // item, [
        (a, begin <= a and a + CHUNK <= end)
        for a in range(first, seg + ncols * item, CHUNK)]


def store_chunks(row, ncols, item):
    """How the kernel's epilogue writes one output row's piece of
    ``ncols`` elements from byte address ``row``: per 16-byte chunk that
    covers it, ``(lo, whole)``, ``lo`` the chunk's first element relative
    to the piece (negative for the head chunk); a ``whole`` chunk is one
    16-byte store, the others store only the piece's elements. The staged
    row holds the piece shifted by its head, so chunk j is read at staged
    column ``j * 16 // item``."""
    v = CHUNK // item
    head = row % CHUNK // item
    return [(j * v - head, j * v >= head and (j + 1) * v - head <= ncols)
            for j in range(-(-(head + ncols) // v))]


def core_offset(row, kc):
    """Byte offset of a row's 16-byte K chunk ``kc`` in the kernel's
    operand tiles (CK bytes of K per row, K-major): core matrices of 8
    rows x 16 bytes, ``[row // 8][kc][row % 8]``."""
    return (row // 8) * SBO + kc * LBO + (row % 8) * 16


def _pitch(item):
    """Elements per staged row: CN plus a chunk (the head's room)."""
    return CN + CHUNK // item


def _values(raw, item):
    """Little-endian element bytes → float32 (bf16: the top half)."""
    if item == 4:
        return raw.view(np.float32).astype(np.float32)
    return (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def _to_dtype(y, dtype):
    return torch.from_numpy(y).to(dtype)


def _operand(tile, start, rows):
    """``rows`` x 32 bytes of K of an operand tile, read as a wgmma
    descriptor at ``start`` reads them (LBO to the next 16 bytes of K,
    SBO to the next 8 rows)."""
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    at = start + (r // 8) * SBO + (k // 16) * LBO + (r % 8) * 16 + k % 16
    return tile.view(np.int8)[at].astype(np.int64)


def _quantized_tile(raw, item, begin, end, x_addr, bz, K, T, k0, t0, ncols,
                    inv_sx):
    """One depth step's x tile as the kernel stages it (``row_chunks``,
    never-loaded bytes NaN) and quantizes it (row r read from its head,
    zero past K) into the K-major core-matrix layout."""
    v = CHUNK // item
    pitch = _pitch(item)
    stage = np.full((CK, pitch), np.nan, np.float32)
    heads = np.zeros(CK, np.int64)
    for r in range(min(CK, K - k0)):
        seg = x_addr + ((bz * K + k0 + r) * T + t0) * item
        head, chunks = row_chunks(seg, ncols, item, begin, end)
        assert len(chunks) * v <= pitch
        heads[r] = head
        for j, (a, whole) in enumerate(chunks):
            lo, hi = max(a, begin), min(a + CHUNK, end)
            assert not whole or (lo, hi) == (a, a + CHUNK)
            if hi > lo:
                stage[r, j * v + (lo - a) // item:j * v + (hi - a) // item] = \
                    _values(raw[lo - begin:hi - begin], item)
    cols = np.arange(CN)
    vals = stage[np.arange(CK)[:, None], heads[:, None] + cols[None, :]]
    q = np.rint(np.fmin(np.fmax(vals * np.float32(inv_sx), np.float32(-127)),
                        np.float32(127))).astype(np.int64)
    q[max(0, K - k0):] = 0
    xq = np.zeros(CN * CK, np.uint8)
    kk = np.arange(CK)
    xq[core_offset(cols[None, :], kk[:, None] // 16) + kk[:, None] % 16] = \
        q.astype(np.int8).view(np.uint8)
    return xq


def _products(acc, wt, xq):
    """acc += one step's products: warpgroup g's rows 128 g + 64 mi, two
    k32 sub-steps, the tiles read as the descriptors read them."""
    for g in range(2):
        for mi in range(2):
            m0 = 128 * g + 64 * mi
            for ks in range(CK // 32):
                a_op = _operand(wt, (m0 // 8) * SBO + ks * 256, 64)
                acc[m0:m0 + 64] += a_op @ _operand(xq, ks * 256, CN).T


def _store_tile(out, acc, scale, b, dtype, item, out_addr, bz, N, T, n0, t0,
                ncols):
    """The epilogue: rounded as __fmul_rn then __fadd_rn, staged per row
    shifted by its head, written by ``store_chunks``; every element once."""
    v = CHUNK // item
    for r in range(min(CM, N - n0)):
        n = n0 + r
        y = acc[r].astype(np.float32) * np.float32(scale[n]) + np.float32(b[n])
        y = _to_dtype(y, dtype).float().numpy()
        row = out_addr + ((bz * N + n) * T + t0) * item
        head = row % CHUNK // item
        staged = np.full(_pitch(item), np.nan, np.float32)
        staged[head:head + CN] = y
        base = (bz * N + n) * T + t0
        for j, (lo, whole) in enumerate(store_chunks(row, ncols, item)):
            assert not whole or (row + lo * item) % CHUNK == 0
            for e in range(v):
                if 0 <= lo + e < ncols:
                    assert np.isnan(out[base + lo + e])
                    out[base + lo + e] = staged[j * v + e]


def replay_conv(x, wq, s_w, bias, act_scale, x_addr=4096, out_addr=8192,
                sms=132):
    """The conv kernel's output for contiguous ``x [nb, K, T]`` whose first
    element sits at byte ``x_addr`` (x spans ``[x_addr, x_addr +
    x.nbytes)``), ``wq`` packed by ``pack_conv_weights``, writing an out
    whose first element sits at ``out_addr``, block by block of
    ``conv_grid`` on ``sms`` SMs: a block quantizes its x tile on its
    first output-channel tile and keeps it for the others."""
    nb, K, T = x.shape
    N = wq.shape[0]
    item = x.element_size()
    raw = x.contiguous().view(torch.uint8).numpy().reshape(-1)
    begin, end = x_addr, x_addr + raw.size
    _, inv_sx = qm.act_scales(act_scale)
    scale, b = (v.numpy() for v in qm._epilogue(wq, s_w, bias, act_scale))
    packed = qm.pack_conv_weights(wq).numpy()
    out = np.full(nb * N * T, np.nan, np.float32)
    (groups, t_tiles, rows), tiles = qm.conv_grid(nb, N, K, T, sms)
    assert rows == nb and (tiles == 1 or tiles * groups * CM >= N)
    for bz, ty, bx in np.ndindex(nb, t_tiles, groups):
        t0 = ty * CN
        ncols = min(CN, T - t0)
        kept = {}   # depth -> quantized x tile, made on the first tile
        for nx in range(bx * tiles, (bx + 1) * tiles):
            acc = np.zeros((CM, CN), np.int64)
            for k0 in range(0, K, CK):
                if k0 not in kept:
                    kept[k0] = _quantized_tile(raw, item, begin, end, x_addr,
                                               bz, K, T, k0, t0, ncols,
                                               inv_sx)
                _products(acc, packed[nx, k0 // CK], kept[k0])
            _store_tile(out, acc, scale, b, x.dtype, item, out_addr, bz, N,
                        T, nx * CM, t0, ncols)
    assert not np.isnan(out).any()
    return _to_dtype(out, x.dtype).reshape(nb, N, T)


def _inputs(shape, n, dtype, seed=0, offset=0, amplitude=1.0):
    """x (a view ``offset`` elements into a storage that ends at its last
    element), int8 weights, their scales, bias, and a static act scale
    under max|x|, so that some inputs saturate at +-127."""
    g = torch.Generator().manual_seed(seed)
    numel = int(np.prod(shape))
    flat = (amplitude * torch.randn(offset + numel, generator=g)).to(dtype)
    x = flat[offset:].view(shape)
    w = torch.randn(n, shape[1], generator=g) / shape[1] ** 0.5
    wq, s_w = qm.quantize_weight(w)
    bias = 0.1 * torch.randn(n, generator=g)
    act = 0.8 * x.float().abs().max().item()
    return x, wq, s_w, bias, act


# (x shape, N): K 96 and K 100 (not a multiple of 16: zero padding in the
# packed wq), N 50 / 192 / 320 / 1000 (one, two and four output-channel
# tiles), T = 1, T below a tile, T = 1, 7 and 8 (mod 8), a T spanning
# three time tiles
REPLAY_SHAPES = [((2, 96, 37), 50), ((2, 100, 129), 320), ((2, 64, 1), 192),
                 ((1, 96, 263), 50), ((3, 72, 8), 130), ((1, 160, 15), 64),
                 ((3, 64, 20), 1000)]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n", REPLAY_SHAPES)
def test_replayed_conv_kernel_matches_plain_bit_for_bit(shape, n, dtype, sms):
    """On 132 SMs these small grids give one output-channel tile per
    block; on 1, blocks keep their quantized x over 2 or 4 tiles."""
    args = _inputs(shape, n, dtype, seed=n + shape[2])
    assert torch.equal(replay_conv(*args, sms=sms),
                       qm.quant_matmul_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shift,out_shift", [(1, 0), (3, 2), (0, 1)])
def test_replay_at_unaligned_addresses(x_shift, out_shift, dtype):
    """x as a view at an element offset whose storage ends at its last
    element (the first and last chunks straddle x), and an out whose rows
    start anywhere."""
    args = _inputs((2, 96, 41), 70, dtype, seed=7, offset=x_shift)
    item = args[0].element_size()
    got = replay_conv(*args, x_addr=4096 + x_shift * item,
                      out_addr=8192 + out_shift * item)
    assert torch.equal(got, qm.quant_matmul_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_with_saturating_inputs(dtype):
    """A scale far under max|x|: most inputs clip to +-127, and the int32
    sums reach 127 * 127 * K."""
    x, wq, s_w, bias, _ = _inputs((1, 128, 21), 40, dtype, seed=3,
                                  amplitude=50.0)
    wq = torch.where(wq >= 0, 127, -127).to(torch.int8)
    args = (x, wq, s_w, bias, 1.0)
    got = replay_conv(*args)
    assert torch.equal(got, qm.quant_matmul_plain(*args))
    assert (qm.quantize_act(x, 1.0).abs() == 127).float().mean() > 0.9


@pytest.mark.parametrize("item", [4, 2])
def test_row_chunks_cover_each_piece_inside_x(item):
    """Every element of the piece lies in a loaded chunk, the chunks fit
    the staged row, whole chunks lie inside x and the others straddle its
    first or last byte."""
    v = CHUNK // item
    for head in range(v):
        for ncols in (1, v - 1, v, v + 1, 37, CN - 1, CN):
            for x_head, x_tail in ((0, 0), (head, 0), (0, 1), (head, 3)):
                seg = 1024 + head * item
                begin = seg - x_head * item
                end = seg + (ncols + x_tail) * item
                got_head, chunks = row_chunks(seg, ncols, item, begin, end)
                assert got_head == head
                assert len(chunks) * v <= _pitch(item)
                assert chunks[0][0] <= seg and chunks[0][0] % CHUNK == 0
                assert chunks[-1][0] + CHUNK >= seg + ncols * item
                for a, whole in chunks:
                    inside = begin <= a and a + CHUNK <= end
                    assert whole == inside
                    if not whole:
                        assert a < begin < a + CHUNK or a < end < a + 16


@pytest.mark.parametrize("item", [4, 2])
def test_store_chunks_write_each_element_once(item):
    v = CHUNK // item
    for head in range(v):
        for ncols in (1, v - 1, v, 2 * v + 1, 105, CN):
            row = 2048 + head * item
            seen = np.zeros(ncols, int)
            for j, (lo, whole) in enumerate(store_chunks(row, ncols, item)):
                assert lo == j * v - head
                if whole:
                    assert (row + lo * item) % CHUNK == 0
                    assert 0 <= lo and lo + v <= ncols
                for e in range(v):
                    if 0 <= lo + e < ncols:
                        seen[lo + e] += 1
            assert (seen == 1).all()


@pytest.mark.parametrize("N,K", [(50, 96), (300, 100), (256, 64)])
def test_packed_weights_hold_each_tile_in_core_matrix_order(N, K):
    wq = torch.randint(-127, 128, (N, K), dtype=torch.int8,
                       generator=torch.Generator().manual_seed(N))
    packed = qm.pack_conv_weights(wq)
    n_tiles = -(-N // CM)
    assert packed.shape == (n_tiles, -(-K // CK), CM * CK)
    rows = np.arange(CM)[:, None]
    k = np.arange(CK)[None, :]
    at = core_offset(rows, k // 16) + k % 16
    full = torch.zeros(n_tiles * CM, packed.shape[1] * CK, dtype=torch.int8)
    full[:N, :K] = wq
    for nt in range(n_tiles):
        for ks in range(packed.shape[1]):
            tile = packed[nt, ks].numpy()[at]
            want = full[nt * CM:(nt + 1) * CM, ks * CK:(ks + 1) * CK].numpy()
            assert (tile == want).all()


@pytest.mark.parametrize("how", ["in_place", "data", "inference"])
def test_packed_weights_follow_edits_or_invalidate_packed(how):
    """An in-place edit bumps the version and repacks; a write through
    ``.data`` or an edit of an inference tensor keeps the stale tiles
    until ``invalidate_packed``."""
    if how == "inference":
        with torch.inference_mode():
            wq = torch.ones(40, 64, dtype=torch.int8)
    else:
        wq = torch.ones(40, 64, dtype=torch.int8)
    first = qm._packed_weights(wq)
    assert qm._packed_weights(wq) is first
    if how == "in_place":
        wq.mul_(2)
        assert torch.equal(qm._packed_weights(wq), qm.pack_conv_weights(wq))
        return
    if how == "data":
        wq.data.mul_(2)
    else:
        with torch.inference_mode():
            wq.mul_(2)
    assert qm._packed_weights(wq) is first
    qm.invalidate_packed(wq)
    assert torch.equal(qm._packed_weights(wq), qm.pack_conv_weights(wq))
    assert not torch.equal(qm._packed_weights(wq), first)


def test_core_offset_is_a_permutation_of_the_tile():
    rows = np.arange(CM)[:, None]
    k = np.arange(CK)[None, :]
    at = core_offset(rows, k // 16) + k % 16
    assert sorted(at.ravel().tolist()) == list(range(CM * CK))
    # a core matrix is 8 rows x 16 bytes, contiguous
    assert (at[:8, :16].ravel() == np.arange(128)).all()


# path C's conv shapes on 132 SMs: (nb, N, K, T) -> grid, tiles per block
@pytest.mark.parametrize("nb,N,K,T,want", [
    (160, 1024, 1024, 1575, ((1, 13, 160), 4)),
    (160, 1024, 1024, 315, ((1, 3, 160), 4)),
    (160, 1024, 1024, 105, ((4, 1, 160), 1)),   # 2 per block: 320 blocks
    (160, 1536, 3072, 105, ((6, 1, 160), 1)),   # K past the kept steps
    (160, 128, 4608, 105, ((1, 1, 160), 1)),
    (160, 512, 512, 201, ((2, 2, 160), 1)),
    (160, 1536, 1536, 201, ((6, 2, 160), 1)),
    (3, 50, 96, 2, ((1, 1, 3), 1))])
def test_conv_grid(nb, N, K, T, want):
    assert qm.conv_grid(nb, N, K, T) == want


def test_replay_shapes_keep_quantized_x_over_two_and_four_tiles():
    tiles = {qm.conv_grid(shape[0], n, shape[1], shape[2], sms=1)[1]
             for shape, n in REPLAY_SHAPES}
    assert tiles == {1, 2, 4}


