"""The port's WAV reader (``data/wavio.py`` + ``native/wavio.cpp``) against
the JAX package's, bit for bit, and its hardening.

Files of every supported format (PCM 16/24/32-bit, IEEE float32/64; mono
and stereo; extra chunks before and after the data; odd lengths with the
RIFF pad byte; WAVE_FORMAT_EXTENSIBLE) are written here from a numpy
seed. The port's native decoder (called directly, no fallback) and its
NumPy parser must give the JAX ``read_wav``'s float32 bits exactly (the
JAX native decoder's), and ``wav_info`` its numbers. The JAX package's
own NumPy fallback averages channels in float32 after the cast, so on
multi-channel float64 files (and on 3 channels) it differs from its
native decoder in the last bit; the port's parser sums channels as the
native decoder does, and equals the JAX fallback wherever the JAX
package's two decoders agree. The malformed-file cases of
``tests/test_wavio_hardening.py`` run against the port's decoders, one
parametrised test per property, plus headers of 1-7 bits per sample,
which give a zero frame size. The library is built with g++ into the
port's ``_build/``, never under ``speakerverification_tpu/``.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import pytest

from speakerverification_tpu.data import wavio as jwavio
from speakerverification_tpu_torch.data import wavio as twavio
from speakerverification_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]


DECODERS = {"native": twavio.read_wav_native,
            "python": twavio._read_wav_python, "read_wav": twavio.read_wav}


def bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.dtype == b.dtype == np.float32 and a.shape == b.shape
            and np.array_equal(a.view(np.uint32), b.view(np.uint32)))


# ---------------------------------------------------------------------------
# files of every format
# ---------------------------------------------------------------------------
def _payload(rng, fmt: str, frames: int, channels: int) -> tuple:
    n = frames * channels
    if fmt == "pcm16":
        return rng.integers(-32768, 32768, n).astype("<i2").tobytes(), 1, 16
    if fmt == "pcm24":
        v = rng.integers(-2**23, 2**23, n).astype("<i4")
        b = v.view(np.uint8).reshape(-1, 4)[:, :3]
        return np.ascontiguousarray(b).tobytes(), 1, 24
    if fmt == "pcm32":
        return rng.integers(-2**31, 2**31, n).astype("<i4").tobytes(), 1, 32
    if fmt == "float32":
        return rng.uniform(-1.2, 1.2, n).astype("<f4").tobytes(), 3, 32
    if fmt == "float64":
        return rng.uniform(-1.2, 1.2, n).astype("<f8").tobytes(), 3, 64
    raise AssertionError(fmt)


def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def write_any(path, fmt: str, frames: int, channels: int, seed: int,
              extra: str = "none", sample_rate: int = 16000) -> None:
    rng = np.random.default_rng(seed)
    payload, audio_format, bits = _payload(rng, fmt, frames, channels)
    block = channels * bits // 8
    if extra == "extensible":
        guid_tail = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
        fmt_body = struct.pack("<HHIIHHHHI", 0xFFFE, channels, sample_rate,
                               sample_rate * block, block, bits, 22, bits, 0)
        fmt_body += struct.pack("<H", audio_format) + guid_tail
    else:
        fmt_body = struct.pack("<HHIIHH", audio_format, channels, sample_rate,
                               sample_rate * block, block, bits)
    info = _chunk(b"LIST", b"INFOISFT" + struct.pack("<I", 5) + b"test\0")
    chunks = [_chunk(b"fmt ", fmt_body), _chunk(b"data", payload)]
    if extra == "chunks":
        chunks = [info, chunks[0], _chunk(b"fact", struct.pack("<I", frames)),
                  chunks[1], info]
    body = b"WAVE" + b"".join(chunks)
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


FORMATS = ["pcm16", "pcm24", "pcm32", "float32", "float64"]
CASES = [(fmt, ch, frames, extra)
         for fmt in FORMATS for ch in (1, 2, 3)
         for frames, extra in ((1001, "none"), (777, "chunks"),
                               (64, "extensible"))]


@pytest.mark.parametrize("fmt,channels,frames,extra", CASES)
def test_decoders_equal_jax_bit_for_bit(tmp_path, fmt, channels, frames,
                                        extra):
    p = tmp_path / f"{fmt}.wav"
    write_any(p, fmt, frames, channels, seed=10 * FORMATS.index(fmt) + channels,
              extra=extra)
    assert jwavio.native_available()
    want, sr = jwavio.read_wav(p)
    assert sr == 16000 and want.shape == (frames,)
    for name, fn in DECODERS.items():
        got, got_sr = fn(p)
        assert got_sr == sr, name
        assert bits_equal(got, want), name
    jpy, _ = jwavio._read_wav_python(p)
    if bits_equal(jpy, want):
        assert channels == 1 or (channels == 2 and fmt != "float64")
    else:
        assert channels == 3 or fmt == "float64"
    info = (16000, frames, channels)
    assert twavio.wav_info(p) == jwavio.wav_info(p) == info
    assert twavio._parse_wav(p.read_bytes(), header_only=True)[:3] == info


@pytest.mark.parametrize("decoder", list(DECODERS))
def test_negative_zero_and_nan_bits(tmp_path, decoder):
    """Float files: -0.0 comes out +0.0 (the native sum starts at 0),
    infinities stay, on every decoder as in the JAX package's."""
    vals = np.array([-0.0, 0.0, np.inf, -np.inf, 1.5, -2.0], "<f4")
    p = tmp_path / "z.wav"
    twavio.write_wav(p, vals, 8000, subtype="FLOAT")
    got, _ = DECODERS[decoder](p)
    assert got.view(np.uint32)[0] == 0
    np.testing.assert_array_equal(got[1:], vals[1:])
    want, _ = jwavio.read_wav(p)
    assert bits_equal(got, want)


@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
@pytest.mark.parametrize("channels", [1, 2])
def test_write_wav_bytes_equal_jax(tmp_path, subtype, channels):
    rng = np.random.default_rng(channels)
    audio = rng.uniform(-1.3, 1.3, (513, channels)).astype(np.float32)
    if channels == 1:
        audio = audio[:, 0]
    twavio.write_wav(tmp_path / "t.wav", audio, 8000, subtype=subtype)
    jwavio.write_wav(tmp_path / "j.wav", audio, 8000, subtype=subtype)
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    got, _ = twavio.read_wav(tmp_path / "t.wav")
    want, _ = jwavio.read_wav(tmp_path / "j.wav")
    assert bits_equal(got, want)
    with pytest.raises(ValueError):
        twavio.write_wav(tmp_path / "x.wav", audio, 8000, subtype="PCM_24")


# ---------------------------------------------------------------------------
# hardening (the cases of tests/test_wavio_hardening.py, on the port)
# ---------------------------------------------------------------------------
def _header(audio_format=1, channels=1, sample_rate=8000, bits=16,
            data_size=0):
    block_align = min(max(channels * bits // 8, 1), 0xFFFF)
    byte_rate = min(sample_rate * block_align, 0xFFFF_FFFF)
    h = b"RIFF" + struct.pack("<I", min(36 + data_size, 0xFFFF_FFFF)) + b"WAVE"
    h += b"fmt " + struct.pack("<IHHIIHH", 16, audio_format, channels,
                               sample_rate, byte_rate, block_align, bits)
    h += b"data" + struct.pack("<I", data_size)
    return h


@pytest.mark.parametrize("decoder", list(DECODERS))
def test_lying_data_size_is_clamped(tmp_path, decoder):
    """The header claims ~4 GB; 64 frames follow."""
    p = tmp_path / "lie.wav"
    p.write_bytes(_header(data_size=0xFFFF_FFF0)
                  + np.arange(64, dtype="<i2").tobytes())
    audio, sr = DECODERS[decoder](p)
    assert sr == 8000 and audio.shape == (64,)
    np.testing.assert_allclose(audio, np.arange(64) / 32768.0, atol=1e-7)
    assert twavio.wav_info(p) == (8000, 64, 1)
    assert twavio._parse_wav(p.read_bytes(), header_only=True)[:3] == \
        (8000, 64, 1)


@pytest.mark.parametrize("decoder", list(DECODERS))
def test_truncated_data_rounds_to_whole_frames(tmp_path, decoder):
    payload = np.zeros(10, "<i2").tobytes() + b"\x01"   # 2.75 stereo frames
    p = tmp_path / "trunc.wav"
    p.write_bytes(_header(channels=2, data_size=len(payload)) + payload)
    assert DECODERS[decoder](p)[0].shape == (5,)


@pytest.mark.parametrize("decoder", list(DECODERS))
def test_many_channels_bounded_memory(tmp_path, decoder):
    """A 65,535-channel header decodes in bounded memory."""
    ch = 65535
    payload = np.zeros(ch * 2, "<i2").tobytes()           # 2 frames
    p = tmp_path / "wide.wav"
    p.write_bytes(_header(channels=ch, data_size=len(payload)) + payload)
    audio, _ = DECODERS[decoder](p)
    assert audio.shape == (2,)
    np.testing.assert_allclose(audio, 0.0)


# channels 0, bits 0, and 1-7 bits: a zero frame size
ZERO_FIELDS = [(0, 16), (1, 0), (0, 0)] + [(1, b) for b in range(1, 8)]


@pytest.mark.parametrize("decoder", list(DECODERS))
@pytest.mark.parametrize("channels,bits", ZERO_FIELDS)
def test_zero_frame_size_raises_valueerror(tmp_path, decoder, channels,
                                           bits):
    p = tmp_path / "zero.wav"
    p.write_bytes(_header(channels=channels, bits=bits, data_size=4)
                  + b"\0\0\0\0")
    with pytest.raises(ValueError):
        DECODERS[decoder](p)
    with pytest.raises(ValueError):
        twavio.wav_info(p)


@pytest.mark.parametrize("decoder", list(DECODERS))
@pytest.mark.parametrize("audio_format,bits", [(1, 12), (1, 8), (3, 16),
                                               (1, 64), (2, 16)])
def test_unsupported_format_raises(tmp_path, decoder, audio_format, bits):
    p = tmp_path / "odd.wav"
    p.write_bytes(_header(audio_format=audio_format, bits=bits, data_size=8)
                  + b"\0" * 8)
    with pytest.raises(ValueError):
        DECODERS[decoder](p)


BAD_HEADERS = [
    b"",                                   # empty
    b"RIFF",                               # cut inside the magic
    b"RIFF\x10\x00\x00\x00WAVE",           # no chunks
    b"RIFF\x10\x00\x00\x00WAVEfmt ",       # chunk tag, no size
    b"garbage-not-a-wav-file-at-all",      # not RIFF
    _header()[:20],                        # truncated fmt body
    _header(data_size=0)[:-8],             # fmt only, no data chunk
    # data before fmt
    b"RIFF" + struct.pack("<I", 20) + b"WAVEdata" + struct.pack("<I", 4)
    + b"\0\0\0\0",
    # a junk chunk claiming 4 GB must end the walk, not hang it
    b"RIFF" + struct.pack("<I", 100) + b"WAVEJUNK"
    + struct.pack("<I", 0xFFFF_FFFF) + b"\0" * 16,
]


@pytest.mark.parametrize("decoder", list(DECODERS))
@pytest.mark.parametrize("case", range(len(BAD_HEADERS)))
def test_malformed_headers_raise_valueerror(tmp_path, decoder, case):
    p = tmp_path / "bad.wav"
    p.write_bytes(BAD_HEADERS[case])
    with pytest.raises((ValueError, IndexError)):
        DECODERS[decoder](p)


@pytest.mark.parametrize("decoder", list(DECODERS))
def test_fuzz_never_crashes(tmp_path, decoder):
    """Random bytes behind valid RIFF/WAVE magic: a clean error or a
    decode."""
    rng = np.random.default_rng(0)
    p = tmp_path / "fuzz.wav"
    for _ in range(60):
        body = rng.integers(0, 256, rng.integers(0, 200),
                            dtype=np.uint8).tobytes()
        p.write_bytes(b"RIFF" + struct.pack("<I", len(body) + 4) + b"WAVE"
                      + body)
        try:
            audio, _ = DECODERS[decoder](p)
            assert audio.dtype == np.float32
        except (ValueError, IndexError, struct.error):
            pass


@pytest.mark.parametrize("decoder", list(DECODERS))
def test_bitflips_never_crash(tmp_path, decoder):
    """Byte corruptions anywhere in a well-formed header (the bits field
    included): no crash, no allocation beyond the file's size, and the
    two decoders agree wherever both decode."""
    rng = np.random.default_rng(1)
    p0 = tmp_path / "ok.wav"
    twavio.write_wav(p0, rng.normal(0, 0.1, 256).astype(np.float32), 8000)
    raw = bytearray(p0.read_bytes())
    p = tmp_path / "flip.wav"
    for trial in range(200):
        flipped = bytearray(raw)
        # every header byte once, then random ones
        idx = trial if trial < 44 else int(rng.integers(0, 44))
        flipped[idx] ^= int(rng.integers(1, 256))
        p.write_bytes(bytes(flipped))
        try:
            audio, _ = DECODERS[decoder](p)
        except (ValueError, IndexError, struct.error):
            continue
        assert len(audio) <= 16 * len(raw)
        try:
            ref, _ = twavio._read_wav_python(p)
        except (ValueError, IndexError, struct.error):
            continue
        assert bits_equal(audio, ref)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------
def _tree(root: Path) -> dict:
    """Files under the JAX package with their sizes and mtimes, apart from
    what its own tests make there (``__pycache__``, its ``libsvwav.so``)."""
    return {str(f.relative_to(root)): (f.stat().st_size, f.stat().st_mtime_ns)
            for f in root.rglob("*") if f.is_file()
            and "__pycache__" not in f.parts and f.name != "libsvwav.so"}


def test_native_library_builds_into_the_ports_build_dir(tmp_path,
                                                        monkeypatch):
    assert twavio.native_available(), twavio.native_error()
    path = _build.build_host("wavio")
    assert path.parent == _build.BUILD_DIR == \
        ROOT / "speakerverification_tpu_torch" / "_build"
    assert path.name.startswith("libwavio-") and path.suffix == ".so"
    src = ROOT / "speakerverification_tpu_torch" / "native" / "wavio.cpp"
    assert not src.is_symlink()
    assert src.read_bytes() != (ROOT / "speakerverification_tpu" / "native"
                                / "wavio.cpp").read_bytes()
    # a fresh build writes into its build directory and nowhere else
    before = _tree(ROOT / "speakerverification_tpu")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    fresh = _build.build_host("wavio")
    assert fresh.parent == tmp_path / "_build" and fresh.exists()
    assert fresh.name == path.name           # named by the source's hash
    assert sorted(f.name for f in (tmp_path / "_build").iterdir()) == \
        sorted([fresh.name, "wavio.log"])
    assert _tree(ROOT / "speakerverification_tpu") == before
    assert not list((ROOT / "speakerverification_tpu_torch" / "native")
                    .glob("*.so"))
