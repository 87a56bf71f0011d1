"""The port's zstd decoder (``native/zstd.cpp``, RFC 8878), through
``training/orbax_read.zstd_decompress``, against ``zstandard``'s encoder
and decoder.

Frames at levels 1, 3 and 19, with and without a content checksum, on
random, repetitive and float-weight data decode to ``zstandard``'s
output. The decoder counts the modes it meets (``svz_coverage``): the
corpus, with crafted frames for the modes an encoder picks rarely (RLE
blocks, RLE literals, frames without a content size, skippable frames),
reaches every block type, every literals type with 1 and 4 Huffman
streams and direct and FSE-coded weights, every sequence table mode and
every repeat offset. A bad checksum, a dictionary, a wrong magic and a
truncated frame are refused by name.
"""

import ctypes
import io

import numpy as np
import pytest
import zstandard

from speakerverification_tpu_torch.training import orbax_read as O

COVERAGE = ["block raw", "block RLE", "block compressed", "literals raw",
            "literals RLE", "literals compressed", "literals treeless",
            "1 Huffman stream", "4 Huffman streams", "Huffman weights direct",
            "Huffman weights FSE", "no sequences", "sequences predefined",
            "sequences RLE", "sequences FSE", "sequences repeat",
            "repeat offset 1", "repeat offset 2", "repeat offset 3",
            "repeat offset 1 - 1", "frame with content size",
            "frame without content size", "checksum", "skippable frame"]


def _data():
    rng = np.random.default_rng(0)
    R = rng.bytes(131072)
    return {
        "random": rng.bytes(200_000),
        "repetitive": b"".join(
            b"speaker %d says hello to the bank\n" % (i % 89)
            for i in range(8000)),
        "float weights": (rng.standard_normal(150_000) * 0.05)
        .astype(np.float32).tobytes(),
        "small alphabet": rng.integers(0, 4, 200_000,
                                       dtype=np.uint8).tobytes(),
        "one byte": b"x",
        # level 19 codes an offset as "repeat offset 1 minus 1" here
        "numbers": b" ".join(b"%d" % (i * i % 1000) for i in range(100_000)),
        # an encoder emits RLE blocks only after a frame's first block
        "zeros": bytes(400_000),
        # matches into R separated by single 'z's: all-'z' literals
        "same literals": R + b"".join(
            b"z" + R[i:i + 90]
            for i in rng.integers(0, 131072 - 100, 1500)),
    }


DATA = _data()


def _coverage():
    lib = O._zstd()
    out = (ctypes.c_longlong * 64)()
    n = lib.svz_coverage(out, 64)
    return dict(zip(COVERAGE, out[:n]))


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", ["random", "repetitive", "float weights"])
def test_frames_decode_as_zstandard_decodes_them(name, level, checksum):
    data = DATA[name]
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=checksum).compress(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert O.zstd_decompress(frame).tobytes() == data
    assert O.zstd_content_size(frame) == len(data)
    assert O.zstd_decompress(frame, len(data)).tobytes() == data


def _streamed(data, level=3):
    buf = io.BytesIO()
    with zstandard.ZstdCompressor(level=level, write_checksum=True) \
            .stream_writer(buf, closefd=False) as w:
        for i in range(0, len(data), 7000):
            w.write(data[i:i + 7000])
            w.flush()
    return buf.getvalue()


def test_every_block_literal_and_sequence_mode_is_reached():
    O._zstd().svz_coverage_reset()
    for level in (1, 3, 19):
        for name, data in DATA.items():
            frame = zstandard.ZstdCompressor(
                level=level, write_checksum=level == 3).compress(data)
            assert O.zstd_decompress(frame).tobytes() == data, (name, level)
    for name in ("repetitive", "float weights"):
        frame = _streamed(DATA[name])
        assert O.zstd_content_size(frame) is None
        assert O.zstd_decompress(frame).tobytes() == DATA[name]
    skip = b"\x5a\x2a\x4d\x18" + (3).to_bytes(4, "little") + b"abc"
    two = zstandard.ZstdCompressor().compress(b"left ") + skip + \
        zstandard.ZstdCompressor().compress(b"right")
    assert O.zstd_decompress(two).tobytes() == b"left right"
    cov = _coverage()
    assert all(cov.values()), {k: v for k, v in cov.items() if not v}


def test_what_the_decoder_refuses():
    text = DATA["repetitive"]
    bad = bytearray(zstandard.ZstdCompressor(write_checksum=True)
                    .compress(text))
    bad[-1] ^= 1
    with pytest.raises(ValueError, match="checksum mismatch"):
        O.zstd_decompress(bytes(bad))
    samples = [text[i:i + 400] for i in range(0, len(text), 400)]
    dictionary = zstandard.train_dictionary(2048, samples)
    framed = zstandard.ZstdCompressor(dict_data=dictionary).compress(
        text[:3000])
    with pytest.raises(ValueError, match="dictionaries are not supported"):
        O.zstd_decompress(framed)
    with pytest.raises(ValueError, match="bad magic"):
        O.zstd_decompress(b"\x00" * 16)
    frame = zstandard.ZstdCompressor().compress(text)
    with pytest.raises(ValueError, match="zstd: "):
        O.zstd_decompress(frame[:len(frame) // 2])
    with pytest.raises(ValueError, match="exceed the 10-byte buffer"):
        O.zstd_decompress(frame, 10)
    with pytest.raises(ValueError, match="malformed"):
        O.zstd_content_size(b"nope")


def test_crc32c_is_castagnoli():
    # RFC 3720's check value for "123456789"
    assert O.crc32c(b"123456789") == 0xE3069283
    assert O.crc32c(b"") == 0
