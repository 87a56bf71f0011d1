"""WAV I/O (port of ``data/wavio.py``): the native C++ decoder
(``native/wavio.cpp``, built with g++ at first use into ``_build/`` and
loaded through ``ctypes.CDLL``, which releases the interpreter lock for
the whole file) and a NumPy RIFF parser for hosts without a compiler.

Both return mono float32 in [-1, 1] (channels averaged), bit for bit
alike: PCM 16/24/32-bit scaled by 1/2^(bits-1), IEEE float32/float64 as
stored, channels summed in the native decoder's order and precision; a data chunk whose size lies is clamped to the bytes present,
rounded down to whole frames. :func:`write_wav` writes ``PCM_16``
(``x · 32767``, clipped and truncated) or ``FLOAT`` (float32).
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["read_wav", "read_wav_native", "write_wav", "wav_info",
           "native_available", "native_error"]

_lib = None
_lib_error = None
_lib_lock = threading.Lock()

_SIGNATURES = {
    "sv_wav_info": ([ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                     ctypes.POINTER(ctypes.c_int64),
                     ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    "sv_wav_read": ([ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                     ctypes.c_int64, ctypes.POINTER(ctypes.c_int)],
                    ctypes.c_int64),
}


def _load_native():
    """The native library, built on first use; None (once, with the
    reason in :func:`native_error`) where it cannot be built."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    with _lib_lock:
        if _lib is None and _lib_error is None:
            from speakerverification_tpu_torch.ops import _build
            try:
                _lib = _build.load_host("wavio", _SIGNATURES)
            except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
                _lib_error = str(exc)
    return _lib


def native_available() -> bool:
    return _load_native() is not None


def native_error() -> str | None:
    """Why the native library could not be built or loaded, if so."""
    _load_native()
    return _lib_error


def wav_info(path: str | Path) -> Tuple[int, int, int]:
    """``(sample_rate, num_frames, channels)`` without decoding."""
    lib = _load_native()
    if lib is not None:
        sr, nf, ch = ctypes.c_int(), ctypes.c_int64(), ctypes.c_int()
        rc = lib.sv_wav_info(str(path).encode(), ctypes.byref(sr),
                             ctypes.byref(nf), ctypes.byref(ch))
        if rc == 0:
            return sr.value, nf.value, ch.value
    sr, frames, ch, _bits = _parse_wav(Path(path).read_bytes(),
                                       header_only=True)
    return sr, frames, ch


def read_wav_native(path: str | Path) -> Tuple[np.ndarray, int]:
    """:func:`read_wav` by the native decoder alone: ``RuntimeError``
    where it is not built, ``ValueError`` (with its error code) on a file
    it refuses."""
    lib = _load_native()
    if lib is None:
        raise RuntimeError(f"the native WAV reader is not available: "
                           f"{_lib_error}")
    # one call, one open: every supported frame takes 2 bytes at least,
    # so the file's size bounds its frames
    cap = os.path.getsize(path) // 2
    out = np.empty(cap, dtype=np.float32)
    sr = ctypes.c_int()
    n = lib.sv_wav_read(str(path).encode(), out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), cap, ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"{path}: sv_wav_read error {n}")
    return out[:n], sr.value


def read_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """Decode a WAV file → ``(mono float32 array, sample_rate)``: the
    native decoder, or the NumPy parser where it is not built or refuses
    the file (which raises ``ValueError`` on a malformed one)."""
    if _load_native() is not None:
        try:
            return read_wav_native(path)
        except ValueError:
            pass
    return _read_wav_python(path)


def _parse_wav(raw: bytes, header_only: bool = False):
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    while pos + 8 <= len(raw):
        tag = raw[pos:pos + 4]
        size = struct.unpack_from("<I", raw, pos + 4)[0]
        body = pos + 8
        if tag == b"fmt ":
            if body + 16 > len(raw):
                raise ValueError("truncated fmt chunk")
            audio_format, channels, sample_rate = struct.unpack_from(
                "<HHI", raw, body)
            bits = struct.unpack_from("<H", raw, body + 14)[0]
            if audio_format == 0xFFFE and size >= 40 and body + 26 <= len(raw):
                # WAVE_FORMAT_EXTENSIBLE: the sub-format GUID's first bytes
                audio_format = struct.unpack_from("<H", raw, body + 24)[0]
            fmt = (audio_format, channels, sample_rate, bits)
        elif tag == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt chunk")
            audio_format, channels, sample_rate, bits = fmt
            frame_bytes = channels * (bits // 8)
            if frame_bytes == 0:
                raise ValueError(
                    f"invalid WAV format: channels={channels} bits={bits}")
            # clamp a lying size to the bytes present, whole frames
            size = min(size, len(raw) - body)
            size -= size % frame_bytes
            if header_only:
                return sample_rate, size // frame_bytes, channels, bits
            return fmt, raw[body:body + size]
        pos = body + size + (size & 1)
    raise ValueError("no data chunk found")


def _read_wav_python(path: str | Path) -> Tuple[np.ndarray, int]:
    """:func:`read_wav` by the NumPy parser alone, bit for bit with the
    native decoder: each frame's channels are summed in order from 0, in
    float64 for float64 files and float32 otherwise, then multiplied by
    float32(1/channels) and rounded to float32 once."""
    return _decode_wav(Path(path).read_bytes())


def _decode_wav(raw: bytes) -> Tuple[np.ndarray, int]:
    """:func:`_read_wav_python` of a file's bytes already in memory."""
    fmt, data = _parse_wav(raw)
    audio_format, channels, sample_rate, bits = fmt
    if audio_format == 1 and bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 24:
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int8).astype(np.int32) << 16))
        x = x.astype(np.float32) / 8388608.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 3 and bits == 32:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif audio_format == 3 and bits == 64:
        x = np.frombuffer(data, dtype="<f8").astype(np.float64)
    else:
        raise ValueError(f"unsupported WAV format={audio_format} bits={bits}")
    x = x.reshape(-1, channels)
    acc = np.zeros(x.shape[0], x.dtype)
    for c in range(channels):
        acc += x[:, c]
    acc *= x.dtype.type(np.float32(1.0) / np.float32(channels))
    return np.ascontiguousarray(acc, dtype=np.float32), sample_rate


def write_wav(path: str | Path, audio: np.ndarray, sample_rate: int,
              subtype: str = "PCM_16") -> None:
    """Write float audio ``[T]`` or ``[T, channels]`` as ``PCM_16`` or
    ``FLOAT``."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    channels = audio.shape[1]
    if subtype == "PCM_16":
        payload = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        bits, audio_format = 16, 1
    elif subtype == "FLOAT":
        payload = audio.astype("<f4").tobytes()
        bits, audio_format = 32, 3
    else:
        raise ValueError(f"unsupported subtype {subtype!r}")
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    header = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, audio_format, channels,
                                    sample_rate, byte_rate, block_align, bits)
    header += b"data" + struct.pack("<I", len(payload))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(header + payload)
