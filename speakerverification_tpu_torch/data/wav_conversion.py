"""Waveform format conversion (port of ``data/wav_conversion.py``):
int16 PCM buffers to and from float, peak normalization, the ffmpeg
converter (optional: False where ffmpeg is missing or fails), and a
polyphase resampler for WAV to WAV (scipy).
"""

from __future__ import annotations

import subprocess
from fractions import Fraction
from pathlib import Path

import numpy as np
from scipy.signal import resample_poly

from speakerverification_tpu_torch.data.audio import normalize_amplitude
from speakerverification_tpu_torch.data.wavio import read_wav, write_wav

__all__ = ["np_to_pcm16", "pcm16_to_np", "normalize_audio_amp",
           "convert_audio_shell", "resample_file"]


def np_to_pcm16(audio: np.ndarray) -> np.ndarray:
    """float [-1, 1] → int16 (``x · 32767``, clipped, truncated)."""
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)


def pcm16_to_np(pcm: np.ndarray, normalize: bool = True) -> np.ndarray:
    """int16 → float32, scaled by 1/32768 when ``normalize``."""
    x = pcm.astype(np.float32)
    return x / 32768.0 if normalize else x


def normalize_audio_amp(audio: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Peak normalization to 1."""
    return normalize_amplitude(audio, eps)


def convert_audio_shell(src: str | Path, dst: str | Path,
                        sample_rate: int = 8000, channels: int = 1,
                        codec: str = "pcm_s16le") -> bool:
    """Convert with ffmpeg (sample rate, channels, codec); False when
    ffmpeg is missing or fails."""
    cmd = ["ffmpeg", "-y", "-i", str(src), "-ar", str(sample_rate),
           "-ac", str(channels), "-acodec", codec, str(dst)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def resample_file(src: str | Path, dst: str | Path, sample_rate: int,
                  ) -> Path:
    """Resample a WAV to ``sample_rate`` by polyphase filtering and write
    it as 16-bit PCM."""
    audio, sr = read_wav(src)
    if sr != sample_rate:
        frac = Fraction(sample_rate, sr).limit_denominator(1000)
        audio = resample_poly(audio, frac.numerator, frac.denominator)
    write_wav(dst, audio.astype(np.float32), sample_rate)
    return Path(dst)
