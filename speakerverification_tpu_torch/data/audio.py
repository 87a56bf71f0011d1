"""Audio crop loading (port of ``data/audio.py``'s ``load_wav``):

* short audio is pad-wrapped to ``sentence_len * sr + 1`` samples;
* eval mode: ``num_eval`` crops at ``linspace(0, size - max_audio)``
  offsets are stacked ``[num_eval, T]``; ``num_eval == 0`` → the whole
  file;
* train mode: one crop at a random offset drawn from ``rng`` (a
  ``numpy.random.Generator``), or at 0 when ``random_chunk`` is off;
* ``load_all``: the whole signal ``[1, T]``, uncropped (impulse
  responses are read so).

WAV files are read with the standard library's ``wave`` module, 16-bit
PCM only, scaled by 1/32768 and averaged to mono; :func:`write_wav`
writes them the same way.
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Mapping, Optional, Union

import numpy as np

__all__ = ["AudioSpec", "load_wav", "normalize_amplitude", "read_wav",
           "write_wav"]

DEFAULT_SPEC = {"sample_rate": 8000, "channels": 1, "sentence_len": 2.0,
                "win_len": 0.025, "hop_len": 0.01}


class AudioSpec(dict):
    """The ``audio_spec`` mapping of the YAML schema."""

    def __init__(self, mapping: Optional[Mapping] = None, **kw):
        super().__init__(DEFAULT_SPEC)
        if mapping:
            self.update(mapping)
        self.update(kw)

    @property
    def sample_rate(self) -> int:
        return int(self["sample_rate"])

    @property
    def max_audio(self) -> int:
        return int(self["sentence_len"] * self["sample_rate"])


def normalize_amplitude(audio: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Peak-normalize to 1."""
    peak = np.max(np.abs(audio))
    return (audio / max(peak, eps)).astype(np.float32)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a 16-bit PCM WAV file → (mono float32 array, sample_rate)."""
    with wave.open(str(path), "rb") as f:
        if f.getsampwidth() != 2 or f.getcomptype() != "NONE":
            raise ValueError(f"{path}: only 16-bit PCM WAV is supported")
        channels, sr = f.getnchannels(), f.getframerate()
        data = f.readframes(f.getnframes())
    x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), sr


def write_wav(path: Union[str, Path], audio: np.ndarray,
              sample_rate: int) -> None:
    """Write float audio ``[T]`` or ``[T, channels]`` in [-1, 1] as 16-bit
    PCM (``x * 32767``, truncated, as the JAX package writes it)."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(audio.shape[1])
        f.setsampwidth(2)
        f.setframerate(int(sample_rate))
        f.writeframes((np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")
                      .tobytes())


def load_wav(source: Union[str, np.ndarray], spec: Optional[Mapping] = None,
             num_eval: int = 10, *, evalmode: bool = True,
             random_chunk: bool = True, load_all: bool = False,
             rng: Optional[np.random.Generator] = None,
             normalize: bool = True) -> np.ndarray:
    """Load audio and cut its crops: eval mode ``[num_eval, T]`` float32,
    or ``[1, whole]`` for ``num_eval == 0`` or ``load_all``; train mode
    ``[1, T]``. A WAV path must match the configured sample rate; an
    ndarray source is peak-normalized unless ``normalize`` is off (the
    training loader's re-crop after a time-domain augmentation keeps its
    volume gain so)."""
    spec = AudioSpec(spec)

    if isinstance(source, str):
        audio, sr = read_wav(source)
        if sr != spec.sample_rate:
            raise ValueError(
                f"{source}: sample rate {sr} != configured {spec.sample_rate}")
    elif isinstance(source, np.ndarray):
        audio = normalize_amplitude(source) if normalize else \
            np.asarray(source, np.float32)
    else:
        raise TypeError(f"invalid audio source type {type(source)}")
    if load_all:
        return np.expand_dims(audio.astype(np.float32), 0)

    max_audio = spec.max_audio
    if audio.shape[0] <= max_audio:
        shortage = max_audio - audio.shape[0] + 1
        audio = np.pad(audio, (0, shortage), "wrap")
    if evalmode:
        if num_eval == 0:
            return np.expand_dims(audio.astype(np.float32), 0)
        starts = np.linspace(0, audio.shape[0] - max_audio, num=num_eval)
    elif random_chunk:
        rng = rng or np.random.default_rng()
        starts = np.array([int(rng.random() * (audio.shape[0] - max_audio))])
    else:
        starts = np.array([0])
    crops = [audio[int(s):int(s) + max_audio] for s in starts]
    return np.stack(crops, axis=0).astype(np.float32)
