"""Audio crop loading (port of ``data/audio.py``'s ``load_wav``):

* short audio is pad-wrapped to ``sentence_len * sr + 1`` samples;
* eval mode: ``num_eval`` crops at ``linspace(0, size - max_audio)``
  offsets are stacked ``[num_eval, T]``; ``num_eval == 0`` → the whole
  file;
* train mode: one crop at a random offset drawn from ``rng`` (a
  ``numpy.random.Generator``), or at 0 when ``random_chunk`` is off;
* ``load_all``: the whole signal ``[1, T]``, uncropped (impulse
  responses are read so).

WAV files are read and written by ``data/wavio.py`` (the native decoder,
or its NumPy parser): PCM 16/24/32-bit and float, averaged to mono.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np

from speakerverification_tpu_torch.data.wavio import read_wav, write_wav

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


def load_wav(source: Union[str, np.ndarray], spec: Optional[Mapping] = None,
             num_eval: int = 10, *, evalmode: bool = True,
             random_chunk: bool = True, load_all: bool = False,
             rng: Optional[np.random.Generator] = None,
             normalize: bool = True) -> np.ndarray:
    """Load audio and cut its crops: eval mode ``[num_eval, T]`` float32,
    or ``[1, whole]`` for ``num_eval == 0`` or ``load_all``; train mode
    ``[1, T]``. A WAV path must match the configured sample rate; an
    ndarray source is peak-normalized unless ``normalize`` is off (the training loader's re-crop after a
    time-domain augmentation keeps its volume gain so)."""
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
