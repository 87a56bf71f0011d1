"""Host-side waveform augmentation (port of ``data/augment.py``): MUSAN/RIR
``env_corrupt`` and the time-domain chain.

* ``additive_noise``: 1..k files of a category, each mixed at an SNR
  drawn from the category's range, with the gain
  ``sqrt(10^((clean_db − noise_db − snr)/10))`` and dB
  ``10·log10(mean(x²) + 1e-4)``;
* ``reverberate``: an energy-normalized simulated RIR, the full
  convolution (by FFT) cut to the crop's length;
* ``env_corrupt``: rev / noise / both / none with p = .2/.4/.2/.2, a
  coin flip ordering 'both';
* the time domain: speed (polyphase resampling), volume (a gain in
  ±dB) or pitch (``ops/phase_vocoder.py``, in 0.05-semitone steps).

Every draw comes from the ``numpy.random.Generator`` the caller passes,
call for call as the JAX package draws, so the same generator and files
give the same bytes (pitch aside, which its vocoder computes in float64).
The corpus layout is MUSAN's and RIRS_NOISES': ``<musan>/{noise,speech,
music}/*/*/*.wav``, ``<noise_vad>/*/*.wav``, ``<rirs>/{pointsource_noises,
real_rirs_isotropic_noises}/*.wav`` (category ``noise_rirs``) and the
impulse responses ``<rirs>/simulated_rirs/*/*/*.wav``.
"""

from __future__ import annotations

import glob
import os
from fractions import Fraction
from typing import Mapping

import numpy as np
from scipy import signal as sps

from speakerverification_tpu_torch.data.audio import AudioSpec, load_wav
from speakerverification_tpu_torch.ops.phase_vocoder import pitch_shift

__all__ = ["AugmentWav", "random_time_domain_augment", "augment_speed",
           "augment_volume", "augment_pitch", "NOISE_CATEGORIES"]

ENV_CORRUPT_TYPES = ["rev", "noise", "both", "none"]
ENV_CORRUPT_PROBS = [0.2, 0.4, 0.2, 0.2]
NOISE_CATEGORIES = ["noise", "speech", "music", "noise_vad", "noise_rirs"]


class AugmentWav:
    """The noise and RIR file lists of ``augment_options`` and the
    corruptions that read them. The object holds no generator: each
    method draws from the one its caller passes, which the training
    loader makes per tuple, so one object serves all its worker
    threads."""

    def __init__(self, augment_options: Mapping, audio_spec: Mapping):
        self.options = augment_options
        self.spec = AudioSpec(audio_spec)
        self.max_audio = self.spec.max_audio

        paths = augment_options["augment_paths"]
        self.noise_snr = dict(augment_options["noise_snr"])
        self.num_noise = dict(augment_options["noise_samples"])
        self.noise_proportion = list(augment_options.get(
            "noise_proportion", [0.2, 0.1, 0.2, 0.25, 0.25]))

        self.noiselist: dict[str, list[str]] = {}
        musan = glob.glob(os.path.join(paths.get("musan", ""), "*/*/*/*.wav"))
        for f in musan:
            cat = f.split("/")[-4]
            if cat in ("noise", "speech", "music"):
                self.noiselist.setdefault(cat, []).append(f)
        for f in glob.glob(os.path.join(paths.get("noise_vad", ""), "*/*.wav")):
            self.noiselist.setdefault("noise_vad", []).append(f)
        rirs = paths.get("rirs", "")
        for f in (glob.glob(os.path.join(rirs, "pointsource_noises", "*.wav"))
                  + glob.glob(os.path.join(rirs, "real_rirs_isotropic_noises",
                                           "*.wav"))):
            self.noiselist.setdefault("noise_rirs", []).append(f)
        self.reverberation_files = glob.glob(
            os.path.join(rirs, "simulated_rirs", "*/*/*.wav"))

    @property
    def has_noise(self) -> bool:
        return any(self.noiselist.values())

    @property
    def has_reverb(self) -> bool:
        return bool(self.reverberation_files)

    def additive_noise(self, category: str, audio: np.ndarray,
                       rng: np.random.Generator) -> np.ndarray:
        """``audio [1, T]`` plus 1..k of the category's files, each at its
        own SNR."""
        clean_db = 10 * np.log10(np.mean(audio ** 2) + 1e-4)
        lo, hi = self.num_noise[category]
        files = list(self.noiselist[category])
        k = min(int(rng.integers(lo, hi + 1)), len(files))
        chosen = rng.choice(len(files), size=k, replace=False)

        noises = []
        for i in chosen:
            noise = load_wav(files[int(i)], self.spec, evalmode=False,
                             rng=rng)
            snr = rng.uniform(*self.noise_snr[category])
            noise_db = 10 * np.log10(np.mean(noise[0] ** 2) + 1e-4)
            gain = np.sqrt(10 ** ((clean_db - noise_db - snr) / 10))
            noises.append(gain * noise)
        if not noises:
            return audio
        return np.sum(np.concatenate(noises, axis=0), axis=0,
                      keepdims=True) + audio

    def reverberate(self, audio: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
        """The full convolution of ``audio [1, T]`` with a random
        energy-normalized RIR, cut to the crop's length."""
        rir_file = self.reverberation_files[
            int(rng.integers(len(self.reverberation_files)))]
        rir = load_wav(rir_file, self.spec, load_all=True)
        rir = rir / np.sqrt(np.sum(rir ** 2))
        out = sps.fftconvolve(audio, rir, mode="full")[:, :self.max_audio]
        return out.astype(np.float32)

    def env_corrupt(self, audio: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
        """rev / noise / both / none at .2/.4/.2/.2; a missing kind of file
        falls back as the JAX package does."""
        augtype = rng.choice(ENV_CORRUPT_TYPES, p=ENV_CORRUPT_PROBS)
        if augtype == "none":
            return audio
        if augtype == "rev" and self.has_reverb:
            return self.reverberate(audio, rng)
        cats = [c for c in NOISE_CATEGORIES if self.noiselist.get(c)]
        if not cats:
            return self.reverberate(audio, rng) if self.has_reverb else audio
        probs = np.array([self.noise_proportion[NOISE_CATEGORIES.index(c)]
                          for c in cats])
        probs = probs / probs.sum()
        if augtype == "noise" or not self.has_reverb:
            cat = rng.choice(cats, p=probs)
            return self.additive_noise(cat, audio, rng)
        # both, in a random order
        cat = rng.choice(cats, p=probs)
        if rng.random() < 0.5:
            return self.additive_noise(cat, self.reverberate(audio, rng), rng)
        return self.reverberate(self.additive_noise(cat, audio, rng), rng)


# ---------------------------------------------------------------------------
# Time-domain augmentation (speed / volume / pitch)
# ---------------------------------------------------------------------------

def _resample_ratio(audio: np.ndarray, ratio: float) -> np.ndarray:
    frac = Fraction(ratio).limit_denominator(100)
    return sps.resample_poly(audio, frac.denominator, frac.numerator,
                             axis=-1).astype(np.float32)


def augment_speed(audio: np.ndarray, low: float, high: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Playback speed × U(low, high) by polyphase resampling (the length
    changes)."""
    speed = float(rng.uniform(low, high))
    return _resample_ratio(audio, speed)


def augment_volume(audio: np.ndarray, volume_db: float,
                   rng: np.random.Generator) -> np.ndarray:
    """A gain of U(−volume_db, volume_db) dB."""
    gain_db = float(rng.uniform(-volume_db, volume_db))
    return (audio * (10.0 ** (gain_db / 20.0))).astype(np.float32)


def augment_pitch(audio: np.ndarray, low: float, high: float,
                  rng: np.random.Generator) -> np.ndarray:
    """A pitch shift of U(low, high) semitones, rounded to 0.05-semitone
    steps as the JAX package rounds it (each of its steps is a compiled
    program), through the phase vocoder; the duration is kept."""
    semitones = round(float(rng.uniform(low, high)) / 0.05) * 0.05
    if abs(semitones) < 1e-6:
        return audio.astype(np.float32)
    flat = audio.reshape(-1, audio.shape[-1])
    out = np.stack([pitch_shift(row, semitones) for row in flat])
    return out.reshape(audio.shape).astype(np.float32)


def random_time_domain_augment(audio: np.ndarray, setting: Mapping,
                               rng: np.random.Generator) -> np.ndarray:
    """One of speed / pitch / volume / none, at ``setting['proportion']``
    (the rest of 1 for none)."""
    p = list(setting.get("proportion", [0.25, 0.25, 0.25]))
    if len(p) < 4:
        p = p + [1.0 - sum(p)]
    choice = rng.choice(["speed", "pitch", "volume", "none"], p=p)
    if choice == "speed":
        return augment_speed(audio, *setting.get("speed", (0.95, 1.05)), rng=rng)
    if choice == "pitch":
        return augment_pitch(audio, *setting.get("pitch", (-0.5, 0.5)), rng=rng)
    if choice == "volume":
        return augment_volume(audio, setting.get("volume", 4.0), rng=rng)
    return audio
