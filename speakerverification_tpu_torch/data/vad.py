"""Voice activity detection (port of ``data/vad.py``): a per-frame voiced
decision and the webrtc-style ring-buffer collector.

30 ms frames and a 300 ms padding window: the collector triggers when
more than 90 % of the buffered frames are voiced and de-triggers when
more than 90 % are unvoiced; the voiced segments are concatenated and
written as ``*_vad.wav``. The frame decision is ``webrtcvad``'s where
that package is importable; otherwise an energy + zero-crossing
classifier over an adaptive noise floor (the quietest 10 % of frames).
"""

from __future__ import annotations

from collections import deque
from pathlib import Path
from typing import List, Tuple

import numpy as np

from speakerverification_tpu_torch.data.wavio import read_wav, write_wav

__all__ = ["VAD"]


class VAD:
    def __init__(self, mode: int = 3, frame_duration: int = 30,
                 win_length: int = 300, use_webrtcvad: bool = True):
        """``mode`` 0-3 sets the aggressiveness (3 the most)."""
        self.mode = mode
        self.frame_duration = frame_duration       # ms
        self.win_length = win_length                # ms of padding window
        self._webrtc = None
        if use_webrtcvad:
            try:
                import webrtcvad
                self._webrtc = webrtcvad.Vad(mode)
            except ImportError:
                pass                                # energy + ZCR

    def _frame_decisions(self, audio: np.ndarray, sample_rate: int,
                         ) -> Tuple[np.ndarray, int]:
        n = int(sample_rate * self.frame_duration / 1000)
        n_frames = len(audio) // n
        frames = audio[:n_frames * n].reshape(n_frames, n)

        if self._webrtc is not None:
            pcm = np.clip(frames * 32768.0, -32768, 32767).astype("<i2")
            voiced = np.asarray([
                self._webrtc.is_speech(pcm[i].tobytes(), sample_rate)
                for i in range(n_frames)])
            return voiced, n

        energy = np.sqrt(np.mean(frames ** 2, axis=1) + 1e-12)
        zcr = np.mean(np.abs(np.diff(np.signbit(frames), axis=1)), axis=1)
        floor = np.percentile(energy, 10)
        # aggressiveness raises the energy margin over the floor
        margin = {0: 2.0, 1: 3.0, 2: 4.0, 3: 6.0}[self.mode]
        voiced = (energy > floor * margin) & (zcr < 0.35)
        return voiced, n

    def collect_segments(self, audio: np.ndarray, sample_rate: int,
                         ) -> List[np.ndarray]:
        """The voiced segments of ``audio``, in order."""
        voiced, n = self._frame_decisions(audio, sample_rate)
        num_padding = max(int(self.win_length / self.frame_duration), 1)
        ring: deque = deque(maxlen=num_padding)
        triggered = False
        segments: List[np.ndarray] = []
        current: List[np.ndarray] = []

        for i, is_speech in enumerate(voiced):
            frame = audio[i * n:(i + 1) * n]
            if not triggered:
                ring.append((frame, is_speech))
                if sum(1 for _, s in ring if s) > 0.9 * ring.maxlen:
                    triggered = True
                    current = [f for f, _ in ring]
                    ring.clear()
            else:
                current.append(frame)
                ring.append((frame, is_speech))
                if sum(1 for _, s in ring if not s) > 0.9 * ring.maxlen:
                    triggered = False
                    segments.append(np.concatenate(current))
                    current = []
                    ring.clear()
        if triggered and current:
            segments.append(np.concatenate(current))
        return segments

    def apply_to_file(self, path: str | Path,
                      out_path: str | Path | None = None) -> Path | None:
        """Write the concatenated voiced audio as ``*_vad.wav`` (or
        ``out_path``); None for a file with no voiced segment."""
        audio, sr = read_wav(path)
        segments = self.collect_segments(audio, sr)
        if not segments:
            return None
        out_path = Path(out_path) if out_path else \
            Path(str(Path(path).with_suffix("")) + "_vad.wav")
        write_wav(out_path, np.concatenate(segments), sr)
        return out_path
