"""Plain PyTorch reference of the benchmarked models, written from the
published descriptions and the yamls' settings, independent of the
program: no kernel, no cache, no batching, no folded weights.

- ``MelFrontend``: pre-emphasis 0.97, centre reflect padding, a
  periodic Hamming window of ``win_length`` centred in ``n_fft``, a real
  FFT (``torch.fft.rfft``), the power spectrum and a Slaney mel
  filterbank.
- ``ECAPA``: ECAPA-TDNN (Desplanques et al., Interspeech 2020,
  arXiv:2005.07143): a TDNN, three SE-Res2Net blocks (dilations 2, 3,
  4), multi-layer feature aggregation, attentive statistics pooling with
  global context, BatchNorm and a linear layer. Convolutions reflect-pad
  to 'same' length, as SpeechBrain does.
- ``RawNet3``: Jung et al., Interspeech 2022 (arXiv:2203.08488):
  pre-emphasis and instance norm, a sinc filterbank (|.|, log, mean over
  time removed), three Bottle2necks and attentive pooling with context.
- ``Raw3ECAPA``: the two branches side by side, embeddings concatenated
  ``[ecapa, raw]`` (the repository's default model).
- ``AAMSoftmax`` (ArcFace) and ``adabelief_step`` (Zhuang et al.,
  NeurIPS 2020) for the training cell.

Module and parameter names follow the flax scope names that the
program's ``state_dict`` carries, so that one seeded state loads into
both. Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["MelFrontend", "ECAPA", "RawNet3", "Raw3ECAPA", "Encoder",
           "AAMSoftmax", "adabelief_step", "build_reference", "no_tf32"]


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Full fp32 matrix products and convolutions (no TF32) inside, the
    process's settings restored after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = was


# ---------------------------------------------------------------------------
# mel features
# ---------------------------------------------------------------------------

def _hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz, logstep = 1000.0, math.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_hz / f_sp
                    + np.log(np.maximum(freq, min_log_hz) / min_log_hz)
                    / logstep,
                    freq / f_sp)


def _mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz, logstep = 1000.0, math.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    f_sp * mels)


def slaney_mel_bank(n_freqs: int, n_mels: int, sample_rate: int,
                    fmin: float, fmax: Optional[float]) -> np.ndarray:
    """Triangular Slaney-normalized filters ``[n_freqs, n_mels]``."""
    fmax = sample_rate / 2.0 if fmax is None else fmax
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[None, :-1]
    up = slopes[:, 2:] / diff[None, 1:]
    bank = np.maximum(0.0, np.minimum(down, up))
    bank *= (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return bank.astype(np.float32)


def pre_emphasis(x: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """``y[t] = x[t] - coef x[t-1]``, with ``x[-1]`` read as ``x[1]``."""
    prev = torch.cat([x[..., 1:2], x[..., :-1]], dim=-1)
    return x - coef * prev


class MelFrontend(nn.Module):
    """``wave [B, T] -> mel power [B, 1 + T // hop, n_mels]``."""

    def __init__(self, sample_rate: int, n_fft: int, win_length: int,
                 hop_length: int, n_mels: int, fmin: float = 0.0,
                 fmax: Optional[float] = None):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop_length
        k = np.arange(win_length + 1, dtype=np.float64)
        hamming = (0.54 - 0.46 * np.cos(2 * np.pi * k / win_length))
        window = np.zeros(n_fft)
        left = (n_fft - win_length) // 2
        window[left:left + win_length] = hamming[:win_length]
        self.register_buffer("window", torch.tensor(window, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("bank", torch.from_numpy(slaney_mel_bank(
            n_fft // 2 + 1, n_mels, sample_rate, fmin, fmax)), persistent=False)

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        x = pre_emphasis(wave.float())
        x = F.pad(x[:, None], (self.n_fft // 2, self.n_fft // 2),
                  mode="reflect")[:, 0]
        frames = x.unfold(-1, self.n_fft, self.hop) * self.window
        spec = torch.fft.rfft(frames, n=self.n_fft, dim=-1)
        power = spec.real.square() + spec.imag.square()
        return power @ self.bank


# ---------------------------------------------------------------------------
# shared layers
# ---------------------------------------------------------------------------

def bn(features: int) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(features, eps=1e-5, momentum=0.1)


class Conv1d(nn.Module):
    """'Same'-length conv, reflect-padded where the kernel spans > 1."""

    def __init__(self, cin: int, cout: int, k: int = 1, dilation: int = 1):
        super().__init__()
        self.pad = dilation * (k - 1)
        self.Conv_0 = nn.Conv1d(cin, cout, k, dilation=dilation)

    def forward(self, x):
        if self.pad:
            x = F.pad(x, (self.pad // 2, self.pad - self.pad // 2),
                      mode="reflect")
        return self.Conv_0(x)


class BatchNorm1d(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.BatchNorm_0 = bn(features)

    def forward(self, x):
        return self.BatchNorm_0(x)


class TDNNBlock(nn.Module):
    def __init__(self, cin, cout, k, dilation=1, act=F.gelu):
        super().__init__()
        self.act = act
        self.Conv1d_0 = Conv1d(cin, cout, k, dilation)
        self.BatchNorm1d_0 = BatchNorm1d(cout)

    def forward(self, x):
        return self.BatchNorm1d_0(self.act(self.Conv1d_0(x)))


class Res2NetBlock(nn.Module):
    def __init__(self, features, scale, k, dilation):
        super().__init__()
        self.scale = scale
        for j in range(scale - 1):
            self.add_module(f"TDNNBlock_{j}", TDNNBlock(
                features // scale, features // scale, k, dilation, torch.relu))

    def forward(self, x):
        chunks = torch.chunk(x, self.scale, dim=1)
        out, y = [chunks[0]], None
        for i in range(1, self.scale):
            y = getattr(self, f"TDNNBlock_{i - 1}")(
                chunks[i] if i == 1 else chunks[i] + y)
            out.append(y)
        return torch.cat(out, dim=1)


class SEBlock(nn.Module):
    def __init__(self, cin, se, cout):
        super().__init__()
        self.Conv1d_0 = Conv1d(cin, se, 1)
        self.Conv1d_1 = Conv1d(se, cout, 1)

    def forward(self, x):
        s = torch.relu(self.Conv1d_0(x.mean(dim=2, keepdim=True)))
        return torch.sigmoid(self.Conv1d_1(s)) * x


class SERes2NetBlock(nn.Module):
    def __init__(self, cin, cout, scale, se, k, dilation):
        super().__init__()
        if cin != cout:
            self.Conv1d_0 = Conv1d(cin, cout, 1)
        self.TDNNBlock_0 = TDNNBlock(cin, cout, 1)
        self.Res2NetBlock_0 = Res2NetBlock(cout, scale, k, dilation)
        self.TDNNBlock_1 = TDNNBlock(cout, cout, 1)
        self.SEBlock_0 = SEBlock(cout, se, cout)

    def forward(self, x):
        res = self.Conv1d_0(x) if hasattr(self, "Conv1d_0") else x
        x = self.TDNNBlock_1(self.Res2NetBlock_0(self.TDNNBlock_0(x)))
        return self.SEBlock_0(x) + res


class AttentiveStatisticsPooling(nn.Module):
    """Attention over ``[x ; mean ; std]`` (global context), then the
    attention-weighted mean and std: ``[B, C, L] -> [B, 2C]``."""

    def __init__(self, channels, attention):
        super().__init__()
        self.TDNNBlock_0 = TDNNBlock(3 * channels, attention, 1,
                                     act=torch.relu)
        self.Conv1d_0 = Conv1d(attention, channels, 1)

    @staticmethod
    def _stats(x, w):
        mean = (w * x).sum(dim=2)
        var = (w * (x - mean[:, :, None]) ** 2).sum(dim=2)
        return mean, torch.sqrt(torch.clamp(var, min=1e-12))

    def forward(self, x):
        L = x.shape[2]
        mean, std = self._stats(x, torch.full_like(x[:, :1], 1.0 / L))
        ctx = torch.cat([x, mean[:, :, None].expand_as(x),
                         std[:, :, None].expand_as(x)], dim=1)
        attn = self.Conv1d_0(torch.tanh(self.TDNNBlock_0(ctx)))
        mean, std = self._stats(x, torch.softmax(attn, dim=2))
        return torch.cat([mean, std], dim=1)


class ECAPA(nn.Module):
    """Features ``[B, frames, n_mels]`` -> ``[B, lin_neurons]``."""

    def __init__(self, n_mels: int, lin_neurons: int,
                 channels: Sequence[int], kernel_sizes: Sequence[int],
                 dilations: Sequence[int], attention_channels: int,
                 res2net_scale: int, se_channels: int,
                 log_input: bool, input_norm: bool):
        super().__init__()
        self.log_input, self.input_norm = log_input, input_norm
        if input_norm:
            self.input_norm_scale = nn.Parameter(torch.ones(n_mels))
            self.input_norm_bias = nn.Parameter(torch.zeros(n_mels))
        self.TDNNBlock_0 = TDNNBlock(n_mels, channels[0], kernel_sizes[0],
                                     dilations[0])
        self.n_blocks = len(channels) - 2
        for i in range(1, len(channels) - 1):
            self.add_module(f"SERes2NetBlock_{i - 1}", SERes2NetBlock(
                channels[i - 1], channels[i], res2net_scale, se_channels,
                kernel_sizes[i], dilations[i]))
        self.TDNNBlock_1 = TDNNBlock(sum(channels[1:-1]), channels[-1],
                                     kernel_sizes[-1], dilations[-1])
        self.AttentiveStatisticsPooling_0 = AttentiveStatisticsPooling(
            channels[-1], attention_channels)
        self.BatchNorm1d_0 = BatchNorm1d(2 * channels[-1])
        self.Dense_0 = nn.Linear(2 * channels[-1], lin_neurons)

    def forward(self, x):
        if self.log_input:
            x = torch.log(torch.clamp(x, min=0.0) + 1e-6)
            x = x - x.mean(dim=1, keepdim=True)
        if self.input_norm:
            mean = x.mean(dim=1, keepdim=True)
            var = x.var(dim=1, unbiased=False, keepdim=True)
            x = ((x - mean) / torch.sqrt(var + 1e-5) * self.input_norm_scale
                 + self.input_norm_bias)
        x = self.TDNNBlock_0(x.transpose(1, 2))
        outs = []
        for i in range(self.n_blocks):
            x = getattr(self, f"SERes2NetBlock_{i}")(x)
            outs.append(x)
        x = self.AttentiveStatisticsPooling_0(
            self.TDNNBlock_1(torch.cat(outs, dim=1)))
        return self.Dense_0(self.BatchNorm1d_0(x))


# ---------------------------------------------------------------------------
# RawNet3
# ---------------------------------------------------------------------------

class SincConv(nn.Module):
    """Mel-initialized sinc band-passes on a 16 kHz grid with a half
    Hamming window, applied as a VALID strided conv."""

    def __init__(self, channels: int, kernel_size: int, stride: int,
                 sample_rate: int = 16000, min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0, init_low_hz: float = 30.0):
        super().__init__()
        self.k, self.stride, self.sr = kernel_size, stride, sample_rate
        self.min_low, self.min_band = min_low_hz, min_band_hz
        high = sample_rate / 2.0 - (min_low_hz + min_band_hz)
        mel = np.linspace(2595.0 * np.log10(1.0 + init_low_hz / 700.0),
                          2595.0 * np.log10(1.0 + high / 700.0), channels + 1)
        hz = 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
        self.low_hz = nn.Parameter(torch.tensor(hz[:-1], dtype=torch.float32))
        self.band_hz = nn.Parameter(torch.tensor(np.diff(hz),
                                                 dtype=torch.float32))

    def filters(self):
        low = self.min_low + self.low_hz.float().abs()
        high = torch.clamp(low + self.min_band + self.band_hz.float().abs(),
                           self.min_low, self.sr / 2.0)
        band = (high - low)[:, None]
        half = (self.k - 1) // 2
        dev = low.device
        n = 2.0 * math.pi * torch.arange(-half, 0, dtype=torch.float32,
                                         device=dev) / self.sr
        grid = torch.arange(half, dtype=torch.float32, device=dev)
        window = 0.54 - 0.46 * torch.cos(2.0 * math.pi * grid / self.k)
        left = (torch.sin(high[:, None] * n) - torch.sin(low[:, None] * n)) \
            / (n / 2.0) * window
        return torch.cat([left, 2.0 * band, left.flip(1)], dim=1) / (2.0 * band)

    def forward(self, x):
        return F.conv1d(x[:, None], self.filters().to(x.dtype)[:, None],
                        stride=self.stride)


class AFMS(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.Dense_0 = nn.Linear(features, features)
        self.alpha = nn.Parameter(torch.ones(features))

    def forward(self, x):
        y = torch.sigmoid(self.Dense_0(x.mean(dim=2)))
        return (x + self.alpha[:, None]) * y[:, :, None]


class Bottle2neckRaw(nn.Module):
    """ReLU before BN, zero-padded k-tap convs over groups that accumulate
    ``sp + chunk``, the last group passed through, AFMS."""

    def __init__(self, cin, planes, k, dilation, scale, pool=None):
        super().__init__()
        self.scale, self.pool = scale, pool
        width = planes // scale
        o = 0
        self.residual_conv = cin != planes
        if self.residual_conv:
            self.Conv_0 = nn.Conv1d(cin, planes, 1, bias=False)
            o = 1
        pad = dilation * (k - 1) // 2
        convs = ([nn.Conv1d(cin, width * scale, 1)]
                 + [nn.Conv1d(width, width, k, dilation=dilation, padding=pad)
                    for _ in range(scale - 1)]
                 + [nn.Conv1d(width * scale, planes, 1)])
        bns = [bn(width * scale)] + [bn(width) for _ in range(scale - 1)] \
            + [bn(planes)]
        self.convs = [f"Conv_{o + i}" for i in range(scale + 1)]
        self.bns = [f"BatchNorm_{i}" for i in range(scale + 1)]
        for name, m in zip(self.convs + self.bns, convs + bns):
            self.add_module(name, m)
        self.AFMS_0 = AFMS(planes)

    def forward(self, x):
        conv = [getattr(self, n) for n in self.convs]
        norm = [getattr(self, n) for n in self.bns]
        res = self.Conv_0(x) if self.residual_conv else x
        chunks = torch.chunk(norm[0](torch.relu(conv[0](x))), self.scale, 1)
        outs, sp = [], None
        for i in range(self.scale - 1):
            sp = chunks[i] if i == 0 else sp + chunks[i]
            sp = norm[1 + i](torch.relu(conv[1 + i](sp)))
            outs.append(sp)
        outs.append(chunks[-1])
        out = norm[-1](torch.relu(conv[-1](torch.cat(outs, 1)))) + res
        if self.pool:
            out = F.max_pool1d(out, self.pool, self.pool)
        return self.AFMS_0(out)


class RawNet3(nn.Module):
    """Raw wave ``[B, T]`` -> ``[B, nOut]``."""

    def __init__(self, nOut: int, C: int, scale: int, sinc_stride: int,
                 context_dim: int = 1536):
        super().__init__()
        self.inorm_scale = nn.Parameter(torch.ones(1))
        self.inorm_bias = nn.Parameter(torch.zeros(1))
        self.SincConv_0 = SincConv(C // 4, 251, sinc_stride)
        self.Bottle2neckRaw_0 = Bottle2neckRaw(C // 4, C, 3, 2, scale, pool=5)
        self.Bottle2neckRaw_1 = Bottle2neckRaw(C, C, 3, 3, scale, pool=3)
        self.Bottle2neckRaw_2 = Bottle2neckRaw(C, C, 3, 4, scale)
        self.Conv_0 = nn.Conv1d(3 * C, context_dim, 1)
        self.Conv_1 = nn.Conv1d(3 * context_dim, 128, 1)
        self.BatchNorm_0 = bn(128)
        self.Conv_2 = nn.Conv1d(128, 1, 1)
        self.BatchNorm_1 = bn(2 * context_dim)
        self.Dense_0 = nn.Linear(2 * context_dim, nOut)

    def forward(self, x):
        x = pre_emphasis(x.float())
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        x = (x - mean) / torch.sqrt(var + 1e-4) * self.inorm_scale \
            + self.inorm_bias
        x = torch.log(self.SincConv_0(x).abs() + 1e-6)
        x = x - x.mean(dim=2, keepdim=True)
        x1 = self.Bottle2neckRaw_0(x)
        x2 = self.Bottle2neckRaw_1(x1)
        p1 = F.max_pool1d(x1, 3, 3)
        x3 = self.Bottle2neckRaw_2(p1 + x2)
        L = min(p1.shape[2], x2.shape[2], x3.shape[2])
        x = torch.relu(self.Conv_0(torch.cat(
            [p1[..., :L], x2[..., :L], x3[..., :L]], dim=1)))
        mu = x.mean(dim=2, keepdim=True)
        sg = torch.sqrt(torch.clamp(x.var(dim=2, keepdim=True), 1e-4, 1e4))
        glob = torch.cat([x, mu.expand_as(x), sg.expand_as(x)], dim=1)
        attn = self.BatchNorm_0(torch.relu(self.Conv_1(glob)))
        w = torch.softmax(self.Conv_2(attn), dim=2)
        mu = (x * w).sum(dim=2)
        sg = torch.sqrt(torch.clamp((x * x * w).sum(dim=2) - mu * mu,
                                    1e-4, 1e4))
        return self.Dense_0(self.BatchNorm_1(torch.cat([mu, sg], dim=1)))


class Raw3ECAPA(nn.Module):
    """``[ECAPA-192 on mel ; RawNet3 on the wave]``."""

    def __init__(self, frontend: MelFrontend, ecapa: ECAPA, raw: RawNet3):
        super().__init__()
        self.frontend = frontend
        self.ecapa = ecapa
        self.raw_branch = raw

    def forward(self, wave):
        return torch.cat([self.ecapa(self.frontend(wave)),
                          self.raw_branch(wave.float())], dim=-1)


class MelECAPA(ECAPA):
    """ECAPA-TDNN on the frontend's mel features of the wave (the
    frontend holds no parameter, so the state is ECAPA's)."""

    def __init__(self, frontend: MelFrontend, **kwargs):
        super().__init__(**kwargs)
        self.frontend = frontend

    def forward(self, wave):
        return super().forward(self.frontend(wave))


# ---------------------------------------------------------------------------
# head and optimizer
# ---------------------------------------------------------------------------

class AAMSoftmax(nn.Module):
    """ArcFace: ``s cos(theta + m)`` at the label, monotonic past
    ``cos(pi - m)``; mean cross-entropy."""

    def __init__(self, n_out: int, n_classes: int, margin: float,
                 scale: float):
        super().__init__()
        self.margin, self.scale = margin, scale
        self.weight = nn.Parameter(torch.empty(n_classes, n_out))

    def forward(self, emb, label):
        cosine = F.normalize(emb, dim=-1) @ F.normalize(self.weight, dim=-1).T
        m = self.margin
        sine = torch.sqrt(torch.clamp(1.0 - cosine * cosine, 0.0, 1.0))
        phi = cosine * math.cos(m) - sine * math.sin(m)
        phi = torch.where(cosine - math.cos(math.pi - m) > 0, phi,
                          cosine - math.sin(math.pi - m) * m)
        one_hot = F.one_hot(label, cosine.shape[1]).to(cosine.dtype)
        logits = self.scale * (one_hot * phi + (1.0 - one_hot) * cosine)
        return F.cross_entropy(logits.float(), label)


class Encoder(nn.Module):
    """The state-dict layout of the program's ``SpeakerEncoder``: the
    model under ``backbone``, the head under ``loss``."""

    def __init__(self, backbone: nn.Module, loss: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        if loss is not None:
            self.loss = loss

    def embed(self, wave):
        """L2-normalized embeddings of ``wave [B, T]``."""
        return F.normalize(self.backbone(wave).float(), dim=-1)

    def loss_of(self, wave, label):
        """``wave [B, n_per, T]``, ``label [B]``: the head's mean loss."""
        n_per = wave.shape[1]
        emb = self.backbone(wave.reshape(-1, wave.shape[-1]))
        return self.loss(emb.float(), label.repeat_interleave(n_per))


@torch.no_grad()
def adabelief_step(params: dict, grads: dict, state: dict, lr: float,
                   weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> None:
    """One AdaBelief update in place: L2 weight decay added to the
    gradient, ``s = b2 s + (1 - b2)(g - m)^2 + eps``, bias-corrected
    ``m / (sqrt(s_hat) + eps)``."""
    t = state["t"] = state.get("t", 0) + 1
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    for k, p in params.items():
        g = grads[k] + weight_decay * p
        m = state.setdefault(("m", k), torch.zeros_like(p))
        s = state.setdefault(("s", k), torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        s.mul_(b2).add_((g - m).square(), alpha=1 - b2).add_(eps)
        p.sub_(lr / bc1 * m / (s.sqrt() / math.sqrt(bc2) + eps))


# ---------------------------------------------------------------------------
# building from a configuration file's sizes
# ---------------------------------------------------------------------------

def _frontend(h: dict) -> MelFrontend:
    spec = h["audio_spec"]
    sr = int(spec["sample_rate"])
    return MelFrontend(sr, int(h.get("n_fft", 512)),
                       round(spec["win_len"] * sr), round(spec["hop_len"] * sr),
                       int(h.get("n_mels", 80)), float(h.get("fmin", 0.0)),
                       h.get("fmax"))


def build_reference(h: dict, with_loss: bool = False) -> Encoder:
    """The reference of the configuration ``h`` (the program's hparams,
    as the configuration file holds them)."""
    model = dict(h["model"])
    name = model["name"]
    n_out = int(model["nOut"])
    n_mels = int(h.get("n_mels", 80))
    if name == "Raw3_ECAPA":
        ecapa = ECAPA(n_mels, 192, tuple(model.get("ecapa_channels",
                                                   (512, 512, 512, 512, 1536))),
                      (5, 3, 3, 3, 1), (1, 2, 3, 4, 1), 128, 8, 128,
                      log_input=False, input_norm=True)
        raw = RawNet3(n_out - 192, int(model.get("C", 1024)), 8, 10)
        backbone = Raw3ECAPA(_frontend(h), ecapa, raw)
    elif name == "ECAPA_TDNN":
        backbone = MelECAPA(
            _frontend(h), n_mels=n_mels, lin_neurons=n_out,
            channels=tuple(model.get("channels",
                                     (1024, 1024, 1024, 1024, 3072))),
            kernel_sizes=tuple(model.get("kernel_sizes", (5, 3, 3, 3, 1))),
            dilations=tuple(model.get("dilations", (1, 2, 3, 4, 1))),
            attention_channels=int(model.get("attention_channels", 128)),
            res2net_scale=int(model.get("res2net_scale", 8)),
            se_channels=int(model.get("se_channels", 128)),
            log_input=True, input_norm=False)
    else:
        raise KeyError(f"no reference for model {name!r}")
    loss = None
    if with_loss:
        crit = h["criterion"]
        if crit["name"] != "AAmSoftmax":
            raise KeyError(f"no reference for head {crit['name']!r}")
        loss = AAMSoftmax(n_out, int(h["nClasses"]), float(crit["margin"]),
                          float(crit["scale"]))
    return Encoder(backbone, loss)
