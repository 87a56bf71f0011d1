"""The augmentation applies on the card against the same applies on the
CPU with the same drawn numbers (``cuda`` marker: skips without a CUDA
device). No JAX here, so the GPU host runs it:

    python -m pytest --noconftest tests/test_torch_port_augment_cuda.py -q

cuFFT against the CPU's FFT at float32: 1e-5 of the output's largest
magnitude; SpecAugment's gathers and masks at 1e-6.
"""

import pytest
import torch

from speakerverification_tpu_torch.ops import device_augment as tda
from speakerverification_tpu_torch.ops import specaugment as tsa
from speakerverification_tpu_torch.ops import timeaugment as tta


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _banks(device, L=16000, seed=0):
    g = torch.Generator().manual_seed(seed)
    noise = 0.1 * torch.randn(32, L, generator=g)
    rir = torch.randn(8, L, generator=g) * torch.exp(
        -torch.arange(L) / 800.0)
    rir = rir / rir.norm(dim=1, keepdim=True)
    banks = tda.AugmentBanks(
        noise, 10 * torch.log10((noise ** 2).mean(1) + 1e-4),
        torch.zeros(32), torch.full((32,), 15.0), rir)
    return tda.AugmentBanks(*(b.to(device) for b in banks))


def _to(draw, device):
    return type(draw)(*(None if f is None else f.to(device) for f in draw))


def _rel(got, want):
    return float((got.cpu() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
def test_env_corrupt_on_the_card_matches_the_cpu(cuda):
    banks = _banks(cuda)
    x = 0.3 * torch.randn(64, 16000, device=cuda)
    draw = tda.draw_env_corrupt(torch.Generator(cuda).manual_seed(0), 64,
                                banks)
    got = tda.apply_env_corrupt(x, draw, banks)
    want = tda.apply_env_corrupt(x.cpu(), _to(draw, "cpu"), _banks("cpu"))
    assert _rel(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["np", "torch"])
def test_time_augment_on_the_card_matches_the_cpu(cuda, mode):
    banks = _banks(cuda)
    x = 0.3 * torch.randn(64, 16000, device=cuda)
    draw = tta.draw_time_augment(torch.Generator(cuda).manual_seed(1), 64,
                                 16000, banks, mode=mode, sample_rate=8000)
    got = tta.apply_time_augment(x, draw, banks, sample_rate=8000)
    want = tta.apply_time_augment(x.cpu(), _to(draw, "cpu"), _banks("cpu"),
                                  sample_rate=8000)
    assert _rel(got, want) <= 1e-5


@pytest.mark.cuda
def test_spec_augment_on_the_card_matches_the_cpu(cuda):
    cfg = tsa.SpecAugmentConfig(replace_with_zero=False)
    x = torch.rand(64, 201, 80, device=cuda)
    d = tsa.draw_spec_augment(torch.Generator(cuda).manual_seed(2),
                              x.shape, cfg)
    cpu = tsa.SpecAugmentDraw(tuple(v.cpu() for v in d.warp),
                              _to(d.time, "cpu"), _to(d.freq, "cpu"))
    assert _rel(tsa.apply_spec_augment(x, d, cfg),
                tsa.apply_spec_augment(x.cpu(), cpu, cfg)) <= 1e-6
