"""K3 (``csrc/quant_matmul.cu``) at the int8 shapes the tenth slice adds,
against its plain version, bit for bit (the sums are exact integers and
both round the epilogue's multiply and add separately).

This file imports torch only (no JAX), so it also runs on the GPU host:

    python -m pytest --noconftest tests/test_torch_port_zoo_k3.py -q

The ``cuda``-marked tests need a card and nvcc and skip without them.
The shapes are one serving batch's (160 crops of 2 s at 16 kHz):
``Raw_ECAPA_conv_asp``'s raw branch (3-tap convs as im2col columns,
K 768 and 1,536 over 1,185 to 43 steps; the AFMS Denses; the pooling's
attention conv over 14 steps; the embedding Dense) and ResNetSE34V2's
attention conv (K 2,560 over 26 steps) and embedding Dense (K 5,120).
"""

import pytest
import torch

from speakerverification_tpu_torch.ops import quant_matmul as qm

# x as the wrapper gets it ([B, K, T] conv columns or [M, K] Dense rows)
# and N
ZOO_SHAPES = [((160, 768, 1185), 256), ((160, 768, 395), 256),
              ((160, 768, 131), 512), ((160, 1536, 131), 512),
              ((160, 1536, 43), 512), ((160, 512), 512),
              ((160, 512, 14), 128), ((160, 1024), 320),
              ((160, 2560, 26), 128), ((160, 5120), 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(x_shape, n, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    K = x_shape[1]
    x = torch.randn(*x_shape, generator=g, device=device)
    w = torch.randn(n, K, generator=g, device=device) / K ** 0.5
    wq, s_w = qm.quantize_weight(w)
    bias = 0.1 * torch.randn(n, generator=g, device=device)
    act = 0.9 * x.abs().max().item()           # a few inputs saturate
    return x.to(dtype), wq, s_w, bias, act


def _out_shape(x_shape, n):
    return ((x_shape[0], n, x_shape[2]) if len(x_shape) == 3
            else (x_shape[0], n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape,n", ZOO_SHAPES)
def test_k3_at_the_zoo_shapes(cuda, x_shape, n, dtype):
    args = _inputs(x_shape, n, dtype, cuda, seed=x_shape[1] + n)
    before = qm.launches
    got = qm.quant_matmul(*args)
    torch.cuda.synchronize()
    assert qm.launches == before + 1
    ref = qm.quant_matmul_plain(*args)
    assert got.dtype == dtype and got.shape == _out_shape(x_shape, n)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape,n", [((1, 768, 395), 256),
                                       ((1, 2560, 26), 128),
                                       ((1, 5120), 256)])
def test_cpu_tensors_run_the_plain_version(x_shape, n, dtype):
    """One crop's columns and rows: a CPU tensor takes the plain version
    and launches nothing."""
    args = _inputs(x_shape, n, dtype, torch.device("cpu"), seed=n)
    before = qm.launches
    got = qm.quant_matmul(*args)
    assert qm.launches == before
    assert torch.equal(got, qm.quant_matmul_plain(*args))
    assert got.dtype == dtype and got.shape == _out_shape(x_shape, n)
