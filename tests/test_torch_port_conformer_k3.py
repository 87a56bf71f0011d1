"""K3's Dense route (``qmm_dense_kernel``) at the Conformer family's int8
shapes, against its plain version, bit for bit (the sums are exact
integers and both round the epilogue's multiply and add separately).

This file imports torch only (no JAX), so it also runs on the GPU host:

    python -m pytest --noconftest tests/test_torch_port_conformer_k3.py -q

The ``cuda``-marked tests need a card and nvcc and skip without them.
The shapes are one serving batch's (160 crops of 2 s: M = 160 · 49
rows): the Conformer's feed-forward and subsampling Denses and its last
Dense, ECAPA_Conformer's feed-forward Denses (N = 144: a 16-row tail of
output-channel tiles) and its subsampling Dense (K = 55,152, not a
multiple of the kernel's 64-deep stages).
"""

import pytest
import torch

from speakerverification_tpu_torch.ops import quant_matmul as qm

CONFORMER_DENSE = [((7840, 1024), 256), ((7840, 4864), 256),
                   ((160, 512), 512), ((7840, 576), 144),
                   ((7840, 55152), 144)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape,n", CONFORMER_DENSE)
def test_dense_route_at_conformer_shapes(cuda, x_shape, n, dtype):
    args = _inputs(x_shape, n, dtype, cuda, seed=x_shape[1] + n)
    before = qm.launches
    got = qm.quant_matmul(*args)
    torch.cuda.synchronize()
    assert qm.launches == before + 1
    ref = qm.quant_matmul_plain(*args)
    assert got.dtype == dtype and got.shape == (x_shape[0], n)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(1024, 256), (576, 144)])
def test_cpu_tensors_run_the_plain_version(k, n, dtype):
    """One crop's rows (49) at the feed-forward widths: a CPU tensor takes
    the plain version and launches nothing."""
    args = _inputs((49, k), n, dtype, torch.device("cpu"), seed=k)
    before = qm.launches
    got = qm.quant_matmul(*args)
    assert qm.launches == before
    assert torch.equal(got, qm.quant_matmul_plain(*args))
    assert got.dtype == dtype and got.shape == (49, n)
