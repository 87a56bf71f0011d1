"""flax's ``nn.RNN(nn.GRUCell(H))`` in PyTorch, with flax's layout.

The cell's six products carry flax's names: ``ir``, ``iz``, ``in``
(input kernels with a bias) and ``hr``, ``hz`` (recurrent kernels
without one), ``hn`` (recurrent, with a bias), so ``GRUCell_0.hr.weight``
is the transposed flax ``GRUCell_0/hr/kernel``. The update is flax's:

    r  = σ(W_ir x + b_ir + W_hr h)
    z  = σ(W_iz x + b_iz + W_hz h)
    n  = tanh(W_in x + b_in + r ⊙ (W_hn h + b_hn))
    h' = (1 − z) ⊙ n + z ⊙ h

(torch's ``nn.GRU`` has a bias on every recurrent product). The carry
starts at zero in fp32, flax's ``param_dtype``: with bf16 weights and
input the recurrent products promote to fp32, and so does every state
after the first, as in JAX (``models.layers.promoted``).

Float input products are taken for every step at once. Once ``quant.py``
has swapped ``ir``/``iz``/``in`` for int8 layers, they run step by step,
as flax's cell calls its input ``Dense`` once per step inside
``nn.RNN``'s scan: each step's input is quantized with its own scale.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from speakerverification_tpu_torch.models.layers import promoted

__all__ = ["GRUCell"]


class GRUCell(nn.Module):
    """One GRU layer run over time: ``[B, L, C] -> [B, L, H]``."""
    # initialized by weights.init_weights_ as flax's orthogonal()
    orthogonal_params = ("hr.weight", "hz.weight", "hn.weight")

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        self.ir = nn.Linear(in_features, features)
        self.iz = nn.Linear(in_features, features)
        self.add_module("in", nn.Linear(in_features, features))
        self.hr = nn.Linear(features, features, bias=False)
        self.hz = nn.Linear(features, features, bias=False)
        self.hn = nn.Linear(features, features)

    def _input_layers(self) -> list[nn.Module]:
        # "in" is a Python keyword, which torch.fx cannot write as an
        # attribute: export.py traces a copy with it renamed "in_"
        return [self._modules[k] if k in self._modules
                else self._modules[k + "_"] for k in ("ir", "iz", "in")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = self._input_layers()
        step_wise = not isinstance(self.ir, nn.Linear)   # int8 layers
        if not step_wise:
            # the input products of every step at once, in x's dtype
            xs = [promoted(layer, x) for layer in layers]
        h = torch.zeros(x.shape[0], self.features, dtype=torch.float32,
                        device=x.device)
        outs = []
        for t in range(x.shape[1]):
            xr, xz, xn = ([layer(x[:, t]) for layer in layers]
                          if step_wise else [v[:, t] for v in xs])
            r = torch.sigmoid(xr + promoted(self.hr, h))
            z = torch.sigmoid(xz + promoted(self.hz, h))
            n = torch.tanh(xn + r * promoted(self.hn, h))
            h = (1.0 - z) * n + z * h
            outs.append(h)
        return torch.stack(outs, dim=1)
