"""Loss heads (port of the ``losses`` package's margin heads).

Each head is called as ``head(x, label) -> (loss, prec1)`` and carries
``test_normalize``; heads are registered under their YAML names
(``criterion.name``). Ported: the margin heads ``Softmax``,
``AmSoftmax``, ``AAmSoftmax`` and ``ARmSoftmax``; the metric heads
``AngularProto``, ``Prototypical``, ``GE2ELoss``, ``GE2ELossV2`` and
``GE2ELoss_fusion``; their sums ``SoftmaxAngularProto``,
``AmSoftmaxProto``, ``AAmSoftmaxProto`` and ``AAmSoftmaxAP``;
``AngularPenaltySMLoss``; the adaptive softmax heads
``adasoftmax_v1``/``_v2``; the proxy heads ``ProxyAnchor``,
``ProxyNCA``, ``MP``, ``MMP`` (and ``*_Balance``), ``MMP_Balance_MTL``;
the pair heads ``MultiSimilarity``, ``MultiSimilarity_v2``,
``MSSoftmax``, ``MSAmSoftmax``, ``CircleLoss``, ``CircleLossV2``; and
``TripletLoss``; and ``ShardedAAmSoftmax``, the class-sharded head of
``model_parallel > 1`` (``losses/sharded.py``).
"""

import inspect

from speakerverification_tpu_torch.losses.margin import (  # noqa: F401
    AAmSoftmax,
    AmSoftmax,
    Softmax,
)
from speakerverification_tpu_torch.losses.margin_extra import (  # noqa: F401
    AngularPenaltySMLoss,
    ARmSoftmax,
)
from speakerverification_tpu_torch.losses.proto import (  # noqa: F401
    AngularProto,
    GE2ELoss,
    GE2ELossFusion,
    GE2ELossV2,
    Prototypical,
)
from speakerverification_tpu_torch.losses.combined import (  # noqa: F401
    AAmSoftmaxAP,
    AAmSoftmaxProto,
    AmSoftmaxProto,
    SoftmaxAngularProto,
)
import speakerverification_tpu_torch.losses.adaptive  # noqa: F401
import speakerverification_tpu_torch.losses.proxy  # noqa: F401
import speakerverification_tpu_torch.losses.similarity  # noqa: F401
import speakerverification_tpu_torch.losses.sharded  # noqa: F401
import speakerverification_tpu_torch.losses.triplet  # noqa: F401
from speakerverification_tpu_torch.registry import LOSSES

__all__ = ["LOSSES", "build_loss"]


def build_loss(name: str, **kwargs):
    """The head registered as ``name``, built from the config keys its
    constructor takes (the others are dropped, as the JAX builder drops
    what a head's fields lack)."""
    cls = LOSSES.get(name)
    accepted = set(inspect.signature(cls.__init__).parameters) - {"self"}
    return cls(**{k: v for k, v in kwargs.items() if k in accepted})
