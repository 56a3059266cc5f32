"""Click-model simulator: synthetic click-through data on ranked slates
(the JAX package's ``click_models/``).

The host models (``base.py``, ``cascade_models.py``, ``duplicate_aware.py``)
click one slate at a time in numpy and draw from ``np.random``: seeded
alike, they click as the JAX package's do, bit for bit. ``device_models.py``
holds their batch formulations on tensors, which ``rank_and_click`` runs on
the model's device fused with the ranking pass wherever one exists.
"""

from allrank_tpu_torch.click_models.base import (  # noqa: F401
    ClickModel,
    ConditionedClickModel,
    FixedClickModel,
    MaxClicksModel,
    MultipleClickModel,
    OnlyRelevantClickModel,
    RandomClickModel,
)
from allrank_tpu_torch.click_models.cascade_models import (  # noqa: F401
    BaseCascadeModel,
    DiverseClicksModel,
)
from allrank_tpu_torch.click_models.duplicate_aware import (  # noqa: F401
    EverythingButDuplicatesClickModel,
)
from allrank_tpu_torch.click_models.click_utils import (  # noqa: F401
    MaskedRemainMasked,
    click_on_slates,
)
