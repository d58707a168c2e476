"""Model modules of the port (channels-first inside, JAX layouts at the boundary).

``MODEL_REGISTRY`` is the counterpart of ``multishiftseg_tpu/models/__init__.py:
31-38``: the model classes and builders by the reference's names.
"""

from .deeplab import DeepWV3Plus
from .deepv3_generic import (DeepR50V3PlusD_m1, DeepSRNX50V3PlusD_m1,
                             DeepSRNX101V3PlusD_m1, DeepV3Plus)
from .maskformer import MaskFormer

MODEL_REGISTRY = {
    "DeepWV3Plus": DeepWV3Plus,
    "DeepV3Plus": DeepV3Plus,
    "DeepR50V3PlusD_m1": DeepR50V3PlusD_m1,
    "DeepSRNX50V3PlusD_m1": DeepSRNX50V3PlusD_m1,
    "DeepSRNX101V3PlusD_m1": DeepSRNX101V3PlusD_m1,
    "MaskFormer": MaskFormer,
}
