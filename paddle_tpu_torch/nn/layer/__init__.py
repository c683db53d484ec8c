from .activation import (GELU, Hardsigmoid, Hardswish, ReLU,  # noqa: F401
                         ReLU6, Sigmoid, SiLU, Silu, Swish)
from .common import (Dropout, Dropout2D, Dropout3D,  # noqa: F401
                     Embedding, Linear)
from .container import LayerList, Sequential  # noqa: F401
from .conv import Conv2D  # noqa: F401
from .loss import MSELoss  # noqa: F401
from .moe import GShardGate, MoELayer, SwitchGate  # noqa: F401
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D, LayerNorm, RMSNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)

__all__ = ["Linear", "Embedding", "RMSNorm", "LayerNorm", "BatchNorm",
           "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm",
           "Sequential", "LayerList", "ReLU", "ReLU6", "Silu", "SiLU",
           "Swish", "Sigmoid", "Hardsigmoid", "Hardswish", "GELU",
           "Dropout", "Dropout2D", "Dropout3D",
           "Conv2D", "MSELoss", "MoELayer", "SwitchGate", "GShardGate",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]
