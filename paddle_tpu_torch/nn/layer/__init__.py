from .activation import GELU, SiLU, Silu  # noqa: F401
from .common import Embedding, Linear  # noqa: F401
from .container import LayerList, Sequential  # noqa: F401
from .conv import Conv2D  # noqa: F401
from .loss import MSELoss  # noqa: F401
from .moe import GShardGate, MoELayer, SwitchGate  # noqa: F401
from .norm import LayerNorm, RMSNorm  # noqa: F401

__all__ = ["Linear", "Embedding", "RMSNorm", "LayerNorm", "Sequential",
           "LayerList", "Silu", "SiLU", "GELU", "Conv2D", "MSELoss", "MoELayer",
           "SwitchGate", "GShardGate"]
