from blvm_tpu_torch.models.wavenet.modules import (
    CausalConv1d,
    Conv1d,
    Conv1dResidualGLU,
    PointwiseTransform,
    ResidualStack,
    residual_glu,
    residual_glu_plain,
)
from blvm_tpu_torch.models.wavenet.wavenet import InputSizeError, WaveNet

__all__ = [
    "CausalConv1d",
    "Conv1d",
    "Conv1dResidualGLU",
    "InputSizeError",
    "PointwiseTransform",
    "ResidualStack",
    "WaveNet",
    "residual_glu",
    "residual_glu_plain",
]
