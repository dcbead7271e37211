"""nn.Module model family: pose-conditioned encoder-decoder with skip
connections, ConvGRU temporal recurrence, flow/mask/rgb heads."""

from dynamic_multiview_3d_torch.models.layers import ConvBlock, ConvGRUCell
from dynamic_multiview_3d_torch.models.dmv3d import (
    DMV3D,
    Decoder,
    Encoder,
    PoseBottleneck,
)

__all__ = ["ConvBlock", "ConvGRUCell", "DMV3D", "Decoder", "Encoder",
           "PoseBottleneck"]
