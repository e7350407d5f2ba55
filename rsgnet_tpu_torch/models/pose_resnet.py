"""SimpleBaseline pose ResNet in PyTorch (NCHW), the port of the JAX
package's ``models/pose_resnet.py``.

ResNet-{18,34,50,101,152} backbone (7x7 stride-2 stem, 3x3 stride-2
maxpool, four block stages at 64/128/256/512 channels) ->
NUM_DECONV_LAYERS transposed convs (each a 2x upsample) + BN + ReLU ->
a FINAL_CONV_KERNEL conv to K heatmaps.

Submodules carry the flax scope names (``stem``, ``layer{li}_{b}``,
``deconv{i}.conv`` / ``.bn``, ``final_layer``), so ``utils/convert.py``
maps a flax variable tree onto this module's state dict.

The JAX side writes each transposed conv as an ordinary conv over the 2x
zero-dilated input, padded (k-1-p, k-1-p+op), with its kernel stored
spatially flipped. Here it is ``ConvTranspose2d(k, stride=2, padding=p,
output_padding=op)``, the same operator, with torch's (Cin, Cout, k, k)
weight: the converter flips and transposes the flax kernel.

MODEL.S2D_STEM runs the 7x7 stem conv as space-to-depth
(``models/hrnet.py::space_to_depth_conv``). Precision as ``models/hrnet.py``: the input is cast to the compute dtype,
convs compute in it (fp32 parameters cast at the call), BatchNorm in fp32,
and the features are cast to fp32 before the fp32 ``final_layer``.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from rsgnet_tpu_torch.config.defaults import Config
from rsgnet_tpu_torch.models.hrnet import (BLOCKS, BatchNorm,
                                           CastConvTranspose2d, ConvBN,
                                           at_least_f32, compute_dtype)

# depth -> (block type, blocks per stage), the public ResNet spec
RESNET_SPEC = {
    18: ("BASIC", (2, 2, 2, 2)),
    34: ("BASIC", (3, 4, 6, 3)),
    50: ("BOTTLENECK", (3, 4, 6, 3)),
    101: ("BOTTLENECK", (3, 4, 23, 3)),
    152: ("BOTTLENECK", (3, 8, 36, 3)),
}

# kernel -> (padding, output_padding) of the reference's _get_deconv_cfg;
# each gives an exact 2x spatial upsample
DECONV_CFG = {4: (1, 0), 3: (1, 1), 2: (0, 0)}


class DeconvBN(nn.Module):
    """ConvTranspose2d(k, stride 2, p, op) in the compute dtype -> fp32
    BatchNorm -> ReLU."""

    def __init__(self, in_features: int, features: int, kernel: int = 4,
                 use_bias: bool = False, dtype=None):
        super().__init__()
        if kernel not in DECONV_CFG:
            raise ValueError(f"unsupported deconv kernel {kernel}; the "
                             f"reference supports {sorted(DECONV_CFG)}")
        p, op = DECONV_CFG[kernel]
        self.conv = CastConvTranspose2d(in_features, features, kernel,
                                        stride=2, padding=p,
                                        output_padding=op, bias=use_bias,
                                        compute_dtype=dtype)
        self.bn = BatchNorm(features)

    def forward(self, x):
        return self.bn(self.conv(x), relu=True)


class PoseResNet(nn.Module):
    """ResNet backbone + deconv head + heatmap conv (the reference's
    ``get_pose_net`` for MODEL.NAME=pose_resnet)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        extra = cfg.MODEL.EXTRA
        block_name, stage_blocks = RESNET_SPEC[extra.NUM_LAYERS]
        blk = BLOCKS[block_name]
        dtype = compute_dtype(cfg)
        self.stem = ConvBN(3, 64, 7, 2, dtype=dtype, s2d=cfg.MODEL.S2D_STEM)
        self._blocks = []
        cin = 64
        for li, num_blocks in enumerate(stage_blocks, start=1):
            width = 64 * (2 ** (li - 1))
            stride = 1 if li == 1 else 2
            for b in range(num_blocks):
                name = f"layer{li}_{b}"
                setattr(self, name, blk(cin, width,
                                        stride=stride if b == 0 else 1,
                                        dtype=dtype))
                self._blocks.append(name)
                cin = width * blk.expansion
        self.num_deconv = extra.NUM_DECONV_LAYERS
        for i in range(self.num_deconv):
            setattr(self, f"deconv{i}", DeconvBN(
                cin, extra.NUM_DECONV_FILTERS[i],
                kernel=extra.NUM_DECONV_KERNELS[i],
                use_bias=extra.DECONV_WITH_BIAS, dtype=dtype))
            cin = extra.NUM_DECONV_FILTERS[i]
        k = extra.FINAL_CONV_KERNEL
        self.final_layer = nn.Conv2d(cin, cfg.MODEL.NUM_JOINTS, k, 1,
                                     1 if k == 3 else 0, bias=True)

    def forward(self, x):
        """x: (N, 3, H, W) normalized images. Returns (N, K, H/4, W/4) fp32
        heatmaps (float64 for a float64 model, the tests' anchor)."""
        x = self.stem(x.to(self.stem.conv.compute_dtype))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self._blocks:
            x = getattr(self, name)(x)
        for i in range(self.num_deconv):
            x = getattr(self, f"deconv{i}")(x)
        return self.final_layer(at_least_f32(x))
