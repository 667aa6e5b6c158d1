"""PatchGAN discriminator (NCHW).

Port of ``ammcnet_aaai2021_tpu/models/discriminator.py`` (reference
"PixelDiscriminator", ``Code/models/pix2pix_networks.py:580-631`` as
configured by ``const_params.py:34``): 4x4 convolutions, stride 2, padding
2, LeakyReLU(0.1), then a 4x4 stride-1 convolution to a 1-channel score map,
returned in float32.  As in the JAX module, the strided convolutions run
over ``num_filters[:-1]``: with the configured (128, 256, 512, 512) that is
three of them, at 128, 256 and 512 channels.  Applied to the RGB prediction
only (train_helper.py:318,327-334).

Module names follow the JAX module's (``conv0``..``conv2``, ``out``);
``tools/weights.discriminator_state_from_jax`` maps its parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv2d


class PixelDiscriminator(nn.Module):
    def __init__(self, num_filters: Sequence[int] = (128, 256, 512, 512),
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.n_strided = len(num_filters) - 1
        ch = in_channels
        for i, width in enumerate(num_filters[:-1]):
            self.add_module(f"conv{i}", Conv2d(ch, width, 4, stride=2,
                                               padding=2))
            ch = width
        self.out = Conv2d(ch, 1, 4, stride=1, padding=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.n_strided):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.1)
        return self.out(x).float()
