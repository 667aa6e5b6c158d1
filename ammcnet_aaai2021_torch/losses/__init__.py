"""Generator and discriminator losses (port of ``ammcnet_aaai2021_tpu/losses``)."""

from .primitives import (
    adversarial_loss,
    discriminate_loss,
    flow_loss,
    gradient_loss,
    intensity_loss,
)
from .zoo import LOSS_TAGS, get_loss

__all__ = ["adversarial_loss", "discriminate_loss", "flow_loss",
           "gradient_loss", "intensity_loss", "LOSS_TAGS", "get_loss"]
