"""Built-in presets; importing this registers them."""

from ddsp_torch.configs import presets
from ddsp_torch.configs.presets import ae, solo_instrument, tiny

__all__ = ['presets', 'ae', 'solo_instrument', 'tiny']
