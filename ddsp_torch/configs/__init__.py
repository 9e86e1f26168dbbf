"""Built-in presets; importing this registers them."""

from ddsp_torch.configs import presets

__all__ = ['presets']
