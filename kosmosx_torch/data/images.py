"""Image preprocessing to CLIP pixel values, on the device of its input
(counterpart of kosmosx_tpu/data/images.py).

CLIPProcessor's steps: the short side scaled to the target size, a
bicubic resize with antialiasing (PyTorch's antialiased bicubic filter is
the Keys a = -0.5 kernel of ``jax.image.resize(method="bicubic")``), a
center crop, /255 for integer input, then the CLIP mean and std.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kosmosx_torch.nn.vision import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD


def preprocess_images(images: torch.Tensor, *, image_size: int = 224,
                      rescale: bool = True,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """images (B, 3, H, W), uint8 in [0, 255] or float in [0, 1] ->
    normalised (B, 3, image_size, image_size) pixel values
    (kosmosx_tpu/data/images.py:20-47)."""
    x = images.float()
    if rescale and not images.is_floating_point():
        x = x / 255.0
    h, w = x.shape[-2:]
    if (h, w) != (image_size, image_size):
        scale = image_size / min(h, w)
        nh, nw = round(h * scale), round(w * scale)
        x = F.interpolate(x, size=(nh, nw), mode="bicubic", antialias=True,
                          align_corners=False)
        top, left = (nh - image_size) // 2, (nw - image_size) // 2
        x = x[:, :, top:top + image_size, left:left + image_size]
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device).reshape(1, 3, 1, 1)
    return ((x - mean) / std).to(dtype)
