"""Photometric augmentation (ColorJitter) of the train step.

Port of infantposeestimation_gaussianbias_tpu/ops/photometric.py.  Per
sample: three factors ``f ~ U[max(0, 1 - amount), 1 + amount]`` for
brightness, contrast and saturation, and a random order of the three ops,
each torchvision's float blend clamped to [0, 1]:

  brightness: img * f
  contrast:   f * img + (1 - f) * mean(gray(img))      (scalar mean)
  saturation: f * img + (1 - f) * gray(img)            (per-pixel gray)

with grayscale coefficients (0.2989, 0.587, 0.114).  The three are one
blend ``f * img + (1 - f) * m`` with m = 0, the image's mean gray or its
gray, so each of the three passes computes one blend and picks each
sample's m and f by its op at that pass (``torch.where`` on the order),
where JAX switches per sample inside a loop.

The randomness is apart from the arithmetic: ``draw_jitter`` draws the
factors and orders from a ``torch.Generator``, ``apply_jitter`` applies
given ones (the tests feed it JAX's draws).  Elementwise work that the JAX
package leaves to XLA; no kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

GRAY = (0.2989, 0.587, 0.114)

Jitter = Tuple[torch.Tensor, torch.Tensor]  # (factors (B, 3), order (B, 3))


def jitter_enabled(amounts: Sequence[float]) -> bool:
    """False when every amount is 0: the jitter is then no op at all."""
    return any(float(a) > 0 for a in amounts)


def draw_jitter(batch: int, amounts: Sequence[float],
                generator: torch.Generator, device=None) -> Jitter:
    """Per-sample factors (B, 3) float32, columns (brightness, contrast,
    saturation), and op orders (B, 3) int64, each row a permutation of
    (0, 1, 2); drawn on the generator's device, returned on ``device``."""
    gdev = generator.device
    lo = torch.tensor([max(0.0, 1.0 - float(a)) for a in amounts],
                      dtype=torch.float32, device=gdev)
    hi = torch.tensor([1.0 + float(a) for a in amounts],
                      dtype=torch.float32, device=gdev)
    u = torch.rand((batch, 3), generator=generator, device=gdev)
    order = torch.argsort(torch.rand((batch, 3), generator=generator,
                                     device=gdev), dim=1)
    return (lo + (hi - lo) * u).to(device), order.to(device)


def _gray(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W, 1) luminance."""
    g = torch.tensor(GRAY, dtype=img.dtype, device=img.device)
    return (img * g).sum(dim=-1, keepdim=True)


def apply_jitter(images: torch.Tensor, factors: torch.Tensor,
                 order: torch.Tensor) -> torch.Tensor:
    """ColorJitter of (B, H, W, 3) images in [0, 1] with the given factors
    and orders (``draw_jitter``'s layout): pass i applies op order[:, i]."""
    x = images
    f_all = factors.to(x.dtype)
    for i in range(3):
        op = order[:, i]
        f = f_all.gather(1, op[:, None]).view(-1, 1, 1, 1)
        g = _gray(x)
        m = torch.where((op == 1).view(-1, 1, 1, 1),
                        g.mean(dim=(1, 2, 3), keepdim=True), g)
        m = torch.where((op == 0).view(-1, 1, 1, 1), torch.zeros_like(m), m)
        x = (f * x + (1.0 - f) * m).clamp(0.0, 1.0)
    return x


def color_jitter(images: torch.Tensor, amounts: Sequence[float],
                 generator: Optional[torch.Generator] = None,
                 jitter: Optional[Jitter] = None) -> torch.Tensor:
    """ColorJitter of (B, H, W, 3) images in [0, 1] by ``amounts``
    (brightness, contrast, saturation), with ``jitter``'s draws or fresh
    ones from ``generator``.  The images themselves when every amount is
    0."""
    if not jitter_enabled(amounts):
        return images
    if jitter is None:
        jitter = draw_jitter(images.shape[0], amounts, generator,
                             images.device)
    return apply_jitter(images, *jitter).to(images.dtype)


def color_jitter_normalized(images: torch.Tensor, mean, std,
                            amounts: Sequence[float],
                            generator: Optional[torch.Generator] = None,
                            jitter: Optional[Jitter] = None) -> torch.Tensor:
    """ColorJitter of already normalised images ((x - mean) / std, as
    data/pipeline.device_batch gives them): back to [0, 1], jitter,
    normalise again."""
    if not jitter_enabled(amounts):
        return images
    mean = torch.tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.tensor(std, dtype=images.dtype, device=images.device)
    x01 = color_jitter(images * std + mean, amounts, generator, jitter)
    return (x01 - mean) / std
