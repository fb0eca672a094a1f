"""Image-quality metrics beyond PSNR, the counterpart of
``nerf_rs_tpu/ops/metrics.py``: single-scale SSIM (Wang et al. 2004)
with an 11-tap separable Gaussian window (sigma 1.5) and valid padding.

Full f32 throughout. The separable filter is written as explicit
shifted sums, not as a convolution: cuDNN runs f32 convolutions in TF32
by default (``torch.backends.cudnn.allow_tf32``), and at TF32's ~3
digits the variance terms E[x^2] - E[x]^2 cancel catastrophically (the
JAX package measured 0.841 for a true 0.9991 when its TPU conv ran at
bf16).
"""

from __future__ import annotations

import torch


def _gaussian_kernel(size: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _filter_axis(a: torch.Tensor, kernel: torch.Tensor, axis: int) -> torch.Tensor:
    """Valid correlation of ``a`` with the 1-D kernel along ``axis``
    (empty when ``a`` is shorter than the kernel, so SSIM is NaN there,
    as in the JAX package)."""
    n = a.shape[axis] - kernel.shape[0] + 1
    if n <= 0:
        return a.narrow(axis, 0, 0)
    out = kernel[0] * a.narrow(axis, 0, n)
    for i in range(1, kernel.shape[0]):
        out = out + kernel[i] * a.narrow(axis, i, n)
    return out


def _filter2(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable valid filter of (H, W, C) along H, then W."""
    return _filter_axis(_filter_axis(img, kernel, 0), kernel, 1)


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM between two (H, W, C) images in [0, max_val]."""
    img1 = img1.float()
    img2 = img2.float()
    kernel = _gaussian_kernel(filter_size, filter_sigma, img1.device)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2

    mu1 = _filter2(img1, kernel)
    mu2 = _filter2(img2, kernel)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # E[x^2] - E[x]^2, clamped: valid-window float error can dip below 0
    s1 = torch.clamp(_filter2(img1 * img1, kernel) - mu1_sq, min=0.0)
    s2 = torch.clamp(_filter2(img2 * img2, kernel) - mu2_sq, min=0.0)
    s12 = _filter2(img1 * img2, kernel) - mu12

    num = (2.0 * mu12 + c1) * (2.0 * s12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    return torch.mean(num / den)
