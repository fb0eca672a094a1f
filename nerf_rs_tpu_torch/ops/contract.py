"""mip-NeRF 360 scene contraction (arXiv 2111.12077 eq. 10), the
counterpart of ``nerf_rs_tpu/ops/contract.py``:

    contract(x) = x                         for ||x|| <= 1
                  (2 - 1/||x||) * x/||x||   otherwise

maps all of R^3 into the radius-2 ball. ``contract_gaussian`` pushes a
diagonal Gaussian through the contraction's linearisation (the IPE
composition rule). Both take the JAX functions' steps in the same
association order, with the three-term sums written out left to right;
they are also the plain versions of the whole-ray kernels' device
functions ``contract_points`` and ``contract_gaussian``
(``kernels/csrc/field.cuh``), which round the same operations in the same
order.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _sum3(a: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 1): (a0 + a1) + a2."""
    return (a[..., 0:1] + a[..., 1:2]) + a[..., 2:3]


def _safe_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """||x|| clamped under the sqrt (a finite gradient at x = 0)."""
    return torch.sqrt(torch.clamp(_sum3(x * x), min=eps * eps))


def contract(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Contract points (..., 3) into the radius-2 ball (eq. 10)."""
    r = _safe_norm(x, eps)
    safe = torch.clamp(r, min=1.0)  # inside the unit ball the branch is the identity
    return torch.where(r <= 1.0, x, (2.0 - 1.0 / safe) * x / safe)


def contract_gaussian(mean: torch.Tensor, var: torch.Tensor,
                      eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contract a diagonal Gaussian (mean, var), each (..., 3), by local
    linearisation: f(mu) and the diagonal of J Sigma J^T, with the
    closed-form Jacobian of f(x) = g(r) x, g(r) = 2/r - 1/r^2:

        diag(J Sigma J^T)_i = g^2 s_i + 2 g (g'/r) x_i^2 s_i
                              + (g'/r)^2 x_i^2 sum_j x_j^2 s_j

    with g'(r) = -2/r^2 + 2/r^3."""
    r = _safe_norm(mean, eps)
    safe = torch.clamp(r, min=1.0)
    inside = r <= 1.0
    s2 = safe * safe
    g = 2.0 / safe - 1.0 / s2
    gp_over_r = (-2.0 / s2 + 2.0 / (safe * s2)) / safe
    x2 = mean * mean
    quad = _sum3(x2 * var)
    var_out = (g * g * var
               + 2.0 * g * gp_over_r * x2 * var
               + gp_over_r * gp_over_r * x2 * quad)
    return (torch.where(inside, mean, g * mean),
            torch.where(inside, var, torch.clamp(var_out, min=0.0)))
