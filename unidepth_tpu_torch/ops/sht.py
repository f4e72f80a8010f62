"""Real spherical harmonics in Cartesian form (counterpart of
unidepth_tpu/ops/sht.py).

Orthonormal real SH with the Condon-Shortley phase, output index
``l*(l+1)+m``, from the associated-Legendre recurrence in z and the real
and imaginary parts of (x + iy)^m. V1 embeds its rays at degree 8 (81
coefficients).
"""

from __future__ import annotations

import math

import torch

__all__ = ["rsh_cart", "rsh_cart_8"]


def rsh_cart(xyz: torch.Tensor, degree: int) -> torch.Tensor:
    """xyz (..., 3) on the unit sphere -> (..., (degree+1)^2) real SH."""
    x, y, z = xyz.unbind(-1)
    one = torch.ones_like(x)
    # c_m = Re[(x+iy)^m], s_m = Im[(x+iy)^m]
    c, s = [one], [torch.zeros_like(x)]
    for m in range(1, degree + 1):
        c.append(x * c[m - 1] - y * s[m - 1])
        s.append(x * s[m - 1] + y * c[m - 1])
    # P~_l^m(z) = P_l^m(cos t) / sin^m t, a polynomial in z (phase included)
    pt = {(0, 0): one}
    for m in range(1, degree + 1):
        pt[(m, m)] = ((-1.0) ** m * math.prod(range(1, 2 * m, 2))) * one
    for m in range(degree):
        pt[(m + 1, m)] = (2 * m + 1) * z * pt[(m, m)]
    for m in range(degree + 1):
        for l in range(m + 2, degree + 1):
            pt[(l, m)] = ((2 * l - 1) * z * pt[(l - 1, m)] - (l - 1 + m) * pt[(l - 2, m)]) / (l - m)
    out = []
    for l in range(degree + 1):
        row = {}
        for m in range(l + 1):
            k = math.sqrt((2 * l + 1) / (4.0 * math.pi) * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                row[0] = k * pt[(l, 0)]
            else:
                row[m] = math.sqrt(2.0) * k * pt[(l, m)] * c[m]
                row[-m] = math.sqrt(2.0) * k * pt[(l, m)] * s[m]
        out.extend(row[m] for m in range(-l, l + 1))
    return torch.stack(out, dim=-1)


def rsh_cart_8(xyz: torch.Tensor) -> torch.Tensor:
    return rsh_cart(xyz, 8)
