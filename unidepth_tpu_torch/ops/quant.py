"""Int8 serving quantization (counterpart of unidepth_tpu/ops/quant.py).

The recipe is the JAX package's post-training quantization:

* weights: symmetric per-output-channel int8, the scale taken over the
  contraction axis, quantized once when the int8 encoder is built;
* activations: symmetric per-token dynamic int8, the row abs-max computed
  at every call;
* the product int8 x int8 -> int32, then the rank-1 dequant epilogue
  ``acc * (s_x * s_w) + b`` in fp32, cast to the input's dtype.

Rounding is half to even, values clip to +-127 and scales are floored at
1e-12, so an all-zero row quantizes to zeros. The int8 product is
``torch._int_mm`` on every device: the JAX package leaves it to XLA outside
any Pallas kernel. On CUDA ``torch._int_mm`` takes M > 16, K and N
multiples of 8, a row-major left operand and a column-major right one:
``QuantLinear`` keeps its weight in nn.Linear's (N, K) layout, whose
transpose is that column-major operand (no copy per call), and pads M <= 16
with zero rows. On CUDA it raises on what it cannot take; nothing falls
back to a float product.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = [
    "QUANT_DENSE_NAMES",
    "QuantLinear",
    "dynamic_quant",
    "int8_matmul",
    "quantizable_linears",
    "quantize_kernel",
    "quantize_linear_tree",
]

# Linear submodules of ViTBlock that carry the encoder's GEMM FLOPs (w12
# and w3: a SwiGLU block's).
QUANT_DENSE_NAMES = ("qkv", "proj", "fc1", "fc2", "w12", "w3")

_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA needs M > 16


def quantize_kernel(weight: torch.Tensor, axis: int = -1):
    """Symmetric per-output-channel int8 quantization of a dense weight.

    ``axis`` is the contraction (in-features) axis: -1 for nn.Linear's
    (N, K) layout. Returns (int8 weight, float32 scale with ``axis``
    removed), weight ~= q * scale."""
    w = weight.float()
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def dynamic_quant(x: torch.Tensor):
    """Symmetric per-row (last-axis) dynamic int8 quantization. Returns
    (int8 x, float32 scale (..., 1)), x ~= q * scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8 row-major, wq (N, K) int8 in nn.Linear layout ->
    (M, N) int32 = xq @ wq.T, exact."""
    m, k = xq.shape
    n = wq.shape[0]
    if xq.is_cuda and (k % 8 or n % 8):
        raise ValueError(f"int8_matmul: K ({k}) and N ({n}) must be multiples of 8 on CUDA")
    if m < _INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    return torch._int_mm(xq.contiguous(), wq.t())[:m]


class QuantLinear(nn.Module):
    """int8 counterpart of ``nn.Linear`` (the JAX ``QuantDense``): buffers
    ``weight`` int8 (N, K), ``scale`` fp32 (N,) and ``bias`` fp32 (N,).

    Moving the module moves its buffers, but a dtype cast
    (``module.to(torch.bfloat16)``) leaves them as they are: a bf16 scale
    would add ~0.4% of dequant error per channel."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight", torch.zeros(out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(out_features, dtype=torch.float32, device=device))

    @classmethod
    @torch.no_grad()
    def from_float(cls, weight: torch.Tensor, bias: torch.Tensor | None = None, device=None) -> "QuantLinear":
        """Quantize an (N, K) float weight (the fp32 master) and its bias;
        a missing bias becomes zeros, as in ``quantize_dense_tree``."""
        device = weight.device if device is None else torch.device(device)
        n, k = weight.shape
        m = cls(k, n, device=device)
        q, s = quantize_kernel(weight.to(device, torch.float32))
        m.weight.copy_(q)
        m.scale.copy_(s)
        if bias is not None:
            m.bias.copy_(bias.to(device, torch.float32))
        return m

    def _apply(self, fn, recurse=True):
        for name, t in self._buffers.items():
            moved = fn(t)
            self._buffers[name] = moved if moved.dtype == t.dtype else t.to(moved.device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, s = dynamic_quant(x)
        acc = int8_matmul(q.reshape(-1, self.in_features), self.weight)
        y = acc.float() * (s.reshape(-1, 1) * self.scale) + self.bias
        return y.to(x.dtype).reshape(*x.shape[:-1], self.out_features)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, int8"


def quantizable_linears(module: nn.Module) -> dict:
    """Qualified name -> ``nn.Linear`` for every linear named in
    ``QUANT_DENSE_NAMES``."""
    return {
        qual: m
        for qual, m in module.named_modules()
        if isinstance(m, nn.Linear) and qual.rsplit(".", 1)[-1] in QUANT_DENSE_NAMES
    }


def quantize_linear_tree(
    module: nn.Module,
    prefixes: tuple[str, ...] | None = None,
    weights: dict | None = None,
) -> nn.Module:
    """A copy of ``module`` in which every ``nn.Linear`` whose attribute name
    is in ``QUANT_DENSE_NAMES`` is a ``QuantLinear`` (counterpart of
    ``quantize_dense_tree``). With ``prefixes``, only linears whose qualified
    name starts with one of them are swapped (the per-stage mask: e.g.
    ``("blocks.0.", "blocks.1.")``). ``weights`` maps a qualified name to
    the (weight, bias) to quantize from, the fp32 masters; a linear it lacks
    is quantized from its own parameters.

    Only the modules on the path to a swapped linear are copied (shallowly);
    every other submodule, parameter and buffer is shared with ``module``,
    which is left as it was."""
    weights = weights or {}

    def walk(mod: nn.Module, path: str) -> nn.Module:
        swapped = {}
        for name, child in mod.named_children():
            qual = f"{path}{name}"
            if (
                isinstance(child, nn.Linear)
                and name in QUANT_DENSE_NAMES
                and (prefixes is None or qual.startswith(tuple(prefixes)))
            ):
                w, b = weights.get(qual, (child.weight, child.bias))
                swapped[name] = QuantLinear.from_float(w, b, device=child.weight.device)
            else:
                new = walk(child, qual + ".")
                if new is not child:
                    swapped[name] = new
        if not swapped:
            return mod
        out = copy.copy(mod)
        out._modules = {**mod._modules, **swapped}
        return out

    return walk(module, "")
