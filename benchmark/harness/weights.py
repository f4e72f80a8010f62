"""Random weights from the seed, drawn on the device in a few large calls.

The spec of what to draw (a name, shape and distribution for every
parameter) is read from the program's module tree: the names are the
reference checkpoint's, which the references read too. The values come from
one truncated-normal and one normal draw of a ``torch.Generator`` on the
device, split and scaled per tensor:

* linear and conv kernels: lecun normal, truncated at 2 std (std
  sqrt(1 / fan_in) / 0.8796); ConvTranspose kernels, the patch embedding,
  the position embedding and the cls token: truncated normal 0.02;
* biases: normal 0.02; LayerNorm weights 1 + normal 0.1, biases normal
  0.02 (nonzero, so a kernel that drops an affine term shows);
* layer scales (parameters named ``gamma``): the configuration's
  ``assumed.layer_scale``; camera latents and level embeddings: standard
  normal;
* a parameter named in the configuration's ``assumed.weight_scales`` is
  drawn as above and multiplied by its factor.

The same seed gives the same values on the same device, so the reference is
handed the weights the program served: drawn again, rounded to the served
dtype and widened to float32.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import torch
import torch.nn as nn

LECUN_TRUNC = 0.87962566103423978  # std of a standard normal truncated at +-2


def subseed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{purpose}".encode()).digest()[:8], "little") >> 1


@dataclasses.dataclass(frozen=True)
class Entry:
    name: str
    shape: tuple
    kind: str  # "trunc", "normal" or "const"
    scale: float
    offset: float = 0.0


def spec(model: nn.Module, layer_scale: float, weight_scales: dict | None = None) -> list[Entry]:
    """What to draw for each parameter of ``model``."""
    weight_scales = dict(weight_scales or {})
    out = []
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            if isinstance(m, nn.ConvTranspose2d) and pname == "weight":
                e = Entry(name, shape, "trunc", 0.02)
            elif isinstance(m, (nn.Linear, nn.Conv2d)) and pname == "weight":
                fan_in = math.prod(shape[1:])
                std = 0.02 if name.endswith("patch_embed.proj.weight") else math.sqrt(1.0 / fan_in) / LECUN_TRUNC
                e = Entry(name, shape, "trunc", std)
            elif isinstance(m, nn.LayerNorm) and pname == "weight":
                e = Entry(name, shape, "normal", 0.1, 1.0)
            elif pname == "bias":
                e = Entry(name, shape, "normal", 0.02)
            elif pname in ("pos_embed", "cls_token"):
                e = Entry(name, shape, "trunc", 0.02)
            elif pname == "gamma":
                e = Entry(name, shape, "const", 0.0, layer_scale)
            elif pname in ("latents_pos", "level_embeds"):
                e = Entry(name, shape, "normal", 1.0)
            else:
                raise ValueError(f"no distribution for parameter {name} {shape}")
            if name in weight_scales:
                e = dataclasses.replace(e, scale=e.scale * weight_scales.pop(name))
            out.append(e)
    if weight_scales:
        raise ValueError(f"weight_scales name no parameter: {sorted(weight_scales)}")
    return out


def draw(entries: list[Entry], seed: int, device) -> dict[str, torch.Tensor]:
    """float32 values for every entry, from two draws on ``device``."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    out = {}
    for kind in ("trunc", "normal"):
        group = [e for e in entries if e.kind == kind]
        total = sum(math.prod(e.shape) for e in group)
        buf = torch.empty(total, device=device)
        if kind == "trunc":
            nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=g)
        else:
            buf.normal_(generator=g)
        at = 0
        for e in group:
            n = math.prod(e.shape)
            out[e.name] = buf[at : at + n].view(e.shape) * e.scale + e.offset
            at += n
        del buf
    for e in entries:
        if e.kind == "const":
            out[e.name] = torch.full(e.shape, e.offset, device=device)
    return out


@torch.no_grad()
def load(model: nn.Module, values: dict[str, torch.Tensor]) -> None:
    """Copy ``values`` into the parameters of ``model`` (cast to their dtype)."""
    params = dict(model.named_parameters())
    if set(params) != set(values):
        raise ValueError(f"weights and model differ: {sorted(set(params) ^ set(values))[:8]}")
    for name, p in params.items():
        p.copy_(values[name])


def served(values: dict[str, torch.Tensor], dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """The values as the program holds them (rounded to ``dtype``), in float32."""
    return {k: v.to(dtype).float() for k, v in values.items()}
