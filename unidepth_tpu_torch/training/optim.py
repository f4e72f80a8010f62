"""AdamW with layer-decay groups and schedules (counterpart of
unidepth_tpu/training/optim.py).

The JAX package runs one optax chain:
``clip_by_global_norm -> scale_by_adam -> add_decayed_weights(mask) ->
per-leaf lr scale -> scale_by_learning_rate``, with lr, beta1 and weight
decay injected from schedules evaluated at the step count before the
update. ``AdamW.apply`` is that chain as tensor code over the port's
parameter names, in the same order and in float32: weight decay is added
before the lr scale, so the encoder's decay is scaled too (where
``torch.optim.AdamW`` would not scale it). It updates the parameters and
moments in place, one ``torch._foreach_*`` pass a group of tensors that
share an lr scale and a decay flag.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from unidepth_tpu_torch.training.schedules import betas_schedule, cosine_warmup

__all__ = ["AdamW", "AdamWState", "build_optimizer", "global_norm", "lr_scale_tree", "wd_mask_tree"]

ENCODER = "pixel_encoder."
_BLOCK = re.compile(r"^pixel_encoder\.blocks\.(\d+)\.")
_STAGE_BLOCK = re.compile(r"^pixel_encoder\.stages\.(\d+)\.blocks\.(\d+)\.")  # ConvNeXt
NO_DECAY = ("cls_token", "pos_embed", "register_tokens", "latents_pos", "level_embeds", "gamma")


def lr_scale_tree(params: dict, encoder_lr_scale: float, ld: float, num_layers: int) -> dict[str, float]:
    """Per-parameter lr multipliers: decoder 1.0; encoder
    ``encoder_lr_scale * ld ** (num_layers - layer_id)``, where block i is
    layer i + 1 (a ConvNeXt's blocks numbered across its stages, as the JAX
    scanned ``stage_{s}`` blocks are), the final norm the last layer
    (ld ** 0) and the embeddings, a ConvNeXt's stem and downsample layers
    layer 0."""
    stage_len: dict[int, int] = {}
    for name in params:
        if (m := _STAGE_BLOCK.match(name)) is not None:
            s, j = int(m.group(1)), int(m.group(2))
            stage_len[s] = max(stage_len.get(s, 0), j + 1)
    out = {}
    for name in params:
        if not name.startswith(ENCODER):
            out[name] = 1.0
        elif ld == 1.0:
            out[name] = encoder_lr_scale
        elif (m := _BLOCK.match(name)) is not None:
            out[name] = encoder_lr_scale * ld ** (num_layers - int(m.group(1)) - 1)
        elif (m := _STAGE_BLOCK.match(name)) is not None:
            s, j = int(m.group(1)), int(m.group(2))
            layer = sum(stage_len.get(i, 0) for i in range(s)) + j + 1
            out[name] = encoder_lr_scale * ld ** (num_layers - layer)
        elif name.startswith(ENCODER + "norm."):
            out[name] = encoder_lr_scale
        else:
            out[name] = encoder_lr_scale * ld**num_layers
    return out


def wd_mask_tree(params: dict) -> dict[str, bool]:
    """True where weight decay applies: not on vectors (norms, biases) and
    not on tokens, position embeddings, latents or gammas."""
    return {name: p.ndim > 1 and not any(kw in name for kw in NO_DECAY) for name, p in params.items()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (``optax.global_norm``)."""
    norms = torch._foreach_norm(list(tensors))
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class AdamWState:
    count: int  # updates applied: the schedules' step
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


class AdamW:
    """The JAX recipe's optimizer over a dict of float32 parameters."""

    def __init__(self, params: dict, lr_sched, b1_sched, wd_sched, scales: dict, wd_mask: dict,
                 clipping: float = 1.0, b2: float = 0.999, eps: float = 1e-8):
        self.lr_sched, self.b1_sched, self.wd_sched = lr_sched, b1_sched, wd_sched
        self.clipping, self.b2, self.eps = clipping, b2, eps
        self.scales, self.wd_mask = scales, wd_mask
        groups: dict[tuple[float, bool], list[str]] = {}
        for name in params:
            groups.setdefault((scales[name], wd_mask[name]), []).append(name)
        self.groups = groups

    def init(self, params: dict) -> AdamWState:
        return AdamWState(count=0, mu={n: torch.zeros_like(p) for n, p in params.items()},
                          nu={n: torch.zeros_like(p) for n, p in params.items()})

    def hyperparams(self, count: int) -> dict[str, float]:
        """lr, beta1 and weight decay at ``count``, float32 values."""
        return {"lr": float(self.lr_sched(count)), "b1": float(self.b1_sched(count)),
                "wd": float(self.wd_sched(count))}

    @torch.no_grad()
    def apply(self, params: dict, grads: dict, state: AdamWState, g_norm: torch.Tensor | None = None) -> AdamWState:
        """One update: clips ``grads`` in place, then updates ``params`` and
        the moments of ``state`` in place. ``g_norm``: the gradients' global
        norm, if already taken."""
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        hp = self.hyperparams(state.count)
        b1 = f32(hp["b1"])
        one_m_b1, b2, one_m_b2 = float(1 - b1), float(f32(self.b2)), float(f32(1 - self.b2))
        count = state.count + 1
        # 1 - b^t in float32 from b^t correctly rounded, as XLA's pow gives it
        # (torch's float32 power by repeated products can be an ulp off, and
        # 1 - 0.999^t turns an ulp into ~2e-5 of the correction)
        bc1 = float(1 - f32(float(b1) ** count))
        bc2 = float(1 - f32(float(f32(self.b2)) ** count))
        names = list(params)
        if g_norm is None:
            g_norm = global_norm(grads[n] for n in names)
        if not bool(g_norm < self.clipping):
            g = [grads[n] for n in names]
            torch._foreach_div_(g, g_norm)
            torch._foreach_mul_(g, self.clipping)
        for (scale, decay), group in self.groups.items():
            p = [params[n] for n in group]
            g = [grads[n] for n in group]
            mu = [state.mu[n] for n in group]
            nu = [state.nu[n] for n in group]
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mu, float(b1))
            torch._foreach_add_(mu, torch._foreach_mul(g, one_m_b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), one_m_b2))
            # u = (mu / bc1) / (sqrt(nu / bc2) + eps)
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, den)
            del den
            if decay:
                torch._foreach_add_(u, torch._foreach_mul(p, hp["wd"]))
            torch._foreach_mul_(u, scale)
            torch._foreach_mul_(u, -hp["lr"])
            torch._foreach_add_(p, u)
        state.count = count
        return state


def build_optimizer(params: dict, lr: float = 1e-4, lr_final: float = 1e-6, encoder_lr: float = 2e-6,
                    wd: float = 0.1, wd_final: float = 0.1, warmup_iters: int = 75_000,
                    total_iters: int = 300_000, ld: float = 1.0, num_encoder_layers: int = 24,
                    clipping: float = 1.0, cycle_betas: bool = True, lr_warmup: float = 1.0) -> AdamW:
    """The reference's AdamW recipe with its schedules, over ``params``
    (name -> tensor)."""
    return AdamW(
        params,
        lr_sched=cosine_warmup(lr, lr_final, warmup_iters, total_iters, init_value=lr * lr_warmup),
        b1_sched=betas_schedule(cycle_betas, warmup_iters, total_iters),
        wd_sched=cosine_warmup(wd, wd_final, 0, total_iters),
        scales=lr_scale_tree(params, encoder_lr / lr, ld, num_encoder_layers),
        wd_mask=wd_mask_tree(params),
        clipping=clipping,
    )
