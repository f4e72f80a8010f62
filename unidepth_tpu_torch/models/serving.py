"""Serving precision for the model wrappers (counterpart of
unidepth_tpu/models/serving.py).

The JAX mixin does two things. Its compute-dtype pre-cast is
``module.to(dtype)`` here (``UniDepthV2.from_config``). Its opt-in int8
mode is ported as this mixin: ``set_serving_precision('int8')`` makes
``infer()`` run an int8 copy of the ViT encoder (``DinoViT.quantize``), whose
qkv/proj/fc1/fc2 GEMMs are int8 x int8 -> int32 with per-output-channel
weight scales and per-token dynamic activation scales (``ops/quant.py``).
The decoder, pre- and postprocessing are untouched.

The weights are quantized from fp32 values, never from a bf16 copy, as in
the JAX package. An encoder linear held in fp32 is quantized from its own
parameter. One held below fp32 has lost those values, so for it alone the
model keeps an fp32 copy on the CPU (``_fp32_masters``): taken when its
weights are written through ``init_params`` or ``load_state_dict``, or when
a cast (``model.to(torch.bfloat16)``) lowers it from fp32, and dropped when
it is fp32 again. An fp32 model holds no second copy. The int8 build uses a
master only while it still equals its parameter at the parameter's dtype;
a bf16 weight written any other way has no fp32 value left, and the build
raises. The int8 encoder is built once per (stage mask, device, dtype) and
rebuilt when any of them changes or the weights are written through
``init_params`` or ``load_state_dict``. A parameter changed in place after
the build is seen at the next build (``set_serving_precision`` to
'default' and back).

The JAX logit audit (``audit_attention_logits``, ``serving_safe_softmax``)
is not ported: the port's attention kernels keep the row max.

UniDepthV2old takes this mixin as V2 does: blanket int8 is accepted
(the JAX ``INT8_REQUIRES_CALIBRATION`` is False for it). UniDepthV1 takes
it with ``INT8_REQUIRES_CALIBRATION``: ``set_serving_precision('int8')``
raises until ``calibrate_int8_stages`` has stored a stage mask, and the
int8 copy of its ``max_cls`` encoder keeps the running max and the tail cls
tokens. An encoder with no ``quantize`` (ConvNeXt) refuses int8 with the
JAX message and keeps no masters.
"""

from __future__ import annotations

import torch

from unidepth_tpu_torch.ops.quant import quantizable_linears

__all__ = ["ServingPrecisionMixin"]


class ServingPrecisionMixin:
    """Mixin for ``nn.Module`` model wrappers with a ``pixel_encoder`` and an
    ``infer(image)`` returning ``depth``. Call ``_init_serving()`` at the end
    of ``__init__``; ``init_params`` passes its fp32 draws of the encoder
    linears to ``_set_fp32_masters``. It must precede ``nn.Module`` in the
    bases, for its ``_apply``."""

    #: families whose depth head exponentiates logits (V1) amplify int8 GEMM
    #: noise too much for blanket quantization and must run
    #: ``calibrate_int8_stages`` before int8 is accepted
    INT8_REQUIRES_CALIBRATION = False

    def _init_serving(self):
        self.serving_precision = "default"  # 'default' (compute dtype) | 'int8'
        # per-stage int8 mask from calibrate_int8_stages(); None = every stage
        self._int8_stages = None
        self._encoder_q = None  # (key, int8 encoder), see _serving_encoder
        # qualified name in the encoder -> fp32 (weight, bias) on the CPU, for
        # the linears held below fp32
        self._fp32_masters = None
        self.register_load_state_dict_pre_hook(self._masters_from_state_dict)

    def set_serving_precision(self, mode: str):
        """Select serving numerics: 'default' keeps the compute dtype; 'int8'
        runs every encoder GEMM as int8 x int8 -> int32 (weights quantized
        once, at the next ``infer``; per-token activation scales at run time)."""
        if mode not in ("default", "int8"):
            raise ValueError(f"unknown serving precision {mode!r}")
        if mode == "int8" and not hasattr(self.pixel_encoder, "quantize"):
            raise ValueError(
                "int8 serving requires a ViT encoder (DinoViT); "
                f"{type(self.pixel_encoder).__name__} has no int8 GEMM path"
            )
        if mode == "int8" and self.INT8_REQUIRES_CALIBRATION and self._int8_stages is None:
            raise ValueError(
                f"{type(self).__name__} exponentiates its depth logits; blanket int8 "
                "is unvalidated for it. Run calibrate_int8_stages(image) first."
            )
        if mode != self.serving_precision:
            self.serving_precision = mode
            self._reset_serving_caches()

    def _reset_serving_caches(self):
        self._encoder_q = None

    def _quantizable_linears(self) -> dict:
        """The encoder linears int8 serving would quantize: none for an
        encoder without an int8 path."""
        return quantizable_linears(self.pixel_encoder) if hasattr(self.pixel_encoder, "quantize") else {}

    def _int8_stage_mask(self):
        """Current per-stage int8 mask as a tuple, or None for blanket int8."""
        m = self._int8_stages
        return None if m is None else tuple(bool(x) for x in m)

    def calibrate_int8_stages(self, image, max_rel_err: float = 0.05):
        """Sensitivity-ordered selective int8: measure each encoder stage's
        depth drift under int8 GEMMs on ``image`` (a batch ``infer`` accepts),
        then enable stages greedily, most robust first, while the cumulative
        mean relative depth error against the default-precision forward
        stays within ``max_rel_err``. Runs ``2 * n_stages + 1`` forwards.

        Returns ``per_stage`` (solo mean rel err, stage order), ``selected``
        (the stored mask), ``rel_err`` (cumulative err of the selection) and
        ``max_rel_err``. Raises if no stage fits the budget."""
        if not hasattr(self.pixel_encoder, "quantize"):
            raise ValueError(
                "int8 calibration requires a ViT encoder (DinoViT); "
                f"{type(self.pixel_encoder).__name__} has no int8 GEMM path"
            )
        n = len(self.pixel_encoder.cfg.output_idx)
        prev_mode, prev_mask = self.serving_precision, self._int8_stages

        def run_depth(mode, mask):
            self._int8_stages = mask
            self.serving_precision = mode
            self._reset_serving_caches()
            return self.infer(image)["depth"].float()

        try:
            base = run_depth("default", None)

            def err_of(mask):
                d = run_depth("int8", mask)
                return float(((d - base).abs() / (base.abs() + 1e-6)).mean())

            solo = sorted((err_of(tuple(j == i for j in range(n))), i) for i in range(n))
            kept = [False] * n
            kept_err = 0.0
            for e, i in solo:
                if e > max_rel_err:
                    break  # solo already over budget; the rest are worse
                trial = list(kept)
                trial[i] = True
                te = err_of(tuple(trial))
                if te <= max_rel_err:
                    kept, kept_err = trial, te
        finally:
            self._int8_stages = prev_mask
            self.serving_precision = prev_mode
            self._reset_serving_caches()
        if not any(kept):
            raise ValueError(
                f"int8 calibration failed: no encoder stage keeps mean rel depth err "
                f"<= {max_rel_err} (best solo {solo[0][0]:.3f} at stage {solo[0][1]})"
            )
        self._int8_stages = tuple(kept)
        self._reset_serving_caches()
        return {
            "per_stage": [(i, e) for e, i in solo],
            "selected": tuple(kept),
            "rel_err": kept_err,
            "max_rel_err": max_rel_err,
        }

    def _serving_encoder(self):
        """The encoder ``infer`` runs: the model's own, or its int8 copy."""
        if self.serving_precision != "int8":
            return self.pixel_encoder
        mask = self._int8_stage_mask()
        p = next(self.pixel_encoder.parameters())
        key = (mask, p.device, p.dtype)
        if self._encoder_q is None or self._encoder_q[0] != key:
            enc = self.pixel_encoder.quantize(True if mask is None else mask, self._int8_weights())
            self._encoder_q = (key, enc)
        return self._encoder_q[1]

    def _int8_weights(self) -> dict:
        """The fp32 (weight, bias) to quantize each encoder linear from: the
        parameters when they are fp32, else the master, moved to the
        parameter's device, while it cast to the parameter's dtype still
        equals the parameter."""
        masters = self._fp32_masters or {}
        out, lost = {}, []
        for name, m in self._quantizable_linears().items():
            live = (m.weight, m.bias)
            if m.weight.dtype == torch.float32:
                out[name] = live
                continue
            master = tuple(None if t is None else t.to(m.weight.device) for t in masters.get(name, ()))
            if master and all(
                (t is None) == (p is None) and (p is None or torch.equal(t.to(p.dtype), p))
                for t, p in zip(master, live)
            ):
                out[name] = master
            else:
                lost.append((name, m.weight.dtype))
        if lost:
            raise ValueError(
                f"int8 serving quantizes from fp32 weights, but {len(lost)} encoder linears "
                f"(first {lost[0][0]!r}) are {lost[0][1]} with no fp32 master that matches "
                "them: write the weights with load_state_dict or init_params"
            )
        return out

    def _set_fp32_masters(self, weights: dict):
        """Merge fp32 masters (qualified encoder name -> (weight, bias)) over
        the current ones, keep those of the linears held below fp32, and drop
        the int8 encoder built from earlier weights."""
        lin = self._quantizable_linears()
        masters = {**(self._fp32_masters or {}), **weights}
        self._fp32_masters = {n: wb for n, wb in masters.items() if lin[n].weight.dtype != torch.float32} or None
        self._reset_serving_caches()

    @staticmethod
    def _fp32_copy(*tensors):
        return tuple(None if t is None else t.detach().to("cpu", torch.float32, copy=True) for t in tensors)

    def _masters_from_state_dict(self, module, state_dict, prefix, *_args):
        """``load_state_dict`` pre-hook: copy the quantizable encoder linears
        of ``state_dict`` that land in parameters below fp32."""
        pre = f"{prefix}pixel_encoder."
        found = {}
        for name, m in self._quantizable_linears().items():
            w = state_dict.get(f"{pre}{name}.weight")
            if w is not None and m.weight.dtype != torch.float32:
                found[name] = self._fp32_copy(w, state_dict.get(f"{pre}{name}.bias"))
        self._set_fp32_masters(found)

    def _apply(self, fn, recurse=True):
        """A cast (``.to``, ``.bfloat16()``, ...) that lowers an fp32 encoder
        linear loses its fp32 values: copy them as masters first."""
        with torch.no_grad():
            lowered = {
                name: self._fp32_copy(m.weight, m.bias)
                for name, m in self._quantizable_linears().items()
                if m.weight.dtype == torch.float32 and fn(m.weight[:0]).dtype != torch.float32
            }
        out = super()._apply(fn, recurse)
        self._set_fp32_masters(lowered)
        return out
