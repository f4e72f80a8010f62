#!/usr/bin/env python3
"""Does an image's depth map depend on its row in the batch, and which op
makes it so?

    python3 scripts_torch/batch_row_probe.py [--config-file configs/config_v2_vitl14.json] [--side 518]

Run from the root of a checkout. Builds UniDepthV2 from the config (random
weights, ``init_params(seed=0)``) in fp32 and in bf16, and runs four
modes: fp32 with the kernels off, fp32 with them on, bf16 with them off
and bf16 with them on (TF32 off throughout, as ``chip_smoke.py`` runs).
In each mode it prints:

1. the same seeded image x in row 1 of ``[a, x]`` against row 0 of ``[x,
   b]`` (B = 2), and in row 7 of ``[b1 .. b7, x]`` against row 0 of ``[x,
   b1 .. b7]`` (B = 8): the share of x's depth pixels that differ and the
   largest relative difference;
2. which modules and which torch ops of one ``infer()`` at B = 2 are not
   row-equivariant: each call is run twice more, on a contiguous copy of
   its inputs and on that copy with the two rows swapped (the copies keep
   a strided view's layout change out of the comparison), and a call whose
   two outputs, the second swapped back, are not bitwise equal is listed
   (module name or op, input shapes and dtypes, the share of output
   elements that moved, the largest absolute and relative move). The
   innermost listed call is the op at fault; an op whose inputs already
   moved is not listed for that reason alone, because the reruns feed it
   its own inputs;
3. each listed ``conv2d`` alone, replayed on its captured inputs: the
   swap with cuDNN on and off, in channels-last, and in float32 on the same
   values, and each image of the pair against the same image alone (B = 1).

A ``{"batch_row": ...}`` line carries the figures beside the card's name
and power limit. ``--device cpu`` runs the same on the CPU (fp32 modes
only), for a rehearsal at a small ``--side`` with a small config.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2  # noqa: E402

SEED = 0
LISTED = 40  # at most this many calls listed a mode


def _swap(obj, b):
    """``obj`` with the rows of every batch-leading tensor reversed."""
    if isinstance(obj, torch.nn.Parameter):
        return obj
    if torch.is_tensor(obj):
        return obj.flip(0) if obj.ndim and obj.shape[0] == b else obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_swap(o, b) for o in obj)
    if isinstance(obj, dict):
        return {k: _swap(v, b) for k, v in obj.items()}
    return obj


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _contiguous(obj):
    """``obj`` with every tensor but a parameter copied contiguous."""
    if isinstance(obj, torch.nn.Parameter):
        return obj
    if torch.is_tensor(obj):
        return obj.clone(memory_format=torch.contiguous_format)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_contiguous(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _contiguous(v) for k, v in obj.items()}
    return obj


def _rows_moved(fn, args, kwargs, b):
    """``_moved`` of ``fn`` on a contiguous copy of its inputs against the
    copy with the rows swapped."""
    args, kwargs = _contiguous(args), _contiguous(kwargs)
    return _moved(fn(*args, **kwargs), fn(*_swap(args, b), **_swap(kwargs, b)), b)


def _moved(out, again, b):
    """Worst difference between ``out`` and ``again`` swapped back, over the
    batch-leading floating tensors of an output; None where bitwise equal."""
    worst = None
    for o, a in zip(_tensors(out), _tensors(_swap(again, b))):
        if not (o.is_floating_point() and o.ndim and o.shape[0] == b and o.shape == a.shape):
            continue
        o, a = o.float(), a.float()
        diff = (o - a).abs()
        if not (diff > 0).any():
            continue
        share = (diff > 0).float().mean().item()
        rel = (diff / o.abs().clamp_min(1e-30)).max().item()
        entry = {"moved_share": share, "max_abs": diff.max().item(), "max_rel": rel, "max_out": o.abs().max().item()}
        if worst is None or entry["max_abs"] > worst["max_abs"]:
            worst = entry
    return worst


def _shapes(args):
    return [f"{tuple(t.shape)} {str(t.dtype).replace('torch.', '')}" for t in _tensors(args)]


class RowProbe(TorchFunctionMode):
    """Reruns every torch op and module call with the batch's rows swapped
    and lists those whose output does not swap with them."""

    SKIP = ("__setitem__", "copy_", "fill_", "zero_", "set_", "uniform_", "normal_", "resize_")

    def __init__(self, model, b):
        super().__init__()
        self.b, self.busy, self.listed, self.convs = b, False, [], {}
        self.handles = [m.register_forward_hook(self._hook(n), with_kwargs=True)
                        for n, m in model.named_modules() if n]

    def _hook(self, name):
        def hook(module, args, kwargs, out):
            if self.busy:
                return
            self.busy = True
            try:
                moved = _rows_moved(module, args, kwargs, self.b)
            finally:
                self.busy = False
            if moved:
                self.listed.append({"call": f"module {name} ({type(module).__name__})", "inputs": _shapes(args),
                                    **moved})
        return hook

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = getattr(func, "__name__", str(func))
        if self.busy or "out" in kwargs or name.endswith("_") and not name.startswith("__") or name in self.SKIP:
            return out
        if not any(t.ndim and t.shape[0] == self.b for t in _tensors(args)):
            return out
        self.busy = True
        try:
            moved = _rows_moved(func, args, kwargs, self.b)
        finally:
            self.busy = False
        if moved:
            self.listed.append({"call": f"op {name}", "inputs": _shapes(args), **moved})
            if name == "conv2d":
                self.convs.setdefault(str(_shapes(args)), (_contiguous(args), dict(kwargs)))
        return out

    def close(self):
        for h in self.handles:
            h.remove()


@torch.inference_mode()
def conv_alone(args, kwargs):
    """A listed conv2d replayed on its captured (B = 2) inputs."""
    x, weight, *rest = args
    conv = torch.nn.functional.conv2d

    def swapped(x, weight, *rest):
        return _moved(conv(x, weight, *rest, **kwargs), conv(x.flip(0), weight, *rest, **kwargs), 2)

    out = {"cudnn": swapped(x, weight, *rest)}
    with torch.backends.cudnn.flags(enabled=False):
        out["cudnn_off"] = swapped(x, weight, *rest)
    cl = x.contiguous(memory_format=torch.channels_last)
    out["channels_last"] = swapped(cl, weight.contiguous(memory_format=torch.channels_last), *rest)
    out["float32"] = swapped(x.float(), weight.float(), *[r.float() if torch.is_tensor(r) else r for r in rest])
    pair = conv(x, weight, *rest, **kwargs)
    for i in range(2):
        alone = conv(x[i : i + 1], weight, *rest, **kwargs)[0]
        diff = (pair[i].float() - alone.float()).abs()
        out[f"row{i}_vs_alone"] = {"moved_share": (diff > 0).float().mean().item(), "max_abs": diff.max().item()}
    return {k: v or "bitwise equal" for k, v in out.items()}


def depth_of_x_by_row(model, x, others, b):
    """x's depth in the last row of [others[:b-1], x] and in row 0 of [x,
    others[:b-1]]."""
    last = model.infer(np.concatenate([others[: b - 1], x[None]]))["depth"][b - 1]
    first = model.infer(np.concatenate([x[None], others[: b - 1]]))["depth"][0]
    diff = (last.float() - first.float()).abs()
    return {"moved_share": (diff > 0).float().mean().item(),
            "max_rel": (diff / first.float().abs().clamp_min(1e-30)).max().item()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", default=str(ROOT / "configs" / "config_v2_vitl14.json"))
    ap.add_argument("--side", type=int, default=518)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    cuda = args.device in (None, "cuda")
    if cuda and not torch.cuda.is_available():
        raise SystemExit("batch_row_probe: no CUDA device; pass --device cpu for a rehearsal")
    dev = torch.device("cuda" if cuda else args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = "cpu"
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, f"torch {torch.__version__}", flush=True)
    config = json.loads(Path(args.config_file).read_text())
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 256, (args.side, args.side, 3), dtype=np.uint8)
    others = rng.integers(0, 256, (7, args.side, args.side, 3), dtype=np.uint8)
    dtypes = (torch.float32, torch.bfloat16) if cuda else (torch.float32,)
    figures = {}
    for dtype in dtypes:
        model = UniDepthV2.from_config(config, device=dev, dtype=dtype).init_params(seed=SEED).eval()
        for kernels in (False, True):
            model.set_kernels(kernels)
            mode = f"{str(dtype).replace('torch.', '')} kernels {'on' if kernels else 'off'}"
            rows = {f"B={b}": depth_of_x_by_row(model, x, others, b) for b in (2, 8)}
            probe = RowProbe(model, 2)
            try:
                with probe:
                    model.infer(np.stack([others[0], x]))
            finally:
                probe.close()
            alone = {sig: conv_alone(*call) for sig, call in probe.convs.items()}
            figures[mode] = {**rows, "calls_moved": len(probe.listed), "listed": probe.listed[:LISTED],
                             "conv2d_alone": alone}
            print(f"{mode}: x's depth by row {rows}; {len(probe.listed)} calls not row-equivariant", flush=True)
            for entry in probe.listed[:LISTED]:
                print("   ", json.dumps(entry), flush=True)
            for sig, result in alone.items():
                print(f"    conv2d {sig} alone: {json.dumps(result)}", flush=True)
        del model
        if cuda:
            torch.cuda.empty_cache()
    print(json.dumps({"batch_row": figures, "device": smi}))


if __name__ == "__main__":
    main()
