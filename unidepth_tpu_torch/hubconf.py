"""Model factory (counterpart of the root hubconf.py, which builds the JAX
models).

``UniDepth(version, backbone, pretrained=None, device=None)`` builds the
requested model of the port from the repo's config zoo, on ``device`` (the
card unless named; without one pass ``device="cpu"``), or loads a local
checkpoint through the class's ``from_pretrained``. Without ``pretrained``
the weights are the module's fresh ones: call ``init_params(seed)`` for the
JAX initializers' draws.
"""

import json
from pathlib import Path

dependencies = ["torch", "numpy"]

_ROOT = Path(__file__).resolve().parents[1]

_CONFIGS = {
    ("v1", "vitl14"): "configs/config_v1_vitl14.json",
    ("v1", "cnvnxtl"): "configs/config_v1_cnvnxtl.json",
    ("v2", "vits14"): "configs/config_v2_vits14.json",
    ("v2", "vitb14"): "configs/config_v2_vitb14.json",
    ("v2", "vitl14"): "configs/config_v2_vitl14.json",
    ("v2old", "vits14"): "configs/config_v2old_vits14.json",
    ("v2old", "vitl14"): "configs/config_v2old_vitl14.json",
}


def UniDepth(version: str = "v2", backbone: str = "vitl14", pretrained: str | None = None, device=None):
    """version 'v1' | 'v2' | 'v2old'; backbone 'vits14' | 'vitb14' | 'vitl14'
    | 'cnvnxtl' (the pairs of ``_CONFIGS``). ``pretrained``: a local
    checkpoint directory or file (no download)."""
    from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
    from unidepth_tpu_torch.models.unidepthv2.old import UniDepthV2old

    cls = {"v1": UniDepthV1, "v2": UniDepthV2, "v2old": UniDepthV2old}[version]
    if pretrained:
        return cls.from_pretrained(pretrained, device=device)
    config = json.loads((_ROOT / _CONFIGS[(version, backbone)]).read_text())
    return cls.from_config(config, device=device)
