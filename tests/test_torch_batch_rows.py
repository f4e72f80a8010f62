"""An image's depth from ``UniDepthV2.infer()`` does not depend on its row
in the batch (CPU, fp32): the shipped V2 ViT-S/14 configuration at its full
widths (random weights, ``init_params(seed=0)``; the pixel budget shrunk to
20,000-40,000 so the network runs at 140 x 196) gives image x the same depth
in row 1 of ``[a, x]`` as in row 0 of ``[x, b]``, and in row 3 of a batch of
4 as in its row 0. The CPU measures these bitwise equal, so the test holds
them exactly. (A batch of another size may round differently: x alone in a
batch of 2 against x in a batch of 4 moves 95% of its pixels by up to
4.1e-6, the fp32 rounding of differently blocked products, which is not a
dependence on the row.) On the card a bf16 map does move with its row at B
= 2, through a cuDNN convolution (ROADMAP C4, scripts_torch/batch_row_probe.py)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "config_v2_vits14.json"

pytestmark = pytest.mark.filterwarnings("ignore:resolution_level not set")


@pytest.fixture(scope="module")
def model():
    config = json.loads(CONFIG.read_text())
    config["data"]["augmentations"]["shape_constraints"].update(pixels_min=20000, pixels_max=40000)
    return UniDepthV2.from_config(config, device="cpu").init_params(seed=0).eval()


@pytest.mark.parametrize("batch", [2, 4])
def test_depth_does_not_depend_on_the_row(model, batch):
    rng = np.random.default_rng(batch)
    x = rng.integers(0, 256, (1, 140, 196, 3), dtype=np.uint8)
    others = rng.integers(0, 256, (batch - 1, 140, 196, 3), dtype=np.uint8)
    last = model.infer(np.concatenate([others, x]))["depth"][batch - 1]
    first = model.infer(np.concatenate([x, others]))["depth"][0]
    assert last.shape == (140, 196, 1)
    np.testing.assert_array_equal(last.numpy(), first.numpy())
