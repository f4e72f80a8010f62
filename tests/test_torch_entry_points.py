"""Where the port's model entry points put the model: on the card unless the
caller names a device, and never on the CPU by a silent fallback."""

import json

import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu_torch.models.unidepthv2 import model as model_module
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2

CFG = {
    "model": {
        "name": "UniDepthV2", "num_heads": 2,
        "pixel_decoder": {"hidden_dim": 64, "out_dim": 16, "depths": [1, 1, 1]},
        "pixel_encoder": {
            "name": "dinov2_vits14", "embed_dim": 128, "depth": 2, "num_heads": 2,
            "pos_embed_size": 8, "output_idx": [1, 1, 2, 2], "use_norm": False,
        },
    },
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_from_config_without_a_card_raises_naming_cpu(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        UniDepthV2.from_config(CFG)


def test_from_pretrained_without_a_card_raises_before_reading(no_card, tmp_path):
    """The device is resolved first: an empty directory is never opened."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        UniDepthV2.from_pretrained(tmp_path)


def test_unnamed_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert model_module.resolve_device(None) == torch.device("cuda")
    assert model_module.resolve_device("cpu") == torch.device("cpu")


def test_from_config_on_the_cpu_is_fp32(no_card):
    model = UniDepthV2.from_config(CFG, device="cpu")
    assert {(p.device.type, p.dtype) for p in model.parameters()} == {("cpu", torch.float32)}


def test_from_pretrained_passes_device_and_dtype(no_card, tmp_path):
    src = UniDepthV2.from_config(CFG, device="cpu").init_params(seed=5)
    (tmp_path / "config.json").write_text(json.dumps(CFG))
    torch.save(src.state_dict(), tmp_path / "pytorch_model.bin")
    loaded = UniDepthV2.from_pretrained(tmp_path, device="cpu", dtype=torch.bfloat16)
    want = src.state_dict()
    for key, value in loaded.state_dict().items():
        assert value.device.type == "cpu" and value.dtype == torch.bfloat16, key
        assert torch.equal(value, want[key].to(torch.bfloat16)), key


def test_trainer_without_a_card_raises_naming_cpu(no_card):
    from unidepth_tpu_torch.training.trainer import build_trainer

    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_trainer({**CFG, "training": {}})


def test_trainer_unnamed_device_is_the_card(monkeypatch):
    """With a card and no device named, the trainer builds its model there
    (the build is stopped before it touches CUDA)."""
    from unidepth_tpu_torch.training import trainer

    class Stop(Exception):
        pass

    asked = []

    def from_config(config, device=None, dtype=None):
        asked.append((device, dtype))
        raise Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(trainer.UniDepthV2, "from_config", from_config)
    with pytest.raises(Stop):
        trainer.build_trainer({**CFG, "training": {}})
    assert asked == [(torch.device("cuda"), torch.float32)]  # fp32 masters first, then the compute dtype


def test_encode_decode_runs_where_the_model_is(no_card):
    """``encode_decode`` takes the batch to the model's device and dtype: a
    model built on the CPU trains there, from numpy-made tensors."""
    model = UniDepthV2.from_config({**CFG, "model": {**CFG["model"], "pixel_encoder": {
        **CFG["model"]["pixel_encoder"], "depth": 4, "output_idx": [1, 2, 3, 4]}}}, device="cpu").init_params(seed=0)
    image = torch.randn(1, 28, 28, 3, dtype=torch.float64)
    out = model.encode_decode(image)
    assert out["depth"].shape == (1, 28, 28, 1) and out["depth"].dtype == torch.float32
    assert out["depth"].requires_grad
