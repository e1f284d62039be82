"""The port's HF CLIP loader (models/sd/hf.py) against the JAX package's.

On a random transformers CLIP text model (2 layers, width 32): the config
and every array of ``clip_weights_from_hf_state_dict`` equal the JAX
package's, and the port's text encoder on those weights matches
transformers' hidden states and pooled output (rtol = atol = 2e-3, the bar
of tests/test_clip_hf_parity.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from onnxstream_tpu.models.sd.hf import clip_config_from_hf as jax_config_from_hf  # noqa: E402
from onnxstream_tpu.models.sd.hf import clip_weights_from_hf_state_dict as jax_weights_from_hf  # noqa: E402
from onnxstream_tpu_torch import Session, SessionConfig  # noqa: E402
from onnxstream_tpu_torch.models.sd.clip import build_text_encoder  # noqa: E402
from onnxstream_tpu_torch.models.sd.hf import clip_config_from_hf, clip_weights_from_hf_state_dict  # noqa: E402
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy  # noqa: E402


def _hf(pooled: bool, act: str):
    cfg = transformers.CLIPTextConfig(
        vocab_size=120, hidden_size=32, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2,
        max_position_embeddings=9, hidden_act=act, eos_token_id=119, bos_token_id=118, pad_token_id=119,
        projection_dim=24)
    torch.manual_seed(0)
    cls = transformers.CLIPTextModelWithProjection if pooled else transformers.CLIPTextModel
    return cfg, cls(cfg).eval()


@pytest.mark.parametrize("pooled,act", [(True, "quick_gelu"), (False, "gelu")])
def test_clip_weights_equal_jax(pooled, act):
    hf_cfg, hf = _hf(pooled, act)
    cfg = clip_config_from_hf(hf_cfg, pooled=pooled)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config_from_hf(hf_cfg, pooled=pooled))
    ours = clip_weights_from_hf_state_dict(hf.state_dict(), cfg)
    theirs = jax_weights_from_hf(hf.state_dict(), jax_config_from_hf(hf_cfg, pooled=pooled))
    assert sorted(ours) == sorted(theirs) and len(ours) > 20
    assert ("text_projection.weight.bin" in ours) == pooled
    for name in ours:
        assert ours[name].dtype == theirs[name].dtype == np.float32
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)


def test_port_text_encoder_on_hf_weights_matches_transformers():
    hf_cfg, hf = _hf(True, "quick_gelu")
    cfg = clip_config_from_hf(hf_cfg, pooled=True)
    b = build_text_encoder(cfg)
    weights = dict(b.weights)
    weights.update(clip_weights_from_hf_state_dict(hf.state_dict(), cfg))
    s = Session(SessionConfig(device=torch.device("cpu")), weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    s.read_string(b.to_text())
    toks = np.array([[118, 5, 9, 42, 7, 3, 2, 1, 119]], np.int64)
    s.add_tensor("tokens", toks)
    out = s.run()
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(toks), output_hidden_states=True)
    np.testing.assert_allclose(out["last_hidden_state"], ref.last_hidden_state.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(out["pooled_output"], ref.text_embeds.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(out["penultimate_hidden_state"], ref.hidden_states[-2].numpy(), rtol=2e-3, atol=2e-3)
