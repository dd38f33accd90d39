"""The port's Lightning checkpoint reader (``compat.strip_lightning_prefixes``)
against the JAX package's on a synthetic Lightning-style joint checkpoint:
the same keys and the same arrays, exactly."""

import numpy as np
import pytest
import torch

from cosy_tpu.compat import strip_lightning_prefixes as j_strip
from cosy_tpu_torch.compat import strip_lightning_prefixes as t_strip
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

KEYS = (
    "model.llm.llm.encoders.0.self_attn.linear_q.original_layer.weight",
    "model.llm.llm.encoders.0.self_attn.linear_q.lora_A",
    "model.llm.text_embedding.weight",
    "llm.llm_decoder.original_layer.bias",
    "model.flow.decoder.estimator.time_mlp.linear_1.original_layer.weight",
    "flow.encoder.embed.out.0.weight",
    "model.hift.conv_pre.weight",
    "model.llmx.stray.weight",
    "optimizer.state.0",
)


@pytest.mark.parametrize("sub", ["llm", "flow", "hift", "missing"])
def test_strip_lightning_prefixes_matches_jax(sub):
    rng = np.random.default_rng(0)
    flat = {k: rng.standard_normal((3, 2)).astype(np.float32) for k in KEYS}
    want = j_strip(flat, sub)
    got = t_strip({k: torch.from_numpy(v) for k, v in flat.items()}, sub)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert all(".original_layer." not in k for k in got)
    assert len(got) == {"llm": 4, "flow": 2, "hift": 1, "missing": 0}[sub]
