"""The port's closed-form cost model (ops/costs.py) against the JAX
package's ``cosy_tpu.ops.costs``: every function gives the same floats on
``ModelConfig()`` / ``TrainConfig()`` and on tiny configs, the production
values pinned by tests/test_costs.py hold, ``decode_bytes_per_token``
keeps its invariants (int8 included), and the estimator's count is held to
``torch.utils.flop_counter.FlopCounterMode`` over the port's plain
estimator on the CPU.

torch's counter differs from the closed form by design on one op: the
closed form counts each up-sampling conv as a k=3 conv over its output
frames, while the op is a stride-2 ``ConvTranspose1d`` with k=4, whose
count torch takes over its input frames (2 B C_in C_out K L_in).  With
that term swapped the two counts are equal exactly; unswapped the closed
form is 0.69% above torch's at the tiny config (JAX's band against XLA is
-8% to +0.5%)."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cosy_tpu.config import EstimatorConfig as JEst
from cosy_tpu.config import ModelConfig as JModel
from cosy_tpu.config import TrainConfig as JTrain
from cosy_tpu.config import tiny_model_config as j_tiny
from cosy_tpu.ops import costs as JC
from cosy_tpu_torch.config import ModelConfig, TrainConfig
from cosy_tpu_torch.layers.unet import conditional_decoder, init_conditional_decoder
from cosy_tpu_torch.models.llm import init_llm_params
from cosy_tpu_torch.ops import costs as C
from cosy_tpu_torch.params import P, Spec, spec_tensors
from test_torch_common import port_config
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

MODELS = {"300M": JModel(), "tiny": j_tiny(), "tiny_8_mels": j_tiny(n_mels=8)}
SHAPES = [(8, 1, 32, 144, 248), (1, 16, 32, 144, 248), (3, 2, 7, 40, 69)]


def _cost(c):
    return (c.linear, c.attn, c.pos, c.total, c.train_total())


@pytest.mark.parametrize("model", list(MODELS))
def test_every_function_equals_jax(model):
    jm = MODELS[model]
    tm = port_config(jm)
    jt, tt = JTrain(), TrainConfig()
    for B, T in ((2, 256), (8, 512), (1, 17)):
        assert _cost(C.estimator_call_flops(tm.flow.estimator, B, T)) == \
            _cost(JC.estimator_call_flops(jm.flow.estimator, B, T))
        for nfe in (1, 10):
            assert C.cfm_solve_flops(tm.flow, B, T, nfe) == JC.cfm_solve_flops(jm.flow, B, T, nfe)
    for enc_t, enc_j in ((tm.llm.llm, jm.llm.llm), (tm.llm.text_encoder, jm.llm.text_encoder),
                         (tm.flow.encoder, jm.flow.encoder),
                         (dataclasses.replace(tm.flow.encoder, macaron_style=True,
                                              pos_enc_layer_type="abs_pos"),
                          dataclasses.replace(jm.flow.encoder, macaron_style=True,
                                              pos_enc_layer_type="abs_pos"))):
        assert _cost(C.encoder_block_flops(enc_t, 2, 33)) == \
            _cost(JC.encoder_block_flops(enc_j, 2, 33))
        assert _cost(C.encoder_flops(enc_t, 2, 33, 512)) == \
            _cost(JC.encoder_flops(enc_j, 2, 33, 512))
    for B, accum, Tt, Ts, Tm in SHAPES:
        assert _cost(C.llm_fwd_flops(tm.llm, B, Tt, Ts)) == \
            _cost(JC.llm_fwd_flops(jm.llm, B, Tt, Ts))
        assert _cost(C.flow_fwd_flops(tm.flow, B, Ts, Tm)) == \
            _cost(JC.flow_fwd_flops(jm.flow, B, Ts, Tm))
        assert C.joint_step_flops(tm, tt, B, accum, Tt, Ts, Tm) == \
            JC.joint_step_flops(jm, jt, B, accum, Tt, Ts, Tm)


def test_production_costs_pinned_to_the_recorded_values():
    """tests/test_costs.py:53-76's pins, on the port's functions."""
    mc, tc = ModelConfig(), TrainConfig()
    est = C.estimator_call_flops(mc.flow.estimator, 8, 512).total
    assert abs(est - 451.847e9) / 451.847e9 < 0.02, est / 1e9
    assert C.cfm_solve_flops(mc.flow, 4, 512, 10) == pytest.approx(10 * est)
    jb8 = C.joint_step_flops(mc, tc, 8, 1, 32, 144, 248)
    assert abs(jb8 - 1767.40e9) / 1767.40e9 < 0.025, jb8 / 1e9
    jb1 = C.joint_step_flops(mc, tc, 1, 1, 32, 144, 248)
    assert abs(jb1 - 231.91e9) / 231.91e9 < 0.03, jb1 / 1e9
    j2 = C.joint_step_flops(mc, tc, 8, 2, 32, 144, 248)
    assert j2 == pytest.approx(2 * jb8)
    assert C.joint_step_flops(mc, tc, 1, 16, 32, 144, 248) / j2 == pytest.approx(1.0, abs=0.15)


def test_decode_bytes_model_invariants_and_jax():
    tm = port_config(j_tiny())
    p16 = {k: v.to(torch.bfloat16) for k, v in
           init_llm_params(tm.llm, "cpu", seed=0).state_dict().items()}
    b16 = C.decode_bytes_per_token(p16, tm.llm, 64)
    b8 = C.decode_bytes_per_token(p16, tm.llm, 64, int8_weights=True)
    assert b8 < b16
    assert C.decode_bytes_per_token(p16, tm.llm, 128) > b16
    blk = sum(v.numel() * 2 for k, v in p16.items() if k.startswith("llm.encoders."))
    assert b16 > blk * 0.9
    jp = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) for k, v in p16.items()}
    jcfg = j_tiny().llm
    assert b16 == JC.decode_bytes_per_token(jp, jcfg, 64)
    assert b8 == JC.decode_bytes_per_token(jp, jcfg, 64, int8_weights=True)


def _upsample_terms(cfg, B, T):
    """(the closed form's count of the up-sampling convs, torch's count of
    the same ConvTranspose1d ops): each level but the last writes its
    shallower neighbour's frames through a k=4 stride-2 transposed conv."""
    lens = [T]
    for _ in range(len(cfg.channels) - 1):
        lens.append(-(-lens[-1] // 2))
    closed = torch_count = 0
    for i in range(len(cfg.channels) - 1):
        lvl = len(cfg.channels) - 1 - i
        c = cfg.channels[lvl]
        closed += 2 * B * lens[lvl - 1] * 3 * c * c
        torch_count += 2 * B * c * c * 4 * lens[lvl]
    return closed, torch_count


@pytest.mark.parametrize("channels, T", [((32, 32), 64), ((24, 24, 24), 48)])
def test_estimator_flops_against_torch_flop_counter(channels, T):
    """tests/test_costs.py:33's tiny estimator, and a three-level one of one
    width at every level (as the 300M U-Net's: the closed form assumes it)."""
    cfg = port_config(JEst(channels=channels, n_blocks=1, num_mid_blocks=2, num_heads=2,
                           attention_head_dim=16))
    spec = Spec()
    init_conditional_decoder(spec, "", cfg)
    p = P(spec_tensors(spec, "cpu", torch.Generator().manual_seed(0)))
    B = 2
    x = torch.ones(B, 80, T)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        conditional_decoder(p, cfg, x, None, x, torch.full((B,), 0.5), torch.ones(B, 80), x)
    counted = counter.get_total_flops()
    closed = C.estimator_call_flops(cfg, B, T).total
    up_closed, up_torch = _upsample_terms(cfg, B, T)
    assert closed - up_closed == counted - up_torch
    dev = (closed - counted) / counted
    assert 0.0 < dev < 0.01, dev
