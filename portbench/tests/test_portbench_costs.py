"""The frozen cost model: its copied part equals the port's ``ops/costs.py``;
its extension equals hand counts at the toy configurations."""

import math
import types

import pytest

from portbench.reference.frozen import config as FC
from portbench.tests import tiny
from portbench import spec
from portbench.reference.frozen.config import EstimatorConfig, HiFTConfig, ModelConfig, TrainConfig
from portbench.reference.frozen.models.flow2 import Flow2Config
from portbench.reference.frozen.models.qwen2lm import Qwen2LMConfig
from portbench.yardstick import costs as C
from portbench.yardstick import work
from cosy_tpu_torch import config as PC
from cosy_tpu_torch.ops import costs as PORT


def test_estimator_call_matches_the_port_and_the_record():
    est = ModelConfig().flow.estimator
    got = C.estimator_call_flops(est, 2, 312).total
    assert got == PORT.estimator_call_flops(PC.ModelConfig().flow.estimator, 2, 312).total
    assert got / 1e9 == pytest.approx(62.637, abs=5e-4)  # the 62.637 GFLOP call of PERF.md [6]


@pytest.mark.parametrize("T", [206, 313, 2330])
def test_solve_and_encoders_match_the_port(T):
    ours, port = ModelConfig(), PC.ModelConfig()
    assert C.cfm_solve_flops(ours.flow, 1, T, 10) == PORT.cfm_solve_flops(port.flow, 1, T, 10)
    assert C.flow_fwd_flops(ours.flow, 2, T // 2, T).total == \
        PORT.flow_fwd_flops(port.flow, 2, T // 2, T).total
    assert C.llm_fwd_flops(ours.llm, 2, 40, T).total == PORT.llm_fwd_flops(port.llm, 2, 40, T).total


def test_joint_step_matches_the_port():
    ours = C.joint_step_flops(ModelConfig(), TrainConfig(), 8, 2, 40, 146, 250)
    port = PORT.joint_step_flops(PC.ModelConfig(), PC.TrainConfig(), 8, 2, 40, 146, 250)
    assert ours == port and ours > 0


def _conv(L, K, cin, cout):
    return 2 * L * K * cin * cout


def test_hift_by_hand_at_the_toy_config():
    h = spec.build(HiFTConfig, tiny.config_cv2()["hift"])
    T = 10
    # f0 predictor: 80 -> 8 then four 8 -> 8 convs (k = 3), classifier 8 -> 1
    f = _conv(T, 3, 80, 8) + 4 * _conv(T, 3, 8, 8) + 2 * T * 8
    f += _conv(T, 7, 80, 16)  # conv_pre
    samples = T * 8 * 8 * 4
    f += 2 * (samples // 4 + 1) * 16 * 18  # source STFT
    f += 2 * samples * 3  # l_linear over nb_harmonics + 1
    # stage 0: ups 16 -> 8 (k 16) from T frames; L = 8T; source down k = 2 * 8; a source
    # resblock (k 3, one dilation, two convs); the resblock (k 3, dilations 1, 3)
    f += _conv(T, 16, 16, 8) + _conv(8 * T, 16, 18, 8) + 2 * _conv(8 * T, 3, 8, 8) \
        + 4 * _conv(8 * T, 3, 8, 8)
    # stage 1: 8 -> 4 at L = 64T; source down k = 1
    f += _conv(8 * T, 16, 8, 4) + _conv(64 * T, 1, 18, 4) + 2 * _conv(64 * T, 3, 4, 4) \
        + 4 * _conv(64 * T, 3, 4, 4)
    f += _conv(64 * T, 7, 4, 18)  # conv_post
    f += 2 * 64 * T * 9 * 2 * 16  # iSTFT
    assert C.hift_flops(h, T) == f


def test_qwen2_decode_step_by_hand():
    llm = spec.build(Qwen2LMConfig, tiny.config_cv2()["llm"])
    c = 7
    # q (32 -> 4 x 8) and o, k and v (32 -> 2 x 8), the gated MLP 32 <-> 64, scores and
    # att @ V over 4 heads of 8 against 7 positions, two layers; the head 32 -> 30 + 3
    layer = 2 * 32 * 32 * 2 + 2 * 32 * 16 * 2 + 2 * 32 * 64 * 3 + 2 * 4 * 8 * 7 * 2
    assert C.qwen2_decode_step_flops(llm, c) == 2 * layer + 2 * 32 * 33


def test_llm_decode_step_by_hand():
    llm = FC.tiny_model_config().llm
    c = 5
    d, ff = 16, 24
    block = 2 * d * d * 4 + 2 * d * ff * 2 + 2 * d * c * 3
    assert C.llm_decode_step_flops(llm, c) == 2 * 16 * d + block + 2 * 16 * 129


def test_flow2_window_by_hand():
    flow = spec.build(Flow2Config, tiny.config_cv2()["flow"])
    n = 12
    e = flow.encoder
    f = 2 * n * 16 * 16 + _conv(n, 4, 16, 16) + _conv(n, 3, 16, 16)
    f += e.num_blocks * C.encoder_block_flops(e, 1, n).total
    f += _conv(2 * n, 5, 16, 16) + 2 * 2 * n * 16 * 16
    f += 1 * C.encoder_block_flops(e, 1, 2 * n).total + 2 * 2 * n * 16 * 80
    f += 10 * C.estimator_call_flops(flow.estimator, 2, 2 * n).total
    assert C.flow2_window_flops(flow, n, 10) == f


def test_estimator_bytes_are_its_weights_and_its_inputs():
    est = EstimatorConfig()
    from cosy_tpu_torch.models.flow import Flow

    port = Flow(PC.ModelConfig().flow, "meta").p
    n = sum(v.numel() for k, v in port.d.items() if k.startswith("decoder.estimator."))
    assert C.estimator_weight_elements(est) == n
    assert C.estimator_call_bytes(est, 2, 312) == 4 * (n + 4 * 2 * 80 * 312 + 2 * 80)


def _port_llm():
    from cosy_tpu_torch.models.llm import TransformerLM

    return TransformerLM(PC.ModelConfig().llm, "meta").p.d


def test_decode_bytes_differ_from_the_ports_by_the_kv_width_and_the_int8_matrices():
    """The port's ``decode_bytes_per_token`` reads the whole KV capacity at
    bf16 and, with ``int8_weights``, the 2-D weights as int8; the step as
    the port runs it reads f32 weights and, for each row, the columns
    ``[0, W)`` of its f32 keys, values and positional window."""
    plain = types.SimpleNamespace(model=ModelConfig())
    e = plain.model.llm.llm
    params = _port_llm()
    cap, W = 640, 300
    port = PORT.decode_bytes_per_token(params, PC.ModelConfig().llm, cap)
    port_kv = e.num_blocks * 2 * e.output_size * cap * 2 + e.output_size * cap * 2
    ours, _ = C.decode_step_work(plain, 1, W)
    ours_kv = 4 * e.num_blocks * 3 * W * e.output_size
    assert ours - ours_kv == port - port_kv  # the same weights, f32, once
    int8 = PORT.decode_bytes_per_token(params, PC.ModelConfig().llm, cap, int8_weights=True)
    mats = [v for k, v in params.items() if (k.startswith("llm.") or k.startswith("llm_decoder."))
            and "linear_pos" not in k and k.endswith(".weight") and v.ndim == 2]
    assert port - int8 == sum(3 * v.numel() - 4 * v.shape[0] for v in mats)
    rows, _ = C.decode_step_work(plain, 16, W)
    assert rows - ours == 15 * ours_kv  # the weights once, the columns a row


def test_qwen2_decode_bytes_leave_out_the_text_embeddings():
    llm = Qwen2LMConfig()
    plain = types.SimpleNamespace(llm=llm)
    q = llm.qwen
    nbytes, flops = C.decode_step_work(plain, 8, 200)
    weights = nbytes / 4 - q.num_hidden_layers * 2 * 8 * 200 * q.num_key_value_heads * q.head_dim
    assert weights < 400e6  # Qwen2-0.5B's 494M less its 136M-entry text embedding
    assert flops == 8 * C.qwen2_decode_step_flops(llm, 200)


def test_stream_geometry():
    assert work.windows_300m(250, 50) == [(0, 120), (100, 220), (200, 250)]
    assert work.windows_300m(100, 50) == [(0, 100)]
    assert work.windows_cv2(60, 3) == [(0, 28), (25, 53), (50, 60)]
    m = ModelConfig()
    icfg = FC.InferenceConfig()
    one = work.chunk_flops_300m(m, icfg, 25, 250, 0, final=False)
    assert one == work.chunk_flops_300m(m, icfg, 25, 250, 0, final=True)
    assert math.isfinite(one) and one > 0
