"""Configuration dataclasses for the PyTorch port.

A copy of the topology and inference dataclasses of the JAX package's
``config.py`` (the port imports nothing of that package).  Defaults are the
CosyVoice-300M shapes; ``tiny_model_config`` is the toy topology the CPU
tests use.  Training configs arrive with the training slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class EncoderConfig:
    """Conformer/Transformer encoder topology (reference: cosyvoice/transformer/encoder.py:37-106)."""

    input_size: int = 512
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    dropout_rate: float = 0.1
    positional_dropout_rate: float = 0.1
    attention_dropout_rate: float = 0.1
    input_layer: str = "linear"  # linear | linear_legacy | embed
    pos_enc_layer_type: str = "rel_pos_espnet"  # rel_pos_espnet | rel_pos | abs_pos
    normalize_before: bool = True
    static_chunk_size: int = 0
    use_dynamic_chunk: bool = False
    use_dynamic_left_chunk: bool = False
    macaron_style: bool = False
    use_cnn_module: bool = False
    cnn_module_kernel: int = 15
    cnn_module_norm: str = "layer_norm"
    causal: bool = False
    key_bias: bool = True
    activation_type: str = "swish"
    selfattention_layer_type: str = "rel_selfattn"
    layer_norm_eps: float = 1e-12  # vendored wenet layers use 1e-12 (encoder_layer.py:52)
    gradient_checkpointing: bool = False

    @property
    def head_dim(self) -> int:
        return self.output_size // self.attention_heads


@dataclass(frozen=True)
class EstimatorConfig:
    """U-Net ConditionalDecoder topology (reference: flow_model.py:687-699, modules.py:886-997)."""

    in_channels: int = 320  # 4 x 80: x + mu + spks + cond
    out_channels: int = 80
    channels: Tuple[int, ...] = (256, 256)
    dropout: float = 0.0
    attention_head_dim: int = 64
    n_blocks: int = 4
    num_mid_blocks: int = 12
    num_heads: int = 8
    act_fn: str = "gelu"  # must stay 'gelu' for CosyVoice-300M weights
    # diffusers GELU defaults to exact gelu; the reference finetune framework
    # uses the tanh approximation (modules.py:132).  Numerically negligible but
    # kept configurable for bit-parity experiments.
    gelu_approximate: bool = True
    # opt-in local-band estimator attention (±attn_window frames, halved per
    # U-Net level); banded attention is not ported yet, so the port raises
    # for a window on CUDA tensors and applies it as a band bias on the CPU
    attn_window: Optional[int] = None

    @property
    def time_embed_dim(self) -> int:
        return self.channels[0] * 4


@dataclass(frozen=True)
class CFMConfig:
    """Conditional flow matching hyperparameters (reference: flow_model.py:50-72)."""

    sigma_min: float = 1e-6
    t_scheduler: str = "cosine"
    training_cfg_rate: float = 0.2
    inference_cfg_rate: float = 0.7


@dataclass(frozen=True)
class FlowConfig:
    """MaskedDiffWithXvec topology (reference: flow_model.py:207-246, 641-723)."""

    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 4096
    input_frame_rate: int = 50
    token_mel_ratio: float = 22050.0 / 256.0 / 50.0  # mel frames per speech token
    encoder: EncoderConfig = field(
        default_factory=lambda: EncoderConfig(
            input_size=512,
            output_size=512,
            attention_heads=8,
            linear_units=2048,
            num_blocks=6,
            attention_dropout_rate=0.1,
            macaron_style=False,
            use_cnn_module=False,
        )
    )
    estimator: EstimatorConfig = field(default_factory=EstimatorConfig)
    cfm: CFMConfig = field(default_factory=CFMConfig)
    # number of Conv1d+GroupNorm+Mish stages in the length regulator
    # (reference: modules.py:800-815; sampling_ratios=(1,1,1,1))
    regulator_stages: int = 4
    # The stock CosyVoice flow encoder applies x * sqrt(d) before rel-pos
    # attention (EspnetRelPositionalEncoding, embedding.py:219) while the
    # reference's self-contained re-implementation omits it (modules.py:382-428).
    # True matches the pretrained checkpoint's training-time semantics.
    encoder_xscale: bool = True


@dataclass(frozen=True)
class LLMConfig:
    """TransformerLM topology (reference: cosyvoice/llm/llm.py:32-76 + model-dir yaml)."""

    text_encoder_input_size: int = 512
    llm_input_size: int = 1024
    llm_output_size: int = 1024
    # 58836 BPE ranks + special tokens (reference tokenizer.py:169-206)
    text_token_size: int = 60515
    speech_token_size: int = 4096
    spk_embed_dim: int = 192
    sos_eos: int = 0
    task_id: int = 1
    length_normalized_loss: bool = True
    lsm_weight: float = 0.0
    text_encoder: EncoderConfig = field(
        default_factory=lambda: EncoderConfig(
            input_size=512,
            output_size=1024,
            attention_heads=16,
            linear_units=4096,
            num_blocks=6,
            attention_dropout_rate=0.0,
            input_layer="linear",
            static_chunk_size=1,
            macaron_style=False,
            use_cnn_module=False,
        )
    )
    llm: EncoderConfig = field(
        default_factory=lambda: EncoderConfig(
            input_size=1024,
            output_size=1024,
            attention_heads=16,
            linear_units=4096,
            num_blocks=14,
            attention_dropout_rate=0.0,
            input_layer="linear_legacy",
            static_chunk_size=1,
            macaron_style=False,
            use_cnn_module=False,
        )
    )


@dataclass(frozen=True)
class HiFTConfig:
    """HiFT NSF-iSTFT vocoder topology (reference: cosyvoice/hifigan/generator.py:392-488)."""

    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 22050
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 8)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16)
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 11)
    source_resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_predictor_num_class: int = 1
    f0_predictor_cond_channels: int = 512
    # im2col-GEMM conv formulation of the JAX package; the port ignores it
    gemm_convs: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """Full CosyVoice-300M stack."""

    llm: LLMConfig = field(default_factory=LLMConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    hift: HiFTConfig = field(default_factory=HiFTConfig)
    sample_rate: int = 22050
    mel_hop: int = 256
    mel_mean: float = -6.0  # reference: config.py:241
    mel_std: float = 2.0  # reference: config.py:242
    mel_pad_value: float = -11.5


@dataclass(frozen=True)
class InferenceConfig:
    """Reference: config.py:249-268."""

    max_prompt_seconds: float = 5.0
    physical_trim_enabled: bool = True
    physical_trim_frames: int = 80
    physical_trim_extra_ms: int = 300
    trim_ratio: float = 0.08
    boundary_trim_ratio: float = 0.20
    # dynamic NFE thresholds (reference: flow_model.py:525-536)
    nfe_short: int = 10
    nfe_mid: int = 15
    nfe_long: int = 20
    nfe_mid_threshold: int = 300
    nfe_long_threshold: int = 500
    # the MeanFlow sampler is not ported yet: the port accepts "euler" only
    sampler: str = "euler"  # "euler" | "meanflow"
    meanflow_steps: int = 2
    # AR decode limits (reference: llm.py:164-228)
    min_token_text_ratio: float = 2.0
    max_token_text_ratio: float = 20.0
    sampling_top_p: float = 0.8
    sampling_top_k: int = 25
    ras_win_size: int = 10
    ras_tau_r: float = 0.1
    # int8 decode, the bucketed final chunk and the short first streaming
    # hop belong to paths that later slices port; kept for config parity
    int8_decode: bool = False
    bucket_final: bool = True
    first_chunk_tokens: int = 0


def replace(cfg, **kw):
    """dataclasses.replace re-export for ergonomic config overrides."""
    return dataclasses.replace(cfg, **kw)


def tiny_model_config(n_mels: int = 80) -> "ModelConfig":
    """Smoke-test topology: same graph structure as CosyVoice-300M at toy
    widths (seconds on a CPU).  Used by the CLI's ``--tiny`` flag and the
    CPU parity tests; NOT loadable from real checkpoints."""
    enc = EncoderConfig(input_size=16, output_size=16, attention_heads=2,
                        linear_units=24, num_blocks=1)
    return ModelConfig(
        llm=LLMConfig(
            text_encoder_input_size=16, llm_input_size=16, llm_output_size=16,
            text_token_size=60515, speech_token_size=128, spk_embed_dim=192,
            text_encoder=replace(enc, static_chunk_size=1),
            llm=replace(enc, static_chunk_size=1, input_layer="linear_legacy"),
        ),
        flow=FlowConfig(
            input_size=16, output_size=n_mels, spk_embed_dim=192, vocab_size=128,
            encoder=enc,
            estimator=EstimatorConfig(
                in_channels=4 * n_mels, out_channels=n_mels, channels=(16, 16),
                attention_head_dim=4, n_blocks=1, num_mid_blocks=1, num_heads=2),
        ),
        hift=HiFTConfig(
            in_channels=n_mels, base_channels=16, nb_harmonics=2,
            upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
            source_resblock_kernel_sizes=(3, 3),
            source_resblock_dilation_sizes=((1,), (1,)),
            f0_predictor_cond_channels=8,
        ),
    )
