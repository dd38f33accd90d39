"""Configuration dataclasses for the PyTorch port.

A copy of the topology, LoRA, training and inference dataclasses of the JAX
package's ``config.py`` (the port imports nothing of that package).
Defaults are the CosyVoice-300M shapes; ``tiny_model_config`` is the toy
topology the CPU tests use.  ``TrainConfig`` leaves out the mesh-axis and
PRNG-implementation fields: the port trains on one device with a
``torch.Generator``.
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
    # U-Net level): inference only, on levels without an attention bias;
    # kernel C (ops/flash_attention.banded_attention) on CUDA tensors
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
class LoRAConfig:
    """LoRA hyperparameters (reference: config.py:88-101, 195-216)."""

    r: int = 8
    alpha: int = 16
    dropout: float = 0.05
    target_modules: Tuple[str, ...] = (
        "linear_q", "linear_k", "linear_v", "linear_out", "w_1", "w_2")

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


LLM_LORA_DEFAULT = LoRAConfig(
    r=8, alpha=16, dropout=0.15,
    target_modules=("linear_q", "linear_k", "linear_v", "linear_out", "w_1", "w_2"),
)

FLOW_LORA_DEFAULT = LoRAConfig(
    r=16, alpha=32, dropout=0.05,
    target_modules=("to_q", "to_k", "to_v", "linear_q", "linear_k", "linear_v",
                    "w_1", "w_2"),
)


@dataclass(frozen=True)
class AntiLeakageConfig:
    """Anti-semantic-leakage strategies (reference: config.py:108-145)."""

    silence_padding_enabled: bool = False
    silence_token_id: int = 0
    silence_min_tokens: int = 5
    silence_max_tokens: int = 10
    silence_mel_value: float = -11.5

    dynamic_prompt_enabled: bool = True
    prompt_min_ratio: float = 0.05
    prompt_max_ratio: float = 0.20

    prompt_dropout_enabled: bool = True
    prompt_dropout_prob: float = 0.25

    boundary_loss_enabled: bool = True
    boundary_frames: int = 25
    boundary_loss_weight: float = 5.0

    cross_sample_enabled: bool = True
    cross_sample_prob: float = 0.85

    text_blinding_enabled: bool = True
    text_blinding_prob: float = 0.95


@dataclass(frozen=True)
class NoPromptConfig:
    """Reference: config.py:155-170."""

    enabled: bool = False
    mode: str = "full"  # full | mixed
    no_prompt_ratio: float = 0.8
    use_mean_embedding: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Joint training config (reference: config.py:179-224)."""

    training_mode: str = "joint"  # joint | llm_only | flow_only
    llm_loss_weight: float = 2.0
    flow_loss_weight: float = 1.0
    no_prompt_training: bool = True

    learning_rate: float = 2e-4
    min_learning_rate: float = 1e-6
    weight_decay: float = 0.01
    warmup_steps: int = 50
    # warmup_cosine | warmuplr | constantlr | cosine_annealing |
    # square_annealing | squareroot_annealing | noam_annealing |
    # noamhold_annealing (train/schedules.py)
    scheduler: str = "warmup_cosine"
    scheduler_hold_steps: int = 0  # noamhold_annealing only
    scheduler_decay_rate: float = 0.5  # noamhold_annealing only
    scheduler_d_model: int = 1024  # noam_annealing only
    max_epochs: int = 100
    # the reference's effective batch of 16 as 8 samples x 2 accumulation
    # micro-batches
    batch_size: int = 8
    accumulate_grad_batches: int = 2
    gradient_clip_val: float = 1.0
    max_feat_len: int = 250  # mel frames; padded/truncated statically

    # loss-threshold early stop (reference: train_joint.py:58-103)
    llm_loss_threshold: float = 1.5
    flow_loss_threshold: float = 0.3
    early_stop_patience: int = 10
    early_stop_min_delta: float = 0.001

    # base weights and activations bf16, adapters and optimizer state f32
    bf16: bool = True
    seed: int = 1986

    llm_lora: LoRAConfig = field(default_factory=lambda: LLM_LORA_DEFAULT)
    flow_lora: LoRAConfig = field(default_factory=lambda: FLOW_LORA_DEFAULT)
    anti_leakage: AntiLeakageConfig = field(default_factory=AntiLeakageConfig)
    no_prompt: NoPromptConfig = field(default_factory=NoPromptConfig)

    @property
    def max_token_len(self) -> int:
        # speech tokens at 50 Hz vs mel at 22050/256 Hz: ratio ~1/1.72
        return int(self.max_feat_len / (22050.0 / 256.0 / 50.0)) + 1


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
    # int8 decode is not ported (kept for config parity); the bucketed
    # final streaming chunk and the short first hop are
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
