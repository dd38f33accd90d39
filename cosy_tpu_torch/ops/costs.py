"""Closed-form FLOP and byte counts of the port's workloads (the port of the
JAX package's ``ops/costs.py``), so that a share of the card's peak divides
by work counted the same way whatever implements it.

- ``estimator_call_flops`` / ``cfm_solve_flops``: one estimator call, the
  Euler solve;
- ``joint_step_flops``: one joint LoRA optimizer step;
- ``decode_bytes_per_token``: the bytes a decode step reads at batch 1.

Conventions (standard MFU accounting):
- a matmul (m, k) x (k, n) counts 2 m k n flops;
- a conv1d over L output frames, kernel K, C_in -> C_out counts
  2 L K C_in C_out a batch element;
- elementwise work (norms, activations, masks, the softmax's exp) is left
  out: under 2% of these workloads;
- backward with every base weight frozen (LoRA training): a linear or conv
  contributes only its input-gradient product (1x forward, 2x in all);
  data-data products (attention scores, att @ V) need both operand
  gradients (3x in all); adapter chains are live in forward, dgrad and
  wgrad.

The numbers equal the JAX package's on the same configs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ..config import (EncoderConfig, EstimatorConfig, FlowConfig, LLMConfig,
                      LoRAConfig, ModelConfig, TrainConfig)

# The published peaks of the card the port runs on (NVIDIA's H100 SXM data
# sheet, dense, at the full 700 W limit; the card measured here reports
# "NVIDIA H100 80GB HBM3, 700.00 W").  Data-sheet numbers, not measurements.
H100_F32_FLOPS = 67e12  # f32 on the CUDA cores
H100_TF32_FLOPS = 495e12  # dense TF32 tensor cores
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores
H100_HBM_BYTES_PER_S = 3.35e12


@dataclass
class Cost:
    """flops split by backward behavior: ``linear`` = GEMMs needing one
    gradient in bwd (frozen-weight layers: dgrad only; matrix_bd: d(q_v)
    only, the pos operand is constant), ``attn`` = data-data matmuls (two
    dgrads), ``pos`` = entirely gradient-free work (the shared pos-emb
    projection: constant input AND frozen weight, so its whole backward is
    dead code)."""

    linear: float = 0.0
    attn: float = 0.0
    pos: float = 0.0

    @property
    def total(self) -> float:
        return self.linear + self.attn + self.pos

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.linear + o.linear, self.attn + o.attn,
                    self.pos + o.pos)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.linear * k, self.attn * k, self.pos * k)

    __rmul__ = __mul__

    def train_total(self) -> float:
        """fwd + bwd flops under frozen base weights (see module docstring)."""
        return 2.0 * self.linear + 3.0 * self.attn + 1.0 * self.pos


# ---------------------------------------------------------------------------
# Estimator (U-Net ConditionalDecoder, layers/unet.py)
# ---------------------------------------------------------------------------


def _tblock_flops(cfg: EstimatorConfig, B: int, L: int, C: int) -> Cost:
    """BasicTransformerBlock: q/k/v/out projections C<->inner, one (L, L)
    attention, FeedForward C -> 4C -> C (gelu; geglu widens net.0 by 2x)."""
    inner = cfg.num_heads * cfg.attention_head_dim
    ffi = 4 * C
    proj = 2 * B * L * C * inner * 4  # to_q, to_k, to_v, to_out
    attn = 2 * B * L * L * inner * 2  # scores + att @ V
    if cfg.act_fn == "geglu":
        ff = 2 * B * L * (C * 2 * ffi + ffi * C)
    else:
        ff = 2 * B * L * (C * ffi + ffi * C)
    return Cost(linear=proj + ff, attn=attn)


def _resnet_flops(cfg: EstimatorConfig, B: int, L: int, cin: int, cout: int) -> Cost:
    """ResnetBlock1D: two k=3 convs, k=1 res conv, timestep MLP."""
    convs = 2 * B * L * 3 * (cin * cout + cout * cout) + 2 * B * L * cin * cout
    tmlp = 2 * B * cfg.time_embed_dim * cout
    return Cost(linear=convs + tmlp)


def estimator_call_flops(cfg: EstimatorConfig, B: int, T: int) -> Cost:
    """One conditional_decoder call at batch B, T mel frames.

    Topology (layers/unet.py conditional_decoder): n_levels = len(channels),
    one stride-2 downsample per level boundary; per level a resnet +
    n_blocks transformer blocks in down/up, num_mid_blocks * (resnet +
    n_blocks tblocks) at the deepest level; final Block1D + 1x1 proj;
    time MLP in_channels -> ted -> ted."""
    n_levels = len(cfg.channels)
    lens = [T]
    for _ in range(n_levels - 1):
        lens.append(-(-lens[-1] // 2))

    ted = cfg.time_embed_dim
    c = Cost(linear=2 * B * (cfg.in_channels * ted + ted * ted))  # time_mlp

    out_ch = cfg.in_channels
    for i in range(n_levels):
        lvl = min(i, n_levels - 1)
        in_ch, out_ch = out_ch, cfg.channels[i]
        c = c + _resnet_flops(cfg, B, lens[lvl], in_ch, out_ch)
        c = c + cfg.n_blocks * _tblock_flops(cfg, B, lens[lvl], out_ch)
        # down conv k=3 (stride 2 between levels, 1 at the last)
        c = c + Cost(linear=2 * B * lens[min(i + 1, n_levels - 1)] * 3 * out_ch * out_ch)

    mid_lvl = n_levels - 1
    for _ in range(cfg.num_mid_blocks):
        c = c + _resnet_flops(cfg, B, lens[mid_lvl], out_ch, out_ch)
        c = c + cfg.n_blocks * _tblock_flops(cfg, B, lens[mid_lvl], out_ch)

    for i in range(n_levels):
        lvl = n_levels - 1 - i
        skip_ch = cfg.channels[lvl]
        c = c + _resnet_flops(cfg, B, lens[lvl], out_ch + skip_ch, cfg.channels[lvl])
        out_ch = cfg.channels[lvl]
        c = c + cfg.n_blocks * _tblock_flops(cfg, B, lens[lvl], out_ch)
        # up conv / transpose conv k=3 writes at the NEXT (shallower) level's L
        c = c + Cost(linear=2 * B * lens[max(lvl - 1, 0)] * 3 * out_ch * out_ch)

    c = c + Cost(linear=2 * B * T * 3 * out_ch * out_ch)  # final_block conv
    c = c + Cost(linear=2 * B * T * out_ch * cfg.out_channels)  # final_proj
    return c


def cfm_solve_flops(cfg: FlowConfig, B: int, T: int, nfe: int) -> float:
    """Inference Euler solve: nfe estimator calls at CFG-DOUBLED batch 2B
    (models/flow.py cfm_solve_euler concatenates the unconditioned half)."""
    return nfe * estimator_call_flops(cfg.estimator, 2 * B, T).total


# ---------------------------------------------------------------------------
# Wenet/ESPnet encoder stacks (layers/conformer.py via encoder_forward)
# ---------------------------------------------------------------------------


def encoder_block_flops(cfg: EncoderConfig, B: int, L: int) -> Cost:
    """One transformer/conformer block at the 300M topologies (no macaron,
    no conv module — both off for every live config, config.py).

    Rel-pos attention (rel_selfattn): q/k/v/out projections + the shared
    pos projection over the (2L-1)-frame pos-emb table (batch-independent)
    + matrix_ac (L x L) + matrix_bd (L x 2L-1, rel-shifted) + att @ V."""
    d = cfg.output_size
    ff = cfg.linear_units
    proj = 2 * B * L * d * d * 4
    pos = 0.0
    if cfg.pos_enc_layer_type in ("rel_pos", "rel_pos_espnet"):
        P = 2 * L - 1
        pos = 2 * P * d * d  # linear_pos: batch-1 AND gradient-free
        # matrix_ac + att@V are data-data (3x in training); matrix_bd's pos
        # operand is constant, so it behaves like a frozen linear (2x)
        attn = 2 * B * L * L * d * 2
        proj += 2 * B * L * P * d  # matrix_bd
    else:
        attn = 2 * B * L * L * d * 2
    ffn = 2 * B * L * (d * ff + ff * d)
    if cfg.macaron_style:
        ffn *= 2
    return Cost(linear=proj + ffn, attn=attn, pos=pos)


def encoder_flops(cfg: EncoderConfig, B: int, L: int,
                  input_dim: int | None = None) -> Cost:
    """Full encoder stack + the input projection (linear input layers)."""
    c = cfg.num_blocks * encoder_block_flops(cfg, B, L)
    if input_dim is not None and cfg.input_layer in ("linear", "linear_legacy"):
        c = c + Cost(linear=2 * B * L * input_dim * cfg.output_size)
    return c


# ---------------------------------------------------------------------------
# Joint LLM+Flow LoRA train step
# ---------------------------------------------------------------------------


def _lora_flops(lora: LoRAConfig, n_layers_hit: int, B: int, L: int,
                d_in: int, d_out: int) -> float:
    """Adapter fwd+bwd: x@A@B fwd (2BL*r*(d_in+d_out)) and ~2x that again
    for dgrad+wgrad — small (r << d) but counted for honesty."""
    return 3 * n_layers_hit * 2 * B * L * lora.r * (d_in + d_out)


def llm_fwd_flops(cfg: LLMConfig, B: int, Tt: int, Ts: int) -> Cost:
    """llm_forward_train: text encoder over Tt, LM stack over the packed
    sequence S = 3 + Tt + Ts (models/llm.py pack_lm_inputs), head to
    speech_token_size + 3 logits."""
    S = 3 + Tt + Ts
    c = encoder_flops(cfg.text_encoder, B, Tt, cfg.text_encoder_input_size)
    c = c + encoder_flops(cfg.llm, B, S, cfg.llm_input_size)
    c = c + Cost(linear=2 * B * S * cfg.llm_output_size * (cfg.speech_token_size + 3))
    c = c + Cost(linear=2 * B * cfg.spk_embed_dim * cfg.llm_input_size)
    return c


def flow_fwd_flops(cfg: FlowConfig, B: int, Ts: int, Tm: int) -> Cost:
    """flow_forward_train: token conformer over Ts + encoder_proj, length
    regulator (4 k=3 convs at mel rate, C=80), one estimator call at batch
    B (training does NOT double the batch — CFG is train-time cond
    dropout), spk affine."""
    c = encoder_flops(cfg.encoder, B, Ts, cfg.input_size)
    d = cfg.encoder.output_size
    c = c + Cost(linear=2 * B * Ts * d * cfg.output_size)  # encoder_proj
    M = cfg.output_size
    c = c + Cost(linear=cfg.regulator_stages * 2 * B * Tm * 3 * M * M)
    c = c + Cost(linear=2 * B * cfg.spk_embed_dim * M)  # spk affine
    c = c + estimator_call_flops(cfg.estimator, B, Tm)
    return c


def joint_step_flops(model_cfg: ModelConfig, train_cfg: TrainConfig,
                     B: int, accum: int, Tt: int, Ts: int, Tm: int) -> float:
    """One optimizer step = accum micro fwd+bwd (LoRA-frozen backward:
    2x linear + 3x attn, see module docstring) + adapter chains."""
    fwd = llm_fwd_flops(model_cfg.llm, B, Tt, Ts) + \
        flow_fwd_flops(model_cfg.flow, B, Ts, Tm)
    per_micro = fwd.train_total()
    # LoRA adapters: llm targets hit q/k/v/out (4/block, d=1024) + w_1/w_2
    # (2/block, 1024<->4096) over 14 blocks at S; flow targets hit the
    # estimator's to_q/k/v (3/tblock, 256<->512) + encoder q/k/v (no out)
    # + w_1/w_2 (512<->2048) over 6 blocks
    lcfg, fcfg = train_cfg.llm_lora, train_cfg.flow_lora
    S = 3 + Tt + Ts
    nl = model_cfg.llm.llm.num_blocks
    d = model_cfg.llm.llm.output_size
    ff = model_cfg.llm.llm.linear_units
    per_micro += _lora_flops(lcfg, 4 * nl, B, S, d, d)
    per_micro += _lora_flops(lcfg, 2 * nl, B, S, d, ff)
    est = model_cfg.flow.estimator
    n_tb = est.n_blocks * (2 * len(est.channels) + est.num_mid_blocks)
    inner = est.num_heads * est.attention_head_dim
    # tblocks live at T and T/2; approximate with the mid-level length
    per_micro += _lora_flops(fcfg, 3 * n_tb, B, Tm // 2, est.channels[-1], inner)
    ecfg = model_cfg.flow.encoder
    per_micro += _lora_flops(fcfg, 3 * ecfg.num_blocks, B, Ts,
                             ecfg.output_size, ecfg.output_size)
    per_micro += _lora_flops(fcfg, 2 * ecfg.num_blocks, B, Ts,
                             ecfg.output_size, ecfg.linear_units)
    return accum * per_micro


# ---------------------------------------------------------------------------
# AR decode memory traffic
# ---------------------------------------------------------------------------


def decode_bytes_per_token(llm_params: Dict[str, torch.Tensor], cfg: LLMConfig,
                           kv_capacity: int, int8_weights: bool = False) -> float:
    """Bytes read a decoded token at batch 1 (bound by the weight stream).

    A token streams every LM-stack weight once (q/k/v/out, FFN, norms,
    after_norm, head) plus the live KV cache window.  Left out:
    ``linear_pos`` (hoisted out of the token loop) and the embedding tables
    (one-row gathers).  The KV term reads the whole fixed-capacity
    (nl, 2, H, S, dk) buffer a step (masked attention over static shapes)
    plus the hoisted positional window.

    ``int8_weights=True`` models the weight-only-quantized stack
    (``quant.py``): 2-D weights stream as 1 byte and an f32 scale a row."""
    wbytes = 0
    for name, leaf in llm_params.items():
        if not (name.startswith("llm.") or name.startswith("llm_decoder.")):
            continue
        if "linear_pos" in name:
            continue
        n = leaf.numel()
        if int8_weights and name.endswith(".weight") and leaf.ndim == 2:
            wbytes += n + leaf.shape[0] * 4  # int8 payload + f32 scales
        else:
            wbytes += n * leaf.element_size()
    ecfg = cfg.llm
    H, dk, nl = ecfg.attention_heads, ecfg.output_size // ecfg.attention_heads, ecfg.num_blocks
    kv = nl * 2 * H * kv_capacity * dk * 2  # bf16 KV buffer, full read a step
    pos_window = H * kv_capacity * dk * 2  # hoisted pos_k slice
    return float(wbytes + kv + pos_window)
