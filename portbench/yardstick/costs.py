"""Closed-form FLOP and byte counts of the benchmark's workloads: the
yardstick the per-layer shares divide by, frozen here so that a change to
the program cannot change how its work is counted.

The first part is a copy of ``cosy_tpu_torch/ops/costs.py`` (the estimator
call, the CFM solve, the encoders, the LLM and flow training forwards, the
joint LoRA step); the second extends it with HiFT, the
300M and Qwen2 decode steps, the flow windows of both families, and the
bytes an estimator call and a decode step read.  The functions read
configuration objects by attribute (the dataclasses of either package).

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
"""

from __future__ import annotations

import math
from dataclasses import dataclass


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
# Extension: HiFT, the decode steps, the flow windows, the estimator kernels
# ---------------------------------------------------------------------------


def _conv(L: int, K: int, cin: int, cout: int) -> float:
    return 2.0 * L * K * cin * cout


def hift_flops(cfg, T: int) -> float:
    """HiFT over T mel frames at batch 1 (models/hift.py): the f0
    predictor (five k=3 convs and the classifier), conv_pre, per stage the
    transposed upsampling conv, the source STFT's downsampling conv, the
    source resblock and the nk resblocks (two convs a dilation), conv_post,
    the harmonic merge, and the STFT and iSTFT as dense DFTs."""
    n_fft, hop = cfg.istft_n_fft, cfg.istft_hop_len
    ups = list(cfg.upsample_rates)
    samples = T * int(math.prod(ups)) * hop
    cc = cfg.f0_predictor_cond_channels
    f = _conv(T, 3, cfg.in_channels, cc) + 4 * _conv(T, 3, cc, cc) + 2.0 * T * cc
    f += _conv(T, 7, cfg.in_channels, cfg.base_channels)
    s_frames = samples // hop + 1
    f += 2.0 * s_frames * n_fft * (n_fft + 2)  # the source's STFT
    f += 2.0 * samples * (cfg.nb_harmonics + 1)  # l_linear
    L, c_in = T, cfg.base_channels
    for i, (u, k) in enumerate(zip(ups, cfg.upsample_kernel_sizes)):
        c = cfg.base_channels // (2 ** (i + 1))
        f += _conv(L, k, c_in, c)  # each input frame meets the kernel once
        L = L * u
        du = int(math.prod(ups[i + 1:]))
        f += _conv(L, 1 if du == 1 else 2 * du, n_fft + 2, c)
        sk = cfg.source_resblock_kernel_sizes[i]
        f += 2 * len(cfg.source_resblock_dilation_sizes[i]) * _conv(L, sk, c, c)
        for kk, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            f += 2 * len(dil) * _conv(L, kk, c, c)
        c_in = c
    f += _conv(L, 7, c_in, n_fft + 2)
    f += 2.0 * L * (n_fft // 2 + 1) * 2 * n_fft  # iSTFT
    return f


def llm_decode_step_flops(cfg, context: int) -> float:
    """One 300M decode step of one row (models/llm.py
    llm_decode_step_batch) against ``context`` cached columns: the legacy
    input linear, per block q/k/v/out and the FF, the rel-pos scores (the
    content and the positional term) and att @ V, and the head."""
    e = cfg.llm
    d, ff = e.output_size, e.linear_units
    per_block = 2.0 * d * d * 4 + 2.0 * d * ff * 2 + 2.0 * d * context * 3
    return 2.0 * cfg.llm_input_size * d + e.num_blocks * per_block \
        + 2.0 * cfg.llm_output_size * (cfg.speech_token_size + 1)


def qwen2_decode_step_flops(cfg, context: int) -> float:
    """One Qwen2LM decode step of one row (models/qwen2lm.py) against
    ``context`` cached positions: q/k/v/o with grouped keys, the gated MLP,
    scores and att @ V over every query head, and the speech head."""
    q = cfg.qwen
    D, hd = q.hidden_size, q.head_dim
    per_layer = (2.0 * D * q.num_attention_heads * hd * 2
                 + 2.0 * D * q.num_key_value_heads * hd * 2
                 + 2.0 * D * q.intermediate_size * 3
                 + 2.0 * q.num_attention_heads * hd * context * 2)
    return q.num_hidden_layers * per_layer + 2.0 * cfg.llm_output_size * (cfg.speech_token_size + 3)


def flow_window_flops(cfg, n_tokens: int, mel_frames: int, nfe: int) -> float:
    """One 300M flow inference (models/flow.py flow_inference) over
    ``n_tokens`` tokens (prompt included) and ``mel_frames`` frames: the
    token encoder, its projection, the length regulator, the spk affine and
    the CFG-batched Euler solve at the even length the U-Net runs."""
    fwd = flow_fwd_flops(cfg, 1, n_tokens, mel_frames).total \
        - estimator_call_flops(cfg.estimator, 1, mel_frames).total
    return fwd + cfm_solve_flops(cfg, 1, mel_frames + mel_frames % 2, nfe)


def flow2_window_flops(cfg, n_tokens: int, nfe: int) -> float:
    """One CosyVoice2 flow inference over ``n_tokens`` tokens (models/
    flow2.py): the upsample encoder (lookahead convs, the token-rate
    blocks, the k = 2s+1 upsampling conv and its embed, the mel-rate
    blocks), the projection and the CFG-batched Euler solve at
    ``token_mel_ratio`` frames a token."""
    e = cfg.encoder
    D = e.output_size
    T2 = n_tokens * cfg.token_mel_ratio
    f = 2.0 * n_tokens * cfg.input_size * D  # embed linear
    f += _conv(n_tokens, cfg.pre_lookahead_len + 1, D, D) + _conv(n_tokens, 3, D, D)
    f += e.num_blocks * encoder_block_flops(e, 1, n_tokens).total
    f += _conv(T2, 2 * cfg.token_mel_ratio + 1, D, D) + 2.0 * T2 * D * D
    f += cfg.num_up_blocks * encoder_block_flops(e, 1, T2).total
    f += 2.0 * T2 * D * cfg.output_size
    return f + nfe * estimator_call_flops(cfg.estimator, 2, T2).total


# ---------------------------------------------------------------------------
# Extension: the bytes an estimator call and a decode step read
# ---------------------------------------------------------------------------


def _spec_elements(spec, keep) -> int:
    return sum(math.prod(shape) for name, (shape, _) in spec.entries.items() if keep(name))


def estimator_weight_elements(cfg) -> int:
    """Parameters of one estimator (the frozen spec's names and shapes)."""
    from ..reference.frozen.layers.unet import init_conditional_decoder
    from ..reference.frozen.params import Spec

    spec = Spec()
    init_conditional_decoder(spec, "", cfg)
    return _spec_elements(spec, lambda name: True)


def estimator_call_bytes(cfg, B: int, T: int, elem: int = 4) -> float:
    """The least an estimator call at batch B over T frames moves: every
    weight read once, its inputs x, mu and cond (B, 80, T) and spks (B, 80)
    read once and its output written once."""
    io = 4 * B * cfg.out_channels * T + B * cfg.out_channels
    return float(elem * (estimator_weight_elements(cfg) + io))


def decode_step_weight_elements(plain) -> int:
    """Parameters a decode step reads: the 300M backbone without
    ``linear_pos`` (its table is projected once a request into the cache)
    and the head; Qwen2LM's layers, final norm and head.  Embedding rows
    are one-row gathers and left out."""
    if hasattr(plain, "model"):
        from ..reference.frozen.models.llm import llm_spec

        return _spec_elements(llm_spec(plain.model.llm), lambda n: (
            (n.startswith("llm.") and "linear_pos" not in n) or n.startswith("llm_decoder.")))
    from ..reference.frozen.models.qwen2lm import qwen2lm_spec

    return _spec_elements(qwen2lm_spec(plain.llm), lambda n: (
        (n.startswith("llm.model.model.") and "embed_tokens" not in n)
        or n.startswith("llm_decoder.")))


def decode_step_work(plain, rows: int, width: int, elem: int = 4):
    """(bytes, flops) of one decode step of ``rows`` rows that reads the
    cache columns ``[0, width)``, as the port's step reads them: the
    weights once (f32), and a row's keys and values in every layer over
    those columns (300M: its positional window too); the flops of every
    row's step against ``width`` columns."""
    weights = decode_step_weight_elements(plain)
    if hasattr(plain, "model"):
        cfg = plain.model.llm
        e = cfg.llm
        kv = e.num_blocks * 3 * rows * width * e.output_size  # keys, values, positions
        flops = rows * llm_decode_step_flops(cfg, width)
    else:
        q = plain.llm.qwen
        kv = q.num_hidden_layers * 2 * rows * width * q.num_key_value_heads * q.head_dim
        flops = rows * qwen2_decode_step_flops(plain.llm, width)
    return float(elem * (weights + kv)), float(flops)
