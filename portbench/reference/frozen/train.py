"""The joint LoRA training step of the port, restated plainly: the LLM's
cross-entropy and the flow's OT-CFM loss (in the no-prompt mode of
``TrainConfig()``), their weighted sum over the accumulated
micro-batches, the gradient clipped by its global norm and AdamW on the
adapters with the warmup-cosine schedule.  Every dropout mask, the CFM
noise and the CFG draw come from the step's generator in the program's
order, so one seed gives both sides the same draws.  The reference runs in
float32 whatever the program's compute type."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .config import ModelConfig, TrainConfig
from .ctx import Ctx
from .layers.basic import dense, embedding
from .layers.conformer import encoder_forward
from .layers.unet import conditional_decoder
from .models.flow import PI, flow_encode, regulator_stack, interpolate_linear
from .models.llm import _l2_normalize, llm_encode_text
from .ops import masks as M
from .params import P

IGNORE_ID = -1


def pack_lm_inputs(p: P, cfg, text_enc, text_len, spk_emb, speech_emb, speech_len,
                   speech_token) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lm_input (B, S, D), lm_len (B,), lm_target (B, S)), S = 3 + Tt + Ts:
    [sos, spk, text, task, speech, pad] against [IGNORE x (2 + tl), speech,
    EOS, IGNORE]."""
    B, Tt, D = text_enc.shape
    Ts = speech_emb.shape[1]
    S = 3 + Tt + Ts
    dt, dev = text_enc.dtype, text_enc.device
    emb = p["llm_embedding.weight"]
    sos, task = emb[cfg.sos_eos].to(dt), emb[cfg.task_id].to(dt)
    pos = torch.arange(S, device=dev)[None, :]
    tl = text_len.long()[:, None]
    sl = speech_len.long()[:, None]
    text_idx = torch.clamp(pos - 2, 0, Tt - 1).expand(B, S)
    speech_idx = torch.clamp(pos - 3 - tl, 0, Ts - 1)
    g_text = torch.gather(text_enc, 1, text_idx[:, :, None].expand(B, S, D))
    g_speech = torch.gather(speech_emb, 1, speech_idx[:, :, None].expand(B, S, D))
    is_text = (pos >= 2) & (pos < 2 + tl)
    is_task = pos == 2 + tl
    is_speech = (pos > 2 + tl) & (pos < 3 + tl + sl)
    x = torch.where(is_speech[:, :, None], g_speech, torch.zeros((), dtype=dt, device=dev))
    x = torch.where(is_task[:, :, None], task[None, None, :], x)
    x = torch.where(is_text[:, :, None], g_text, x)
    x = torch.where((pos == 1)[:, :, None], spk_emb[:, None, :].to(dt), x)
    x = torch.where((pos == 0)[:, :, None], sos[None, None, :], x)
    tgt_idx = torch.clamp(pos - 2 - tl, 0, Ts - 1)
    g_tok = torch.gather(speech_token.long(), 1, tgt_idx)
    is_tgt = (pos >= 2 + tl) & (pos < 2 + tl + sl)
    target = torch.where(is_tgt, g_tok,
                         torch.where(pos == 2 + tl + sl, cfg.speech_token_size, IGNORE_ID))
    return x, (3 + tl + sl)[:, 0], target


def llm_loss(p: P, cfg, batch: Dict[str, torch.Tensor], ctx: Ctx) -> torch.Tensor:
    """Length-normalized cross-entropy of the speech tokens and EOS."""
    text_len = batch["text_token_len"]
    text_enc = llm_encode_text(p, cfg, batch["text_token"].long(), text_len, ctx)
    spk = dense(p, "spk_embed_affine_layer",
                _l2_normalize(batch["embedding"].to(text_enc.dtype), dim=1), ctx)
    speech = embedding(p, "speech_embedding", batch["speech_token"].long(), clamp_min=0)
    x, lm_len, target = pack_lm_inputs(p, cfg, text_enc, text_len, spk, speech,
                                       batch["speech_token_len"], batch["speech_token"])
    h, _ = encoder_forward(p.sub("llm"), cfg.llm, x, lm_len, ctx, conformer=False)
    logp = torch.log_softmax(dense(p, "llm_decoder", h, ctx).float(), dim=-1)
    valid = target != IGNORE_ID
    nll = -torch.gather(logp, 2, torch.where(valid, target, 0)[:, :, None])[:, :, 0]
    return torch.where(valid, nll, 0.0).sum() / torch.clamp(valid.sum(), min=1)


def flow_loss(p: P, cfg, generator: torch.Generator, batch: Dict[str, torch.Tensor],
              ctx: Ctx, mel_norm: Tuple[float, float]) -> torch.Tensor:
    """The OT-CFM loss of the no-prompt fine-tune (no condition frames, no
    prompt isolation, the CFG dropout of ``training_cfg_rate``)."""
    mean, std = mel_norm
    feat = (batch["speech_feat"] - mean) / std
    feat_len = batch["speech_feat_len"]
    B, T, _ = feat.shape
    dev = feat.device
    spk = dense(p, "spk_embed_affine_layer",
                _l2_normalize(batch["embedding"].to(feat.dtype), dim=1), ctx)
    h = flow_encode(p, cfg, batch["speech_token"].long(), batch["speech_token_len"], ctx)
    mask_t = M.make_non_pad_mask(feat_len, T)[:, :, None].to(h.dtype)
    h = regulator_stack(p.sub("length_regulator"), interpolate_linear(h.transpose(1, 2), T),
                        cfg.regulator_stages, ctx).transpose(1, 2) * mask_t
    x1 = feat.transpose(1, 2)
    mask = M.make_non_pad_mask(feat_len, T)[:, None, :].to(h.dtype)
    mu = h.transpose(1, 2)
    cond = torch.zeros_like(x1)
    plen = torch.zeros((B,), dtype=torch.long, device=dev)
    t = torch.rand((B, 1, 1), generator=generator, device=dev).to(x1.dtype)
    z = torch.randn(x1.shape, generator=generator, device=dev).to(x1.dtype)
    cfg_u = torch.rand((B,), generator=generator, device=dev)
    if cfg.cfm.t_scheduler == "cosine":
        t = 1.0 - torch.cos(t * 0.5 * PI)
    sigma = cfg.cfm.sigma_min
    y = (1.0 - (1.0 - sigma) * t) * z + t * x1
    u = x1 - (1.0 - sigma) * z
    if cfg.cfm.training_cfg_rate > 0:
        keep = (cfg_u > cfg.cfm.training_cfg_rate).to(x1.dtype)
        mu, spk, cond = mu * keep[:, None, None], spk * keep[:, None], cond * keep[:, None, None]
    pred = conditional_decoder(p.sub("decoder.estimator"), cfg.estimator, y, mask, mu,
                               t[:, 0, 0], spk, cond, ctx, prompt_lens=plen)
    idx = torch.arange(T, device=dev)[None, :]
    w = torch.where(idx < plen[:, None], 0.0, 1.0)
    loss_mask = mask * w[:, None, :].to(mask.dtype)
    diff = (pred - u) * loss_mask
    return torch.square(diff).sum() / torch.clamp(loss_mask.sum() * u.shape[1], min=1.0)


def joint_loss(llm_p, flow_p, loras: Dict[str, Dict[str, torch.Tensor]], cfg: ModelConfig,
               tcfg: TrainConfig, generator: torch.Generator,
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``llm_loss_weight`` x the LLM's loss + ``flow_loss_weight`` x the flow's."""
    if tcfg.training_mode != "joint" or not tcfg.no_prompt_training \
            or tcfg.no_prompt.mode != "full":
        raise NotImplementedError("the reference restates the joint no-prompt fine-tune only")
    lctx = Ctx(generator, train=True, lora=loras["llm"], lora_scale=tcfg.llm_lora.scaling,
               lora_dropout=tcfg.llm_lora.dropout)
    fctx = Ctx(generator, train=True, lora=loras["flow"], lora_scale=tcfg.flow_lora.scaling,
               lora_dropout=tcfg.flow_lora.dropout)
    ll = llm_loss(P(llm_p), cfg.llm, batch, lctx)
    fl = flow_loss(P(flow_p), cfg.flow, generator, batch, fctx, (cfg.mel_mean, cfg.mel_std))
    return ll * tcfg.llm_loss_weight + fl * tcfg.flow_loss_weight


def warmup_cosine(tcfg: TrainConfig, total_steps: int, step: int) -> float:
    base, floor, warm = tcfg.learning_rate, tcfg.min_learning_rate, tcfg.warmup_steps
    if step < warm:
        return base * step / max(1, warm)
    progress = (step - warm) / max(1, total_steps - warm)
    return base * max(floor / base, 0.5 * (1.0 + math.cos(progress * 3.14159)))


def train_steps(llm_p, flow_p, loras, cfg: ModelConfig, tcfg: TrainConfig,
                batches: List[Dict[str, torch.Tensor]], generators: List[torch.Generator],
                total_steps: int, cast=None):
    """Run one optimizer step a super-batch (``(accum, B, ...)`` tensors) on
    f32 copies of ``loras`` (``{"llm": {...}, "flow": {...}}``); returns
    (each step's loss, the first step's clipped gradient by leaf, the
    adapters after the last step).  ``cast`` maps each micro-batch before
    the forward (the control's lower precision)."""
    leaves = {f"{k}/{n}": v.detach().float().clone().requires_grad_(True)
              for k in sorted(loras) for n, v in sorted(loras[k].items())}
    tree = {k: {n: leaves[f"{k}/{n}"] for n in loras[k]} for k in loras}
    opt = torch.optim.AdamW(list(leaves.values()), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=tcfg.weight_decay)
    losses, first = [], None
    accum = tcfg.accumulate_grad_batches
    for k, (sb, gen) in enumerate(zip(batches, generators)):
        opt.zero_grad(set_to_none=True)
        total = 0.0
        for a in range(accum):
            micro = {n: v[a] for n, v in sb.items()}
            if cast is not None:
                micro = cast(micro)
            loss = joint_loss(llm_p, flow_p, tree, cfg, tcfg, gen, micro)
            (loss / accum).backward()
            total += float(loss.detach()) / accum
        grads = [v.grad if v.grad is not None else torch.zeros_like(v) for v in leaves.values()]
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        factor = tcfg.gradient_clip_val / torch.clamp(gnorm, min=tcfg.gradient_clip_val)
        for v, g in zip(leaves.values(), grads):
            v.grad = g * factor
        if first is None:
            first = {n: v.grad.detach().clone() for n, v in leaves.items()}
        for group in opt.param_groups:
            group["lr"] = warmup_cosine(tcfg, total_steps, k)
        opt.step()
        losses.append(total)
    return losses, first, {n: v.detach().clone() for n, v in leaves.items()}
