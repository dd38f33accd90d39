"""Prompt-free TTS pipeline: text ids -> speech tokens -> mel -> waveform
(the port of the JAX package's ``infer/pipeline.py``, non-streaming path).

Stages: ``_build_prefix`` packs [sos, spk, text_enc, task] for the LLM,
``generate_tokens`` runs the AR decode, ``token2wav`` runs the flow solve
(NFE by mel length), the boundary trim and HiFT.  Streaming, batching and
multi-voice serving are later slices.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..config import InferenceConfig, ModelConfig
from ..layers.basic import dense
from ..models import flow as F
from ..models import hift as H
from ..models import llm as L


class TTSPipeline:
    """Non-streaming synthesis over the port's ``TransformerLM``, ``Flow``
    and ``HiFT`` modules (all on one device)."""

    def __init__(self, model_cfg: ModelConfig, llm: L.TransformerLM, flow: F.Flow,
                 hift: H.HiFT, infer_cfg: InferenceConfig = InferenceConfig(),
                 finetuned_norm: bool = True):
        if infer_cfg.sampler != "euler":
            raise NotImplementedError("only the Euler CFM sampler is ported")
        self.cfg = model_cfg
        self.icfg = infer_cfg
        self.finetuned_norm = finetuned_norm
        self.llm_p, self.flow_p, self.hift_p = llm.p, flow.p, hift.p
        self.device = next(flow.parameters()).device
        # wall seconds of the last synthesize() per stage (decode, flow,
        # hift), each ending in a device synchronize
        self.stage_seconds: Dict[str, float] = {}
        self._t_mark = 0.0

    def _mark(self, stage: Optional[str]):
        """Close ``stage`` (None: start the clock) after the device is idle."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if stage is not None:
            self.stage_seconds[stage] = now - self._t_mark
        self._t_mark = now

    # ------------------------------------------------------------------
    # stage 1: AR speech-token generation
    # ------------------------------------------------------------------

    def _build_prefix(self, text_tokens: np.ndarray,
                      spk_embedding: Optional[np.ndarray], max_len_cap: int):
        """Pack [sos, spk?, text_enc, task]; returns (prefix (1, L0, D),
        min_len, max_len).  ``spk_embedding=None`` omits the speaker row."""
        p, cfg = self.llm_p, self.cfg.llm
        tt = torch.as_tensor(np.asarray(text_tokens), dtype=torch.long, device=self.device)
        text_len = tt.shape[1]
        text_enc = L.llm_encode_text(
            p, cfg, tt, torch.full((1,), text_len, dtype=torch.int32, device=self.device))
        emb = p["llm_embedding.weight"]
        parts = [emb[cfg.sos_eos][None, None]]
        if spk_embedding is not None:
            spk = torch.as_tensor(np.asarray(spk_embedding, np.float32), device=self.device)
            parts.append(dense(p, "spk_embed_affine_layer",
                               L._l2_normalize(spk.to(emb.dtype), dim=1))[:, None])
        parts += [text_enc, emb[cfg.task_id][None, None]]
        prefix = torch.cat(parts, dim=1)
        min_len = int(text_len * self.icfg.min_token_text_ratio)
        max_len = min(int(text_len * self.icfg.max_token_text_ratio), max_len_cap)
        return prefix, min_len, max_len

    def generate_tokens(self, text_tokens: np.ndarray,
                        spk_embedding: Optional[np.ndarray] = None,
                        max_len_cap: int = 2048,
                        generator: Optional[torch.Generator] = None) -> np.ndarray:
        """(1, Tt) text ids -> (1, n) speech tokens.  ``generator`` is a CPU
        generator (sampling runs on the host)."""
        prefix, min_len, max_len = self._build_prefix(text_tokens, spk_embedding,
                                                      max_len_cap)
        toks = L.llm_decode(self.llm_p, self.cfg.llm, prefix, min_len, max_len,
                            top_p=self.icfg.sampling_top_p, top_k=self.icfg.sampling_top_k,
                            win_size=self.icfg.ras_win_size, tau_r=self.icfg.ras_tau_r,
                            generator=generator)
        return np.asarray(toks, np.int64)[None, :]

    # ------------------------------------------------------------------
    # stage 2+3: tokens -> mel -> wav
    # ------------------------------------------------------------------

    def _select_nfe(self, mel_len: int) -> int:
        """Euler steps by true mel length: 10 / 15 / 20."""
        if mel_len > self.icfg.nfe_long_threshold:
            return self.icfg.nfe_long
        if mel_len > self.icfg.nfe_mid_threshold:
            return self.icfg.nfe_mid
        return self.icfg.nfe_short

    def token2wav(self, token: np.ndarray, spk_embedding: np.ndarray,
                  prompt_token: Optional[np.ndarray] = None,
                  prompt_feat: Optional[np.ndarray] = None, speed: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  z: Optional[torch.Tensor] = None,
                  hift_phase: Optional[torch.Tensor] = None,
                  hift_noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """Flow solve, anti-leakage boundary trim, optional speed change and
        HiFT -> (1, n) float32 waveform.  ``z`` / ``hift_phase`` /
        ``hift_noise`` inject the random draws (tests); otherwise they come
        from ``generator`` (a generator on the pipeline's device)."""
        dev = self.device
        self._mark(None)
        prompt_token = np.zeros((1, 0), np.int64) if prompt_token is None else prompt_token
        prompt_feat = np.zeros((1, 0, 80), np.float32) if prompt_feat is None else prompt_feat
        mel_len = (prompt_feat.shape[1]
                   + int(token.shape[1] / self.cfg.flow.input_frame_rate * 22050 / 256))
        mel = F.flow_inference(
            self.flow_p, self.cfg.flow,
            torch.as_tensor(token, dtype=torch.long, device=dev),
            torch.as_tensor(prompt_token, dtype=torch.long, device=dev),
            torch.as_tensor(prompt_feat, dtype=torch.float32, device=dev),
            torch.as_tensor(spk_embedding, dtype=torch.float32, device=dev),
            n_timesteps=self._select_nfe(mel_len), finetuned_norm=self.finetuned_norm,
            mel_norm=(self.cfg.mel_mean, self.cfg.mel_std), generator=generator, z=z)
        trim = int(prompt_feat.shape[1] * self.icfg.boundary_trim_ratio)
        if trim > 0 and mel.shape[2] > trim:
            mel = mel[:, :, trim:]
        if speed != 1.0:
            mel = F.interpolate_linear(mel, int(mel.shape[2] / speed))
        self._mark("flow")
        wav, _ = H.hift_inference(self.hift_p, self.cfg.hift, mel, generator,
                                  hift_phase, hift_noise)
        wav = wav.float().cpu().numpy()
        self._mark("hift")
        return wav

    # ------------------------------------------------------------------
    # full pipeline
    # ------------------------------------------------------------------

    def synthesize(self, text_tokens: np.ndarray,
                   spk_embedding: Optional[np.ndarray] = None, speed: float = 1.0,
                   max_len_cap: int = 2048, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yields one {'tts_speech': (1, n) float32} chunk (non-streaming).
        ``spk_embedding`` None is the prompt-free zero embedding with the
        speaker row present.  Random draws are seeded by ``seed``."""
        if spk_embedding is None:
            spk_embedding = np.zeros((1, self.cfg.llm.spk_embed_dim), np.float32)
        self.stage_seconds = {}
        with torch.inference_mode():
            self._mark(None)
            tokens = self.generate_tokens(
                text_tokens, spk_embedding, max_len_cap,
                generator=torch.Generator().manual_seed(seed))
            self._mark("decode")
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            wav = self.token2wav(tokens, spk_embedding, speed=speed, generator=gen)
        yield {"tts_speech": wav}
