"""TTS pipeline (the port of the JAX package's ``infer/pipeline.py``), the
parts the benchmark's reference runs: the LLM prefix, ``token2wav`` (the
flow's Euler solve, NFE by mel length, the boundary trim and HiFT) and the
streamed windows of a prompt-free request (``stream_chunks``).  Streaming
keeps the reference's geometry: windows of hop + overlap tokens advance by
the hop, the mel overlap is faded into the next window, and the last window
is padded to one token bucket (``bucket_final``) with its true length
masked.

Randomness: every draw comes from a ``torch.Generator`` seeded with
``stream_seed(seed, row, stage) = seed + stage + row * 2**32``.  Stage 0 is
the row's decode (a CPU generator, its uniforms drawn in bulk for the
sampler on the device); stage ``1 + k`` is the row's k-th wav chunk (a
generator on the pipeline's device, which draws the flow's z, then
HiFT's phases and noise).  A single
request is row 0, so whole-utterance synthesis draws from ``seed`` and
``seed + 1``, and row b of a batch decodes as a solo request does with
``stream_seed(seed, b, 0)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..config import InferenceConfig, ModelConfig
from ..ctx import EVAL
from ..layers.basic import dense
from ..models import flow as F
from ..models import hift as H
from ..models import llm as L


def stream_seed(seed: int, row: int, stage: int) -> int:
    """The seed of ``row``'s generator for ``stage`` (0: decode, 1 + k: wav
    chunk k); see the module docstring."""
    return seed + stage + (row << 32)


def fade_in_out(fade_in: torch.Tensor, fade_out: torch.Tensor, window: torch.Tensor,
                valid: Optional[int] = None) -> torch.Tensor:
    """Crossfade the head of ``fade_in`` with the tail of ``fade_out`` over
    half the window, clamped to the shorter signal (a final chunk can be
    shorter than the window).  ``valid``: ``fade_in`` is bucket-padded and
    only its first ``valid`` frames are real, so the clamp uses that length
    (the JAX package's ``fade_in_out_valid_jnp``)."""
    half = window.shape[0] // 2
    n = min(half, fade_in.shape[-1], fade_out.shape[-1],
            fade_in.shape[-1] if valid is None else valid)
    if n == 0:
        return fade_in
    head = fade_in[..., :n] * window[:n] + fade_out[..., -n:] * window[half:half + n]
    return torch.cat([head, fade_in[..., n:]], dim=-1)


@dataclasses.dataclass
class StreamState:
    """Per-request streaming carries, kept on the pipeline's device (the
    emitted wav is the one host copy a chunk).  None before the first
    chunk."""
    mel_overlap: Optional[torch.Tensor] = None  # (1, 80, 34) faded into the next window
    hift_mel: Optional[torch.Tensor] = None  # (1, 80, 20) mel cache before the next chunk
    hift_source: Optional[torch.Tensor] = None  # (1, 1, 5120) source carry
    hift_speech: Optional[torch.Tensor] = None  # (1, 5120) wav tail faded into the next chunk
    flow_cache: Optional[torch.Tensor] = None  # (1, 80, 34, 2) z / mu carry


@dataclasses.dataclass
class StreamCursor:
    """One stream's place in its token stream: the next window's start
    ``pos`` and hop, the chunks emitted so far (chunk k draws from
    ``stream_seed(seed, row, 1 + k)``) and its carries."""
    spk: np.ndarray
    seed: int
    row: int
    hop: int
    pos: int = 0
    chunk: int = 0
    state: StreamState = dataclasses.field(default_factory=StreamState)
    prompt_token: Optional[np.ndarray] = None  # the flow prompt every window takes
    prompt_feat: Optional[np.ndarray] = None  # its raw mel (1, T, 80)


class TTSPipeline:
    """Synthesis over the port's ``TransformerLM``, ``Flow`` and ``HiFT``
    modules (all on one device)."""

    _marks_off = False  # stage marks skipped (a batch dispatched before its reads)

    def __init__(self, model_cfg: ModelConfig, llm: L.TransformerLM, flow: F.Flow,
                 hift: H.HiFT, infer_cfg: InferenceConfig = InferenceConfig(),
                 finetuned_norm: bool = True):
        self.device = next(flow.parameters()).device
        F.check_sampler(infer_cfg.sampler)
        self.cfg = model_cfg
        self.icfg = infer_cfg
        self.finetuned_norm = finetuned_norm
        self.llm_p, self.flow_p, self.hift_p = llm.p, flow.p, hift.p
        # wall seconds of the last synthesize() / token2wav() per stage
        # (decode, flow, hift), each ending in a device synchronize
        self.stage_seconds: Dict[str, float] = {}
        self._t_mark = 0.0
        # streaming geometry (the reference's hop / overlap / fade constants)
        fr = model_cfg.flow.input_frame_rate
        self.token_min_hop_len = 2 * fr
        self.token_overlap_len = 20
        self.mel_overlap_len = int(self.token_overlap_len / fr * 22050 / 256)
        self.mel_cache_len = 20
        self.source_cache_len = self.mel_cache_len * 256
        self.mel_window = self._hamming(2 * self.mel_overlap_len)
        self.speech_window = self._hamming(2 * self.source_cache_len)
        # the short first hop (first_chunk_tokens), clamped below by the
        # smallest window whose emitted audio is not empty: a non-final
        # window of W tokens emits ~W * ratio - mel_overlap - mel_cache frames
        ratio = model_cfg.flow.token_mel_ratio
        min_first = max(1, int(-(-(self.mel_overlap_len + self.mel_cache_len + 1)
                                 // ratio)) - self.token_overlap_len)
        self.first_hop = (min(max(infer_cfg.first_chunk_tokens, min_first),
                              self.token_min_hop_len)
                          if infer_cfg.first_chunk_tokens else self.token_min_hop_len)
        # the final window is shorter than hop + overlap tokens: one bucket
        self._final_tok_bucket = -(-(self.token_min_hop_len + self.token_overlap_len) // 32) * 32


    def _hamming(self, n: int) -> torch.Tensor:
        return torch.as_tensor(np.hamming(n), dtype=torch.float32, device=self.device)

    def _mark(self, stage: Optional[str]):
        """Close ``stage`` (None: start the clock) after the device is idle."""
        if self._marks_off:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if stage is not None:
            self.stage_seconds[stage] = now - self._t_mark
        self._t_mark = now

    def _wav_generator(self, seed: int, row: int, chunk: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(stream_seed(seed, row, 1 + chunk))


    def _spk(self, spk_embedding: Optional[np.ndarray]) -> np.ndarray:
        """The prompt-free zero embedding for None (the batched paths, the
        engine and the flow: a speaker row of zeros)."""
        if spk_embedding is None:
            return np.zeros((1, self.cfg.llm.spk_embed_dim), np.float32)
        return np.asarray(spk_embedding, np.float32)

    # ------------------------------------------------------------------
    # stage 1: the LLM's prefix
    # ------------------------------------------------------------------

    def _build_prefix(self, text_tokens: np.ndarray, prompt_text: Optional[np.ndarray],
                      prompt_speech_token: Optional[np.ndarray],
                      spk_embedding: Optional[np.ndarray], max_len_cap: int):
        """Pack [sos, spk?, text_enc, task, prompt_speech?]; returns (prefix
        (1, L0, D), min_len, max_len).  The prompt text goes before the text
        into the text encoder; ``spk_embedding=None`` omits the speaker row
        (instruct).  min_len and max_len follow the target text's length
        only."""
        p, cfg = self.llm_p, self.cfg.llm
        ctx = EVAL
        tt = np.asarray(text_tokens)
        n_prompt = 0
        if prompt_text is not None and np.asarray(prompt_text).size:
            n_prompt = np.asarray(prompt_text).shape[1]
            tt = np.concatenate([np.asarray(prompt_text), tt], axis=1)
        tt = torch.as_tensor(tt, dtype=torch.long, device=self.device)
        text_len = tt.shape[1]
        text_enc = L.llm_encode_text(
            p, cfg, tt, torch.full((1,), text_len, dtype=torch.int32, device=self.device), ctx)
        emb = p["llm_embedding.weight"]
        parts = [emb[cfg.sos_eos][None, None]]
        if spk_embedding is not None:
            spk = torch.as_tensor(np.asarray(spk_embedding, np.float32), device=self.device)
            parts.append(dense(p, "spk_embed_affine_layer",
                               L._l2_normalize(spk.to(emb.dtype), dim=1), ctx)[:, None])
        parts += [text_enc, emb[cfg.task_id][None, None]]
        if prompt_speech_token is not None and np.asarray(prompt_speech_token).size:
            pst = torch.as_tensor(np.asarray(prompt_speech_token), dtype=torch.long,
                                  device=self.device).reshape(1, -1)
            parts.append(p["speech_embedding.weight"][pst].to(emb.dtype))
        prefix = torch.cat(parts, dim=1)
        target = text_len - n_prompt
        min_len = int(target * self.icfg.min_token_text_ratio)
        max_len = min(int(target * self.icfg.max_token_text_ratio), max_len_cap)
        return prefix, min_len, max_len


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

    def _mel_len(self, n_tokens: int) -> int:
        return int(n_tokens / self.cfg.flow.input_frame_rate * 22050 / 256)

    def _flow_kw(self) -> dict:
        """flow_inference's mel-space arguments."""
        return dict(finetuned_norm=self.finetuned_norm,
                    mel_norm=(self.cfg.mel_mean, self.cfg.mel_std))

    def token2wav(self, token: np.ndarray, spk_embedding: np.ndarray,
                  prompt_token: Optional[np.ndarray] = None,
                  prompt_feat: Optional[np.ndarray] = None, speed: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  z: Optional[torch.Tensor] = None,
                  hift_phase: Optional[torch.Tensor] = None,
                  hift_noise: Optional[torch.Tensor] = None,
                  stream_state: Optional[StreamState] = None,
                  finalize: bool = True) -> np.ndarray:
        """Flow solve, anti-leakage boundary trim, optional speed change and
        HiFT -> (1, n) float32 waveform.  ``z`` / ``hift_phase`` /
        ``hift_noise`` inject the random draws (tests); otherwise they come
        from ``generator`` (a generator on the pipeline's device).  A flow
        prompt (``prompt_token`` and its raw mel ``prompt_feat``) conditions
        the solve, and its region is dropped from the output.

        Streaming: ``stream_state`` carries the flow cache, the mel overlap
        and HiFT's mel, source and wav tails from one window to the next and
        is updated in place; a prompt goes into every window.  A window that
        is not the last (``finalize`` False) holds back its last
        mel_overlap frames for the next window's fade and source_cache
        samples for the next wav's.  The last window, when ``bucket_final``
        holds and it is prompt-free at speed 1 with 0 < n <= the token
        bucket, is padded to the bucket with its true length masked
        (:meth:`_token2wav_final_bucketed`)."""
        wav = self._token2wav(token, spk_embedding, prompt_token, prompt_feat, speed, generator,
                              z, hift_phase, hift_noise, stream_state, finalize)
        wav = wav.float().cpu().numpy()
        self._mark("hift")
        return wav

    def _token2wav(self, token, spk_embedding, prompt_token, prompt_feat, speed, generator, z,
                   hift_phase, hift_noise, stream_state, finalize) -> torch.Tensor:
        """:meth:`token2wav`'s (1, n) waveform, left on the device."""
        if speed != 1.0 and stream_state is not None and stream_state.hift_mel is not None:
            # the speed change would stretch the crossfade-cache region
            raise ValueError("speed change only supports non-stream inference mode")
        dev = self.device
        flow_kw = self._flow_kw()
        self._mark(None)
        prompt_token = np.zeros((1, 0), np.int64) if prompt_token is None else prompt_token
        prompt_feat = np.zeros((1, 0, 80), np.float32) if prompt_feat is None else prompt_feat
        if (self.icfg.bucket_final and stream_state is not None and finalize
                and speed == 1.0 and prompt_token.shape[1] == 0 and prompt_feat.shape[1] == 0
                and 0 < token.shape[1] <= self._final_tok_bucket):
            return self._token2wav_final_bucketed(token, spk_embedding, stream_state,
                                                  generator, z, hift_phase, hift_noise,
                                                  flow_kw)
        st = stream_state
        mel_len = prompt_feat.shape[1] + self._mel_len(token.shape[1])
        out = F.flow_inference(
            self.flow_p, self.cfg.flow,
            torch.as_tensor(token, dtype=torch.long, device=dev),
            torch.as_tensor(prompt_token, dtype=torch.long, device=dev),
            torch.as_tensor(prompt_feat, dtype=torch.float32, device=dev),
            torch.as_tensor(spk_embedding, dtype=torch.float32, device=dev),
            n_timesteps=self._select_nfe(mel_len), generator=generator, z=z,
            flow_cache=None if st is None else st.flow_cache,
            return_cache=st is not None and not finalize, **flow_kw)
        mel = out[0] if st is not None and not finalize else out
        trim = int(prompt_feat.shape[1] * self.icfg.boundary_trim_ratio)
        if trim > 0 and mel.shape[2] > trim:
            mel = mel[:, :, trim:]
        cache_source = None
        if st is not None:
            if not finalize:
                st.flow_cache = out[1]
            if st.mel_overlap is not None:
                mel = fade_in_out(mel, st.mel_overlap, self.mel_window)
            if st.hift_mel is not None:
                mel = torch.cat([st.hift_mel, mel], dim=2)
                cache_source = st.hift_source
            if not finalize:
                st.mel_overlap = mel[:, :, -self.mel_overlap_len:]
                mel = mel[:, :, :-self.mel_overlap_len]
        if speed != 1.0 and finalize:
            mel = F.interpolate_linear(mel, int(mel.shape[2] / speed))
        self._mark("flow")
        wav, source = H.hift_inference(self.hift_p, self.cfg.hift, mel, generator,
                                       hift_phase, hift_noise, cache_source)
        if st is not None:
            if st.hift_speech is not None:
                wav = fade_in_out(wav, st.hift_speech, self.speech_window)
            if not finalize:
                st.hift_mel = mel[:, :, -self.mel_cache_len:]
                st.hift_source = source[:, :, -self.source_cache_len:]
                st.hift_speech = wav[:, -self.source_cache_len:]
                wav = wav[:, :-self.source_cache_len]
        return wav

    def _token2wav_final_bucketed(self, token, spk_embedding, st: StreamState, generator,
                                  z, hift_phase, hift_noise, flow_kw) -> torch.Tensor:
        """The last streaming window at the one token bucket: the flow
        solve, the fade and HiFT run at the bucket's length with the true
        length masked, and the wav is cut back to the true length.  NFE
        follows the true mel length."""
        dev = self.device
        n = token.shape[1]
        mel2 = self._mel_len(n)
        tok = torch.zeros((1, self._final_tok_bucket), dtype=torch.long, device=dev)
        tok[:, :n] = torch.as_tensor(token, dtype=torch.long, device=dev)
        mel = F.flow_inference(
            self.flow_p, self.cfg.flow, tok, torch.zeros((1, 0), dtype=torch.long, device=dev),
            torch.zeros((1, 0, 80), device=dev),
            torch.as_tensor(spk_embedding, dtype=torch.float32, device=dev),
            n_timesteps=self._select_nfe(mel2), generator=generator, z=z,
            flow_cache=st.flow_cache, token_valid=n, mel_valid=mel2, **flow_kw)
        valid = mel2
        if st.mel_overlap is not None:
            mel = fade_in_out(mel, st.mel_overlap, self.mel_window, valid=mel2)
        if st.hift_mel is not None:
            mel = torch.cat([st.hift_mel, mel], dim=2)
            valid += st.hift_mel.shape[2]
        self._mark("flow")
        wav, _ = H.hift_inference(self.hift_p, self.cfg.hift, mel, generator, hift_phase,
                                  hift_noise, st.hift_source, mel_valid=valid)
        if st.hift_speech is not None:
            wav = fade_in_out(wav, st.hift_speech, self.speech_window)
        return wav[:, :valid * 256]

    # ------------------------------------------------------------------
    # streaming
    # ------------------------------------------------------------------


    def stream_chunks(self, cur: StreamCursor, tokens: np.ndarray,
                      done: bool) -> Iterator[np.ndarray]:
        """The (1, n) wavs of the windows that ``tokens`` (the stream's
        tokens so far) already fill, advancing ``cur``: hop + overlap
        tokens each, the cursor's hop first and the pipeline's after, then
        the rest as the last window once ``done``.  Every window takes the
        cursor's flow prompt."""
        ov = self.token_overlap_len
        kw = dict(prompt_token=cur.prompt_token, prompt_feat=cur.prompt_feat,
                  stream_state=cur.state)
        while tokens.shape[1] - cur.pos >= cur.hop + ov:
            yield self.token2wav(tokens[:, cur.pos:cur.pos + cur.hop + ov], cur.spk,
                                 generator=self._wav_generator(cur.seed, cur.row, cur.chunk),
                                 finalize=False, **kw)
            cur.pos, cur.hop, cur.chunk = cur.pos + cur.hop, self.token_min_hop_len, cur.chunk + 1
        if done:
            yield self.token2wav(tokens[:, cur.pos:], cur.spk,
                                 generator=self._wav_generator(cur.seed, cur.row, cur.chunk),
                                 finalize=True, **kw)
