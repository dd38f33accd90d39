"""CosyVoice2 synthesis: Qwen2LM -> causal flow -> 24 kHz HiFT (the port of
the JAX package's ``infer/pipeline2.py``).

Reference behavior: cosyvoice/cli/model.py:291-437 (CosyVoice2Model):
25-token hops with the 3-token lookahead, the token-offset mel trim
(token_mel_ratio 2), HiFT's mel / source / wav caches (mel_cache_len 8,
source cache 8 x hop, a hamming crossfade), and no flow carry: the causal
flow starts every window from the fixed seeded noise.  The last window of
a prompt-free stream runs at a token bucket with its true length masked.

Randomness, as in the port's ``TTSPipeline``: row ``row``'s decode draws
from a CPU generator seeded ``stream_seed(seed, row, 0)`` and its k-th wav
chunk's HiFT phases and noise from a generator on the pipeline's device
seeded ``stream_seed(seed, row, 1 + k)``; tests inject the draws instead
(``hift_phase`` / ``hift_noise``).

Streaming has one window planner, :meth:`TTS2Pipeline.stream_chunks` over a
:class:`Stream2Cursor`, as the serving engine cuts its token streams.  The
benchmark's reference runs the prefix pack, ``token2wav`` and the streamed
windows.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import HiFTConfig, InferenceConfig
from ..models import hift as H
from ..models import qwen2lm as Q
from ..models.flow import interpolate_linear
from ..models.flow import check_sampler
from ..models.flow2 import Flow2, Flow2Config, flow2_inference
from .pipeline import fade_in_out, stream_seed


@dataclasses.dataclass
class Stream2State:
    """HiFT carries of one stream, on the pipeline's device; None before the
    first chunk."""
    hift_mel: Optional[torch.Tensor] = None  # (1, 80, 8)
    hift_source: Optional[torch.Tensor] = None  # (1, 1, 8 * hop)
    hift_speech: Optional[torch.Tensor] = None  # (1, 8 * hop)


@dataclasses.dataclass
class Stream2Cursor:
    """One CosyVoice2 stream's place in its token stream: the tokens already
    emitted (``offset``), the next window's hop (the first one padded so a
    flow prompt ends on a hop boundary), the chunks emitted so far (chunk k
    draws from ``stream_seed(seed, row, 1 + k)``), its flow prompt and its
    HiFT carries."""
    spk: np.ndarray
    seed: int
    row: int
    hop: int
    prompt_token: Optional[np.ndarray] = None
    prompt_feat: Optional[np.ndarray] = None
    offset: int = 0
    chunk: int = 0
    state: Stream2State = dataclasses.field(default_factory=Stream2State)


class TTS2Pipeline:
    """Synthesis over the port's ``Qwen2LM``, ``Flow2`` and ``HiFT``
    modules, all on one device."""

    _marks_off = False  # stage marks skipped (a batch dispatched before its reads)

    def __init__(self, llm_cfg: Q.Qwen2LMConfig, flow_cfg: Flow2Config, hift_cfg: HiFTConfig,
                 llm: Q.Qwen2LM, flow: Flow2, hift: H.HiFT,
                 infer_cfg: InferenceConfig = InferenceConfig(), hop_samples: int = 480):
        self.device = next(flow.parameters()).device
        check_sampler(infer_cfg.sampler)
        self.lcfg, self.fcfg, self.hcfg, self.icfg = llm_cfg, flow_cfg, hift_cfg, infer_cfg
        self.llm_p, self.flow_p, self.hift_p = llm.p, flow.p, hift.p
        self.token_hop_len = 25  # model.py:307, the training chunk
        self.mel_cache_len = 8
        self.hop_samples = hop_samples
        self.source_cache_len = self.mel_cache_len * hop_samples
        self.speech_window = torch.as_tensor(np.hamming(2 * self.source_cache_len),
                                             dtype=torch.float32, device=self.device)
        # the un-emitted tokens of a final window: fewer than hop + lookahead
        self._final_out_tokens = -(-(self.token_hop_len + flow_cfg.pre_lookahead_len) // 32) * 32
        # wall seconds of the last synthesize() per stage (decode, flow,
        # hift), each ending in a device synchronize
        self.stage_seconds: Dict[str, float] = {}
        self._t_mark = 0.0


    def _mark(self, stage: Optional[str]):
        if self._marks_off:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if stage is not None:
            self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + now - self._t_mark
        self._t_mark = now

    def _nfe(self) -> int:
        """Fixed NFE (the reference's 10)."""
        return self.icfg.nfe_short

    def _wav_generator(self, seed: int, row: int, chunk: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(stream_seed(seed, row, 1 + chunk))


    def _spk(self, spk_embedding: Optional[np.ndarray]) -> np.ndarray:
        """The flow's speaker embedding: zeros when none is given."""
        return np.zeros((1, self.fcfg.spk_embed_dim), np.float32) if spk_embedding is None \
            else spk_embedding

    def _long(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)

    # ------------------------------------------------------------------
    # stage 1: speech tokens
    # ------------------------------------------------------------------

    def _build_prefix(self, text_tokens, prompt_text, prompt_speech_token, max_len_cap: int):
        """[sos, prompt text + text, task, prompt speech] -> (prefix
        (1, L0, D), min_len, max_len): the bounds count the target text."""
        tt = np.asarray(text_tokens)
        n_prompt = 0
        if prompt_text is not None and np.asarray(prompt_text).size:
            tt = np.concatenate([np.asarray(prompt_text), tt], axis=1)
            n_prompt = np.asarray(prompt_text).shape[1]
        pst = None
        if prompt_speech_token is not None and np.asarray(prompt_speech_token).size:
            pst = self._long(prompt_speech_token)
        prefix = Q.qwen2lm_prefix(self.llm_p, self.lcfg, self._long(tt), pst)
        target = tt.shape[1] - n_prompt
        min_len = int(target * self.icfg.min_token_text_ratio)
        max_len = min(int(target * self.icfg.max_token_text_ratio), max_len_cap)
        return prefix, min_len, max_len


    # ------------------------------------------------------------------
    # stage 2+3: tokens -> mel -> wav
    # ------------------------------------------------------------------

    def token2wav(self, token: np.ndarray, prompt_token: Optional[np.ndarray],
                  prompt_feat: Optional[np.ndarray], spk_embedding: np.ndarray,
                  token_offset: int, state: Optional[Stream2State] = None,
                  stream: bool = False, finalize: bool = True, speed: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  hift_phase: Optional[torch.Tensor] = None,
                  hift_noise: Optional[torch.Tensor] = None
                  ) -> Tuple[np.ndarray, Optional[Stream2State]]:
        """The causal flow over the cumulative tokens (the lookahead as
        context unless ``finalize``), the trim of the ``token_offset``
        tokens already emitted, HiFT with the stream's caches
        (model.py:336-370) -> ((1, n) wav, the updated state or None).
        A prompt-free last window at speed 1 with 0 < n - offset <= the
        final bucket runs at a token bucket with its length masked."""
        wav, state = self._token2wav(token, prompt_token, prompt_feat, spk_embedding,
                                     token_offset, state, stream, finalize, speed, generator,
                                     hift_phase, hift_noise)
        out = wav.float().cpu().numpy()
        self._mark("hift")
        return out, state

    def _token2wav(self, token, prompt_token, prompt_feat, spk_embedding, token_offset, state,
                   stream, finalize, speed, generator, hift_phase, hift_noise):
        """:meth:`token2wav` with its (1, n) waveform left on the device."""
        if speed != 1.0 and (stream or (state is not None and state.hift_mel is not None)):
            raise ValueError("speed change only supports non-stream inference mode")
        dev = self.device
        prompt_token = np.zeros((1, 0), np.int64) if prompt_token is None else prompt_token
        prompt_feat = np.zeros((1, 0, 80), np.float32) if prompt_feat is None else prompt_feat
        n = token.shape[1]
        if (self.icfg.bucket_final and state is not None and finalize and speed == 1.0
                and prompt_token.shape[1] == 0 and prompt_feat.shape[1] == 0
                and 0 < n - token_offset <= self._final_out_tokens):
            return self._token2wav_final_bucketed(token, spk_embedding, token_offset, state,
                                                  generator, hift_phase, hift_noise), None
        self._mark(None)
        mel = flow2_inference(
            self.flow_p, self.fcfg, self._long(token), self._long(prompt_token),
            torch.as_tensor(prompt_feat, dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(spk_embedding), dtype=torch.float32, device=dev),
            streaming=stream, finalize=finalize, n_timesteps=self._nfe(),
            sampler=self.icfg.sampler)
        mel = mel[:, :, token_offset * self.fcfg.token_mel_ratio:]
        state = state or Stream2State()
        cache_source = None
        if state.hift_mel is not None:
            mel = torch.cat([state.hift_mel, mel], dim=2)
            cache_source = state.hift_source
        if finalize and speed != 1.0:
            mel = interpolate_linear(mel, int(mel.shape[2] / speed))
        self._mark("flow")
        wav, source = H.hift_inference(self.hift_p, self.hcfg, mel, generator, hift_phase,
                                       hift_noise, cache_source)
        if state.hift_speech is not None:
            wav = fade_in_out(wav, state.hift_speech, self.speech_window)
        if not finalize:
            state.hift_mel = mel[:, :, -self.mel_cache_len:]
            state.hift_source = source[:, :, -self.source_cache_len:]
            state.hift_speech = wav[:, -self.source_cache_len:]
            wav = wav[:, :-self.source_cache_len]
        return wav, None if finalize else state

    def _token2wav_final_bucketed(self, token, spk_embedding, token_offset: int,
                                  st: Stream2State, generator, hift_phase,
                                  hift_noise) -> torch.Tensor:
        """The last window at a 128-token bucket of the cumulative stream:
        the flow runs with the true length masked, the un-emitted mel
        window (``_final_out_tokens`` wide) is cut at the offset, and HiFT
        runs on it with its valid length; the wav is cut back to it."""
        dev, r = self.device, self.fcfg.token_mel_ratio
        self._mark(None)
        n = token.shape[1]
        tb = max(128, -(-n // 128) * 128)
        tok = torch.zeros((1, tb), dtype=torch.long, device=dev)
        tok[:, :n] = self._long(token)
        mel = flow2_inference(
            self.flow_p, self.fcfg, tok, torch.zeros((1, 0), dtype=torch.long, device=dev),
            torch.zeros((1, 0, 80), device=dev),
            torch.as_tensor(np.asarray(spk_embedding), dtype=torch.float32, device=dev),
            streaming=False, finalize=True, n_timesteps=self._nfe(), token_valid=n,
            sampler=self.icfg.sampler)
        width = self._final_out_tokens * r
        mel = torch.nn.functional.pad(mel, (0, width))
        melw = mel[:, :, token_offset * r:token_offset * r + width]
        valid = (n - token_offset) * r
        if st.hift_mel is not None:
            melw = torch.cat([st.hift_mel, melw], dim=2)
            valid += st.hift_mel.shape[2]
        self._mark("flow")
        wav, _ = H.hift_inference(self.hift_p, self.hcfg, melw, generator, hift_phase,
                                  hift_noise, st.hift_source, mel_valid=valid)
        if st.hift_speech is not None:
            wav = fade_in_out(wav, st.hift_speech, self.speech_window)
        return wav[:, :valid * self.hop_samples]

    # ------------------------------------------------------------------
    # full pipeline
    # ------------------------------------------------------------------


    def stream_chunks(self, cur: Stream2Cursor, tokens: np.ndarray,
                      done: bool) -> Iterator[np.ndarray]:
        """The (1, n) wavs of the windows that ``tokens`` (the stream's
        tokens so far) already fill, advancing ``cur``: cumulative windows of
        offset + hop + pre_lookahead tokens, the lookahead as context, the
        emitted tokens trimmed; then, once ``done``, the rest as the final
        window (model.py:388-430)."""
        la = self.fcfg.pre_lookahead_len
        while tokens.shape[1] >= cur.offset + cur.hop + la:
            wav, cur.state = self.token2wav(
                tokens[:, :cur.offset + cur.hop + la], cur.prompt_token, cur.prompt_feat,
                cur.spk, cur.offset, cur.state, stream=True, finalize=False,
                generator=self._wav_generator(cur.seed, cur.row, cur.chunk))
            cur.offset, cur.hop, cur.chunk = cur.offset + cur.hop, self.token_hop_len, cur.chunk + 1
            yield wav
        if done:
            wav, _ = self.token2wav(tokens, cur.prompt_token, cur.prompt_feat, cur.spk, cur.offset,
                                    cur.state, finalize=True,
                                    generator=self._wav_generator(cur.seed, cur.row, cur.chunk))
            yield wav


