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
:class:`Stream2Cursor`: solo streaming (``synthesize(stream=True)``),
batched streaming (``synthesize_stream_batch``) and the serving engine
(``infer/engine.py``) all cut their token streams with it.

``InferenceConfig.int8_decode`` quantizes every Qwen2 projection
(``quant.QWEN2_PROJ_SUFFIXES``) once, in the constructor, for every route,
as the JAX package does.  The bistream decoder has no pipeline entry point,
as in the JAX package (``models.qwen2lm.qwen2lm_inference_bistream``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import HiFTConfig, InferenceConfig
from ..models import hift as H
from ..models import qwen2lm as Q
from ..models.flow import interpolate_linear
from ..models.flow import check_sampler_weights
from ..models.flow2 import Flow2, Flow2Config, flow2_inference
from ..ops.fused_block import require_kernel_widths
from ..params import P
from ..quant import quantize_int8
from .pipeline import _batch_prefixes, fade_in_out, stream_seed


def hift24k_config() -> HiFTConfig:
    """CosyVoice2's 24 kHz HiFT, as the public CosyVoice2 yaml spells it:
    upsampling (8, 5, 3) with kernels (16, 11, 7), a source resblock a
    stage, hop 480."""
    return HiFTConfig(sampling_rate=24000, upsample_rates=(8, 5, 3),
                      upsample_kernel_sizes=(16, 11, 7),
                      source_resblock_kernel_sizes=(7, 7, 11),
                      source_resblock_dilation_sizes=((1, 3, 5),) * 3)


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

    def __init__(self, llm_cfg: Q.Qwen2LMConfig, flow_cfg: Flow2Config, hift_cfg: HiFTConfig,
                 llm: Q.Qwen2LM, flow: Flow2, hift: H.HiFT,
                 infer_cfg: InferenceConfig = InferenceConfig(), hop_samples: int = 480):
        self.device = next(flow.parameters()).device
        require_kernel_widths(flow_cfg.estimator, self.device)
        check_sampler_weights(infer_cfg.sampler, infer_cfg.meanflow_steps, flow)
        self.lcfg, self.fcfg, self.hcfg, self.icfg = llm_cfg, flow_cfg, hift_cfg, infer_cfg
        self.llm_p, self.flow_p, self.hift_p = llm.p, flow.p, hift.p
        if infer_cfg.int8_decode:
            self.llm_p = P(quantize_int8(self.llm_p.d))
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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if stage is not None:
            self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + now - self._t_mark
        self._t_mark = now

    def _nfe(self) -> int:
        """Fixed NFE (the reference's 10), or the few-step count under the
        distilled MeanFlow sampler."""
        return (self.icfg.meanflow_steps if self.icfg.sampler == "meanflow"
                else self.icfg.nfe_short)

    def _wav_generator(self, seed: int, row: int, chunk: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(stream_seed(seed, row, 1 + chunk))

    @staticmethod
    def _decode_generator(seed: int, row: int) -> torch.Generator:
        return torch.Generator().manual_seed(stream_seed(seed, row, 0))

    def _sampling(self) -> dict:
        return dict(top_p=self.icfg.sampling_top_p, top_k=self.icfg.sampling_top_k,
                    win_size=self.icfg.ras_win_size, tau_r=self.icfg.ras_tau_r)

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

    def generate_tokens(self, text_tokens, prompt_text=None, prompt_speech_token=None,
                        max_len_cap: int = 2048,
                        generator: Optional[torch.Generator] = None) -> np.ndarray:
        """(1, Tt) text ids -> (1, n) speech tokens; ``generator`` is a CPU
        generator (sampling runs on the host)."""
        prefix, min_len, max_len = self._build_prefix(text_tokens, prompt_text,
                                                      prompt_speech_token, max_len_cap)
        toks = Q.qwen2lm_decode(self.llm_p, self.lcfg, prefix, min_len, max_len,
                                generator=generator, **self._sampling())
        return np.asarray(toks, np.int64)[None, :]

    def generate_tokens_stream(self, text_tokens, prompt_text=None, prompt_speech_token=None,
                               max_len_cap: int = 2048, seg_tokens: Optional[int] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> Iterator[Tuple[np.ndarray, bool]]:
        """Yields (tokens so far (1, n), done) every ``seg_tokens`` attempts
        (default two hops): the segments of one paused and resumed decode,
        so the tokens equal ``generate_tokens``'s.  A segment can deliver
        fewer tokens than attempts (fill tokens are not stored)."""
        prefix, min_len, max_len = self._build_prefix(text_tokens, prompt_text,
                                                      prompt_speech_token, max_len_cap)
        state = Q.qwen2lm_decode_start(self.llm_p, self.lcfg, prefix, [prefix.shape[1]],
                                       [min_len], [max_len], [generator], **self._sampling())
        seg = seg_tokens or 2 * self.token_hop_len
        target = min(seg, max_len)
        while True:
            state.run(target)
            done = state.done[0]
            yield np.asarray(state.tokens[0], np.int64)[None, :], done
            if done:
                return
            target = min(target + seg, max_len)

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
        out = wav.float().cpu().numpy()
        self._mark("hift")
        return out, None if finalize else state

    def _token2wav_final_bucketed(self, token, spk_embedding, token_offset: int,
                                  st: Stream2State, generator, hift_phase,
                                  hift_noise) -> np.ndarray:
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
        out = wav[:, :valid * self.hop_samples].float().cpu().numpy()
        self._mark("hift")
        return out

    # ------------------------------------------------------------------
    # full pipeline
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def synthesize(self, text_tokens: Optional[np.ndarray] = None,
                   prompt_text: Optional[np.ndarray] = None,
                   llm_prompt_speech_token: Optional[np.ndarray] = None,
                   flow_prompt_speech_token: Optional[np.ndarray] = None,
                   prompt_feat: Optional[np.ndarray] = None,
                   flow_embedding: Optional[np.ndarray] = None,
                   source_speech_token: Optional[np.ndarray] = None,
                   stream: bool = False, speed: float = 1.0, seed: int = 0,
                   max_len_cap: int = 2048) -> Iterator[Dict[str, np.ndarray]]:
        """model.py:372-430: yields {'tts_speech': (1, n) float32} chunks,
        one, or with ``stream`` one a hop (the first hop padded so the flow
        prompt ends on a hop boundary, model.py:388-404).  The tokens come
        from the LLM, or are ``source_speech_token`` (voice conversion)."""
        if stream and speed != 1.0:
            raise ValueError("speed != 1.0 is only supported with stream=False")
        flow_embedding = self._spk(flow_embedding)
        self.stage_seconds = {}
        vc_tokens = None
        if source_speech_token is not None and np.asarray(source_speech_token).size:
            vc_tokens = np.asarray(source_speech_token, np.int64).reshape(1, -1)
        fp = flow_prompt_speech_token
        dec_gen = self._decode_generator(seed, 0)
        if not stream:
            self._mark(None)
            tokens = vc_tokens if vc_tokens is not None else self.generate_tokens(
                text_tokens, prompt_text, llm_prompt_speech_token, max_len_cap, dec_gen)
            self._mark("decode")
            wav, _ = self.token2wav(tokens, fp, prompt_feat, flow_embedding, 0, speed=speed,
                                    generator=self._wav_generator(seed, 0, 0))
            yield {"tts_speech": wav}
            return

        producer = iter([(vc_tokens, True)]) if vc_tokens is not None else \
            self.generate_tokens_stream(text_tokens, prompt_text, llm_prompt_speech_token,
                                        max_len_cap, generator=dec_gen)
        n_prompt = 0 if fp is None else np.asarray(fp).shape[1]
        pad0 = -(-n_prompt // self.token_hop_len) * self.token_hop_len - n_prompt
        cur = Stream2Cursor(flow_embedding, seed, 0, self.token_hop_len + pad0, fp, prompt_feat)
        done = False
        while not done:
            self._mark(None)
            tokens, done = next(producer)
            self._mark("decode")
            for wav in self.stream_chunks(cur, tokens, done):
                yield {"tts_speech": wav}

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

    def _decode_start(self, text_tokens_list: Sequence[np.ndarray], max_len_cap: int,
                      seed: int) -> Q.Qwen2DecodeState:
        """Prefill the requests' LEFT-padded prefixes as one batch; row b
        draws from ``stream_seed(seed, b, 0)``, as a solo request with that
        seed does, so its tokens are the solo decode's."""
        built = [self._build_prefix(t, None, None, max_len_cap) for t in text_tokens_list]
        prefix, valid, min_lens, max_lens = _batch_prefixes(built)
        return Q.qwen2lm_decode_start(self.llm_p, self.lcfg, prefix, valid, min_lens, max_lens,
                                      [self._decode_generator(seed, b) for b in range(len(built))],
                                      **self._sampling())

    def decode_batch(self, text_tokens_list: Sequence[np.ndarray], max_len_cap: int = 2048,
                     seed: int = 0) -> List[List[int]]:
        """One lock-step decode of the requests (rows as :meth:`_decode_start`)."""
        return self._decode_start(text_tokens_list, max_len_cap, seed).run().tokens

    @torch.inference_mode()
    def synthesize_batch(self, text_tokens_list: Sequence[np.ndarray], spk_embeddings=None,
                         speed=1.0, max_len_cap: int = 2048, seed: int = 0) -> List[np.ndarray]:
        """Micro-batched whole-utterance synthesis: one batched decode, then
        flow and HiFT per request.  Returns a (1, n) wav per request."""
        B = len(text_tokens_list)
        spks = [self._spk(s) for s in (spk_embeddings or [None] * B)]
        speeds = list(speed) if isinstance(speed, (list, tuple)) else [speed] * B
        self.stage_seconds = {}
        self._mark(None)
        rows = self.decode_batch(text_tokens_list, max_len_cap, seed)
        self._mark("decode")
        return [self.token2wav(np.asarray(rows[b], np.int64)[None], None, None, spks[b], 0,
                               speed=speeds[b], generator=self._wav_generator(seed, b, 0))[0]
                for b in range(B)]

    @torch.inference_mode()
    def synthesize_stream_batch(self, text_tokens_list: Sequence[np.ndarray],
                                spk_embeddings=None, max_len_cap: int = 2048, seed: int = 0
                                ) -> Iterator[Tuple[int, np.ndarray, bool]]:
        """Batched streaming: one lock-step segmented decode (segments of two
        hops of attempts) shares each step's weight reads across the
        streams, and each stream emits its windows (:meth:`stream_chunks`)
        as its tokens fill them, then its final window.  Row b's tokens and
        chunks are those of a solo streamed synthesis with row b's draws.
        Yields (request index, wav (1, n), last)."""
        B = len(text_tokens_list)
        spks = [self._spk(s) for s in (spk_embeddings or [None] * B)]
        self.stage_seconds = {}
        self._mark(None)
        state = self._decode_start(text_tokens_list, max_len_cap, seed)
        curs = [Stream2Cursor(spks[b], seed, b, self.token_hop_len) for b in range(B)]
        seg = 2 * self.token_hop_len
        finished = [False] * B
        target = seg
        while not all(finished):
            state.run(target)
            self._mark("decode")
            for b in range(B):
                if finished[b]:
                    continue
                finished[b] = state.done[b]
                wavs = list(self.stream_chunks(
                    curs[b], np.asarray(state.tokens[b], np.int64)[None], finished[b]))
                for i, wav in enumerate(wavs):
                    yield b, wav, finished[b] and i == len(wavs) - 1
            self._mark(None)
            target += seg
