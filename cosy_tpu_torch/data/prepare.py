"""Data preparation: (wav, txt) pairs -> parquet shards + data.list (the port
of the JAX package's ``data/prepare.py`` and of ``prepare_joint_data.py``).

Reference behavior: prepare_joint_data.py (JointDataPreparer).

- The mel frontend (ops/audio.mel_spectrogram_prepadded) runs on the
  preparer's device in length-bucketed batches (0.5 s buckets, each clip
  reflect-padded on its own signal first).
- The frozen extractors, the ONNX speech tokenizer (whisper log-mel at
  16 kHz) and the campplus speaker encoder (kaldi fbank), run their graphs
  through the port's own executor (``compat.onnx``) on the device; their
  host features are numpy, as in the JAX package.  When no model file is
  given, the reference's documented fallbacks apply (random tokens at
  50/s, a random 192-d embedding: prepare_joint_data.py:128-133, 156-158).
- Resampling is scipy's polyphase ``resample_poly``.

Run it as ``python -m cosy_tpu_torch.data.prepare --input DIR --output DIR
[--speech-tokenizer-onnx PATH] [--campplus-onnx PATH] [--samples-per-shard
N] [--device cuda]``; the shards are what ``data.dataset`` reads.
"""

from __future__ import annotations

import argparse
import hashlib
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..compat.onnx import OnnxModel
from ..ops import audio as A
from ..params import resolve_device
from .text import text_normalize
from .tokenizer import TextTokenizer, find_vocab_file


# ---------------------------------------------------------------------------
# IO helpers
# ---------------------------------------------------------------------------


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """(mono float32 in [-1, 1], sample_rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    data = np.asarray(data)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data, int(sr)


def resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return wav
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    return resample_poly(wav, target_sr // g, sr // g).astype(np.float32)


# ---------------------------------------------------------------------------
# pluggable extractors
# ---------------------------------------------------------------------------


class OnnxSpeechTokenizer:
    """ONNX speech tokenizer (frontend.py:131-141): 16 kHz -> whisper 128-mel
    (host) -> the graph on ``device`` -> 50 Hz token ids."""

    def __init__(self, onnx_path: str, device=None):
        self.model = OnnxModel.load(onnx_path, device)

    def __call__(self, wav16k: np.ndarray) -> np.ndarray:
        mel = whisper_log_mel(wav16k, n_mels=128)[None]
        names = self.model.input_names
        out = self.model.run({names[0]: mel.astype(np.float32),
                              names[1]: np.array([mel.shape[2]], np.int32)})
        return _host(out[0]).reshape(-1).astype(np.int64)


class OnnxCampplus:
    """ONNX campplus speaker encoder (frontend.py:143-152): kaldi fbank 80
    (host), mean-normalized, then the graph on ``device``."""

    def __init__(self, onnx_path: str, device=None):
        self.model = OnnxModel.load(onnx_path, device)

    def __call__(self, wav16k: np.ndarray) -> np.ndarray:
        feat = kaldi_fbank(wav16k, sr=16000, n_mels=80)
        feat = feat - feat.mean(axis=0, keepdims=True)
        out = self.model.run({self.model.input_names[0]: feat[None]})
        return _host(out[0]).reshape(-1).astype(np.float32)


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def fallback_speech_tokenizer(wav16k: np.ndarray, seed: int = 0) -> np.ndarray:
    """Reference fallback: ~50 tokens/s random ids (prepare_joint_data.py:128-133),
    made deterministic per clip."""
    n = max(1, int(len(wav16k) / 16000 * 50))
    rng = np.random.default_rng(seed + len(wav16k))
    return rng.integers(0, 4096, size=n).astype(np.int64)


def fallback_embedding(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(192).astype(np.float32)


# ---------------------------------------------------------------------------
# host feature ops used by the ONNX extractors
# ---------------------------------------------------------------------------


def whisper_log_mel(wav: np.ndarray, n_mels: int = 128, sr: int = 16000) -> np.ndarray:
    """whisper.log_mel_spectrogram parity (reference frontend.py:131-141 feeds
    this to the S3 speech tokenizer): periodic hann 400 / hop 160, center=True
    reflect pad, power spectrum with the final frame dropped, SLANEY (htk=False,
    norm='slaney') librosa filterbank — whisper's bundled mel_filters.npz is
    generated exactly that way — then log10(clamp(x, 1e-10)), a max()-8
    dynamic-range clamp, and (x+4)/4 scaling.  Pinned to a recorded independent
    torch oracle: tests/goldens/whisper_mel.npz via
    tests/test_audio_ops.py::test_whisper_log_mel_golden (max|err| ~5e-5)."""
    n_fft, hop = 400, 160
    pad = n_fft // 2
    y = np.pad(wav, (pad, pad), mode="reflect")
    window = np.hanning(n_fft + 1)[:-1]
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = (np.arange(n_frames) * hop)[:, None] + np.arange(n_fft)[None, :]
    frames = y[idx] * window
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)
    power = (np.abs(spec) ** 2).T  # (F, T)
    power = power[:, :-1]  # whisper drops the final frame
    basis = A.mel_filterbank(sr, n_fft, n_mels, 0.0, sr / 2)
    mel = basis @ power
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def kaldi_fbank(wav: np.ndarray, sr: int = 16000, n_mels: int = 80) -> np.ndarray:
    """Kaldi-style fbank: 25 ms frames / 10 ms shift, povey window, snip edges,
    per-frame dither-free, log mel energies (torchaudio.compliance.kaldi.fbank
    defaults used by frontend.py:145)."""
    frame_len = int(sr * 0.025)
    frame_shift = int(sr * 0.010)
    wav = wav * 32768.0  # kaldi operates on int16 scale
    n_frames = 1 + (len(wav) - frame_len) // frame_shift
    if n_frames <= 0:
        return np.zeros((0, n_mels), np.float32)
    idx = (np.arange(n_frames) * frame_shift)[:, None] + np.arange(frame_len)[None, :]
    frames = wav[idx].astype(np.float64)
    frames = frames - frames.mean(axis=1, keepdims=True)  # remove_dc_offset
    # preemphasis 0.97 (torchaudio kaldi default; first sample pairs with
    # itself) — omitting it boosts low-frequency energy ~20 dB vs the
    # features campplus was trained on
    frames = frames - 0.97 * np.concatenate(
        [frames[:, :1], frames[:, :-1]], axis=1)
    # povey window = hann ** 0.85
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame_len) / (frame_len - 1))) ** 0.85
    frames = frames * win
    n_fft = 1 << (frame_len - 1).bit_length()
    power = np.abs(np.fft.rfft(frames, n=n_fft, axis=-1)) ** 2
    # kaldi mel banks: htk mel scale, triangles piecewise-linear in MEL
    # space (get_mel_banks), no normalization
    low, high = 20.0, sr / 2
    mel = lambda f: 1127.0 * np.log(1 + f / 700.0)  # noqa: E731
    pts = np.linspace(mel(low), mel(high), n_mels + 2)
    bins_mel = mel(np.linspace(0, sr / 2, n_fft // 2 + 1))
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for m in range(n_mels):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        up = (bins_mel - lo) / (c - lo)
        down = (hi - bins_mel) / (hi - c)
        fb[m] = np.maximum(0, np.minimum(up, down))
    mel_e = power @ fb.T
    return np.log(np.maximum(mel_e, 1.19209290e-7)).astype(np.float32)


# ---------------------------------------------------------------------------
# preparer
# ---------------------------------------------------------------------------


@dataclass
class PrepareConfig:
    target_sr: int = 22050
    min_duration: float = 0.5
    max_duration: float = 30.0
    samples_per_shard: int = 100  # reference: 100 rows per parquet
    mel_batch: int = 8  # clips per mel batch (bucketed by length)


class JointDataPreparer:
    """wav+txt directory -> parquet dataset (prepare_joint_data.py:56-372);
    the mels run on ``device`` (CUDA unless the caller passes another)."""

    def __init__(
        self,
        cfg: PrepareConfig = PrepareConfig(),
        tokenizer: Optional[TextTokenizer] = None,
        speech_tokenizer: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        spk_encoder: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        device=None,
    ):
        self.cfg = cfg
        if tokenizer is None and find_vocab_file() is not None:
            tokenizer = TextTokenizer()
        self.tokenizer = tokenizer
        self.speech_tokenizer = speech_tokenizer
        self.spk_encoder = spk_encoder
        self.device = resolve_device(device)

    # -- per-stage ------------------------------------------------------

    def text_to_tokens(self, text: str) -> List[int]:
        normalized = text_normalize(text)
        if self.tokenizer is None:
            # byte-level fallback keeps the pipeline runnable without the vocab asset
            return list(normalized.encode("utf-8"))
        return self.tokenizer.encode(normalized)

    def read_samples(self, input_dir: str) -> List[Dict]:
        samples = []
        for fn in sorted(os.listdir(input_dir)):
            if not fn.endswith(".wav"):
                continue
            stem = fn[:-4]
            txt = os.path.join(input_dir, stem + ".txt")
            if not os.path.exists(txt):
                print(f"  [WARN] missing text for {stem}")
                continue
            text = open(txt, encoding="utf-8").read().strip()
            if not text:
                continue
            samples.append({"utt": stem, "wav": os.path.join(input_dir, fn), "text": text})
        print(f"found {len(samples)} (wav, txt) pairs in {input_dir}")
        return samples

    def _batched_mels(self, wavs: List[np.ndarray]) -> List[np.ndarray]:
        """Fused batched mel extraction with length bucketing.

        Each clip is reflect-padded on its OWN signal before the zero pad to
        the bucket (mel_spectrogram_prepadded): otherwise every non-longest
        clip's final frames window into bucket zeros instead of its
        reflected signal end.  Bucket lengths quantize to 0.5 s."""
        pad_r = (A.N_FFT - A.HOP_SIZE) // 2
        bucket_q = self.cfg.target_sr // 2  # 0.5 s grid
        order = np.argsort([len(w) for w in wavs])
        mels: List[Optional[np.ndarray]] = [None] * len(wavs)
        for start in range(0, len(order), self.cfg.mel_batch):
            group = order[start : start + self.cfg.mel_batch]
            max_len = max(len(wavs[i]) for i in group) + 2 * pad_r
            max_len = -(-max_len // bucket_q) * bucket_q
            batch = np.zeros((len(group), max_len), np.float32)
            for row, i in enumerate(group):
                yp = np.pad(wavs[i], (pad_r, pad_r), mode="reflect")
                batch[row, : len(yp)] = yp
            mel = A.mel_spectrogram_prepadded(
                torch.as_tensor(batch, device=self.device)).cpu().numpy()
            for row, i in enumerate(group):
                t = A.num_mel_frames(len(wavs[i]))
                mels[i] = mel[row, :, :t].T.astype(np.float32)  # (T, 80)
        return mels  # type: ignore[return-value]

    # -- full pipeline --------------------------------------------------

    def prepare(self, input_dir: str, output_dir: str) -> int:
        import pandas as pd  # the parquet writer, needed here only

        os.makedirs(output_dir, exist_ok=True)
        samples = self.read_samples(input_dir)

        rows: List[Dict] = []
        wavs22, kept = [], []
        for s in samples:
            wav, sr = load_wav(s["wav"])
            dur = len(wav) / sr
            if dur < self.cfg.min_duration or dur > self.cfg.max_duration:
                print(f"  [WARN] skip {s['utt']}: duration {dur:.1f}s outside [0.5, 30]")
                continue
            text_token = self.text_to_tokens(s["text"])
            if not text_token:
                continue
            wav16 = resample(wav, sr, 16000)
            if self.speech_tokenizer is not None:
                speech_token = np.asarray(self.speech_tokenizer(wav16)).reshape(-1)
            else:
                speech_token = fallback_speech_tokenizer(wav16)
            if self.spk_encoder is not None:
                embedding = np.asarray(self.spk_encoder(wav16)).reshape(-1)
            else:
                # stable digest, NOT hash(): str hashing is salted per
                # process, which would give the same utterance a different
                # fallback embedding on every run
                h = hashlib.md5(s["utt"].encode()).hexdigest()
                embedding = fallback_embedding(seed=int(h[:8], 16))
            wavs22.append(resample(wav, sr, self.cfg.target_sr))
            kept.append((s, text_token, speech_token, embedding))

        if not kept:
            print("no valid samples")
            return 0

        mels = self._batched_mels(wavs22)
        for (s, text_token, speech_token, embedding), mel in zip(kept, mels):
            rows.append({
                "utt": s["utt"],
                "text": s["text"],
                "text_token": list(map(int, text_token)),
                "speech_token": speech_token.astype(np.int64).tolist(),
                "speech_feat": mel.reshape(-1).tolist(),
                "speech_feat_shape": [int(mel.shape[0]), int(mel.shape[1])],
                "utt_embedding": embedding.astype(np.float32).tolist(),
            })

        shard_paths = []
        for i in range(0, len(rows), self.cfg.samples_per_shard):
            shard = rows[i : i + self.cfg.samples_per_shard]
            path = os.path.join(output_dir, f"data_{i // self.cfg.samples_per_shard:06d}.parquet")
            pd.DataFrame(shard).to_parquet(path)
            shard_paths.append(path)
        with open(os.path.join(output_dir, "data.list"), "w", encoding="utf-8") as f:
            for p in shard_paths:
                f.write(p + "\n")
        print(f"wrote {len(rows)} samples -> {len(shard_paths)} parquet shards in {output_dir}")
        return len(rows)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The root ``prepare_joint_data.py``'s flags, and ``--device``.  An
    extractor file that fails to load raises (the JAX CLI warns and falls
    back to random tokens or embeddings)."""
    ap = argparse.ArgumentParser(description="prepare (wav, txt) -> parquet")
    ap.add_argument("--input", default="raw_audio")
    ap.add_argument("--output", default="data")
    ap.add_argument("--speech-tokenizer-onnx", default=None,
                    help="speech_tokenizer_v1.onnx from the pretrained model dir")
    ap.add_argument("--campplus-onnx", default=None,
                    help="campplus.onnx from the pretrained model dir")
    ap.add_argument("--samples-per-shard", type=int, default=100)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    speech_tok = (OnnxSpeechTokenizer(args.speech_tokenizer_onnx, device)
                  if args.speech_tokenizer_onnx else None)
    spk_enc = OnnxCampplus(args.campplus_onnx, device) if args.campplus_onnx else None
    prep = JointDataPreparer(PrepareConfig(samples_per_shard=args.samples_per_shard),
                             speech_tokenizer=speech_tok, spk_encoder=spk_enc, device=device)
    n = prep.prepare(args.input, args.output)
    print(f"prepared {n} samples")
    return n


if __name__ == "__main__":
    main()
