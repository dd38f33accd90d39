"""Composable streaming data pipeline — the vendored trainer's data path
(the port of the JAX package's ``data/processor.py``, stage by stage).

Reference behavior: cosyvoice/dataset/{dataset,processor}.py — a chain of
generator stages over utterance dicts, sharded per host, with shuffle/sort
buffers and static/dynamic batching.  Used by the generic FullTrainer path;
the LoRA fine-tune path uses data.dataset.DataLoader.

Each stage is ``stage(iterable, **kw) -> iterable``; compose with
``build_pipeline(source, [(stage, kwargs), ...])``.  ``compute_fbank`` runs
the mel frontend on a device (CUDA unless the caller passes another);
``compute_f0_stage`` runs the native pitch tracker (``ops/f0.py``).
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, Iterator, List

import numpy as np
import torch

from ..ops import audio as A
from ..params import resolve_device
from .prepare import resample as _resample
from .dataset import MEL_PADDING_VALUE


def shard_list(items: List, num_shards: int = 1, shard_index: int = 0,
               num_workers: int = 1, worker_index: int = 0) -> List:
    """Rank/worker sharding (reference: dataset.py:51-104 DistributedSampler)."""
    items = items[shard_index::num_shards]
    return items[worker_index::num_workers]


def parquet_opener(sources: Iterable[str]) -> Iterator[Dict]:
    """Parquet shards -> utterance dicts (processor.py parquet_opener)."""
    import pandas as pd

    for path in sources:
        df = pd.read_parquet(path)
        for row in df.to_dict("records"):
            yield row


def tokenize(data: Iterable[Dict], tokenizer=None) -> Iterator[Dict]:
    for s in data:
        if "text_token" not in s and "text" in s and tokenizer is not None:
            s["text_token"] = tokenizer.encode(s["text"])
        yield s


def filter_stage(
    data: Iterable[Dict],
    max_length: int = 40960,
    min_length: int = 0,
    token_max_length: int = 200,
    token_min_length: int = 1,
) -> Iterator[Dict]:
    """Length filters in 10ms frames / token counts (processor.py filter)."""
    for s in data:
        if "speech" in s:
            frames = len(s["speech"]) / s.get("sample_rate", 22050) * 100
            if not (min_length <= frames <= max_length):
                continue
        tt = s.get("text_token")
        if tt is not None and not (token_min_length <= len(tt) <= token_max_length):
            continue
        # DPO samples must carry a non-empty rejected continuation
        # (processor.py:101-102)
        if "reject_speech_token" in s and len(s["reject_speech_token"]) == 0:
            continue
        yield s


def resample_stage(data: Iterable[Dict], resample_rate: int = 22050,
                   min_sample_rate: int = 16000) -> Iterator[Dict]:
    """Resample + peak normalization (processor.py resample)."""
    for s in data:
        sr = s.get("sample_rate", resample_rate)
        wav = np.asarray(s["speech"], np.float32)
        if sr != resample_rate:
            if sr < min_sample_rate:
                continue
            wav = _resample(wav, sr, resample_rate)
        peak = np.abs(wav).max()
        if peak > 0.95:  # reference scales only when max > 1 after resample; be safe
            wav = wav / peak * 0.95
        s["speech"] = wav
        s["sample_rate"] = resample_rate
        yield s


def truncate_stage(data: Iterable[Dict], truncate_length: int = 24576) -> Iterator[Dict]:
    """Random fixed-length crop for GAN training (processor.py truncate)."""
    for s in data:
        wav = s["speech"]
        if len(wav) > truncate_length:
            start = random.randint(0, len(wav) - truncate_length)
            wav = wav[start : start + truncate_length]
        else:
            wav = np.pad(wav, (0, truncate_length - len(wav)))
        s["speech"] = wav
        yield s


def compute_fbank(data: Iterable[Dict], length_bucket: int = 16384,
                  device=None) -> Iterator[Dict]:
    """Mel features (processor.py compute_fbank) on ``device``.

    The waveform is reflect-padded on its TRUE signal (matching
    mel_spectrogram's internal pad), then zero-padded up to a
    ``length_bucket`` multiple, and the mel is sliced back to the true frame
    count: frames inside the true length are those of the unbucketed call
    (center=False STFT), so the features equal the JAX stage's."""
    dev = resolve_device(device)
    pad_r = (A.N_FFT - A.HOP_SIZE) // 2
    for s in data:
        wav = np.asarray(s["speech"], np.float32)
        n_true = A.num_mel_frames(len(wav))
        yp = np.pad(wav, (pad_r, pad_r), mode="reflect")
        yp = np.pad(yp, (0, -len(yp) % length_bucket))
        mel = A.mel_spectrogram_prepadded(torch.as_tensor(yp[None], device=dev))[0]
        s["speech_feat"] = mel.T[:n_true].cpu().numpy().astype(np.float32)  # (T, 80)
        yield s


def compute_f0_stage(data: Iterable[Dict]) -> Iterator[Dict]:
    """Pitch targets (processor.py compute_f0; pyworld replaced by the
    autocorrelation tracker of ``ops/f0.py``, its native kernel), gaps
    filled linearly, edge-padded or cut to the mel length."""
    from ..ops.f0 import extract_f0, interpolate_f0

    for s in data:
        f0 = interpolate_f0(extract_f0(s["speech"], s.get("sample_rate", 22050)))
        n = s["speech_feat"].shape[0] if "speech_feat" in s else len(f0)
        if len(f0) < n:
            f0 = np.pad(f0, (0, n - len(f0)), mode="edge")
        s["pitch_feat"] = f0[:n]
        yield s


def parse_embedding(data: Iterable[Dict], normalize: bool = True) -> Iterator[Dict]:
    """Normalize utt/spk embeddings, keeping BOTH so padding() can select
    per use_spk_embedding (reference processor.py:213-227, 430-433)."""
    for s in data:
        first = None
        for key in ("utt_embedding", "spk_embedding", "embedding"):
            if key in s and s[key] is not None:
                e = np.asarray(s[key], np.float32).reshape(-1)
                if normalize:
                    e = e / max(np.linalg.norm(e), 1e-12)
                s[key] = e
                first = e if first is None else first
        if first is not None:
            s["embedding"] = s.get("embedding", first)
        yield s


def shuffle_stage(data: Iterable[Dict], shuffle_size: int = 10000) -> Iterator[Dict]:
    """Buffered shuffle (processor.py shuffle)."""
    buf: List[Dict] = []
    for s in data:
        buf.append(s)
        if len(buf) >= shuffle_size:
            random.shuffle(buf)
            yield from buf
            buf = []
    random.shuffle(buf)
    yield from buf


def sort_stage(data: Iterable[Dict], sort_size: int = 500) -> Iterator[Dict]:
    """Buffered sort by feature length for padding efficiency (processor.py sort)."""
    buf: List[Dict] = []

    def key(s):
        if "speech_feat" in s:
            return s["speech_feat"].shape[0]
        return len(s.get("speech", ()))

    for s in data:
        buf.append(s)
        if len(buf) >= sort_size:
            buf.sort(key=key)
            yield from buf
            buf = []
    buf.sort(key=key)
    yield from buf


def static_batch(data: Iterable[Dict], batch_size: int = 16) -> Iterator[List[Dict]]:
    buf: List[Dict] = []
    for s in data:
        buf.append(s)
        if len(buf) >= batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def dynamic_batch(data: Iterable[Dict], max_frames_in_batch: int = 12000) -> Iterator[List[Dict]]:
    """Frame-budget batching (processor.py dynamic_batch)."""
    buf: List[Dict] = []
    longest = 0
    for s in data:
        frames = s["speech_feat"].shape[0] if "speech_feat" in s else len(s["speech"]) // 256
        longest = max(longest, frames)
        if longest * (len(buf) + 1) > max_frames_in_batch and buf:
            yield buf
            buf = [s]
            longest = frames
        else:
            buf.append(s)
    if buf:
        yield buf


def padding(batches: Iterable[List[Dict]], use_spk_embedding: bool = False) -> Iterator[Dict]:
    """Sort-desc + pad to batch max (processor.py padding).  The LoRA path
    uses static shapes instead (data.dataset.collate_static)."""
    for batch in batches:
        batch = sorted(batch, key=lambda s: s["speech_feat"].shape[0]
                       if "speech_feat" in s else 0, reverse=True)
        B = len(batch)
        out: Dict[str, np.ndarray] = {}
        if "speech_feat" in batch[0]:
            lens = [s["speech_feat"].shape[0] for s in batch]
            T = max(lens)
            feat = np.full((B, T, batch[0]["speech_feat"].shape[1]),
                           MEL_PADDING_VALUE, np.float32)
            for i, s in enumerate(batch):
                feat[i, : lens[i]] = s["speech_feat"]
            out["speech_feat"] = feat
            out["speech_feat_len"] = np.asarray(lens, np.int32)
        if "pitch_feat" in batch[0]:
            # pitch may run without compute_fbank (compute_f0_stage supports
            # it); fall back to the batch's own f0 lengths then
            T = (out["speech_feat"].shape[1] if "speech_feat" in out
                 else max(len(s["pitch_feat"]) for s in batch))
            pf = np.zeros((B, T), np.float32)
            for i, s in enumerate(batch):
                pf[i, : len(s["pitch_feat"][:T])] = s["pitch_feat"][:T]
            out["pitch_feat"] = pf
        if "speech" in batch[0]:
            n = max(len(s["speech"]) for s in batch)
            sp = np.zeros((B, n), np.float32)
            for i, s in enumerate(batch):
                sp[i, : len(s["speech"])] = s["speech"]
            out["speech"] = sp
        # reject_speech_token rides along when the DPO dataset provides it
        # (processor.py:422-429)
        for key, dtype, pad in (("speech_token", np.int32, 0), ("text_token", np.int32, 0),
                                ("reject_speech_token", np.int32, 0)):
            if batch[0].get(key) is not None:
                lens = [len(s[key]) for s in batch]
                arr = np.full((B, max(lens)), pad, dtype)
                for i, s in enumerate(batch):
                    arr[i, : lens[i]] = np.asarray(s[key], dtype)
                out[key] = arr
                out[key + "_len"] = np.asarray(lens, np.int32)
        # spk- vs utt-embedding selection (reference processor.py:430-433):
        # use_spk_embedding=True conditions on the speaker-level embedding
        emb_key = "spk_embedding" if use_spk_embedding else "utt_embedding"
        if batch[0].get(emb_key) is not None:
            out["embedding"] = np.stack(
                [np.asarray(s[emb_key], np.float32).reshape(-1) for s in batch])
        elif "embedding" in batch[0]:
            out["embedding"] = np.stack([s["embedding"] for s in batch]).astype(np.float32)
        yield out


def build_pipeline(source: Iterable, stages) -> Iterable:
    """Compose stages: build_pipeline(paths, [(parquet_opener, {}), ...])."""
    it = source
    for stage, kwargs in stages:
        it = stage(it, **kwargs)
    return it
