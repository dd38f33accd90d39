"""Host-side data pipeline: parquet -> static-shape numpy batches (the
port's copy of the JAX package's ``data/dataset.py``, which imports no JAX;
the port imports nothing of that package, so it keeps this copy).

Reference behavior: dataset.py (FlowFinetuneDataset, MelAugmentation,
collate_fn).  Differences from the reference, kept from the JAX package so
that same-seed batches are equal to its batches:

- batches are padded to STATIC maxima (max_feat_len and the derived token /
  text budgets), instead of the reference's pad-to-batch-max
  (dataset.py:521-522);
- augmentation and collation are pure numpy with explicit
  ``np.random.Generator``s, in the JAX package's draw order;
- the loader yields (accum, batch, ...) super-batches for the trainer's
  gradient accumulation, and shards per host (replacing torch
  DistributedSampler, cosyvoice/dataset/dataset.py:51-104).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..config import AntiLeakageConfig, TrainConfig

MEL_PADDING_VALUE = -11.5  # reference: dataset.py:526
N_MELS = 80


# ---------------------------------------------------------------------------
# Augmentation (reference: dataset.py:28-160)
# ---------------------------------------------------------------------------


@dataclass
class AugmentConfig:
    enable: bool = True
    time_mask_prob: float = 0.5
    time_mask_max_ratio: float = 0.1
    num_time_masks: int = 2
    freq_mask_prob: float = 0.5
    freq_mask_max_bins: int = 8
    num_freq_masks: int = 2
    volume_prob: float = 0.5
    volume_range: tuple = (-0.2, 0.2)
    time_stretch_prob: float = 0.3
    time_stretch_range: tuple = (0.95, 1.05)
    noise_prob: float = 0.3
    noise_std: float = 0.02


def _interp_linear_np(mel: np.ndarray, new_T: int) -> np.ndarray:
    """(T, C) -> (new_T, C), torch F.interpolate(align_corners=False) parity."""
    T = mel.shape[0]
    pos = (np.arange(new_T) + 0.5) * (T / new_T) - 0.5
    pos = np.clip(pos, 0, T - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, T - 1)
    w = (pos - lo)[:, None]
    return mel[lo] * (1 - w) + mel[hi] * w


def augment(
    rng: np.random.Generator,
    mel: np.ndarray,  # (T, 80)
    speech_token: np.ndarray,  # (T',)
    cfg: AugmentConfig = AugmentConfig(),
):
    """SpecAugment-style mel augmentation with token-synchronized stretch."""
    if not cfg.enable:
        return mel, speech_token
    mel = mel.copy()
    T = mel.shape[0]

    if rng.random() < cfg.time_mask_prob:
        for _ in range(cfg.num_time_masks):
            t = int(T * cfg.time_mask_max_ratio * rng.random())
            if t > 0:
                # randint-style inclusive upper bound: t0 may equal T - t
                t0 = rng.integers(0, max(0, T - t) + 1)
                mel[t0 : t0 + t, :] = mel.mean()

    if rng.random() < cfg.freq_mask_prob:
        for _ in range(cfg.num_freq_masks):
            f = int(rng.integers(1, cfg.freq_mask_max_bins + 1))
            f0 = int(rng.integers(0, max(0, mel.shape[1] - f) + 1))
            mel[:, f0 : f0 + f] = mel.mean()

    if rng.random() < cfg.volume_prob:
        mel = mel + rng.uniform(*cfg.volume_range)

    if rng.random() < cfg.time_stretch_prob and speech_token is not None:
        factor = rng.uniform(*cfg.time_stretch_range)
        new_T = int(T * factor)
        if 10 <= new_T <= T * 2:
            mel = _interp_linear_np(mel, new_T)
            tl = speech_token.shape[0]
            new_tl = int(tl * factor)
            if new_tl > 0:
                idx = np.clip(np.linspace(0, tl - 1, new_tl).astype(np.int64), 0, tl - 1)
                speech_token = speech_token[idx]

    if rng.random() < cfg.noise_prob:
        mel = mel + rng.standard_normal(mel.shape).astype(np.float32) * cfg.noise_std

    return mel.astype(np.float32), speech_token


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


def _to_2d_feat(x, shape_hint=None) -> Optional[np.ndarray]:
    """Coerce stored mel to (T, 80) (reference: dataset.py:353-391)."""
    a = np.asarray(x, dtype=np.float32)
    if a.ndim == 1:
        if shape_hint is not None and len(shape_hint) == 2:
            a = a.reshape(int(shape_hint[0]), int(shape_hint[1]))
        elif a.size % N_MELS == 0:
            a = a.reshape(-1, N_MELS)
        else:
            return None
    if a.ndim != 2:
        return None
    if a.shape[-1] != N_MELS and a.shape[0] == N_MELS:
        a = a.T
    return a


class FlowFinetuneDataset:
    """Map-style parquet dataset (reference: dataset.py:168-482)."""

    def __init__(self, data_dir: str, augmentation: bool = True,
                 leak: AntiLeakageConfig = AntiLeakageConfig(),
                 seed: int = 0):
        import pandas as pd

        self.data_dir = data_dir
        self.aug_cfg = AugmentConfig(enable=augmentation)
        self.leak = leak
        self.rng = np.random.default_rng(seed)

        files = self._resolve_parquet_files(data_dir)
        self.samples: List[dict] = []
        for pf in files:
            try:
                df = pd.read_parquet(pf)
                self.samples.extend(df.to_dict("records"))
            except Exception as e:  # noqa: BLE001
                print(f"Failed to read {pf}: {e}")
        print(f"Dataset loaded: {len(self.samples)} samples from {len(files)} parquet files")

    @staticmethod
    def _resolve_parquet_files(data_dir: str) -> List[str]:
        """data.list multi-path resolution (reference: dataset.py:200-248)."""
        list_path = os.path.join(data_dir, "data.list")
        out = []
        if os.path.exists(list_path):
            with open(list_path, encoding="utf-8") as f:
                raw_paths = [ln.strip() for ln in f if ln.strip()]
            for raw in raw_paths:
                raw = raw.replace("\\", "/")
                parts = raw.split("/")
                candidates = [
                    raw,
                    os.path.join(data_dir, os.path.basename(raw)),
                    os.path.join(data_dir, raw),
                ]
                if len(parts) > 1:
                    candidates.append(os.path.join(data_dir, "/".join(parts[1:])))
                for c in candidates:
                    if os.path.exists(c):
                        out.append(c)
                        break
                else:
                    print(f"Warning: could not find parquet file for: {raw}")
        else:
            for root, _, files in os.walk(data_dir):
                out.extend(os.path.join(root, f) for f in files if f.endswith(".parquet"))
            out = sorted(out)
        return out

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Optional[dict]:
        s = self.samples[idx]
        feat = _to_2d_feat(s.get("speech_feat"), s.get("speech_feat_shape"))
        if feat is None or "speech_token" not in s:
            return None
        token = np.asarray(s["speech_token"], dtype=np.int64).reshape(-1)

        emb = None
        for key in ("utt_embedding", "spk_embedding", "embedding"):
            if s.get(key) is not None:
                emb = np.asarray(s[key], dtype=np.float32).reshape(-1)
                break
        if emb is None:
            emb = self.rng.standard_normal(192).astype(np.float32)

        feat, token = augment(self.rng, feat, token, self.aug_cfg)

        cross = None
        if self.leak.cross_sample_enabled and self.rng.random() < self.leak.cross_sample_prob:
            cross = self._random_prompt_mel(idx)

        text = None
        if s.get("text_token") is not None:
            text = np.asarray(s["text_token"], dtype=np.int64).reshape(-1)

        return {
            "speech_token": token,
            "speech_feat": feat,
            "embedding": emb,
            "cross_sample_mel": cross,
            "text_token": text,
        }

    def _random_prompt_mel(self, exclude_idx: int, max_len: int = 100) -> Optional[np.ndarray]:
        if len(self.samples) < 2:
            return None
        ridx = exclude_idx
        for _ in range(10):
            ridx = int(self.rng.integers(0, len(self.samples)))
            if ridx != exclude_idx:
                break
        if ridx == exclude_idx:
            return None
        s = self.samples[ridx]
        feat = _to_2d_feat(s.get("speech_feat"), s.get("speech_feat_shape"))
        if feat is None:
            return None
        return feat[:max_len]


# ---------------------------------------------------------------------------
# Static-shape collation
# ---------------------------------------------------------------------------


def collate_static(
    batch: List[dict],
    max_feat_len: int,
    max_token_len: int,
    max_text_len: int = 64,
    cross_mel_len: int = 100,
) -> Optional[Dict[str, np.ndarray]]:
    """Pad/truncate to fixed maxima (reference truncation: dataset.py:506-519;
    every step sees the same shapes)."""
    batch = [b for b in batch if b is not None]
    if not batch:
        return None
    B = len(batch)

    out = {
        "speech_token": np.zeros((B, max_token_len), np.int32),
        "speech_token_len": np.zeros((B,), np.int32),
        "speech_feat": np.full((B, max_feat_len, N_MELS), MEL_PADDING_VALUE, np.float32),
        "speech_feat_len": np.zeros((B,), np.int32),
        "embedding": np.zeros((B, 192), np.float32),
        "cross_sample_mel": np.full((B, cross_mel_len, N_MELS), MEL_PADDING_VALUE, np.float32),
        "cross_sample_mel_len": np.zeros((B,), np.int32),
        "text_token": np.zeros((B, max_text_len), np.int32),
        "text_token_len": np.zeros((B,), np.int32),
    }
    has_text = all(b.get("text_token") is not None for b in batch)

    for i, b in enumerate(batch):
        feat = b["speech_feat"]
        token = b["speech_token"]
        fl = feat.shape[0]
        if fl > max_feat_len:
            tl = token.shape[0]
            token = token[: int(tl * max_feat_len / fl)]
            if b.get("text_token") is not None:
                xl = b["text_token"].shape[0]
                b = dict(b, text_token=b["text_token"][: max(1, int(xl * max_feat_len / fl))])
            feat = feat[:max_feat_len]
            fl = max_feat_len
        token = token[:max_token_len]
        out["speech_feat"][i, :fl] = feat
        out["speech_feat_len"][i] = fl
        out["speech_token"][i, : token.shape[0]] = token
        out["speech_token_len"][i] = token.shape[0]
        out["embedding"][i] = b["embedding"][:192]
        if b.get("cross_sample_mel") is not None:
            cm = b["cross_sample_mel"][:cross_mel_len]
            out["cross_sample_mel"][i, : cm.shape[0]] = cm
            out["cross_sample_mel_len"][i] = cm.shape[0]
        if has_text:
            tt = b["text_token"][:max_text_len]
            out["text_token"][i, : tt.shape[0]] = tt
            out["text_token_len"][i] = tt.shape[0]

    if not has_text:
        out.pop("text_token")
        out.pop("text_token_len")
    return out


class DataLoader:
    """Shuffled epoch iterator yielding (accum, B, ...) super-batches.

    ``num_shards``/``shard_index`` implement per-host sharding for multi-host
    data parallelism (reference DistributedSampler semantics:
    cosyvoice/dataset/dataset.py:51-104).
    """

    def __init__(
        self,
        dataset: FlowFinetuneDataset,
        tcfg: TrainConfig,
        batch_size: Optional[int] = None,
        accum: Optional[int] = None,
        max_text_len: int = 64,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        drop_last: bool = True,
        prefetch_depth: int = 2,
    ):
        self.ds = dataset
        self.tcfg = tcfg
        self.batch_size = batch_size or tcfg.batch_size
        self.accum = accum or tcfg.accumulate_grad_batches
        self.max_text_len = max_text_len
        self.rng = np.random.default_rng(seed)
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_last = drop_last
        # background prefetch replaces the reference's DataLoader worker
        # processes (train_joint.py:290-298): batch N+1 collates on a host
        # thread while the card runs step N.  0 disables.
        self.prefetch_depth = prefetch_depth

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        it = self._iter_batches()
        if self.prefetch_depth > 0:
            from .prefetch import prefetch as _prefetch

            pf = _prefetch(it, self.prefetch_depth)
            try:
                yield from pf
            finally:
                # unblock the worker thread when the consumer stops early
                # (preemption, early-stop, exceptions)
                pf.close()
            return
        yield from it

    def _iter_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(len(self.ds))
        self.rng.shuffle(idx)
        idx = idx[self.shard_index :: self.num_shards]
        super_bs = self.batch_size * self.accum
        n = (len(idx) // super_bs) * super_bs if self.drop_last else len(idx)
        for start in range(0, n, super_bs):
            chunk = [self.ds[int(i)] for i in idx[start : start + super_bs]]
            batch = collate_static(
                chunk, self.tcfg.max_feat_len, self.tcfg.max_token_len, self.max_text_len)
            if batch is None:
                continue
            B = batch["speech_feat"].shape[0]
            if B < super_bs:  # refill dropped (None) samples by repetition
                reps = np.resize(np.arange(B), super_bs)
                batch = {k: v[reps] for k, v in batch.items()}
            yield {
                k: v.reshape(self.accum, self.batch_size, *v.shape[1:])
                for k, v in batch.items()
            }

    def steps_per_epoch(self) -> int:
        per_shard = len(self.ds) // self.num_shards
        return per_shard // (self.batch_size * self.accum)
