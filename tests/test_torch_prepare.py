"""The port's data preparation on the CPU against the JAX package:
``JointDataPreparer.prepare`` on seeded (wav, txt) pairs gives the JAX
preparer's parquet rows (ids exact, mels and embeddings at 2e-4), the
processor stages give JAX's records, and ``python -m
cosy_tpu_torch.data.prepare --device cpu`` with replica extractor graphs
writes shards that the port's ``FlowFinetuneDataset`` and ``DataLoader``
read."""

import os
import random
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from scipy.io import wavfile

from cosy_tpu.data import prepare as JPR
from cosy_tpu.data import processor as JPS
from cosy_tpu_torch.compat import replicas as TR
from cosy_tpu_torch.config import TrainConfig
from cosy_tpu_torch.data import dataset as TD
from cosy_tpu_torch.data import prepare as TPR
from cosy_tpu_torch.data import processor as TPS
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-4, rtol=2e-4)
TEXTS = ["The 21st meeting starts at 9:30.", "今天是2024年5月1日。", "Hello there, world!",
         "pi is 3.14159", "", "costs $5.50 today"]


def _write_clips(d, n=6, seed=0):
    """``n`` seeded clips (0.6-1.7 s; 16, 22.05 and 24 kHz; int16) with
    their texts; the fifth text is empty (skipped by the preparer)."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        sr = (16000, 22050, 24000)[i % 3]
        t = np.arange(int(sr * (0.6 + 0.22 * i))) / sr
        wav = 0.3 * np.sin(2 * np.pi * (120 + 40 * i) * t) + 0.05 * rng.standard_normal(t.size)
        wavfile.write(os.path.join(d, f"utt{i}.wav"), sr, (wav * 32767).astype(np.int16))
        with open(os.path.join(d, f"utt{i}.txt"), "w", encoding="utf-8") as f:
            f.write(TEXTS[i % len(TEXTS)])
    return d


def _rows(out_dir):
    return pd.concat([pd.read_parquet(os.path.join(out_dir, f))
                      for f in sorted(os.listdir(out_dir)) if f.endswith(".parquet")])


def test_prepare_rows_equal_jax(tmp_path):
    src = _write_clips(str(tmp_path / "raw"))
    cfg = dict(samples_per_shard=2, mel_batch=3)
    n_t = TPR.JointDataPreparer(TPR.PrepareConfig(**cfg), device="cpu").prepare(
        src, str(tmp_path / "port"))
    n_j = JPR.JointDataPreparer(JPR.PrepareConfig(**cfg)).prepare(src, str(tmp_path / "jax"))
    assert n_t == n_j == 5
    got, want = _rows(str(tmp_path / "port")), _rows(str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert list(got.columns) == list(want.columns)
    for (_, g), (_, w) in zip(got.iterrows(), want.iterrows()):
        for key in ("utt", "text"):
            assert g[key] == w[key]
        for key in ("text_token", "speech_token", "speech_feat_shape"):
            assert list(g[key]) == list(w[key]), key
        for key in ("speech_feat", "utt_embedding"):
            np.testing.assert_allclose(np.asarray(g[key]), np.asarray(w[key]), **TOL,
                                       err_msg=key)


def _records(n=5, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sr = (22050, 16000, 24000, 8000, 22050)[i % 5]
        out.append({"utt": f"u{i}", "text": TEXTS[i % 4], "sample_rate": sr,
                    "speech": (0.5 * rng.standard_normal(int(sr * (0.3 + 0.15 * i))))
                    .astype(np.float32) * (3.0 if i == 2 else 1.0),
                    "speech_token": rng.integers(0, 100, 10 + i).tolist(),
                    "text_token": rng.integers(0, 50, 3 + i).tolist(),
                    "utt_embedding": rng.standard_normal(8).astype(np.float32),
                    "spk_embedding": rng.standard_normal(8).astype(np.float32)})
    return out


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) and np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, **TOL, err_msg=path)
    else:
        assert np.array_equal(np.asarray(got), np.asarray(want)), path


@pytest.mark.parametrize("batching", ["static", "dynamic"])
def test_processor_stages_equal_jax(batching):
    """parse_embedding, filter, resample (with a peak to scale and a rate
    below the floor), compute_fbank, the seeded shuffle, sort, batching
    and padding, each as a pipeline of the same stages in both packages."""

    def stages(P, fbank_kw):
        batch = ((P.static_batch, dict(batch_size=2)) if batching == "static"
                 else (P.dynamic_batch, dict(max_frames_in_batch=120)))
        return [(P.parse_embedding, {}), (P.filter_stage, dict(token_max_length=7)),
                (P.resample_stage, dict(resample_rate=22050)), (P.compute_fbank, fbank_kw),
                (P.shuffle_stage, dict(shuffle_size=3)), (P.sort_stage, dict(sort_size=4)),
                batch, (P.padding, dict(use_spk_embedding=batching == "static"))]

    random.seed(5)
    want = list(JPS.build_pipeline(_records(), stages(JPS, {})))
    random.seed(5)
    got = list(TPS.build_pipeline(_records(), stages(TPS, dict(device="cpu"))))
    assert len(got) == len(want) >= 2
    _same(got, want)


def test_record_stages_equal_jax(tmp_path):
    """truncate_stage under the same seed, tokenize, shard_list, the parquet
    opener over prepared shards; compute_f0_stage against JAX's (the native
    trackers of both agree within tests/test_f0.py's rule: 99% of frames
    within 3%)."""
    recs = _records()
    random.seed(3)
    want = list(JPS.truncate_stage([dict(r) for r in recs], truncate_length=6000))
    random.seed(3)
    got = list(TPS.truncate_stage([dict(r) for r in recs], truncate_length=6000))
    _same(got, want)
    tok = type("T", (), {"encode": staticmethod(lambda s: [ord(c) % 50 for c in s])})()
    plain = [{"text": r["text"]} for r in recs]
    _same(list(TPS.tokenize([dict(r) for r in plain], tok)),
          list(JPS.tokenize([dict(r) for r in plain], tok)))
    assert TPS.shard_list(list(range(20)), 3, 1, 2, 1) == JPS.shard_list(list(range(20)), 3, 1, 2, 1)
    out = str(tmp_path / "shards")
    TPR.JointDataPreparer(TPR.PrepareConfig(samples_per_shard=3), device="cpu").prepare(
        _write_clips(str(tmp_path / "raw"), n=4), out)
    paths = sorted(os.path.join(out, f) for f in os.listdir(out) if f.endswith(".parquet"))
    _same(list(TPS.parquet_opener(paths)), list(JPS.parquet_opener(paths)))
    got = list(TPS.compute_f0_stage([dict(r) for r in recs]))
    want = list(JPS.compute_f0_stage([dict(r) for r in recs]))
    assert len(got) == len(want) == len(recs)
    for g, w in zip(got, want):
        assert g["pitch_feat"].shape == w["pitch_feat"].shape
        close = np.isclose(g["pitch_feat"], w["pitch_feat"], rtol=0.03, atol=1e-3)
        assert close.mean() > 0.99


def test_prepare_cli_writes_shards_the_dataset_reads(tmp_path):
    """``python -m cosy_tpu_torch.data.prepare`` on 6 clips with replica
    extractor graphs (speech tokens and embeddings from the graphs, run by
    the port's executor), then one batch of the port's reader."""
    src = _write_clips(str(tmp_path / "raw"), seed=2)
    st, cp = str(tmp_path / "s3.onnx"), str(tmp_path / "campplus.onnx")
    with open(st, "wb") as f:
        f.write(TR.make_s3_replica(seed=3, d=32, n_codes=64, dv=16, max_t=512)[1])
    with open(cp, "wb") as f:
        f.write(TR.make_campplus_replica(seed=4, fcm_ch=8, ch=32, growth=16, emb=192)[1])
    out = str(tmp_path / "data")
    res = subprocess.run(
        [sys.executable, "-m", "cosy_tpu_torch.data.prepare", "--input", src, "--output", out,
         "--speech-tokenizer-onnx", st, "--campplus-onnx", cp, "--samples-per-shard", "2",
         "--device", "cpu"], cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "prepared 5 samples" in res.stdout
    assert len(open(os.path.join(out, "data.list")).read().split()) == 3
    rows = _rows(out)
    assert all(0 <= min(t) and max(t) < 64 for t in rows["speech_token"])
    assert all(len(e) == 192 for e in rows["utt_embedding"])
    ds = TD.FlowFinetuneDataset(out, augmentation=False)
    assert len(ds) == 5 and ds[0]["speech_feat"].shape[1] == 80
    tcfg = TrainConfig(batch_size=2, accumulate_grad_batches=1, max_feat_len=200)
    batch = next(iter(TD.DataLoader(ds, tcfg, prefetch_depth=0)))
    assert batch["speech_feat"].shape[:2] == (1, 2) and np.isfinite(batch["speech_feat"]).all()
