"""The port's command lines of the other training regimes on the CPU at
``--tiny``: ``python -m cosy_tpu_torch.train.full`` (every branch: llm,
flow in both styles, CosyVoice2's llm and flow, DPO, hifigan, with CV,
``--max_steps``, ``--resume`` and the parallel flags at a world of one) and
``python -m cosy_tpu_torch.train.distill`` (an export that ``infer
--meanflow`` synthesizes from), and its loader against ``train_full.py``'s
(batches equal).  One intra-op thread, one or two steps a branch."""

import os
import sys

import numpy as np
import pytest
import torch

import train_full as J
from cosy_tpu_torch.models.flow import is_distilled
from cosy_tpu_torch.params import load_torch_checkpoint, load_weight_meta
from cosy_tpu_torch.train import distill as TD
from cosy_tpu_torch.train import full as TFULL
from cosy_tpu_torch.train.checkpoint import TrainCheckpointer
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)


class _Summaries:
    """Stands in for ``torch.utils.tensorboard`` (whose import pulls in a
    whole TensorFlow where one is installed): records every scalar."""

    scalars = []

    class SummaryWriter:
        def __init__(self, logdir):
            self.logdir = logdir

        def add_scalar(self, tag, value, step):
            _Summaries.scalars.append((self.logdir, tag, value, step))

        def flush(self):
            pass

        def close(self):
            pass


@pytest.fixture(autouse=True)
def _summaries(monkeypatch):
    _Summaries.scalars = []
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", _Summaries)
    return _Summaries


def write_dataset(d, name, n=16, raw_speech=False, dpo=False, seed=0):
    """Synthetic parquet rows at the tiny widths (80 mel, 192-d embedding,
    128 speech tokens) and a data.list naming the shard."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row = {"utt": f"u{i}",
               "text_token": rng.integers(0, 40, int(rng.integers(3, 8))).tolist(),
               "speech_token": rng.integers(0, 128, int(rng.integers(6, 12))).tolist(),
               "utt_embedding": rng.standard_normal(192).astype(np.float32).tolist()}
        if dpo:
            row["reject_speech_token"] = rng.integers(0, 128, int(rng.integers(6, 12))).tolist()
        if raw_speech:
            dur = int(rng.integers(3000, 5000))
            row["speech"] = (0.3 * np.sin(2 * np.pi * 220 * np.arange(dur) / 22050)
                             ).astype(np.float32).tolist()
            row["sample_rate"] = 22050
        else:
            T = 2 * len(row["speech_token"])
            row["speech_feat"] = (rng.standard_normal((T, 80)) * 2 - 6).astype(
                np.float32).reshape(-1).tolist()
            row["speech_feat_shape"] = [T, 80]
        rows.append(row)
    os.makedirs(d, exist_ok=True)
    pq = os.path.join(d, f"{name}.parquet")
    pd.DataFrame(rows).to_parquet(pq)
    lst = os.path.join(d, f"{name}.list")
    with open(lst, "w") as f:
        f.write(pq + "\n")
    return lst


def base(model, train, mdir, *extra):
    return ["--model", model, "--train_data", train, "--model_dir", mdir, "--tiny",
            "--device", "cpu", "--batch_size", "4", "--log_every", "1", "--shuffle_size", "4",
            "--sort_size", "4", "--seed", "3", *extra]


def test_loader_equals_train_full(tmp_path):
    """build_loader + stack_accum give train_full.py's super-batches (no
    shuffle or sort randomness: buffers of 1)."""
    train = write_dataset(str(tmp_path), "t", n=8)
    args = TFULL.parse_args(base("flow", train, str(tmp_path / "o"), "--shuffle_size", "1",
                                 "--sort_size", "1", "--accum", "2"))
    got = list(TFULL.stack_accum(TFULL.build_loader(train, args, device="cpu"), 2, 32))
    want = list(J.stack_accum(J.build_loader(train, args), 2, 32))
    assert len(got) == len(want) == 1
    assert sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)


@pytest.mark.parametrize("branch", [
    ("llm",), ("flow",), ("flow", "--flow_style", "finetune"), ("llm", "--cosyvoice2"),
    ("flow", "--cosyvoice2", "--cv2_streaming"), ("llm", "--dpo")])
def test_full_cli_branch_trains_saves_and_resumes(tmp_path, branch):
    """Two steps (batch 4 x accum 2) with CV, then --resume for one more:
    the step counter continues, the .pt export and the step checkpoints
    exist, losses are finite."""
    dpo = "--dpo" in branch
    train = write_dataset(str(tmp_path), "train", dpo=dpo)
    cv = write_dataset(str(tmp_path), "cv", n=4, dpo=dpo, seed=1)
    mdir = str(tmp_path / "out")
    args = base(branch[0], train, mdir, "--cv_data", cv, "--accum", "2", *branch[1:])
    assert TFULL.main(args + ["--max_steps", "2"]) == 0
    ck = TrainCheckpointer(os.path.join(mdir, "ckpt"))
    assert ck.latest_step() == 2
    export = load_torch_checkpoint(os.path.join(mdir, f"{branch[0]}_epoch0.pt"))
    assert all(torch.isfinite(v).all() for v in export.values())
    assert TFULL.main(args + ["--max_steps", "1", "--resume"]) == 0
    assert TrainCheckpointer(os.path.join(mdir, "ckpt")).latest_step() == 3
    tags = {(tag, step) for d, tag, _, step in _Summaries.scalars if d == os.path.join(mdir, "tb")}
    assert {("train/loss", 1), ("train/loss", 2), ("train/loss", 3)} <= tags
    assert any(tag == "cv/loss" for tag, _ in tags)


def test_full_cli_hifigan_branch(tmp_path):
    """Raw-speech rows through resample, crop, mel and the native pitch
    tracker, one GAN turn of the tiny vocoder against the full-width
    discriminators on 2048-sample crops, a generator export."""
    train = write_dataset(str(tmp_path), "train", n=2, raw_speech=True)
    mdir = str(tmp_path / "out")
    assert TFULL.main(base("hifigan", train, mdir, "--max_steps", "1", "--gan_truncate",
                           "2048", "--batch_size", "2")) == 0
    gen = load_torch_checkpoint(os.path.join(mdir, "hift_epoch0.pt"))
    assert all(torch.isfinite(v).all() for v in gen.values())
    assert TrainCheckpointer(os.path.join(mdir, "ckpt")).latest_step() == 1


@pytest.mark.parametrize("flag", [["--tensor_parallel"], ["--sequence_parallel"],
                                  ["--pp_microbatches", "2"]])
def test_full_cli_refuses_parallelism(tmp_path, flag):
    """The parallel flags, once refused naming ROADMAP A15, run: at a world
    of one every axis is 1, so a step is the plain one; under torchrun
    they split over the mesh (tests/test_torch_parallel.py)."""
    train = write_dataset(str(tmp_path), "train", n=4)
    mdir = str(tmp_path / "out")
    assert TFULL.main(base("llm", train, mdir, "--max_steps", "1", *flag)) == 0
    assert TrainCheckpointer(os.path.join(mdir, "ckpt")).latest_step() == 1


def test_distill_cli_export_serves_meanflow(tmp_path, capsys):
    """Two distillation steps on prepared-style parquet at --tiny, the
    export (distilled, with its sidecar) loaded strictly by ``infer
    --meanflow`` and refused without it."""
    from cosy_tpu_torch.infer.__main__ import main as infer_main

    data = str(tmp_path / "data")
    write_dataset(data, "part0", n=8)
    out = str(tmp_path / "flow_distilled.pt")
    with pytest.raises(SystemExit, match="not found"):
        TD.main(["--data-dir", data, "--tiny", "--device", "cpu", "--flow",
                 str(tmp_path / "none.pt")])
    distiller, state = TD.main(["--data-dir", data, "--tiny", "--device", "cpu", "--steps", "2",
                                "--batch-size", "4", "--out", out, "--max-feat-len", "32",
                                "--log-every", "1", "--pretrained", str(tmp_path / "none")])
    assert state.step == 2
    flow = load_torch_checkpoint(out)
    assert is_distilled(flow)
    assert load_weight_meta(out)["sampler"] == "meanflow"
    wav = str(tmp_path / "o.wav")
    common = ["--text", "hi", "--tiny", "--device", "cpu", "--flow", out, "--pretrained",
              str(tmp_path / "none"), "--output", wav]
    infer_main(common + ["--meanflow", "--meanflow-steps", "1"])
    assert os.path.getsize(wav) > 44
    with pytest.raises(SystemExit, match="MeanFlow-distilled"):
        infer_main(common)
