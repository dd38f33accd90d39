"""The port's data reader (cosy_tpu_torch/data) against the JAX package's:
same-seed super-batches are equal (numpy, exact) with augmentation on and
off, with records that read as None and are refilled, per-host shards and
the ``data.list`` resolution; then the prefetch thread: order, ``close()``
unblocking a worker on a full queue, and a source exception reaching the
consumer.  Every wait has a timeout."""

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from cosy_tpu.config import TrainConfig as JTrainConfig
from cosy_tpu.data import dataset as JD
from cosy_tpu_torch.config import TrainConfig as TTrainConfig
from cosy_tpu_torch.data import dataset as TD
from cosy_tpu_torch.data.prefetch import prefetch
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

WAIT = 20.0  # seconds any wait in this file may take


def write_records(path, n, seed=0, broken=(), vocab=128, text_vocab=200):
    """``n`` synthetic records as one parquet shard: 80-bin features of
    20-70 frames, ~1/1.72 as many speech tokens, text ids and a 192-dim
    embedding; records in ``broken`` hold 81 feature values and no shape,
    which no (T, 80) reading takes (they read as None)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        T = int(rng.integers(20, 70))
        row = {"utt": f"u{seed}_{i}",
               "speech_feat": (rng.standard_normal((T, 80)) * 2 - 6).astype(np.float32)
               .reshape(-1).tolist(),
               "speech_feat_shape": [T, 80],
               "text_token": rng.integers(0, text_vocab, int(rng.integers(3, 12))).tolist(),
               "utt_embedding": rng.standard_normal(192).astype(np.float32).tolist()}
        row["speech_token"] = rng.integers(0, vocab, max(2, int(T / 1.72))).tolist()
        if i in broken:
            row["speech_feat"], row["speech_feat_shape"] = [0.5] * 81, None
        rows.append(row)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pd.DataFrame(rows).to_parquet(path)
    return path


def _batches(mod, cfg_cls, data_dir, augmentation, **loader_kw):
    tcfg = cfg_cls(batch_size=4, accumulate_grad_batches=2, max_feat_len=60, seed=3)
    ds = mod.FlowFinetuneDataset(data_dir, augmentation=augmentation, leak=tcfg.anti_leakage,
                                 seed=tcfg.seed)
    loader = mod.DataLoader(ds, tcfg, seed=tcfg.seed, **loader_kw)
    out = []
    for _ in range(2):  # two epochs: the shuffles continue from one generator
        out.extend(list(loader))
    return out, loader.steps_per_epoch()


def _assert_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("records")
    write_records(str(root / "a" / "part0.parquet"), 21, seed=1, broken=(4, 9))
    write_records(str(root / "b" / "part1.parquet"), 19, seed=2)
    return str(root)


@pytest.mark.parametrize("augmentation", [True, False], ids=["augment", "plain"])
@pytest.mark.parametrize("shard", [(1, 0), (2, 1)], ids=["one_host", "host_1_of_2"])
def test_super_batches_equal_the_jax_loaders(shards, augmentation, shard):
    """(accum, B, ...) super-batches, two epochs: every array equal, dtypes
    too.  Records 4 and 9 of the first shard read as None, so some
    super-batches are refilled by repetition."""
    n, i = shard
    kw = dict(num_shards=n, shard_index=i, prefetch_depth=2)
    want, want_steps = _batches(JD, JTrainConfig, shards, augmentation, **kw)
    got, got_steps = _batches(TD, TTrainConfig, shards, augmentation, **kw)
    _assert_equal(got, want)
    assert got_steps == want_steps
    assert got[0]["speech_feat"].shape == (2, 4, 60, 80)
    assert got[0]["text_token"].shape == (2, 4, 64)


def test_refill_of_records_that_read_as_none(tmp_path):
    """A super-batch with dropped records is refilled by repeating the
    valid ones, as in the JAX loader."""
    write_records(str(tmp_path / "p.parquet"), 8, seed=5, broken=(0, 1, 2))
    want, _ = _batches(JD, JTrainConfig, str(tmp_path), False, prefetch_depth=0)
    got, _ = _batches(TD, TTrainConfig, str(tmp_path), False, prefetch_depth=0)
    _assert_equal(got, want)
    feats = got[0]["speech_feat"].reshape(8, 60, 80)
    assert len({f.tobytes() for f in feats}) == 5  # three of eight repeat


def test_data_list_resolution(tmp_path):
    """``data.list`` lines resolve through the four candidates: the path as
    written, the data dir plus its base name, the data dir plus the path,
    and the data dir plus the path without its first component (with
    backslashes made slashes); a line that resolves nowhere is skipped."""
    d = tmp_path / "data"
    abs_path = write_records(str(tmp_path / "elsewhere" / "abs.parquet"), 3, seed=1)
    write_records(str(d / "base.parquet"), 3, seed=2)
    write_records(str(d / "rel" / "sub.parquet"), 3, seed=3)
    write_records(str(d / "strip" / "x.parquet"), 3, seed=4)
    lines = [abs_path, "/nowhere/base.parquet", "rel/sub.parquet", "gone\\strip\\x.parquet",
             "missing/none.parquet"]
    (d / "data.list").write_text("\n".join(lines) + "\n")
    want = JD.FlowFinetuneDataset._resolve_parquet_files(str(d))
    got = TD.FlowFinetuneDataset._resolve_parquet_files(str(d))
    assert got == want == [abs_path, os.path.join(str(d), "base.parquet"),
                           os.path.join(str(d), "rel/sub.parquet"),
                           os.path.join(str(d), "strip/x.parquet")]
    assert len(TD.FlowFinetuneDataset(str(d))) == 12


def test_collate_and_augment_equal_the_jax_copies():
    rng_j, rng_t = np.random.default_rng(9), np.random.default_rng(9)
    mel = np.random.default_rng(1).standard_normal((90, 80)).astype(np.float32)
    tok = np.arange(52)
    for _ in range(6):
        mj, tj = JD.augment(rng_j, mel, tok)
        mt, tt = TD.augment(rng_t, mel, tok)
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(tt, tj)
    recs = [{"speech_feat": mel, "speech_token": tok, "embedding": np.ones(192, np.float32),
             "cross_sample_mel": mel[:30], "text_token": np.arange(5)}, None]
    want = JD.collate_static(recs, 60, 40, 8)
    got = TD.collate_static(recs, 60, 40, 8)
    _assert_equal([got], [want])


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------


def _consume(it):
    with ThreadPoolExecutor(1) as ex:
        return ex.submit(list, it).result(timeout=WAIT)


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_keeps_order(depth):
    assert _consume(prefetch(iter(range(50)), depth)) == list(range(50))


def test_prefetch_reraises_a_source_exception_after_the_batches_before_it():
    def source():
        yield 1
        yield 2
        raise KeyError("bad record")

    pf = prefetch(source(), 4)
    got = []
    with pytest.raises(KeyError, match="bad record"):
        with ThreadPoolExecutor(1) as ex:
            ex.submit(lambda: [got.append(x) for x in pf]).result(timeout=WAIT)
    assert got == [1, 2]


def test_close_unblocks_a_worker_on_a_full_queue():
    produced = []
    gate = threading.Event()

    def source():
        for i in range(1000):
            produced.append(i)
            gate.set()
            yield i

    pf = prefetch(source(), 1)
    assert gate.wait(WAIT)
    assert next(pf) == 0
    deadline = time.monotonic() + WAIT
    while len(produced) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)  # the worker fills the queue and blocks on the next put
    assert pf.close(timeout=WAIT)
    assert len(produced) < 10


def test_loader_stopped_early_closes_its_prefetch_thread(shards):
    tcfg = TTrainConfig(batch_size=2, accumulate_grad_batches=1, max_feat_len=60)
    loader = TD.DataLoader(TD.FlowFinetuneDataset(shards, augmentation=False), tcfg,
                           prefetch_depth=1)
    before = threading.active_count()
    it = iter(loader)
    next(it)
    it.close()  # the consumer stops after one batch
    deadline = time.monotonic() + WAIT
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before
