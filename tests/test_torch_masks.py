"""The port's ``add_optional_chunk_mask``: the dynamic-chunk draws of
training, held as tests/test_masks_dynamic.py holds JAX's (torch's
generator cannot replay JAX's draws): each sampled mask is recovered into
its (chunk, num_left) and must equal the reference formula for them, and
the sampler must visit full, small and limited masks; the fixed branches
equal JAX's exactly; a conformer's training forward with dynamic chunks
draws from its ``Ctx``'s generator and refuses to run without one."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosy_tpu.ops.masks as JM
from cosy_tpu_torch.config import EncoderConfig
from cosy_tpu_torch.ctx import Ctx
from cosy_tpu_torch.layers.conformer import encoder_forward, init_encoder
from cosy_tpu_torch.ops import masks as M
from cosy_tpu_torch.params import P, Spec, spec_tensors
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

T = 64


def reference_mask(chunk: int, num_left: int) -> np.ndarray:
    """mask.py:176-211 subsequent_chunk_mask semantics in numpy."""
    pos = np.arange(T)
    end = (pos // chunk + 1) * chunk
    allowed = pos[None, :] < end[:, None]
    if num_left >= 0:
        start = np.maximum((pos // chunk - num_left) * chunk, 0)
        allowed &= pos[None, :] >= start[:, None]
    return allowed


def sample_mask(seed: int, use_left: bool) -> np.ndarray:
    out = M.add_optional_chunk_mask(T, torch.ones((1, 1, T), dtype=torch.bool), True, use_left,
                                    0, 0, -1, generator=torch.Generator().manual_seed(seed))
    return out[0].numpy()


def recover_chunk_and_left(m: np.ndarray):
    """(chunk, num_left) of a realized mask."""
    if m.all():
        return T, -1
    chunk = int(m[0].sum())  # row 0 attends [0, chunk)
    last = T - 1
    first_col = int(np.argmax(m[last]))
    num_left = -1 if first_col == 0 else last // chunk - first_col // chunk
    return chunk, num_left


def test_dynamic_chunk_masks_are_valid_reference_masks():
    saw_full = saw_small = saw_limited = False
    lefts = set()
    for i in range(120):
        m = sample_mask(i, use_left=True)
        chunk, num_left = recover_chunk_and_left(m)
        assert np.array_equal(m, reference_mask(chunk, num_left)), (i, chunk, num_left)
        if chunk == T:
            saw_full = True
            assert num_left == -1  # full-context draws keep all history
        else:
            saw_small = True
            assert 1 <= chunk <= 25
            if num_left >= 0:
                saw_limited = True
                assert num_left < max((T - 1) // chunk, 1)
                lefts.add(num_left)
    assert saw_full and saw_small and saw_limited
    assert len(lefts) >= 3  # the left limit actually varies


def test_dynamic_chunk_without_left_limit_keeps_history():
    for i in range(40):
        m = sample_mask(i, use_left=False)
        chunk, num_left = recover_chunk_and_left(m)
        assert num_left == -1, (i, chunk, num_left)
        assert np.array_equal(m, reference_mask(chunk, -1))


def test_dynamic_left_never_kills_own_chunk():
    for i in range(40):
        assert sample_mask(i, use_left=True).diagonal().all()


def test_one_draw_for_the_batch_and_full_context_switch():
    """One chunk for every row (its valid rows and keys), and without
    ``enable_full_context`` no draw is full context."""
    lens = torch.tensor([64, 40, 17])
    pad = M.make_non_pad_mask(lens, T)[:, None, :]
    for i in range(20):
        out = M.add_optional_chunk_mask(T, pad, True, True, 0, 0, -1,
                                        generator=torch.Generator().manual_seed(i))
        want = torch.from_numpy(sample_mask(i, use_left=True))
        for b, n in enumerate(lens.tolist()):
            assert torch.equal(out[b, :n, :n], want[:n, :n])
        m = M.add_optional_chunk_mask(T, torch.ones((1, 1, T), dtype=torch.bool), True, False,
                                      0, 0, -1, generator=torch.Generator().manual_seed(i),
                                      enable_full_context=False)[0].numpy()
        assert recover_chunk_and_left(m)[0] <= 25


@pytest.mark.parametrize("dyn, left, dec, static, nleft", [
    (True, False, -1, 0, -1), (True, True, 4, 0, 2), (True, False, 5, 0, -1),
    (False, False, 0, 3, -1), (False, False, 0, 4, 1), (False, False, 0, 0, -1)])
def test_fixed_branches_equal_jax(dyn, left, dec, static, nleft):
    lens = np.array([23, 9, 0])
    pad = np.arange(23)[None, :] < lens[:, None]
    want = JM.add_optional_chunk_mask(23, jnp.asarray(pad[:, None, :]), dyn, left, dec, static,
                                      nleft)
    got = M.add_optional_chunk_mask(23, torch.from_numpy(pad[:, None, :]), dyn, left, dec,
                                    static, nleft)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CFG = EncoderConfig(input_size=12, output_size=16, attention_heads=2, linear_units=24,
                    num_blocks=2, dropout_rate=0.1, positional_dropout_rate=0.1,
                    attention_dropout_rate=0.1, use_dynamic_chunk=True,
                    use_dynamic_left_chunk=True)


@pytest.fixture(scope="module")
def encoder():
    spec = Spec()
    init_encoder(spec, "", CFG, conformer=True)
    p = P(spec_tensors(spec, "cpu", torch.Generator().manual_seed(0)))
    x = torch.randn(2, 40, 12, generator=torch.Generator().manual_seed(1))
    return p, x, torch.tensor([40, 31])


def test_conformer_training_forward_draws_dynamic_chunks(encoder):
    p, x, lens = encoder
    outs = [encoder_forward(p, CFG, x, lens, Ctx(generator=torch.Generator().manual_seed(s),
                                                 train=True))[0] for s in (3, 3, 4)]
    assert all(torch.isfinite(o).all() for o in outs)
    assert torch.equal(outs[0], outs[1])  # the same generator, the same draws
    assert not torch.equal(outs[0], outs[2])
    # at eval a decoding chunk needs no generator
    y, _ = encoder_forward(p, CFG, x, lens, decoding_chunk_size=-1)
    assert torch.isfinite(y).all()


def test_conformer_dynamic_chunk_training_needs_a_generator(encoder):
    p, x, lens = encoder
    nodrop = dataclasses.replace(CFG, dropout_rate=0.0, positional_dropout_rate=0.0,
                                 attention_dropout_rate=0.0)
    with pytest.raises(ValueError, match="generator"):
        encoder_forward(p, nodrop, x, lens, Ctx(train=True))
    with pytest.raises(ValueError, match="generator"):
        M.add_optional_chunk_mask(8, torch.ones((1, 1, 8), dtype=torch.bool), True, False,
                                  0, 0, -1)
