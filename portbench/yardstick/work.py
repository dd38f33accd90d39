"""The work behind what a run delivered, in the cost model's flops: a
streamed chunk of the engine, a token2wav call.  The stream geometry is
the configuration's own (the reference's hop, overlap and lookahead), so
a chunk's window follows from the request's token count and the chunk's
index alone."""

from __future__ import annotations

from typing import List, Tuple

from . import costs as C

# the 300M stream: windows of hop + overlap tokens advancing by the hop
OVERLAP_300M = 20
MEL_HOP = 256
# CosyVoice2: 25-token hops with the flow's pre-lookahead, cumulative windows
HOP_CV2 = 25
NFE_CV2 = 10


def mel_frames_300m(n_tokens: int, frame_rate: int, sample_rate: int) -> int:
    return int(n_tokens / frame_rate * sample_rate / MEL_HOP)


def nfe_300m(icfg, mel_len: int) -> int:
    if mel_len > icfg.nfe_long_threshold:
        return icfg.nfe_long
    if mel_len > icfg.nfe_mid_threshold:
        return icfg.nfe_mid
    return icfg.nfe_short


def windows_300m(n_tokens: int, frame_rate: int) -> List[Tuple[int, int]]:
    """(start, end) tokens of each streamed window of a prompt-free stream
    of ``n_tokens`` tokens (the engine's hop from the first window on)."""
    hop, out, pos = 2 * frame_rate, [], 0
    while n_tokens - pos >= hop + OVERLAP_300M:
        out.append((pos, pos + hop + OVERLAP_300M))
        pos += hop
    out.append((pos, n_tokens))
    return out


def windows_cv2(n_tokens: int, lookahead: int) -> List[Tuple[int, int]]:
    """(emitted from, tokens the flow runs over) of each CosyVoice2 window."""
    out, off = [], 0
    while n_tokens >= off + HOP_CV2 + lookahead:
        out.append((off, off + HOP_CV2 + lookahead))
        off += HOP_CV2
    out.append((off, n_tokens))
    return out


def chunk_flops_300m(model, icfg, n_ids: int, n_tokens: int, k: int,
                     final: bool) -> float:
    """Flops of chunk ``k`` of a 300M engine request of ``n_ids`` text ids
    (``n_tokens`` tokens once it is done): its window's flow and HiFT and
    the decode steps of the tokens it is the first to cover.  A chunk that
    is not the request's last has the geometry of a window that is not."""
    fr = model.flow.input_frame_rate
    if final:
        start, end = windows_300m(n_tokens, fr)[k]
    else:
        start, end = k * 2 * fr, k * 2 * fr + 2 * fr + OVERLAP_300M
    prev_end = 0 if k == 0 else start + OVERLAP_300M
    mel = mel_frames_300m(end - start, fr, model.sample_rate)
    f = C.flow_window_flops(model.flow, end - start, mel, nfe_300m(icfg, mel))
    f += C.hift_flops(model.hift, mel)
    L0 = n_ids + 3
    f += sum(C.llm_decode_step_flops(model.llm, L0 + i) for i in range(prev_end, end))
    return f


def chunk_flops_cv2(llm, flow, hift, n_ids: int, n_tokens: int, k: int,
                    final: bool) -> float:
    """Flops of chunk ``k`` of a CosyVoice2 engine request: the flow over
    every token so far (the window's lookahead included), HiFT over the
    frames it emits, and the decode steps of its new tokens."""
    la = flow.pre_lookahead_len
    if final:
        off, upto = windows_cv2(n_tokens, la)[k]
    else:
        off, upto = k * HOP_CV2, k * HOP_CV2 + HOP_CV2 + la
    prev = 0 if k == 0 else off + la
    f = C.flow2_window_flops(flow, upto, NFE_CV2)
    f += C.hift_flops(hift, (upto - off) * flow.token_mel_ratio)
    L0 = n_ids + 2
    f += sum(C.qwen2_decode_step_flops(llm, L0 + i) for i in range(prev, upto))
    return f


def token2wav_flops(model, icfg, n_tokens: int) -> Tuple[float, int, int]:
    """(flops, mel frames, NFE) of one prompt-free 300M token2wav call."""
    fr = model.flow.input_frame_rate
    mel = mel_frames_300m(n_tokens, fr, model.sample_rate)
    nfe = nfe_300m(icfg, mel)
    f = C.flow_window_flops(model.flow, n_tokens, mel, nfe) + C.hift_flops(model.hift, mel)
    return f, mel, nfe
