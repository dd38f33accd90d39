"""Continuous-batching TTS serving engine (the port of the JAX package's
``infer/engine.py``): requests join and leave a running batched decode at
segment boundaries instead of waiting for a whole cohort to drain.

- One decode state of ``slots`` rows runs in segments of ``seg_tokens``
  loop steps: :class:`~cosy_tpu_torch.models.llm.DecodeState` behind a
  CosyVoice-300M ``TTSPipeline``, or
  :class:`~cosy_tpu_torch.models.qwen2lm.Qwen2DecodeState` behind a
  CosyVoice2 ``TTS2Pipeline`` (one engine, the family read from the
  pipeline).
- At each segment boundary a pending request is prefilled and spliced into
  a free row (``llm_admit_slot`` / ``qwen2lm_admit_slot``); its first audio
  waits one segment, not the running rows' longest utterance.
- Cache columns are slot-local, so a free row admits any request that fits
  the engine's prefix width and cap, whatever the other rows have decoded.
- A row's tokens are those of a solo decode with the request's seed: the
  admission brings the request's own generator.
- After each segment every row's ready windows are synthesized (the
  pipeline's ``stream_chunks``: CosyVoice-300M's hop + overlap windows with
  the hop from the first window on, or CosyVoice2's cumulative windows with
  the pre-lookahead and the token offset, then its final window) and put on
  the request's queue; a finished row frees at once.

- With ``prefetch`` (the JAX engine's dispatch pipelining, off by default
  as there), segment k+1 is enqueued before segment k is read, so the card
  runs it while this thread reads segment k and synthesizes its windows.
  It is taken only when no admission is waiting, used only if its target
  still holds and no row was frozen since, and dropped on an admission,
  when the last live request finishes, and on a reset (``prefetch_hits``
  counts the segments used).  The port's state is updated in place, so a
  dropped segment's steps have happened: rows are independent (slot-local
  columns, a frozen row writes only its column L0 - 1, which an admission's
  prefill overwrites) and each live row's steps are the ones it would run
  next, so they stay, and the next segment goes on from them.  Every
  request's tokens are those of its solo decode either way.

One daemon thread runs the loop and owns every slot and the decode state;
``submit`` and ``cancel`` only touch the pending list under a condition
variable.  The loop holds ``device_lock`` for each admission, each decode
segment and each window's synthesis, never across a queue put, so a
server that shares the device with direct calls interleaves them there.  A failure inside one request's synthesis fails that request; a
failure of the loop itself fails every request and the engine starts
afresh on the next submission.

Those locked sections are the engine's whole device work, and each is a
method of its own (``_admit``, ``_run``, ``_prefetch``, ``_window``,
``_reset``) whose arguments determine it.  Under a tensor-parallel server
rank 0's engine sends each section to the followers before it runs it
(``replay``, a ``parallel.replay.Leader``), and a follower's engine, which
never starts its thread, runs the same section through :meth:`apply`, so
every rank enters the same collectives in the same order.

Usage::

    eng = ContinuousBatchEngine(pipeline, slots=4)
    req = eng.submit(text_tokens, seed=0)
    for chunk in req.chunks(timeout=60):   # (1, n) float32 wav chunks
        play(chunk)
    eng.stop()
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterator, List, Optional, Union

import numpy as np
import torch

from ..models import llm as L
from ..models import qwen2lm as Q
from .pipeline import StreamCursor, TTSPipeline
from .pipeline2 import Stream2Cursor, TTS2Pipeline


class EngineRequest:
    """One in-flight synthesis request; its chunks arrive on ``q`` as
    (1, n) arrays, then None (with ``err`` set on failure)."""

    def __init__(self, text_tokens: np.ndarray, spk_embedding: Optional[np.ndarray],
                 seed: int):
        self.text_tokens = text_tokens
        self.spk_embedding = spk_embedding
        self.seed = seed
        self.q: queue.Queue = queue.Queue()
        self.err: Optional[BaseException] = None
        self.cancelled = False
        # filled at admission by the loop thread
        self.prefix: Optional[torch.Tensor] = None  # (1, L0, D), left-padded
        self.valid = 0
        self.min_len = 0
        self.cap = 0
        self.cursor = None  # its StreamCursor / Stream2Cursor: windows and carries
        self.admitted_segment: Optional[int] = None  # segments run before admission
        self.tokens: Optional[np.ndarray] = None  # the final token stream

    def chunks(self, timeout: Optional[float] = None):
        """Iterate this request's wav chunks; raises the request's error,
        or ``queue.Empty`` when none arrives within ``timeout`` seconds."""
        while (got := self.q.get(timeout=timeout)) is not None:
            yield got
        if self.err is not None:
            raise self.err


class ContinuousBatchEngine:
    """Token-level continuous batching over one persistent decode state of
    ``slots`` rows, prefixes left-padded to ``prefix_len`` and at most
    ``max_len`` tokens a request."""

    def __init__(self, pipeline: Union[TTSPipeline, TTS2Pipeline], slots: int = 4,
                 prefix_len: int = 128, max_len: int = 512, seg_tokens: Optional[int] = None,
                 device_lock: Optional[threading.Lock] = None, replay=None,
                 prefetch: bool = False):
        self.pl = pipeline
        self.replay = replay
        self.lock = device_lock if device_lock is not None else contextlib.nullcontext()
        self.is_cv2 = isinstance(pipeline, TTS2Pipeline)
        self.B = slots
        self.L0 = prefix_len
        self.max_len = max_len
        # admission granularity: one audio hop (CosyVoice2: two, its streaming
        # decode segment) by default, so the emission and admission cadences
        # coincide
        if self.is_cv2:
            self.hop = pipeline.token_hop_len
            self.seg = seg_tokens or 2 * self.hop
        else:
            self.hop = pipeline.token_min_hop_len
            self.seg = seg_tokens or self.hop
        self._slots: List[Optional[EngineRequest]] = [None] * slots
        self._windows: List[Optional[Iterator[np.ndarray]]] = [None] * slots
        self._state: Optional[Union[L.DecodeState, Q.Qwen2DecodeState]] = None
        self._pending: List[EngineRequest] = []
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self.segments_run = 0
        # rows to freeze on the device at the next segment (a request that
        # failed while its row still decodes)
        self._to_freeze: set = set()
        self._i_read: Optional[int] = None  # the step count of the last segment read
        self._prefetch_on = prefetch
        self._ahead = None  # (the prefetched Segment, its target)
        self.prefetch_hits = 0

    # -- public API -------------------------------------------------------

    def submit(self, text_tokens: np.ndarray, spk_embedding: Optional[np.ndarray] = None,
               seed: int = 0) -> EngineRequest:
        """Queue a request; its draws are those of ``pipeline.synthesize``
        with ``seed`` (row 0).  Consume its chunks with ``req.chunks()``."""
        req = EngineRequest(np.asarray(text_tokens), spk_embedding, seed)
        with self._cv:
            self._pending.append(req)
            if self._thread is None or not self._thread.is_alive():
                self._stopping = False
                self._thread = threading.Thread(target=self._loop, daemon=True)
                self._thread.start()
            self._cv.notify()
        return req

    def cancel(self, req: EngineRequest):
        """Abandon a request: a pending one is dropped at once, an admitted
        one stops at the next segment boundary and frees its row.  No-op
        for a finished request."""
        with self._cv:
            req.cancelled = True
            if req in self._pending:
                self._pending.remove(req)
                req.q.put(None)
            self._cv.notify()

    def stop(self, timeout: float = 30.0):
        """Finish the admitted and pending requests, then end the loop
        thread (waits at most ``timeout`` seconds for it)."""
        with self._cv:
            self._stopping = True
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # -- internals (loop thread) ------------------------------------------

    def _active(self) -> bool:
        return any(r is not None for r in self._slots)

    def _locked(self, name: str, args: tuple, wire: Optional[tuple] = None):
        """Run the section ``_<name>(*args)`` under the device lock; under a
        tensor-parallel server first send it (``wire``: its picklable
        arguments, default ``args``) to the followers."""
        with self.lock:
            if self.replay is not None:
                self.replay.send(("engine", name, args if wire is None else wire))
            return getattr(self, "_" + name)(*args)

    def apply(self, name: str, args: tuple):
        """A follower's run of a section rank 0 sent (never on rank 0)."""
        if name == "admit":
            text_tokens, spk_embedding, seed, slot = args
            return self._admit(EngineRequest(text_tokens, spk_embedding, seed), slot)
        return getattr(self, "_" + name)(*args)

    # -- the sections (device work) -----------------------------------------

    def _admit(self, req: EngineRequest, slot: int) -> None:
        """Build and left-pad the request's prefix to the engine's width and
        admit it into row ``slot`` (the state made at the first admission);
        a prefix that does not fit fails the request alone."""
        pl = self.pl
        spk = pl._spk(req.spk_embedding)
        if self.is_cv2:  # no speaker row on CosyVoice2's LLM side
            prefix, min_len, max_len = pl._build_prefix(req.text_tokens, None, None,
                                                        self.max_len)
        else:
            prefix, min_len, max_len = pl._build_prefix(req.text_tokens, None, None, spk,
                                                        self.max_len)
        if prefix.shape[1] > self.L0:
            req.err = ValueError(f"prefix length {prefix.shape[1]} exceeds the engine's "
                                 f"prefix width {self.L0}")
            req.q.put(None)
            return
        req.valid = prefix.shape[1]
        req.prefix = torch.nn.functional.pad(prefix, (0, 0, self.L0 - req.valid, 0))
        req.min_len, req.cap = min_len, max_len
        req.cursor = (Stream2Cursor if self.is_cv2 else StreamCursor)(spk, req.seed, 0, self.hop)
        if self._state is None:
            idle, cfg, kw = ((Q.qwen2lm_decode_idle, pl.lcfg, {}) if self.is_cv2
                             else (L.llm_decode_idle, pl.cfg.llm, dict(step_p=pl.llm_step_p)))
            self._state = idle(pl.llm_p, cfg, self.B, self.L0, self.max_len, req.prefix.dtype,
                               pl.device, **pl._sampling(), **kw)
        admit = Q.qwen2lm_admit_slot if self.is_cv2 else L.llm_admit_slot
        admit(self._state, req.prefix, req.valid, req.min_len, req.cap,
              pl._decode_generator(req.seed, 0), slot)
        req.admitted_segment = self.segments_run
        self._slots[slot] = req
        self._to_freeze.discard(slot)
        self._ahead = None  # enqueued without this row

    def _run(self, frozen: List[int], stop_at: int):
        """Enqueue one decode segment after freezing rank 0's cancelled and
        failed rows ``frozen``; returns it (rank 0 reads it)."""
        self._state.freeze(frozen)
        return self._state.launch(stop_at)

    def _prefetch(self, stop_at: int):
        """Enqueue the next segment ahead of reading the last one."""
        return self._state.launch(stop_at)

    def _window(self, slot: int, tokens: Optional[np.ndarray], done: bool):
        """The next ready window of row ``slot``'s stream, or None; a new
        segment's first call passes the row's ``tokens`` so far."""
        if tokens is not None:
            self._windows[slot] = self.pl.stream_chunks(self._slots[slot].cursor, tokens, done)
        wav = next(self._windows[slot], None)
        if wav is None:
            self._windows[slot] = None
        return wav

    def _reset(self) -> None:
        """A fresh state on the next admission (after a failed loop)."""
        self._state = None
        self._slots = [None] * self.B
        self._windows = [None] * self.B
        self._ahead, self._i_read, self._to_freeze = None, None, set()

    # -- internals (loop thread) ------------------------------------------

    def _try_admit(self):
        """Admit pending requests into free rows, in submission order."""
        while None in self._slots:
            with self._cv:
                if not self._pending:
                    return
                req = self._pending.pop(0)
            if req.cancelled:  # cancelled after leaving the pending list
                req.q.put(None)
                continue
            b = self._slots.index(None)
            self._locked("admit", (req, b), (req.text_tokens, req.spk_embedding, req.seed, b))

    def _segment(self):
        """Run one decode segment and emit every row's ready audio."""
        st = self._state
        # a cancelled row is frozen by the one segment that then frees it
        frozen = sorted(self._to_freeze | {b for b, r in enumerate(self._slots)
                                           if r is not None and r.cancelled})
        self._to_freeze = set()
        ahead, self._ahead = self._ahead, None
        if ahead is not None and ahead[1] == self._i_read + self.seg and not frozen:
            seg, target = ahead
            self.prefetch_hits += 1
        else:
            target = st.i + self.seg
            seg = self._locked("run", (frozen, target))
        with self._cv:
            waiting = bool(self._pending)
        if self._prefetch_on and not waiting:
            self._ahead = (self._locked("prefetch", (target + self.seg,)), target + self.seg)
        seg.wait()
        self._i_read = seg.i
        self.segments_run += 1
        for b, req in enumerate(self._slots):
            if req is None:
                continue
            done = st.done[b]
            if not req.cancelled:
                try:
                    tokens = np.asarray(st.tokens[b], np.int64)[None]
                    while (wav := self._locked("window", (b, tokens, done))) is not None:
                        tokens = None  # one window a section
                        req.q.put(wav)
                except Exception as e:  # noqa: BLE001 - fail only this request
                    req.err = e
                    if not done:  # still decoding on the device: freeze it
                        self._to_freeze.add(b)
                    done = True
            if done:
                req.tokens = np.asarray(st.tokens[b], np.int64)
                req.q.put(None)
                self._slots[b] = None
        if not self._active():
            self._ahead = None  # the last live request finished

    def _fail_all(self, e: BaseException):
        for b, req in enumerate(self._slots):
            if req is not None:
                req.err = e
                req.q.put(None)
        with self._cv:
            for req in self._pending:
                req.err = e
                req.q.put(None)
            self._pending.clear()
        self._locked("reset", ())

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._active() and not self._stopping:
                    self._cv.wait()
                if self._stopping and not self._active() and not self._pending:
                    return
            try:
                with torch.inference_mode():
                    self._try_admit()
                    if self._active():
                        self._segment()
            except Exception as e:  # noqa: BLE001 - the engine must survive
                self._fail_all(e)
