"""The device-resident AR decode that the TransformerLM and Qwen2LM states
share (the port of the JAX package's decode segments: one
``lax.while_loop`` a segment with RAS sampling inside it,
``cosy_tpu/models/llm.py:548-597,908`` and ``qwen2lm.py:365,756``).

Every row's tokens (B, max_len) with -1 past its count, token count,
attempts, previous token, ``done`` flag, EOS floor and cap live in device
tensors.  A step feeds each row's previous token at its own column, samples
on the device (``ops.sampling.ras_sample_batch``) and updates those
tensors, so it makes no host read.  The uniforms come from each row's own
CPU ``torch.Generator``, two a step, drawn in bulk for a segment's steps
and copied to the device once; ``torch.rand((n, 2))`` gives the numbers of
2n scalar draws in their order, so a row's tokens are those of a host loop
that draws two a step from the same generator.

A step reads the cache columns ``[0, W)``, W a host upper bound of every
live row's column: a live row's column grows by one a step and a frozen row
sits at ``L0 - 1``; the -1e10 bias makes the columns past a row's own exact
zeros of its softmax.

``launch(stop_at)`` enqueues a segment's steps and returns a
:class:`Segment`, whose ``wait`` refreshes the host view (``tokens``,
``done``, ``attempts``) from one copy of the state taken after its last
step; ``run(stop_at)`` is the two together.  JAX's loop exits on the device
once every row is done; enqueued CUDA work cannot, so ``launch`` reads
``all(done)`` back every :data:`CHUNK` steps, one chunk behind the steps it
has enqueued (a pinned copy and an event), and stops there.  A finished
decode so runs at most ``2 * CHUNK - 1`` steps in which every row is
already done; ``frozen_steps`` counts them on the device and ``host_reads``
counts the reads.  How many steps a launch enqueues depends only on its
arguments, the host's own starts, admissions and freezes, and the rows'
``done`` flags on the device, never on what the host has read, so every
rank of a tensor-parallel server enqueues the same steps.

``launch(stop_at, ahead=True)`` is the dispatch pipelining's: a segment
enqueued ahead of the previous one's read.  Enqueueing a step is the
host's work (some 300 launches at 300M), so a whole segment enqueued
before the read would hold the read back by the segment's steps (the
streamed first chunk 2.052 -> 3.044 s on an H100 when it did, PERF.md
§6).  It enqueues one chunk, which gives the card work while the host
reads, and the rest when the segment is waited for or the next one is
launched.

A module-level ``ras_sample`` replaced by a stand-in (a test's Gumbel-max
or scripted sampler) is called on the host instead, row by row with the
row's log-probs and tokens, the state read back every step.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from ..ops import sampling as S

CHUNK = 4  # steps between two reads of all(done)


class Columns(NamedTuple):
    """A step's cache columns on the device, (B,) long, and the host's bound
    of the columns it reads: every live row's column is below ``width``."""
    at: torch.Tensor
    width: int


class HostCopy:
    """A device tensor's copy to the host, enqueued now and read by
    :meth:`get`: a pinned buffer written by a non-blocking copy and an event
    on the card, a clone on the CPU."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t.clone(), None

    def get(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.host


class Segment:
    """A segment's steps and, once the last is enqueued, the state as it
    stood after it (or after a start or an admission) on its way to the
    host; :meth:`wait` enqueues what is left, then makes that copy the
    state's host view."""

    def __init__(self, state: "DeviceDecode", steps: int = 0,
                 u: Optional[torch.Tensor] = None):
        self.state, self.steps, self.u, self.j = state, steps, u, 0
        self.copy: Optional[HostCopy] = None
        self.seq = self.i = 0
        self.epochs: List[int] = []

    def wait(self) -> "DeviceDecode":
        if self.copy is None:
            self.state._enqueue(self)
        self.state._take(self)
        return self.state


class DeviceDecode:
    """B rows of an AR decode on the device (module docstring).  A
    subclass supplies :meth:`_logits`, one step's (B, V) logits of tokens
    fed at :class:`Columns`, and :meth:`_host_rule`.  Ids below ``eos`` are stored
    and fed back; an id above it (``fill_ids``: Qwen2LM's fill tokens)
    counts an attempt only.  A row stops at EOS or after ``cap`` attempts.

    Host view: ``tokens`` (each row's ids), ``done`` and ``attempts`` as of
    the last segment read; ``i`` counts the steps enqueued (the prefill's
    sample is step 0)."""

    fill_ids = False

    def __init__(self, L0: int, B: int, capacity: int, device, eos: int, sampling):
        self.L0, self.B, self.eos = L0, B, eos
        self.sampling = tuple(sampling)  # top_p, top_k, win_size, tau_r
        self.device = torch.device(device)
        max_len = capacity - L0

        def zeros(dtype=torch.long):
            return torch.zeros((B,), dtype=dtype, device=device)

        self.tok_d = torch.full((B, max_len), -1, dtype=torch.long, device=device)
        self.n_d, self.att_d, self.last_d = zeros(), zeros(), zeros()
        self.done_d = torch.ones((B,), dtype=torch.bool, device=device)
        self.min_d, self.cap_d = zeros(), zeros()
        self.frozen_d = torch.zeros((), dtype=torch.long, device=device)
        self.generators: List[Optional[torch.Generator]] = [None] * B
        self.min_lens, self.caps = [0] * B, [0] * B
        self.i = 1
        self.host_reads = 0  # device-to-host reads
        self.frozen_steps = 0  # steps in which every row was already done
        self.segments_run = 0
        self._tokens: List[List[int]] = [[] for _ in range(B)]
        self._done, self._attempts = [True] * B, [0] * B
        # what decides a launch's steps comes from the host's own acts
        # (starts, admissions, freezes), never from a read, so ranks that
        # read at different points enqueue the same steps: the rows closed
        # by the host and the step by which each other row is surely done.
        # A read only narrows the step's width: each row's attempts bound
        # (hi) and the rows known to be done
        self._closed, self._end = [True] * B, [0] * B
        self._hi, self._known_done = [0] * B, [True] * B
        self._frozen_by_host: set = set()
        # each row's admissions: a read never overwrites a later occupant
        self._epochs = [0] * B
        self._seq = self._taken = 0
        self._view: Optional[Segment] = None
        self._open: Optional[Segment] = None  # a segment with steps left to enqueue

    # -- the host view ------------------------------------------------------

    def _settle(self):
        if self._view is not None:
            self._view.wait()

    @property
    def tokens(self) -> List[List[int]]:
        self._settle()
        return self._tokens

    @property
    def done(self) -> List[bool]:
        self._settle()
        return self._done

    @property
    def attempts(self) -> List[int]:
        self._settle()
        return self._attempts

    @property
    def max_len(self) -> int:
        """The most attempts a row can make (the cache's columns past L0)."""
        return self.tok_d.shape[1]

    def _close(self, seg: Segment) -> Segment:
        """Enqueue the copy of the state after ``seg``'s last step."""
        w = min(self.max_len, max(self._hi))  # no row holds more tokens
        pack = torch.cat([self.n_d[:, None], self.att_d[:, None], self.done_d[:, None].long(),
                          self.frozen_d.expand(self.B)[:, None], self.tok_d[:, :w]], 1)
        self._seq += 1
        seg.copy, seg.seq, seg.i, seg.epochs = HostCopy(pack), self._seq, self.i, list(self._epochs)
        seg.u = None
        if self._open is seg:
            self._open = None
        return seg

    def _snapshot(self) -> Segment:
        return self._close(Segment(self))

    def _take(self, seg: Segment):
        if self._view is not None and self._view.seq <= seg.seq:
            self._view = None
        if seg.seq <= self._taken:  # never go back to an older view
            return
        h = seg.copy.get()
        self.host_reads += 1
        self._taken = seg.seq
        lag = self.i - seg.i
        for b in range(self.B):
            if seg.epochs[b] != self._epochs[b]:
                continue
            n, a, d = int(h[b, 0]), int(h[b, 1]), bool(h[b, 2])
            self._tokens[b] = h[b, 4:4 + n].tolist()
            self._attempts[b] = a
            self._done[b] = d or b in self._frozen_by_host
            self._known_done[b] = self._known_done[b] or d
            self._hi[b] = min(self._hi[b], a + lag)
        self.frozen_steps = int(h[0, 3])

    # -- rows ---------------------------------------------------------------

    def _host_rule(self) -> Optional[Callable]:
        """The host sampler replacing the device rule, or None."""
        return None

    def _logits(self, tokens: torch.Tensor, cols: Columns) -> torch.Tensor:
        raise NotImplementedError

    def _uniforms(self, steps: int, rows: Sequence[int]) -> torch.Tensor:
        """(steps, B, 2) uniforms on the device, drawn from ``rows``'
        generators (the other rows' are zero and unused)."""
        u = torch.zeros((self.B, steps, 2))
        for b in rows:
            u[b] = torch.rand((steps, 2), generator=self.generators[b])
        u = u.transpose(0, 1).contiguous()
        if self.device.type == "cuda":
            return u.pin_memory().to(self.device, non_blocking=True)
        return u.to(self.device)

    def _sample(self, logits: torch.Tensor, sl: slice, u: Optional[torch.Tensor],
                rule: Optional[Callable]):
        """Sample rows ``sl`` from their (R, V) logits and apply the ids."""
        if rule is None:
            tok = S.ras_sample_batch(logits, self.tok_d[sl], self.n_d[sl], u, self.att_d[sl],
                                     self.min_d[sl], self.eos, *self.sampling,
                                     fill_ids=self.fill_ids)
        else:
            self._settle()
            logp = S.decode_log_probs(logits, self.att_d[sl], self.min_d[sl], self.eos,
                                      self.fill_ids).cpu()
            self.host_reads += 1
            rows = range(self.B)[sl]
            tok = torch.tensor([0 if self._done[b] else int(rule(
                logp[k], self._tokens[b], *self.sampling, generator=self.generators[b]))
                for k, b in enumerate(rows)], device=self.device)
        self._apply(sl, tok)

    def _apply(self, sl: slice, tok: torch.Tensor):
        live = ~self.done_d[sl]
        emit = live & (tok < self.eos)
        buf, n, att = self.tok_d[sl], self.n_d[sl], self.att_d[sl]
        idx = torch.clamp(n, max=self.max_len - 1)[:, None]
        buf.scatter_(1, idx, torch.where(emit, tok, buf.gather(1, idx)[:, 0])[:, None])
        n.add_(emit.long())
        self.last_d[sl] = torch.where(emit, tok, self.last_d[sl])
        att.add_(live.long())
        self.done_d[sl] = self.done_d[sl] | (live & ((tok == self.eos) | (att >= self.cap_d[sl])))

    def _reset(self, sl: slice, min_lens: Sequence[int], caps: Sequence[int],
               generators: Sequence[Optional[torch.Generator]]):
        """Make rows ``sl`` fresh requests (no token yet) with these bounds
        (every cap in [1, max_len]: the callers check)."""
        self._finish()
        self.tok_d[sl] = -1
        self.n_d[sl], self.att_d[sl], self.last_d[sl] = 0, 0, 0
        self.done_d[sl] = False
        rows = range(self.B)[sl]
        for k, b in enumerate(rows):
            self.min_lens[b], self.caps[b], self.generators[b] = min_lens[k], caps[k], generators[k]
            self._tokens[b], self._done[b], self._attempts[b] = [], False, 0
            self._hi[b], self._end[b] = 0, self.i + caps[k] - 1
            self._closed[b] = self._known_done[b] = False
            self._frozen_by_host.discard(b)
            self._epochs[b] += 1
        if self.device.type == "cuda":
            bounds = torch.tensor([list(min_lens), list(caps)]).pin_memory()
            bounds = bounds.to(self.device, non_blocking=True)
        else:
            bounds = torch.tensor([list(min_lens), list(caps)])
        self.min_d[sl], self.cap_d[sl] = bounds[0], bounds[1]

    def _first(self, logits: torch.Tensor, sl: slice):
        """Sample the first token of the fresh rows ``sl`` from their
        prefill's (R, V) logits; the host view is read lazily."""
        rows = list(range(self.B)[sl])
        rule = self._host_rule()
        u = None if rule is not None else self._uniforms(1, rows)[0, sl]
        self._sample(logits, sl, u, rule)
        for b in rows:
            self._hi[b] = 1
            self._closed[b] = self._known_done[b] = self.caps[b] <= 1
        self._view = self._snapshot()

    def freeze(self, rows: Sequence[int]):
        """Mark rows done from the host (a cancelled request stops here)."""
        self._finish()
        for b in rows:
            self.done_d[b] = True
            self._done[b] = self._known_done[b] = self._closed[b] = True
            self._frozen_by_host.add(b)

    # -- steps --------------------------------------------------------------

    def _width(self) -> int:
        live = [min(self._hi[b], self.caps[b] - 1) for b in range(self.B)
                if not self._known_done[b]]
        return self.L0 + max(live, default=0)

    def _step(self, u: Optional[torch.Tensor], rule: Optional[Callable]):
        cols = torch.where(self.done_d, self.L0 - 1, self.L0 + self.att_d - 1)
        logits = self._logits(self.last_d, Columns(cols, self._width()))
        self.frozen_d.add_(self.done_d.all().long())
        self._sample(logits, slice(None), u, rule)
        for b in range(self.B):
            if not self._known_done[b]:
                self._hi[b] = min(self._hi[b] + 1, self.caps[b])
        self.i += 1

    def _enqueue(self, seg: Segment, chunks: Optional[int] = None):
        """Enqueue ``seg``'s steps left, ``chunks`` chunks of them (None:
        all), and close it after its last.  Before each chunk ``all(done)``
        is copied, and read once the chunk is queued behind it, so the card
        has a chunk to run while the host waits; a done probe ends the
        segment there."""
        while seg.j < seg.steps and chunks != 0:
            probe = HostCopy(self.done_d.all())
            for _ in range(min(CHUNK, seg.steps - seg.j)):
                self._step(seg.u[seg.j], None)
                seg.j += 1
            chunks = None if chunks is None else chunks - 1
            if seg.j < seg.steps:
                self.host_reads += 1
                if bool(probe.get()):
                    seg.steps = seg.j
        if seg.j >= seg.steps:
            self._close(seg)

    def _finish(self):
        """Enqueue the rest of a segment launched ahead."""
        if self._open is not None:
            self._enqueue(self._open)

    def launch(self, stop_at: Optional[int] = None, ahead: bool = False) -> Segment:
        """Enqueue steps until every row is done or ``i`` reaches
        ``stop_at``; returns the segment's :class:`Segment`.  ``ahead``:
        enqueue its first chunk now and the rest when it is waited for or
        the next segment is launched (module docstring)."""
        self._finish()
        ends = [self._end[b] for b in range(self.B) if not self._closed[b]]
        steps = max(ends, default=self.i) - self.i
        if stop_at is not None:
            steps = min(steps, stop_at - self.i)
        self.segments_run += 1
        rule = self._host_rule()
        if steps > 0 and rule is not None:  # a stand-in sampler: read every step
            while steps > 0 and not all(self._known_done):
                self._step(None, rule)
                self._snapshot().wait()
                steps -= 1
            return self._snapshot()
        live = [b for b in range(self.B) if not self._known_done[b]]
        seg = Segment(self, max(steps, 0), self._uniforms(steps, live) if steps > 0 else None)
        self._open = seg
        self._enqueue(seg, 1 if ahead else None)
        return seg

    def run(self, stop_at: Optional[int] = None) -> "DeviceDecode":
        """Step until every row is done or ``i`` reaches ``stop_at`` and
        read the result back.  A frozen row is fed at column L0 - 1 and its
        output dropped, so it neither widens the step nor touches a live
        row."""
        return self.launch(stop_at).wait()
