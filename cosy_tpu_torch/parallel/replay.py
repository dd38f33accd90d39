"""Replayed device sections: one tensor-parallel server over N processes.

The JAX package serves ``--tp N`` from one controller process, in which
GSPMD runs each model call over every device.  The port runs one process a
GPU (``torchrun``), and rank 0 alone serves HTTP, so every other rank (a
*follower*) must enter the split products' collectives (``parallel/tp.py``)
in rank 0's order.

Rank 0's server does its device work in sections under one device lock: one
advance of a model generator, one batch call, one of the engine's locked
sections.  Before it runs a section it sends it, as one picklable op, to the
followers (:class:`Leader`: a broadcast over a gloo group of its own, not
the model group).  Each follower (:func:`follow`) runs the ops in order on
its mirror of rank 0's objects, the pipeline and the engine, so it runs rank
0's sections with rank 0's collectives.  An op is determined by its
arguments: rank 0 draws the seeds and sends them.

The ops:

- ``("open", gid, method, args, kwargs)``: ``model.<method>(*args,
  **kwargs)``, a generator, and its first advance;
- ``("next", gid)``: its next advance (its end or an error drops it);
- ``("close", gid)``: close it early (a client that went away);
- ``("call", method, args, kwargs)``: one whole call (``synthesize_batch``);
- ``("engine", name, args)``: one engine section
  (``ContinuousBatchEngine.apply``): an admission, a decode segment, a
  prefetched segment (``--engine-prefetch``: enqueued before rank 0 reads
  the segment before it, and sent in that order), a window or a reset.  A
  segment's steps depend only on its arguments, the admissions and freezes
  before it and the rows' done flags (``models/decode.py``), so a follower,
  which reads nothing back, enqueues the same steps as rank 0;
- ``("beat",)``: nothing; an idle rank 0 sends one every :data:`BEAT_S`
  seconds, so a follower waiting for the next op hears within
  :data:`TIMEOUT` that rank 0 lives;
- ``("stop",)``: the end of the loop.

An op raises alike on every rank (the same code on the same inputs): a
follower records the error and takes the next op, and rank 0 answers the
request as a world of one does.  A rank that dies fails the others' next
broadcast or collective, and the run with them.
"""

from __future__ import annotations

import itertools
import sys
import threading
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

BEAT_S = 30.0  # seconds between an idle rank 0's beats
TIMEOUT = timedelta(seconds=300)  # the replay group's wait for an op

_END = object()


def replay_group():
    """A gloo group over the world for the ops (pickled bytes on the CPU);
    every rank calls it once, in the same place."""
    return dist.new_group(backend="gloo", timeout=TIMEOUT)


class Leader:
    """Rank 0's end.  ``lock`` is the server's device lock: the caller of
    :meth:`send` holds it, so the ops go out in the sections' order.
    ``sent`` counts the sections sent (not the beats or the stop)."""

    def __init__(self, group, lock: threading.Lock):
        self.group, self.lock = group, lock
        self.sent = 0
        self._gids = itertools.count()
        self._stopped = threading.Event()
        self._beats = threading.Thread(target=self._beat, daemon=True)
        self._beats.start()

    def send(self, op: tuple) -> None:
        dist.broadcast_object_list([op], src=0, group=self.group)
        if op[0] not in ("beat", "stop"):
            self.sent += 1

    def advance(self, gid: Optional[int], method: str, args: tuple, kwargs: dict) -> int:
        """Send one advance of a model generator, its call with the first;
        returns the generator's id."""
        if gid is None:
            gid = next(self._gids)
            self.send(("open", gid, method, args, kwargs))
        else:
            self.send(("next", gid))
        return gid

    def _beat(self):
        while not self._stopped.wait(BEAT_S):
            with self.lock:
                if not self._stopped.is_set():
                    self.send(("beat",))

    def stop(self, timeout: float = 60.0) -> None:
        """After the last section: end the beats and the followers' loops."""
        self._stopped.set()
        with self.lock:
            self.send(("stop",))
        self._beats.join(timeout=timeout)


def follow(group, model, engine=None) -> dict:
    """A follower's loop: run each op rank 0 sends on ``model`` (the
    pipeline) and ``engine`` (a mirror that never starts its thread) until
    the stop.  Returns ``{"replayed": sections run, "errors": [...]}``, one
    entry for each op that raised (as it did on rank 0)."""
    gens, replayed, errors = {}, 0, []
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=group)
        op = box[0]
        kind = op[0]
        if kind == "stop":
            break
        if kind == "beat":
            continue
        if kind not in ("open", "next", "close", "call", "engine"):
            raise ValueError(f"unknown replay op {op!r}")
        replayed += 1
        try:
            with torch.inference_mode():
                if kind == "open":
                    gens[op[1]] = getattr(model, op[2])(*op[3], **op[4])
                    _advance(gens, op[1])
                elif kind == "next":
                    _advance(gens, op[1])
                elif kind == "close":
                    gens.pop(op[1]).close()
                elif kind == "call":
                    getattr(model, op[1])(*op[2], **op[3])
                else:
                    engine.apply(op[1], op[2])
        except Exception as e:  # noqa: BLE001 - rank 0 raised alike and answers for it
            errors.append(f"{kind}: {e!r}")
            print(f"replay: a {kind} op raised {e!r}, as on rank 0", file=sys.stderr, flush=True)
    for g in gens.values():
        g.close()
    return {"replayed": replayed, "errors": errors}


def _advance(gens: dict, gid: int) -> None:
    try:
        if next(gens[gid], _END) is _END:
            del gens[gid]
    except Exception:
        gens.pop(gid, None)
        raise
