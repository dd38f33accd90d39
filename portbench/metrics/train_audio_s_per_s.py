"""Seconds of unpadded training audio in the optimizer steps completed in
the window over the seconds from the first step's start to the last one's
synchronised end."""


def read(rec):
    return rec.audio_s / rec.window_s if rec.audio_s > 0 else None
