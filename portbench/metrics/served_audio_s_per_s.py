"""Seconds of streamed audio that reached the clients inside the window,
counted chunk by chunk at arrival, over the window's seconds (whole engine
segments, from one segment end to the first one ``seconds`` or more
later)."""


def read(rec):
    return rec.audio_s / rec.window_s if rec.audio_s > 0 else None
