"""Device milliseconds of the kernels launched inside HiFT's spans a second
of audio the traced window produced."""

from portbench.readers import span_ms_per_audio_s

SPANS = {"hift": ["cosy_tpu_torch.models.hift:hift_inference"]}


def read(rec):
    return span_ms_per_audio_s(rec, "hift")
