"""The token2wav cells' comparison on the frozen reference:
``wav_rel_err`` of each sampled call against the reference's call on the
same inputs and noise seed."""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from .. import system
from .check import rel_err, set_tf32


def numbers(config: Dict[str, Any], seed: int, inference: Dict[str, Any],
                      samples: List[Dict[str, Any]], device, control: bool) -> Dict[str, float]:
    """``{wav_rel_err}`` of the program's sampled calls (or the control's)."""
    set_tf32(False)
    pipe = system.build(config, seed, device, inference, reference=True)
    worst = 0.0
    with torch.inference_mode():
        for s in samples:
            x = s["inputs"]

            def run():
                g = torch.Generator(device=device).manual_seed(x["seed"])
                return pipe.token2wav(x["token"], x["spk_embedding"], generator=g).reshape(-1)

            want = run()
            if control:
                set_tf32(True)
                got = run()
                set_tf32(False)
            else:
                got = s["wav"]
            worst = max(worst, rel_err(got, want))
    return {"wav_rel_err": worst}
