"""The port imports neither JAX nor the JAX package: checked in a fresh
interpreter (this one has JAX loaded by tests/conftest.py) and by a scan of
the port's sources and chip_smoke.py."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# "cosy_tpu" followed by ".", whitespace or the end: cosy_tpu_torch is fine
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|cosy_tpu)(\.|\s|$)", re.M)


def test_import_in_fresh_interpreter_loads_no_jax():
    # modules an interpreter start-up hook may have loaded already are not
    # the port's doing: only what the import adds counts
    code = ("import sys\nbefore = set(sys.modules)\n"
            "import cosy_tpu_torch, cosy_tpu_torch.infer.pipeline, cosy_tpu_torch.infer.engine, "
            "cosy_tpu_torch.infer.__main__, cosy_tpu_torch.train.trainer, "
            "cosy_tpu_torch.merge, cosy_tpu_torch.lora, cosy_tpu_torch.models.joint\n"
            "bad = sorted(m for m in set(sys.modules) - before if m == 'jax' or "
            "m.startswith('jax.') or m == 'cosy_tpu' or m.startswith('cosy_tpu.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "cosy_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    offenders = []
    for f in files:
        with open(f, encoding="utf-8") as fh:
            offenders += [f"{f}: {m.group(0).strip()}" for m in FORBIDDEN.finditer(fh.read())]
    assert not offenders, offenders
    assert FORBIDDEN.search("from cosy_tpu.config import X")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from cosy_tpu_torch.config import X")
