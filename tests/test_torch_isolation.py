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


def test_cv2_training_cli_and_data_modules_load_no_jax():
    """The CosyVoice2 modules, the data reader, the loader and the training
    CLI, imported in a fresh interpreter."""
    code = ("import sys\nbefore = set(sys.modules)\n"
            "import cosy_tpu_torch.data.dataset, cosy_tpu_torch.data.prefetch, "
            "cosy_tpu_torch.compat.loader, cosy_tpu_torch.train.__main__, "
            "cosy_tpu_torch.layers.qwen2, cosy_tpu_torch.layers.upsample_encoder, "
            "cosy_tpu_torch.models.qwen2lm, cosy_tpu_torch.models.flow2, "
            "cosy_tpu_torch.infer.pipeline2\n"
            "bad = sorted(m for m in set(sys.modules) - before if m == 'jax' or "
            "m.startswith('jax.') or m == 'cosy_tpu' or m.startswith('cosy_tpu.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_frontend_extractor_and_prepare_modules_load_no_jax():
    """The text frontend, tokenizers, ONNX executor and replicas, the
    preparer, the processor stages and the inference frontend, and the
    preparer's ``__main__`` (run to its --help) in a fresh interpreter."""
    code = ("import sys, runpy\nbefore = set(sys.modules)\n"
            "import cosy_tpu_torch.data.text, cosy_tpu_torch.data.textnorm, "
            "cosy_tpu_torch.data.tokenizer, cosy_tpu_torch.data.prepare, "
            "cosy_tpu_torch.data.processor, cosy_tpu_torch.data.frontend, "
            "cosy_tpu_torch.compat.onnx, cosy_tpu_torch.compat.onnx_export, "
            "cosy_tpu_torch.compat.replicas, cosy_tpu_torch.ops.audio\n"
            "sys.argv = ['prepare', '--help']\n"
            "try:\n"
            "    runpy.run_module('cosy_tpu_torch.data.prepare', run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "bad = sorted(m for m in set(sys.modules) - before if m == 'jax' or "
            "m.startswith('jax.') or m == 'cosy_tpu' or m.startswith('cosy_tpu.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "--speech-tokenizer-onnx" in res.stdout


def test_api_serve_client_and_yaml_modules_load_no_jax():
    """The user API, the server, the client and the yaml reader in a fresh
    interpreter, the server's and the client's ``__main__`` run to their
    --help; the client and the server module load without torch."""
    code = ("import sys, runpy\nbefore = set(sys.modules)\n"
            "import cosy_tpu_torch.client, cosy_tpu_torch.serve\n"
            "light = 'torch' not in sys.modules\n"
            "import cosy_tpu_torch.api, cosy_tpu_torch.compat.yaml_config\n"
            "for mod in ('cosy_tpu_torch.serve', 'cosy_tpu_torch.client'):\n"
            "    sys.argv = [mod, '--help']\n"
            "    try:\n"
            "        runpy.run_module(mod, run_name='__main__')\n"
            "    except SystemExit:\n"
            "        pass\n"
            "bad = sorted(m for m in set(sys.modules) - before if m == 'jax' or "
            "m.startswith('jax.') or m == 'cosy_tpu' or m.startswith('cosy_tpu.'))\n"
            "print(bad, light)\nsys.exit(1 if bad or not light else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "--voices" in res.stdout and "--stream" in res.stdout


def test_training_regime_modules_load_no_jax():
    """The distiller, the full-parameter and GAN trainers, their checkpoints,
    the GAN models, the pitch tracker and its native build, the DPO loss,
    the TensorBoard writer, the scale-out modules (the mesh, the
    collectives, tensor / sequence / pipeline parallelism, the agreement),
    weight-only int8 with its MCD metric, monotonic alignment search and
    the Lightning checkpoint reader in a fresh interpreter, and the two
    command lines (``train.full``, ``train.distill``) run to their --help."""
    code = ("import sys, runpy\nbefore = set(sys.modules)\n"
            "import cosy_tpu_torch.train.distill, cosy_tpu_torch.train.full_trainer, "
            "cosy_tpu_torch.train.checkpoint, cosy_tpu_torch.train.gan_trainer, "
            "cosy_tpu_torch.train.dpo, cosy_tpu_torch.models.gan, cosy_tpu_torch.ops.f0, "
            "cosy_tpu_torch.native, cosy_tpu_torch.utils.tb, cosy_tpu_torch.train.full, "
            "cosy_tpu_torch.parallel.mesh, cosy_tpu_torch.parallel.comm, "
            "cosy_tpu_torch.parallel.tp, cosy_tpu_torch.parallel.sp, "
            "cosy_tpu_torch.parallel.pp, cosy_tpu_torch.utils.distributed, "
            "cosy_tpu_torch.quant, cosy_tpu_torch.ops.mcd, cosy_tpu_torch.ops.mas, "
            "cosy_tpu_torch.compat\n"
            "for mod in ('cosy_tpu_torch.train.full', 'cosy_tpu_torch.train.distill'):\n"
            "    sys.argv = [mod, '--help']\n"
            "    try:\n"
            "        runpy.run_module(mod, run_name='__main__')\n"
            "    except SystemExit:\n"
            "        pass\n"
            "bad = sorted(m for m in set(sys.modules) - before if m == 'jax' or "
            "m.startswith('jax.') or m == 'cosy_tpu' or m.startswith('cosy_tpu.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "--dpo_beta" in res.stdout and "--teacher-substeps" in res.stdout



def test_registry_export_profiling_aot_and_cost_modules_load_no_jax():
    """The ASR decoders, the conv subsamplings, the positional encodings,
    the masks, the exporters, profiling, the library cache and the cost
    model in a fresh interpreter; the library cache loads without torch
    (the server imports it before the model)."""
    code = ("import sys\nbefore = set(sys.modules)\n"
            "import cosy_tpu_torch.utils.aot\n"
            "light = 'torch' not in sys.modules\n"
            "import cosy_tpu_torch.layers.decoder, cosy_tpu_torch.layers.subsampling, "
            "cosy_tpu_torch.layers.posenc, cosy_tpu_torch.ops.masks, cosy_tpu_torch.export, "
            "cosy_tpu_torch.compat.onnx_export, cosy_tpu_torch.utils.profiling, "
            "cosy_tpu_torch.ops.costs, cosy_tpu_torch.ops._cuda, cosy_tpu_torch.native\n"
            "bad = sorted(m for m in set(sys.modules) - before if m == 'jax' or "
            "m.startswith('jax.') or m == 'cosy_tpu' or m.startswith('cosy_tpu.'))\n"
            "print(bad, light)\nsys.exit(1 if bad or not light else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
