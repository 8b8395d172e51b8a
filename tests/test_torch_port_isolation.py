"""The port stands alone: importing it pulls in neither jax nor anything of
horovod_tpu, no source file of it (nor chip_smoke.py) imports horovod_tpu,
its entry points refuse to pick the CPU on their own, and its kernel module
imports and runs on CPU tensors without triton or nvcc. Each check that
imports the port runs in a fresh interpreter."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "horovod_tpu_torch"
MODULES = [
    "horovod_tpu_torch",
    "horovod_tpu_torch.common.basics",
    "horovod_tpu_torch.common.functions",
    "horovod_tpu_torch.ops",
    "horovod_tpu_torch.ops._build",
    "horovod_tpu_torch.ops.flash_attention",
    "horovod_tpu_torch.optim.distributed",
    "horovod_tpu_torch.parallel.mesh",
    "horovod_tpu_torch.parallel.train",
    "horovod_tpu_torch.models.transformer",
    "horovod_tpu_torch.models.registry",
    "horovod_tpu_torch.models.convert",
]
FORBIDDEN_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|horovod_tpu)(\.|\s|$)", re.M)


def _python(code: str, env_extra=None, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_import_leaves_jax_and_horovod_tpu_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'horovod_tpu', 'triton'))\n"
        "assert not bad, bad\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]))
def test_sources_do_not_import_the_jax_package(path):
    text = (REPO / path).read_text()
    assert not FORBIDDEN_IMPORT.search(text), path


def test_init_without_cuda_and_without_cpu_request_raises():
    code = (
        "import torch, horovod_tpu_torch as hvd\n"
        "assert not torch.cuda.is_available()\n"
        "try:\n"
        "    hvd.init()\n"
        "except RuntimeError as e:\n"
        "    assert 'CUDA' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('init() fell back to the CPU')\n"
        "assert not hvd.is_initialized()\n"
        "hvd.init(device='cpu')\n"
        "assert hvd.device().type == 'cpu' and hvd.size() == 1\n"
        "hvd.shutdown()\n"
    )
    proc = _python(code, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_kernel_module_needs_no_triton_or_nvcc_and_cpu_takes_plain_path():
    code = (
        "import sys, torch\n"
        "from horovod_tpu_torch.ops import flash_attention as fa, _build\n"
        "g = torch.Generator().manual_seed(0)\n"
        "q, k, v = (torch.randn(2, 40, 2, 64, generator=g) for _ in range(3))\n"
        "got = fa.flash_attention(q, k, v, causal=True)\n"
        "want, _ = fa._flash_fwd_plain(q, k, v, None, True)\n"
        "assert torch.equal(got, want)\n"
        "assert fa.launches() == dict.fromkeys(fa.launches(), 0)\n"
        "assert 'triton' not in sys.modules\n"
        "assert _build._lib is None and not _build.build_info\n"
    )
    # An empty PATH hides any nvcc; the CPU path must not need one.
    proc = _python(code, {"PATH": ""})
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_chip_smoke_refuses_to_run_without_cuda():
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
