"""The port stands alone: importing it pulls in neither jax nor anything of
horovod_tpu, no source file of it (nor chip_smoke.py) imports horovod_tpu,
its entry points (``init``, ``make_model``) refuse to pick the CPU on their
own, and its kernel modules import and run on CPU tensors without triton or
nvcc. Each check that imports the port runs in a fresh interpreter."""
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
    "horovod_tpu_torch.common.async_handles",
    "horovod_tpu_torch.common.env",
    "horovod_tpu_torch.ops",
    "horovod_tpu_torch.ops.adasum",
    "horovod_tpu_torch.ops.compression",
    "horovod_tpu_torch.ops.sync_batch_norm",
    "horovod_tpu_torch.ops.wire",
    "horovod_tpu_torch.ops._build",
    "horovod_tpu_torch.ops.flash_attention",
    "horovod_tpu_torch.ops.fused_bn_conv",
    "horovod_tpu_torch.optim.distributed",
    "horovod_tpu_torch.optim.zero",
    "horovod_tpu_torch.parallel.mesh",
    "horovod_tpu_torch.parallel.collectives",
    "horovod_tpu_torch.parallel.ring",
    "horovod_tpu_torch.parallel.ulysses",
    "horovod_tpu_torch.parallel.step",
    "horovod_tpu_torch.parallel.train",
    "horovod_tpu_torch.parallel.pipeline",
    "horovod_tpu_torch.parallel.sharding",
    "horovod_tpu_torch.parallel.tensor",
    "horovod_tpu_torch.parallel.fsdp",
    "horovod_tpu_torch.train_gpt2",
    "horovod_tpu_torch.train_mnist",
    "horovod_tpu_torch.train_synthetic",
    "horovod_tpu_torch.models.transformer",
    "horovod_tpu_torch.models.dropout",
    "horovod_tpu_torch.models.vit",
    "horovod_tpu_torch.models.mnist",
    "horovod_tpu_torch.models.resnet",
    "horovod_tpu_torch.models.registry",
    "horovod_tpu_torch.models.convert",
    "horovod_tpu_torch.models.pipelined",
    "horovod_tpu_torch.profile_step",
    "horovod_tpu_torch.common.message",
    "horovod_tpu_torch.common.types",
    "horovod_tpu_torch.engine",
    "horovod_tpu_torch.engine.tensor_queue",
    "horovod_tpu_torch.engine.response_cache",
    "horovod_tpu_torch.engine.stall",
    "horovod_tpu_torch.engine.timeline",
    "horovod_tpu_torch.engine.controller",
    "horovod_tpu_torch.engine.transport",
    "horovod_tpu_torch.engine.operation_manager",
    "horovod_tpu_torch.engine.engine",
    "horovod_tpu_torch.utils.clock",
    "horovod_tpu_torch.utils.chrome_trace",
    "horovod_tpu_torch.utils.logging",
    "horovod_tpu_torch.torch",
    "horovod_tpu_torch.torch.optimizer",
    "horovod_tpu_torch.torch.elastic",
    "horovod_tpu_torch.common.fault_injection",
    "horovod_tpu_torch.common.telemetry",
    "horovod_tpu_torch.common.metrics_export",
    "horovod_tpu_torch.utils.retry",
    "horovod_tpu_torch.backend",
    "horovod_tpu_torch.backend.rendezvous",
    "horovod_tpu_torch.backend.elastic_env",
    "horovod_tpu_torch.elastic",
    "horovod_tpu_torch.elastic.state",
    "horovod_tpu_torch.elastic.run",
    "horovod_tpu_torch.runner",
    "horovod_tpu_torch.runner.util.secret",
    "horovod_tpu_torch.runner.hosts",
    "horovod_tpu_torch.runner.config_parser",
    "horovod_tpu_torch.runner.rendezvous_server",
    "horovod_tpu_torch.runner.launch",
    "horovod_tpu_torch.runner.run_func",
    "horovod_tpu_torch.runner.elastic",
    "horovod_tpu_torch.runner.elastic.discovery",
    "horovod_tpu_torch.runner.elastic.registration",
    "horovod_tpu_torch.runner.elastic.driver",
    "horovod_tpu_torch.runner.elastic.launcher",
    "horovod_tpu_torch.utils.atomic_file",
    "horovod_tpu_torch.common.checkpoint",
    "horovod_tpu_torch.common.drain",
]
# The JAX package's names that the port exports under the same names.
EXPORTS = [
    "is_homogeneous", "mpi_built", "nccl_built", "gloo_built", "ccl_built",
    "ddl_built", "cuda_built", "rocm_built", "xla_built", "tcp_built",
    "allreduce", "allreduce_async", "grouped_allreduce", "allgather",
    "allgather_async", "broadcast", "broadcast_async", "alltoall",
    "alltoall_async", "reducescatter", "barrier", "join", "poll", "synchronize",
    "broadcast_object", "allgather_object", "broadcast_parameters",
    "broadcast_optimizer_state", "Compression", "DistributedOptimizer",
    "DistributedGradientTape", "distributed_value_and_grad",
    "SyncBatchNorm", "sync_batch_stats", "adasum_allreduce", "zero",
    "create_mesh", "create_hybrid_mesh", "wrap_step", "ring_attention",
    "ulysses_attention", "dense_attention", "AXIS_ORDER", "elastic",
    "HostsUpdatedInterrupt",
]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")
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


def test_modules_import_with_the_jax_package_blocked():
    """An import finder that refuses jax, flax, optax and horovod_tpu: every
    module of the port, the new ones among them, still imports, and the
    package exports the JAX package's names."""
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {BLOCKED!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        f"assert not [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}]\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "import horovod_tpu_torch as hvd\n"
        f"missing = [n for n in {EXPORTS!r} if not hasattr(hvd, n)]\n"
        "assert not missing, missing\n"
        "assert callable(hvd.zero.recut_state) and callable(hvd.zero.status_snapshot)\n"
        "assert hvd.Compression.fp16.compress(__import__('torch').ones(1))[0].dtype "
        "== __import__('torch').bfloat16\n"
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


@pytest.mark.parametrize("name", ["resnet50", "gpt2-tiny", "bert-tiny", "vit-tiny",
                                  "mnist-cnn"])
def test_make_model_without_cuda_and_without_cpu_request_raises(name):
    code = (
        "import torch, horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch.models.registry import get_model\n"
        "spec = get_model(%r)\n"
        "kw = {'num_filters': 8, 'num_classes': 3} if spec.name == 'resnet50' else {}\n"
        "try:\n"
        "    spec.make_model(**kw)\n"
        "except RuntimeError as e:\n"
        "    assert 'CUDA' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('make_model() fell back to the CPU')\n"
        "p = next(spec.make_model(device='cpu', **kw).parameters())\n"
        "assert p.device.type == 'cpu'\n"
        "hvd.init(device='cpu')\n"
        "p = next(spec.make_model(**kw).parameters())\n"
        "assert p.device == hvd.device(), p.device\n"
        "hvd.shutdown()\n"
    ) % name
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
        "from horovod_tpu_torch.ops import fused_bn_conv as fb\n"
        "x = torch.randn(64, 32, generator=g).to(torch.bfloat16)\n"
        "c = torch.ones(32)\n"
        "w = torch.randn(32, 16, generator=g).to(torch.bfloat16)\n"
        "for accum in ('scratch', 'revisit'):\n"
        "    got = fb.fused_bn_relu_matmul(x, 0 * c, c, c, 0 * c, w, accum=accum)\n"
        "    assert all(torch.equal(a, b) for a, b in zip(got, fb._reference_bn_relu_matmul(x, 0 * c, c, c, 0 * c, w)))\n"
        "assert fb.launches() == dict.fromkeys(fb.launches(), 0)\n"
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
