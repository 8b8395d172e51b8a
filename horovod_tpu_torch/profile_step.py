"""Where the time of the GPT-2-small training step goes on the card.

    python -m horovod_tpu_torch.profile_step [--steps 3] [--out PATH]

Builds the slice that ``chip_smoke.py`` drives (GPT-2-small, B=4, S=2048,
bf16 logits, ``DistributedOptimizer(AdamW)`` on one card), warms up, then
for ``attn_impl`` = flash and dense: times ``--steps`` steps by host clock
around ``torch.cuda.synchronize()``, and traces the same number of steps
with ``torch.profiler`` to sum device time by kernel. Prints one JSON line
per implementation: step ms, tokens/s, device busy ms per step and the idle
share against the untraced step, and device ms per step by kernel class (the
flash kernels, matrix products, everything else) and for the top kernels.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

B, S = 4, 2048


def _classify(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name or "flash_bwd_" in name:
        return "flash_kernels"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "wgmma")):
        return "matmul"
    if "nccl" in low:
        return "nccl"
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val is not None:
            return float(val)
    return 0.0


def profile(attn_impl: str, steps: int) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    dev = hvd.device()
    spec = get_model("gpt2-small")
    model = spec.make_model(device=dev, generator=torch.Generator(device=dev).manual_seed(0),
                            attn_impl=attn_impl, logits_dtype=torch.bfloat16, max_len=S)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8))
    init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=create_mesh({"dp": 1}))
    state = init_fn()
    ids = torch.from_numpy(spec.make_batch(B, seed=42, seq_len=S)[0]).to(dev)
    for _ in range(2):
        state, loss = step_fn(state, ids, ids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = step_fn(state, ids, ids)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = step_fn(state, ids, ids)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        # Device-side rows only; record_function ranges (the optimizer's
        # "Optimizer.step#...") also appear on the device and would count twice.
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and not evt.key.startswith(("Optimizer.", "ProfilerStep"))):
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us
    busy_ms = sum(by_kernel.values()) / 1e3 / steps
    classes = {}
    for name, us in by_kernel.items():
        c = _classify(name)
        classes[c] = classes.get(c, 0.0) + us / 1e3 / steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    median = statistics.median(times)
    return {
        "attn_impl": attn_impl, "batch": B, "seq": S, "steps": steps,
        "step_ms": times, "median_step_ms": median,
        "tokens_per_s": B * S / (median / 1e3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss": float(loss),
        "traced_ms_per_step": traced_ms / steps,
        "device_busy_ms_per_step": busy_ms if by_kernel else "not measured",
        # Against the untraced step: tracing adds host time per launch.
        "device_idle_share": (1 - busy_ms / median) if by_kernel else "not measured",
        "device_ms_per_step_by_class": classes,
        "top_kernels_ms_per_step": [[name[:90], us / 1e3 / steps] for name, us in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    import subprocess

    import horovod_tpu_torch as hvd

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    hvd.init()
    lines = []
    try:
        for impl in ("flash", "dense"):
            rec = profile(impl, args.steps)
            rec["card"] = card
            lines.append(json.dumps(rec))
            print(lines[-1], flush=True)
            torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
