#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each, any failed check raises (non-zero exit):

1. the card: ``nvidia-smi`` name and power limit;
2. the kernel build from ``horovod_tpu_torch/csrc`` (nvcc, sm_90a);
3. K1, the flash-attention forward kernel, against its plain PyTorch
   version at the GPT-2-small path shape (B=4, S=2048, H=12, D=64, bf16,
   causal, q/k/v as strided views of one qkv tensor) and at a small
   padded-mask shape with one fully masked sequence; kernel, plain and
   library (scaled_dot_product_attention, a yardstick the port never calls)
   times from CUDA events;
4. K2, the two backward kernels, against autograd of the plain version on
   the same shapes;
5. the slice: ``hvd.init()`` (NCCL), ``create_mesh({"dp": 1})``,
   GPT-2-small (12 x 768, vocab 50257) with flash attention and bf16
   logits, ``DistributedOptimizer(AdamW)``, parameter broadcast, then 5
   training steps at B=4, S=2048 on seeded synthetic ids. The forward loss
   is first held against the same weights with dense attention; the kernel
   launch counts of the 5 steps must be exactly 12 per kernel per step;
6. the ``{"kernels": [...]}`` line; then the card line from nvidia-smi and
   the last line ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when CUDA is not available.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense), used for bound_ms.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SOURCE = "horovod_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:66",       # _kernel
    "flash_bwd_dkdv": "horovod_tpu/ops/flash_attention.py:267",  # _dqkv_kernel
    "flash_bwd_dq": "horovod_tpu/ops/flash_attention.py:267",
}
B, S, H, D = 4, 2048, 12, 64
STEPS = 5
O_ATOL = 2e-2        # bf16 output: a few ulp at |o| ~ 1
LSE_ATOL = 1e-3      # f32 logsumexp; the two differ in summation order only
GRAD_TOL = 2e-2      # bf16 dq/dk/dv, atol and rtol
LOSS_RTOL = 2e-2     # flash vs dense forward loss, bf16 model


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call over `iters` calls, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                atol: float, rtol: float = 0.0) -> float:
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    excess = (got.float() - want.float()).abs() - (atol + rtol * want.float().abs())
    if float(excess.max()) > 0:
        raise AssertionError(f"{name}: max abs err {max_err(got, want)} above "
                             f"atol {atol} rtol {rtol}")
    return max_err(got, want)


def valid_pairs(Bn: int, Sn: int, Hn: int, mask, causal: bool) -> int:
    """(query, key) pairs the kernels compute: what this run's data needs."""
    if mask is None:
        per = Sn * (Sn + 1) // 2 if causal else Sn * Sn
        return Bn * Hn * per
    total = 0
    for row in (mask > 0).cpu().numpy():
        keys = np.nonzero(row)[0]
        total += int(np.sum(Sn - keys)) if causal else Sn * len(keys)
    return total * Hn


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def qkv_views(Bn, Sn, Hn, Dn, gen, dev):
    """q, k, v as the model makes them: strided views of one (B,S,3,H,D)."""
    qkv = torch.randn(Bn, Sn, 3, Hn, Dn, generator=gen, device=dev).to(torch.bfloat16)
    return qkv.unbind(dim=2)


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    emit({"phase": "card", "nvidia_smi": out[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return out[0]


def phase_build():
    from horovod_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_info["ptxas"].splitlines()
             if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_info["seconds"],
          "cached": _build.build_info["cached"], "ptxas": ptxas})


def phase_k1(fa, gen, dev):
    """K1 against the plain version; returns the path-shape record."""
    import torch.nn.functional as F

    q, k, v = qkv_views(B, S, H, D, gen, dev)
    o, lse = fa.flash_fwd_cuda(q, k, v, None, True)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, None, True)
    torch.cuda.synchronize()
    err_o = check_close("K1 o (path)", o, o_ref, O_ATOL)
    err_lse = check_close("K1 lse (path)", lse, lse_ref, LSE_ATOL)
    rec = {"phase": "k1", "shape": [B, S, H, D], "causal": True,
           "o_max_abs_err": err_o, "lse_max_abs_err": err_lse,
           "tolerance": {"o_atol": O_ATOL, "lse_atol": LSE_ATOL}}

    # Small padded shape: batch 0 padded after 150, batch 1 fully masked.
    qs, ks, vs = qkv_views(2, 200, 2, D, gen, dev)
    mask = torch.ones(2, 200, device=dev)
    mask[0, 150:] = 0
    mask[1, :] = 0
    for causal in (True, False):
        o_s, lse_s = fa.flash_fwd_cuda(qs, ks, vs, mask, causal)
        o_sr, lse_sr = fa._flash_fwd_plain(qs, ks, vs, mask, causal)
        tag = f"padded causal={causal}"
        rec[f"o_max_abs_err {tag}"] = check_close(f"K1 o ({tag})", o_s, o_sr, O_ATOL)
        rec[f"lse_max_abs_err {tag}"] = check_close(
            f"K1 lse ({tag})", lse_s, lse_sr, LSE_ATOL)
        if float(o_s[1].float().abs().max()) != 0.0:
            raise AssertionError("K1: the fully masked sequence is not zero")

    rec["kernel_ms"] = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, None, True), 50)
    rec["plain_ms"] = time_ms(lambda: fa._flash_fwd_plain(q, k, v, None, True), 5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 50)
    pairs = valid_pairs(B, S, H, None, True)
    n = B * S * H * D
    rec["flops"] = 4 * D * pairs
    rec["bytes"] = 4 * n * 2 + B * H * S * 4
    rec["bound_ms"], rec["bound_by"] = bound(rec["flops"], rec["bytes"])
    emit(rec)
    return rec, (q, k, v, o, lse)


def _library_bwd_ms(q, k, v, dout):
    """One aten call computing dq, dk, dv (PyTorch's own flash backward), as
    a yardstick; None when this PyTorch's op has another signature."""
    fwd = torch.ops.aten._scaled_dot_product_flash_attention.default
    bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward.default
    names = [a.name for a in bwd._schema.arguments]
    expected = ["grad_out", "query", "key", "value", "out", "logsumexp",
                "cum_seq_q", "cum_seq_k", "max_q", "max_k", "dropout_p",
                "is_causal", "philox_seed", "philox_offset", "scale"]
    if names != expected:
        return None
    qt, kt, vt, gt = (t.transpose(1, 2) for t in (q, k, v, dout))
    out, lse, cq, ck, mq, mk, seed, offset, _ = fwd(qt, kt, vt, 0.0, True)
    return time_ms(lambda: bwd(gt, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0,
                               True, seed, offset), 50)


def phase_k2(fa, gen, dev, fwd_out):
    q, k, v, o, lse = fwd_out
    dout = torch.randn(B, S, H, D, generator=gen, device=dev).to(torch.bfloat16)
    delta = (dout.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, None, dout, lse, delta, True)
    dq = fa.flash_bwd_dq_cuda(q, k, v, None, dout, lse, delta, True)
    dq_r, dk_r, dv_r = fa._flash_bwd_plain(q, k, v, None, dout, True)
    torch.cuda.synchronize()
    rec = {"phase": "k2", "shape": [B, S, H, D], "causal": True,
           "tolerance": {"atol": GRAD_TOL, "rtol": GRAD_TOL}}
    for name, got, want in (("dq", dq, dq_r), ("dk", dk, dk_r), ("dv", dv, dv_r)):
        rec[f"{name}_max_abs_err"] = check_close(f"K2 {name} (path)", got, want,
                                                 GRAD_TOL, GRAD_TOL)
        rec[f"{name}_max_abs_ref"] = float(want.float().abs().max())

    qs, ks, vs = qkv_views(2, 200, 2, D, gen, dev)
    mask = torch.ones(2, 200, device=dev)
    mask[0, 150:] = 0
    mask[1, :] = 0
    dos = torch.randn(2, 200, 2, D, generator=gen, device=dev).to(torch.bfloat16)
    for causal in (True, False):
        o_s, lse_s = fa.flash_fwd_cuda(qs, ks, vs, mask, causal)
        dlt = (dos.float() * o_s.float()).sum(-1).permute(0, 2, 1).contiguous()
        dk_s, dv_s = fa.flash_bwd_dkdv_cuda(qs, ks, vs, mask, dos, lse_s, dlt, causal)
        dq_s = fa.flash_bwd_dq_cuda(qs, ks, vs, mask, dos, lse_s, dlt, causal)
        refs = fa._flash_bwd_plain(qs, ks, vs, mask, dos, causal)
        for name, got, want in zip(("dq", "dk", "dv"), (dq_s, dk_s, dv_s), refs):
            tag = f"padded causal={causal}"
            rec[f"{name}_max_abs_err {tag}"] = check_close(
                f"K2 {name} ({tag})", got, want, GRAD_TOL, GRAD_TOL)

    rec["dkdv_kernel_ms"] = time_ms(
        lambda: fa.flash_bwd_dkdv_cuda(q, k, v, None, dout, lse, delta, True), 30)
    rec["dq_kernel_ms"] = time_ms(
        lambda: fa.flash_bwd_dq_cuda(q, k, v, None, dout, lse, delta, True), 30)
    rec["plain_ms"] = time_ms(lambda: fa._flash_bwd_plain(q, k, v, None, dout, True), 3)
    rec["library_pair_ms"] = _library_bwd_ms(q, k, v, dout)
    pairs = valid_pairs(B, S, H, None, True)
    n = B * S * H * D
    rows = B * H * S * 4
    rec["dkdv_flops"], rec["dkdv_bytes"] = 8 * D * pairs, 4 * n * 2 + 2 * rows + 2 * n * 2
    rec["dq_flops"], rec["dq_bytes"] = 6 * D * pairs, 4 * n * 2 + 2 * rows + n * 2
    rec["dkdv_bound_ms"], rec["dkdv_bound_by"] = bound(rec["dkdv_flops"], rec["dkdv_bytes"])
    rec["dq_bound_ms"], rec["dq_bound_by"] = bound(rec["dq_flops"], rec["dq_bytes"])
    emit(rec)
    return rec


def phase_slice(fa, dev):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    hvd.init()
    try:
        if hvd.device().type != "cuda":
            raise AssertionError(f"hvd.init() chose {hvd.device()}")
        mesh = create_mesh({"dp": 1})
        spec = get_model("gpt2-small")
        gen = torch.Generator(device=hvd.device()).manual_seed(0)
        model = spec.make_model(device=hvd.device(), generator=gen, attn_impl="flash",
                                logits_dtype=torch.bfloat16, max_len=S)
        cfg = model.cfg
        ids = torch.from_numpy(spec.make_batch(B, seed=42, seq_len=S)[0]).to(hvd.device())

        # The forward loss through the kernels against dense attention on
        # the same weights.
        dense = spec.make_model(device=hvd.device(), attn_impl="dense",
                                logits_dtype=torch.bfloat16, max_len=S)
        dense.load_state_dict(model.state_dict())
        with torch.no_grad():
            loss_flash = float(lm_loss(model(ids), ids))
            loss_dense = float(lm_loss(dense(ids), ids))
        del dense
        if not (math.isfinite(loss_flash)
                and abs(loss_flash - loss_dense) <= LOSS_RTOL * abs(loss_dense)):
            raise AssertionError(f"flash loss {loss_flash} vs dense {loss_dense}")

        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8))
        init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh)
        state = init_fn()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()

        fa.reset_launches()
        losses, step_ms = [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            state, loss = step_fn(state, ids, ids)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        launches = fa.launches()
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite losses {losses}")
        want = cfg.n_layers * STEPS
        if launches != {name: want for name in launches}:
            raise AssertionError(f"launch counts {launches}, expected {want} each")
        steady = statistics.median(step_ms[1:])
        rec = {"phase": "slice", "model": "gpt2-small", "n_layers": cfg.n_layers,
               "d_model": cfg.d_model, "n_heads": cfg.n_heads, "vocab": cfg.vocab_size,
               "batch": B, "seq": S, "world": hvd.size(), "device": str(hvd.device()),
               "loss_flash_fwd": loss_flash, "loss_dense_fwd": loss_dense,
               "losses": losses, "step_ms": step_ms, "median_step_ms_2_to_5": steady,
               "tokens_per_s": B * S / (steady / 1e3),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": launches, "launches_per_step": {
                   k: v / STEPS for k, v in launches.items()}}
        emit(rec)
        return rec
    finally:
        hvd.shutdown()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = phase_card()
    phase_build()
    gen = torch.Generator(device=dev).manual_seed(1234)
    k1, fwd_out = phase_k1(fa, gen, dev)
    k2 = phase_k2(fa, gen, dev, fwd_out)
    del fwd_out
    torch.cuda.empty_cache()
    sl = phase_slice(fa, dev)

    kernels = [
        {"name": "flash_fwd", "launches": sl["launches"]["flash_fwd"],
         "max_abs_err": k1["o_max_abs_err"], "ms": k1["kernel_ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]},
        {"name": "flash_bwd_dkdv", "launches": sl["launches"]["flash_bwd_dkdv"],
         "max_abs_err": max(k2["dk_max_abs_err"], k2["dv_max_abs_err"]),
         "ms": k2["dkdv_kernel_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["dkdv_bound_ms"], "bound_by": k2["dkdv_bound_by"],
         "library_ms": None},
        {"name": "flash_bwd_dq", "launches": sl["launches"]["flash_bwd_dq"],
         "max_abs_err": k2["dq_max_abs_err"], "ms": k2["dq_kernel_ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["dq_bound_ms"],
         "bound_by": k2["dq_bound_by"], "library_ms": None},
    ]
    for kern in kernels:
        kern.update(route="cuda", source=SOURCE, replaces=REPLACES[kern["name"]])
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
