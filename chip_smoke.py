#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each, any failed check raises (non-zero exit):

1. the card: ``nvidia-smi`` name and power limit;
2. the kernel build from ``horovod_tpu_torch/csrc`` (nvcc, sm_90a);
3. K1, the flash-attention forward kernel, against its plain PyTorch
   version at the GPT-2-small path shape (B=4, S=2048, H=12, D=64, bf16,
   causal, q/k/v as strided views of one qkv tensor) and at two small
   shapes, causal and not: D=64 (B=2, S=200, H=2) with a padded mask and
   one fully masked sequence, and D=128 (B=2, S=320, H=2) with and without
   that mask; o and lse bitwise-equal over two launches at the path shape;
   kernel, plain and library (scaled_dot_product_attention, a yardstick
   the port never calls) times from CUDA events, achieved TFLOP/s and the
   share of the bound;
4. K2, the two backward kernels, against autograd of the plain version on
   the same shapes, dq, dk and dv bitwise-equal over two launches; times,
   TFLOP/s and shares of each kernel and of the pair, beside the aten flash
   backward (``library_pair_ms``) and the function's own 5-product bound;
5. K3 and K4, the fused BN + ReLU + 1x1-conv + stats kernels (x- and
   w-stationary), against their plain PyTorch version at the four ResNet-50
   stage shapes at B=256, 224x224 (y, s1, s2 at the JAX tests'
   tolerances), with bitwise-equal stats over two launches; kernel, plain
   and library (the bf16 product alone, ``torch.matmul``) times at the
   path shape (stage 1);
6. the GPT-2 slice: ``hvd.init()`` (NCCL), ``create_mesh({"dp": 1})``,
   GPT-2-small (12 x 768, vocab 50257) with flash attention and bf16
   logits, ``DistributedOptimizer(AdamW)``, parameter broadcast, then 5
   training steps at B=4, S=2048 on seeded synthetic ids. The forward loss
   is first held against the same weights with dense attention; the kernel
   launch counts of the 5 steps must be exactly 12 per kernel per step;
7. the ResNet slice: ResNet-50 with ``fuse_bn_conv_stages=(1,)``,
   ``DistributedOptimizer(SGD(0.01, momentum=0.9))``, 5 steps at B=256,
   224x224 on bench.py's seeded images and labels. The forward loss is
   first held against the unfused ResNet-50 carrying the same weights; the
   5 steps must launch K3 exactly 4 times a step and K4 never; then the
   unfused model takes the same 5 steps for ``fused_bn_delta_ms``;
8. the ``{"kernels": [...]}`` line; then the card line from nvidia-smi and
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
SOURCE = {
    "flash_fwd": "horovod_tpu_torch/csrc/flash_attention.cu",
    "flash_bwd_dkdv": "horovod_tpu_torch/csrc/flash_attention.cu",
    "flash_bwd_dq": "horovod_tpu_torch/csrc/flash_attention.cu",
    "fused_bn_conv_scratch": "horovod_tpu_torch/csrc/fused_bn_conv.cu",
    "fused_bn_conv_revisit": "horovod_tpu_torch/csrc/fused_bn_conv.cu",
}
REPLACES = {
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:66",       # _kernel
    "flash_bwd_dkdv": "horovod_tpu/ops/flash_attention.py:267",  # _dqkv_kernel
    "flash_bwd_dq": "horovod_tpu/ops/flash_attention.py:267",
    # fused_bn_relu_matmul's kernel for accum="scratch" and for "revisit"
    "fused_bn_conv_scratch": "horovod_tpu/ops/fused_bn_conv.py:99",
    "fused_bn_conv_revisit": "horovod_tpu/ops/fused_bn_conv.py:166",
}
B, S, H, D = 4, 2048, 12, 64
STEPS = 5
O_ATOL = 2e-2        # bf16 output: a few ulp at |o| ~ 1
LSE_ATOL = 1e-3      # f32 logsumexp; the two differ in summation order only
GRAD_TOL = 2e-2      # bf16 dq/dk/dv, atol and rtol
LOSS_RTOL = 2e-2     # flash vs dense, fused vs unfused forward loss, bf16 models
# ResNet-50 at B=256, 224x224: (M, Cin, Cout) of the bottleneck's last 1x1
# conv in each stage; stage 3's M = 12,544 is padded to 12,800 by the module.
BN_STAGES = [(802816, 64, 256), (200704, 128, 512), (50176, 256, 1024), (12800, 512, 2048)]
BN_PATH_STAGE = 1
BN_TOL = {"y": (2e-2, 2e-2), "s1": (2e-2, 2.0), "s2": (3e-2, 3.0)}   # (rtol, atol)
RESNET_B, RESNET_HW = 256, 224


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


# Small shapes (B, S, H, D, mask kinds) checked beside the path shape, each
# causal and not: S not a multiple of the kernels' 128-row tiles, D = 64 and
# the D = 128 of gpt2-1p3b.
SMALL = [(2, 200, 2, 64, ("padded",)), (2, 320, 2, 128, (None, "padded"))]


def padded_mask(kind, Bn, Sn, dev):
    """None, or a (B, S) key mask with batch 0 padded after 3/4 of S and
    batch 1 fully masked."""
    if kind is None:
        return None
    mask = torch.ones(Bn, Sn, device=dev)
    mask[0, Sn * 3 // 4:] = 0
    mask[1, :] = 0
    return mask


def rates(rec: dict, prefix: str = "") -> None:
    """Achieved TFLOP/s and the share of the bound from a record's own
    flops, kernel time and bound."""
    ms = rec[f"{prefix}kernel_ms"]
    rec[f"{prefix}tflops"] = rec[f"{prefix}flops"] / (ms * 1e-3) / 1e12
    rec[f"{prefix}bound_share"] = rec[f"{prefix}bound_ms"] / ms


def check_repeat(name: str, first, second) -> bool:
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    return True


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

    rec["bitwise_repeat"] = check_repeat(
        "K1 o, lse", (o, lse), fa.flash_fwd_cuda(q, k, v, None, True))

    for Bn, Sn, Hn, Dn, kinds in SMALL:
        qs, ks, vs = qkv_views(Bn, Sn, Hn, Dn, gen, dev)
        for kind in kinds:
            mask = padded_mask(kind, Bn, Sn, dev)
            for causal in (True, False):
                o_s, lse_s = fa.flash_fwd_cuda(qs, ks, vs, mask, causal)
                o_sr, lse_sr = fa._flash_fwd_plain(qs, ks, vs, mask, causal)
                tag = f"D={Dn} S={Sn} {kind or 'unmasked'} causal={causal}"
                rec[f"o_max_abs_err {tag}"] = check_close(f"K1 o ({tag})", o_s, o_sr, O_ATOL)
                rec[f"lse_max_abs_err {tag}"] = check_close(
                    f"K1 lse ({tag})", lse_s, lse_sr, LSE_ATOL)
                if mask is not None and float(o_s[1].float().abs().max()) != 0.0:
                    raise AssertionError(f"K1 ({tag}): the fully masked sequence is not zero")

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
    rates(rec)
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

    rec["bitwise_repeat"] = check_repeat(
        "K2 dq, dk, dv", (dq, dk, dv),
        (fa.flash_bwd_dq_cuda(q, k, v, None, dout, lse, delta, True),
         *fa.flash_bwd_dkdv_cuda(q, k, v, None, dout, lse, delta, True)))

    for Bn, Sn, Hn, Dn, kinds in SMALL:
        qs, ks, vs = qkv_views(Bn, Sn, Hn, Dn, gen, dev)
        dos = torch.randn(Bn, Sn, Hn, Dn, generator=gen, device=dev).to(torch.bfloat16)
        for kind in kinds:
            mask = padded_mask(kind, Bn, Sn, dev)
            for causal in (True, False):
                o_s, lse_s = fa.flash_fwd_cuda(qs, ks, vs, mask, causal)
                dlt = (dos.float() * o_s.float()).sum(-1).permute(0, 2, 1).contiguous()
                dk_s, dv_s = fa.flash_bwd_dkdv_cuda(qs, ks, vs, mask, dos, lse_s, dlt, causal)
                dq_s = fa.flash_bwd_dq_cuda(qs, ks, vs, mask, dos, lse_s, dlt, causal)
                refs = fa._flash_bwd_plain(qs, ks, vs, mask, dos, causal)
                tag = f"D={Dn} S={Sn} {kind or 'unmasked'} causal={causal}"
                for name, got, want in zip(("dq", "dk", "dv"), (dq_s, dk_s, dv_s), refs):
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
    # The pair as designed (7 tile products: p and dP in both kernels) and
    # the function itself (5 products: S, dP, dV, dK, dQ; q, k, v, dO, lse
    # and delta read once, dq, dk, dv written once).
    rec["pair_kernel_ms"] = rec["dkdv_kernel_ms"] + rec["dq_kernel_ms"]
    rec["pair_flops"] = rec["dkdv_flops"] + rec["dq_flops"]
    rec["pair_bound_ms"] = rec["dkdv_bound_ms"] + rec["dq_bound_ms"]
    rec["function_flops"], rec["function_bytes"] = 10 * D * pairs, 4 * n * 2 + 2 * rows + 3 * n * 2
    rec["function_bound_ms"], rec["function_bound_by"] = bound(rec["function_flops"],
                                                               rec["function_bytes"])
    for prefix in ("dkdv_", "dq_", "pair_"):
        rates(rec, prefix)
    rec["function_tflops"] = rec["function_flops"] / (rec["pair_kernel_ms"] * 1e-3) / 1e12
    rec["function_bound_share"] = rec["function_bound_ms"] / rec["pair_kernel_ms"]
    emit(rec)
    return rec


def bn_inputs(M, cin, cout, gen, dev):
    """x, mu, var, gamma, beta, w drawn as tests/test_fused_bn_conv.py draws
    them: bf16 x and w, f32 per-channel vectors."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    return (randn(M, cin).to(torch.bfloat16), randn(cin) * 0.1, rand(cin) + 0.5,
            rand(cin) + 0.5, randn(cin) * 0.1,
            (randn(cin, cout) / math.sqrt(cin)).to(torch.bfloat16))


def phase_k34(fb, gen, dev):
    """K3 and K4 against the plain version at the four stage shapes, stats
    bitwise-equal over two launches; times at the path shape."""
    rec = {"phase": "k34", "batch": RESNET_B, "image": RESNET_HW,
           "tolerance": {k: {"rtol": r, "atol": a} for k, (r, a) in BN_TOL.items()},
           "shapes": []}
    kernels = {"scratch": fb.fused_bn_conv_scratch_cuda,
               "revisit": fb.fused_bn_conv_revisit_cuda}
    for stage, (M, cin, cout) in enumerate(BN_STAGES):
        args = bn_inputs(M, cin, cout, gen, dev)
        want = fb._reference_bn_relu_matmul(*args)
        row = {"stage": stage, "M": M, "Cin": cin, "Cout": cout}
        for name, fn in kernels.items():
            got = fn(*args)
            again = fn(*args)
            torch.cuda.synchronize()
            for part, g, w in zip(("y", "s1", "s2"), got, want):
                rtol, atol = BN_TOL[part]
                row[f"{name}_{part}_max_abs_err"] = check_close(
                    f"K{3 if name == 'scratch' else 4} {part} (stage {stage})", g, w, atol, rtol)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} (stage {stage}): two launches differ")
            row[f"{name}_bitwise_repeat"] = True
        row["s1_max_abs_ref"] = float(want[1].abs().max())
        row["s2_max_abs_ref"] = float(want[2].abs().max())
        rec["shapes"].append(row)
        if stage == BN_PATH_STAGE:
            for name, fn in kernels.items():
                rec[f"{name}_ms"] = time_ms(lambda: fn(*args), 20)
                rec[f"{name}_max_abs_err"] = row[f"{name}_y_max_abs_err"]
            rec["plain_ms"] = time_ms(lambda: fb._reference_bn_relu_matmul(*args), 5)
            x, mu, var, gamma, beta, w = args
            a = torch.relu((x.float() - mu) * torch.rsqrt(var + 1e-5) * gamma + beta).to(x.dtype)
            # No one PyTorch call computes the fused function; the product
            # alone is the least a library takes for part of it.
            rec["library_ms"] = time_ms(lambda: torch.matmul(a, w), 20)
            rec["library_is"] = "torch.matmul(a, w): the bf16 product alone"
            rec["flops"] = 2 * M * cin * cout
            rec["bytes"] = (M * cin + M * cout + cin * cout) * 2 + 4 * cin * 4 + 2 * cout * 4
            rec["bound_ms"], rec["bound_by"] = bound(rec["flops"], rec["bytes"])
            del a
        del args, want
        torch.cuda.empty_cache()
    emit(rec)
    return rec


def steps(step_fn, state, inputs, labels):
    """STEPS training steps; (state, losses, step ms by host clock)."""
    losses, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, loss = step_fn(state, inputs, labels)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    return state, losses, step_ms


def check_loss(name: str, got: float, want: float):
    if not (math.isfinite(got) and abs(got - want) <= LOSS_RTOL * abs(want)):
        raise AssertionError(f"{name}: forward loss {got} vs {want}")


def phase_slice(fa, fb):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    mesh = create_mesh({"dp": 1})
    spec = get_model("gpt2-small")
    gen = torch.Generator(device=hvd.device()).manual_seed(0)
    model = spec.make_model(device=hvd.device(), generator=gen, attn_impl="flash",
                            logits_dtype=torch.bfloat16, max_len=S)
    cfg = model.cfg
    ids = torch.from_numpy(spec.make_batch(B, seed=42, seq_len=S)[0]).to(hvd.device())

    # The forward loss through the kernels against dense attention on the
    # same weights.
    dense = spec.make_model(device=hvd.device(), attn_impl="dense",
                            logits_dtype=torch.bfloat16, max_len=S)
    dense.load_state_dict(model.state_dict())
    with torch.no_grad():
        loss_flash = float(lm_loss(model(ids), ids))
        loss_dense = float(lm_loss(dense(ids), ids))
    del dense
    check_loss("gpt2-small flash vs dense", loss_flash, loss_dense)

    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8))
    init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh)
    state = init_fn()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()

    fa.reset_launches()
    fb.reset_launches()
    state, losses, step_ms = steps(step_fn, state, ids, ids)
    launches, other = fa.launches(), fb.launches()
    want = cfg.n_layers * STEPS
    if launches != {name: want for name in launches} or any(other.values()):
        raise AssertionError(f"launch counts {launches} {other}, expected {want} "
                             "of each flash kernel and no fused-BN launch")
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


def phase_resnet(fa, fb):
    """ResNet-50 with the stage-1 fused tail: forward loss against the
    unfused model on the same weights, 5 steps through K3, then the unfused
    model's 5 steps from the same weights for fused_bn_delta_ms."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import resnet_unfused_state_dict
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import make_train_step, softmax_xent

    dev = hvd.device()
    mesh = create_mesh({"dp": 1})
    spec = get_model("resnet50")
    # No device argument: make_model builds on hvd.device().
    model = spec.make_model(generator=torch.Generator(device=dev).manual_seed(0),
                            fuse_bn_conv_stages=(1,))
    if next(model.parameters()).device != dev:
        raise AssertionError(f"make_model() built on {next(model.parameters()).device}")
    init_sd = {k: v.clone() for k, v in model.state_dict().items()}
    # bench.py's synthetic batch: numpy seed 42, images then labels.
    rng = np.random.RandomState(42)
    images = torch.from_numpy(
        rng.rand(RESNET_B, RESNET_HW, RESNET_HW, 3).astype(np.float32)).to(dev)
    labels = torch.from_numpy(
        rng.randint(0, 1000, size=(RESNET_B,), dtype=np.int32)).to(dev)

    # Forward loss through K3 against the unfused model on the same weights.
    # The last norm of each block starts at scale 0, which would hide the
    # fused tail's output, so both models get scale 0.25 there for this check.
    unfused = spec.make_model(fuse_bn_conv_stages=())
    check_sd = {k: v.clone() for k, v in init_sd.items()}
    for k, v in check_sd.items():
        if k.endswith("bn3.weight"):
            v.fill_(0.25)
    model.load_state_dict(check_sd)
    unfused.load_state_dict(resnet_unfused_state_dict(check_sd))
    model.train()
    unfused.train()
    fb.reset_launches()
    with torch.no_grad():
        logits_fused, logits_unfused = model(images), unfused(images)
        loss_fused = float(softmax_xent(logits_fused, labels))
        loss_unfused = float(softmax_xent(logits_unfused, labels))
    check_launches = fb.launches()["fused_bn_conv_scratch"]
    if check_launches != 4:
        raise AssertionError(f"the fused forward launched K3 {check_launches} times, not 4")
    check_loss("resnet50 fused vs unfused", loss_fused, loss_unfused)
    logits_diff = max_err(logits_fused, logits_unfused)
    del logits_fused, logits_unfused
    model.load_state_dict(init_sd)
    unfused.load_state_dict(resnet_unfused_state_dict(init_sd))

    def train(net, name):
        opt = hvd.DistributedOptimizer(torch.optim.SGD(net.parameters(), lr=0.01,
                                                       momentum=0.9))
        init_fn, step_fn = make_train_step(net, opt, softmax_xent, mesh=mesh)
        state = init_fn()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        fa.reset_launches()
        fb.reset_launches()
        state, losses, step_ms = steps(step_fn, state, images, labels)
        steady = statistics.median(step_ms[1:])
        return {f"{name}_losses": losses, f"{name}_step_ms": step_ms,
                f"{name}_median_step_ms_2_to_5": steady,
                f"{name}_images_per_s": RESNET_B / (steady / 1e3),
                f"{name}_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}, \
            {**fa.launches(), **fb.launches()}

    del unfused
    rec = {"phase": "resnet", "model": "resnet50", "fuse_bn_conv_stages": [1],
           "batch": RESNET_B, "image": RESNET_HW, "world": hvd.size(), "device": str(dev),
           "loss_fused_fwd": loss_fused, "loss_unfused_fwd": loss_unfused,
           "logits_max_abs_diff_fwd": logits_diff, "k3_launches_fwd": check_launches}
    fused_rec, launches = train(model, "fused")
    want = {name: 0 for name in launches}
    want["fused_bn_conv_scratch"] = 4 * STEPS
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    rec.update(fused_rec, launches=launches,
               launches_per_step={k: v / STEPS for k, v in launches.items()})
    del model
    torch.cuda.empty_cache()

    unfused = spec.make_model(fuse_bn_conv_stages=())
    unfused.load_state_dict(resnet_unfused_state_dict(init_sd))
    unfused_rec, launches = train(unfused, "unfused")
    if any(launches.values()):
        raise AssertionError(f"the unfused model launched kernels: {launches}")
    rec.update(unfused_rec)
    # bench.py's definition: positive = the fused kernel made the step faster.
    rec["fused_bn_delta_ms"] = (rec["unfused_median_step_ms_2_to_5"]
                                - rec["fused_median_step_ms_2_to_5"])
    emit(rec)
    del unfused
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_bn_conv as fb

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
    k34 = phase_k34(fb, gen, dev)

    hvd.init()
    try:
        if hvd.device().type != "cuda":
            raise AssertionError(f"hvd.init() chose {hvd.device()}")
        sl = phase_slice(fa, fb)
        torch.cuda.empty_cache()
        rn = phase_resnet(fa, fb)
    finally:
        hvd.shutdown()

    kernels = [
        {"name": "flash_fwd", "launches": sl["launches"]["flash_fwd"],
         "max_abs_err": k1["o_max_abs_err"], "ms": k1["kernel_ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]},
        {"name": "flash_bwd_dkdv", "launches": sl["launches"]["flash_bwd_dkdv"],
         "max_abs_err": max(k2["dk_max_abs_err"], k2["dv_max_abs_err"]),
         "ms": k2["dkdv_kernel_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["dkdv_bound_ms"], "bound_by": k2["dkdv_bound_by"],
         "library_ms": None, "library_pair_ms": k2["library_pair_ms"]},
        {"name": "flash_bwd_dq", "launches": sl["launches"]["flash_bwd_dq"],
         "max_abs_err": k2["dq_max_abs_err"], "ms": k2["dq_kernel_ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["dq_bound_ms"],
         "bound_by": k2["dq_bound_by"], "library_ms": None,
         "library_pair_ms": k2["library_pair_ms"]},
    ]
    for accum in ("scratch", "revisit"):
        name = f"fused_bn_conv_{accum}"
        kernels.append({"name": name, "launches": rn["launches"][name],
                        "max_abs_err": k34[f"{accum}_max_abs_err"], "ms": k34[f"{accum}_ms"],
                        "plain_ms": k34["plain_ms"], "bound_ms": k34["bound_ms"],
                        "bound_by": k34["bound_by"], "library_ms": k34["library_ms"]})
    for kern in kernels:
        kern.update(route="cuda", source=SOURCE[kern["name"]], replaces=REPLACES[kern["name"]])
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
