"""Where the time of a training step goes on the card.

    python -m horovod_tpu_torch.profile_step
        [--model gpt2-small|resnet50|bert-base|vit-l16] [--steps 3] [--out PATH]
        [--zero 0|1|2] [--no-overlap]
        [--attn flash|dense|ring|ulysses] [--sp-use-flash] [--sp N]
        [--n-experts E] [--ep N] [--seq S] [--pp N] [--microbatches M] [--tp N]
        [--remat] [--fsdp]

Builds a slice that ``chip_smoke.py`` drives on one card: GPT-2-small (B=4,
S=2048, bf16 logits, ``DistributedOptimizer(AdamW)``), run with
``attn_impl`` = flash and dense; ResNet-50 (B=256, 224x224,
``DistributedOptimizer(SGD(0.01, momentum=0.9))``), run with
``fuse_bn_conv_stages`` = (1,) and (); or BERT-base (B=256, S=128, bf16
logits, the key padding mask of chip_smoke's BERT phase, gradients from
``distributed_value_and_grad(..., compression=Compression.fp16)``, a plain
AdamW step), run with ``attn_impl`` = flash and dense; or ViT-L/16 (B=32 a
card over dp, 224x224, dense attention as the JAX ViT runs,
``make_train_step`` with SGD(0.01, momentum=0.9), bench.py's seeded images
and labels), run once ("dense"). For each variant it
warms up, times
``--steps`` steps by host clock around ``torch.cuda.synchronize()``, and
traces the same number of steps with ``torch.profiler`` to sum device time
by kernel. Prints one JSON line per variant: step ms, tokens or images per
second, device busy ms per step and the idle share against the untraced
step, and device ms per step by kernel class (the port's own kernels,
matrix products, convolutions, NCCL, everything else) and for the top
kernels. Needs a CUDA card.

``--zero`` (GPT-2 only) runs the flash variant alone with
``DistributedOptimizer(zero=Z)`` (0: the replicated optimizer, overlapped
with backward; with ``--no-overlap`` the after-backward reference, one
grouped all-reduce in ``step()``) and splits the step's device time
further by the ranges the optimizer marks: the flatten copies into the
flat or bucket buffers (``hvd.flatten``), the unflatten copies out of them
(``hvd.unflatten``) and the inner optimizer's step (``Optimizer.step``);
NCCL is its kernel class. Run once per rank (``HOROVOD_RANK``,
``HOROVOD_SIZE``, ``HOROVOD_INIT_METHOD``), it profiles each rank of a
world of several cards, GPT-2 at B=4 a rank.

``--attn``, ``--sp``, ``--n-experts`` and ``--seq`` (GPT-2 only) profile
one variant of the sequence- and expert-parallel path: the attention
(``ulysses`` runs its per-head-group attention through flash with
``--sp-use-flash``, dense attention without), a mesh of
dp x sp over the world (``shard_seq`` where sp > 1, the gradients averaged
over the ("dp", "sp") line), E Switch experts in every other FFN
(capacity factor 1.25, auxiliary loss at 0.01) and S tokens a sequence.
The device time is then split further by the ranges the MoE FFN and the
sp/ep collectives mark: ``hvd.moe.router``, ``hvd.moe.dispatch`` (the
index scatter and the (dp, sp) all-reduce), ``hvd.moe.experts``,
``hvd.moe.combine`` (forward only: their backward kernels run outside
the ranges), ``hvd.sp.*`` and ``hvd.ep.*`` (forward and, with ``.bwd``,
backward).

``--model gpt2-1p3b`` (flash, B=8 over the dp ranks, S=2048, AdamW, the
pipeline slice of ``chip_smoke.py``) takes ``--pp N`` (a pp x dp mesh over
the world, ``PipelinedLM`` with S microbatches) and ``--remat`` (each
block recomputed in backward; ``--remat`` applies to gpt2-small too). The
device time is split further by the pipeline's ranges: ``hvd.pp.send``,
``hvd.pp.recv`` (forward activations and backward cotangents between
stages), ``hvd.pp.replicate`` (the last stage's output to every pp rank)
and ``hvd.pp.psum`` (the input's cotangent summed over pp). It also takes
``--tp N`` (a dp x tp mesh over the world, ``TransformerLM`` with its
heads, FFN and vocabulary cut over tp), splitting the step further by the
tensor-parallel ranges: ``hvd.tp.psum`` (the row-parallel partial
products summed), ``hvd.tp.pvary.bwd`` (the column-parallel input
gradients summed, in backward), ``hvd.tp.embed_sum`` (the vocab-parallel
lookup) and ``hvd.tp.xent`` (the vocab-parallel loss's forward, its max
and sums over tp). ``--zero Z`` takes it too (ZeRO over the ("dp", "sp")
line, the layout of ``make_train_step(zero=True)``), and ``--fsdp`` builds
it under ``FSDP_RULES`` (every d_model dimension cut over dp), splitting
the step further by ``hvd.fsdp.all_gather`` (each parameter gathered at its
use, again in backward under remat) and ``hvd.fsdp.all_gather.bwd`` (its
gradient reduce-scattered). ``--fsdp`` combines with ``--sp``, ``--attn``
and ``--seq`` (FSDP x sp: ``--model gpt2-1p3b --fsdp --sp 2 --attn ulysses
--sp-use-flash --seq 8192 --remat``, a dp x sp mesh over the world whose
cut parameters are replicated over sp), and the step splits by the
``hvd.fsdp.*`` and the ``hvd.sp.*`` ranges together, where
``hvd.fsdp.rest_allreduce`` is the cut gradients' sum over the sp line
(the optimizer's buckets of them). ``--fsdp`` combines with ``--n-experts`` and
``--ep`` too (FSDP with Switch experts: ``--model gpt2-1p3b --fsdp
--n-experts 8 --ep 2 --remat``, a dp x ep mesh over the world, the router
and each rank's experts cut over dp beside the dense parameters), where
``hvd.fsdp.all_gather`` gathers the experts too. ``--tp`` combines with ``--sp``, ``--attn``
and ``--seq`` (tp x sp: ``--model gpt2-1p3b --tp 2 --sp 2 --attn ring
--seq 8192 --remat``, the layout of ``examples/jax_gpt2_train.py:9-11``
cut to one node); at ``--seq`` above 2048 the global batch shrinks to keep
its 16,384 tokens (B=2 at S=8192), and the step splits by the ``hvd.tp.*``
and the ``hvd.sp.*`` ranges together. ``--n-experts`` and ``--ep N`` (the
ep axis's size; tokens replicated over it) profile either model with
Switch experts, with ``--tp`` too (``--model gpt2-1p3b --n-experts 8 --tp 2
--ep 2 --remat``: each expert's d_ff cut over tp): ``hvd.tp.expert_psum``
is the experts' partial outputs summed over tp, ``hvd.ep.psum`` the
combine's sum over ep, ``hvd.ep.pvary.bwd`` the tokens' cotangent summed
over ep and tp and the gate's over ep. ``--pp`` combines with ``--tp``
(``--model gpt2-1p3b --pp 2 --tp 2 --microbatches 8 --remat``: a pp x dp x
tp mesh over the world, ``PipelinedLM`` whose stages, embedding and head
are cut over tp, with ``--microbatches`` M, by default S), and the step
splits by the ``hvd.pp.*`` and the ``hvd.tp.*`` ranges together. ``--pp``
combines with ``--sp``, ``--attn`` and ``--seq`` too (``--model gpt2-1p3b
--pp 2 --sp 2 --attn ulysses --sp-use-flash --seq 8192 --remat``: a pp x dp
x sp mesh, each stage's blocks attending over the rank's sp line, B=2 in
M = S microbatches of one sequence), and the step splits by the
``hvd.pp.*`` and the ``hvd.sp.*`` ranges together.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Optional

import torch

import numpy as np

B, S = 4, 2048
B_1P3B = 8           # the global batch of the pipeline slice
RESNET_B, RESNET_HW = 256, 224
VIT_B = 32           # a card's batch (examples/jax_synthetic_benchmark.py's default)
BERT_B, BERT_S, BERT_MIN_LEN = 256, 128, 64
VARIANTS = {"gpt2-small": ("flash", "dense"), "gpt2-1p3b": ("flash",),
            "resnet50": ("fused", "unfused"), "bert-base": ("flash", "dense"),
            "vit-l16": ("dense",)}
RANGES = ("hvd.flatten", "hvd.unflatten", "Optimizer.step", "hvd.moe.", "hvd.sp.",
          "hvd.ep.", "hvd.pp.", "hvd.tp.", "hvd.fsdp.")


def _classify(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name or "flash_bwd_" in name:
        return "flash_kernels"
    if "fused_bn_conv" in name or "stats_reduce_kernel" in name:
        return "fused_bn_kernels"
    if any(t in low for t in ("conv", "fprop", "dgrad", "wgrad")):
        return "conv"
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


def _build(model_name: str, variant: str, dev, opt_kw=None, sp: int = 1,
           n_experts: int = 0, seq: int = S, pp: int = 1, remat: bool = False,
           tp: int = 1, fsdp: bool = False, sp_use_flash: bool = False, ep: int = 1,
           microbatches: Optional[int] = None):
    """(step_fn, state, inputs, labels, items per step, item name)."""
    import dataclasses

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.pipelined import PipelinedLM
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.models.transformer import GPT2_CONFIGS
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel import train
    from horovod_tpu_torch.parallel.sharding import DEFAULT_RULES, FSDP_RULES

    spec = get_model(model_name)
    gen = torch.Generator(device=dev).manual_seed(0)
    if model_name.startswith("gpt2"):
        dp = hvd.size() // (sp * pp * tp * ep)
        mesh = create_mesh({"pp": pp, "dp": dp, "ep": ep, "sp": sp, "tp": tp})
        overrides = dict(attn_impl=variant, sp_use_flash=sp_use_flash,
                         n_experts=n_experts, logits_dtype=torch.bfloat16,
                         max_len=max(GPT2_CONFIGS[model_name].max_len, seq), remat=remat,
                         scan_layers=pp > 1)
        if pp > 1:
            model = PipelinedLM(dataclasses.replace(GPT2_CONFIGS[model_name], **overrides),
                                mesh, num_microbatches=microbatches, device=dev, generator=gen)
        else:
            model = spec.make_model(device=dev, generator=gen, mesh=mesh,
                                    rules=FSDP_RULES if fsdp else DEFAULT_RULES, **overrides)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8),
            axis_name=("dp", "sp"), **(opt_kw or {}))
        # gpt2-small: B a dp rank, the global batch grows with dp (weak
        # scaling); gpt2-1p3b: the pipeline slice's 16,384 tokens a step.
        batch = max(1, B_1P3B * S // seq) if model_name == "gpt2-1p3b" else B * dp
        ids = torch.from_numpy(spec.make_batch(batch, seed=42, seq_len=seq)[0]).to(dev)
        init_fn, step_fn = train.make_train_step(
            model, opt, train.lm_loss, mesh=mesh, shard_seq=sp > 1,
            moe_aux_weight=0.01 if n_experts else 0.0)
        return step_fn, init_fn(), ids, ids, batch // dp * seq // sp, "tokens"
    mesh = create_mesh({"dp": hvd.size()})
    if model_name == "bert-base":
        return _build_bert(spec, variant, dev, gen)
    if model_name.startswith("vit"):
        model = spec.make_model(device=dev, generator=gen, mesh=mesh)
        batch = VIT_B * hvd.size()
    else:
        model = spec.make_model(device=dev, generator=gen,
                                fuse_bn_conv_stages=(1,) if variant == "fused" else ())
        batch = RESNET_B
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.01,
                                                   momentum=0.9))
    rng = np.random.RandomState(42)   # bench.py's synthetic batch
    images = torch.from_numpy(
        rng.rand(batch, RESNET_HW, RESNET_HW, 3).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.randint(0, 1000, size=(batch,), dtype=np.int32)).to(dev)
    init_fn, step_fn = train.make_train_step(model, opt, train.softmax_xent, mesh=mesh)
    return step_fn, init_fn(), images, labels, batch // hvd.size(), "images"


def _build_bert(spec, variant: str, dev, gen):
    """BERT-base trained through ``distributed_value_and_grad`` with fp16
    (bf16) compression under chip_smoke's padding mask: sequence b attends
    to its first L_b tokens, L_b uniform in [64, 128] from numpy seed 42."""
    from torch.func import functional_call

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.train import lm_loss

    model = spec.make_model(device=dev, generator=gen, attn_impl=variant,
                            logits_dtype=torch.bfloat16)
    ids = torch.from_numpy(spec.make_batch(BERT_B, seed=42, seq_len=BERT_S)[0]).to(dev)
    lengths = np.random.RandomState(42).randint(BERT_MIN_LEN, BERT_S + 1, size=BERT_B)
    mask = torch.from_numpy(
        (np.arange(BERT_S)[None, :] < lengths[:, None]).astype(np.int32)).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
    value_and_grad = hvd.distributed_value_and_grad(
        lambda p, x, m: lm_loss(functional_call(model, p, (x, m)), x),
        compression=hvd.Compression.fp16)

    def step_fn(state, inputs, labels):
        loss, grads = value_and_grad(dict(model.named_parameters()), inputs, mask)
        for name, p in model.named_parameters():
            p.grad = grads[name]
        opt.step()
        return state, loss

    return step_fn, None, ids, ids, BERT_B * BERT_S, "tokens"


def _range_ms(prof, steps: int) -> dict:
    """Device ms per step under each range the optimizer marks, two ways:
    ``kernels`` sums the device time of the kernels launched inside the
    range (its host-side row), ``span`` is the range's own row on the
    device (first kernel start to last kernel end)."""
    out = {}
    for evt in prof.key_averages():
        if not evt.key.startswith(RANGES):
            continue
        side = "span" if evt.device_type == torch.autograd.DeviceType.CUDA else "kernels"
        attrs = (("self_device_time_total", "self_cuda_time_total") if side == "span"
                 else ("device_time_total", "cuda_time_total"))
        us = next((float(getattr(evt, a)) for a in attrs
                   if getattr(evt, a, None) is not None), 0.0)
        row = out.setdefault(evt.key.split("#")[0], {"kernels": 0.0, "span": 0.0})
        row[side] += us / 1e3 / steps
    return out or "not measured"


def profile(model_name: str, variant: str, steps: int, opt_kw=None, **shape) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    import horovod_tpu_torch as hvd

    step_fn, state, inputs, labels, items, unit = _build(model_name, variant, hvd.device(),
                                                         opt_kw, **shape)
    for _ in range(2):
        state, loss = step_fn(state, inputs, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = step_fn(state, inputs, labels)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = step_fn(state, inputs, labels)
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
        "model": model_name, "variant": variant, "steps": steps,
        "step_ms": times, "median_step_ms": median,
        f"{unit}_per_step": items, f"{unit}_per_s": items / (median / 1e3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss": float(loss),
        "traced_ms_per_step": traced_ms / steps,
        "device_busy_ms_per_step": busy_ms if by_kernel else "not measured",
        # Against the untraced step: tracing adds host time per launch.
        "device_idle_share": (1 - busy_ms / median) if by_kernel else "not measured",
        "device_ms_per_step_by_class": classes,
        "device_ms_per_step_by_range": _range_ms(prof, steps),
        "top_kernels_ms_per_step": [[name[:90], us / 1e3 / steps] for name, us in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(VARIANTS), default="gpt2-small")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--zero", type=int, choices=(0, 1, 2), default=None,
                    help="GPT-2 only: the flash variant with DistributedOptimizer(zero=Z)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="with --zero 0: the all-reduce after backward")
    ap.add_argument("--attn", choices=("flash", "dense", "ring", "ulysses"), default=None,
                    help="GPT-2 only: this attention alone")
    ap.add_argument("--sp-use-flash", action="store_true",
                    help="with --attn ulysses: its per-head-group attention through flash")
    ap.add_argument("--sp", type=int, default=1, help="GPT-2 only: the sp axis's size")
    ap.add_argument("--n-experts", type=int, default=0,
                    help="GPT-2 only: Switch experts in every other FFN")
    ap.add_argument("--ep", type=int, default=1,
                    help="GPT-2 only, with --n-experts: the ep axis's size")
    ap.add_argument("--seq", type=int, default=S, help="GPT-2 only: tokens a sequence")
    ap.add_argument("--pp", type=int, default=1,
                    help="gpt2-1p3b only: pipeline stages (PipelinedLM)")
    ap.add_argument("--tp", type=int, default=1,
                    help="gpt2-1p3b only: the tp axis's size")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="with --pp: GPipe's microbatches (default: the stages)")
    ap.add_argument("--remat", action="store_true",
                    help="GPT-2 only: recompute each block in backward")
    ap.add_argument("--fsdp", action="store_true",
                    help="gpt2-1p3b only: the model under FSDP_RULES")
    args = ap.parse_args()
    if not args.model.startswith("gpt2") and (args.attn or args.sp > 1 or args.seq != S):
        ap.error("--attn, --sp and --seq profile GPT-2")
    if (args.n_experts or args.ep > 1) and not args.model.startswith("gpt2"):
        ap.error("--n-experts and --ep profile GPT-2")
    if args.ep > 1 and not args.n_experts:
        ap.error("--ep needs --n-experts")
    if args.zero is not None and not args.model.startswith("gpt2"):
        ap.error("--zero profiles GPT-2")
    if (args.pp > 1 or args.tp > 1 or args.fsdp) and args.model != "gpt2-1p3b":
        ap.error("--pp, --tp and --fsdp profile gpt2-1p3b")
    if args.microbatches is not None and args.pp == 1:
        ap.error("--microbatches needs --pp")
    if args.fsdp and (args.pp > 1 or args.zero):
        ap.error("--fsdp does not combine with --pp or --zero")
    if args.remat and not args.model.startswith("gpt2"):
        ap.error("--remat profiles GPT-2")
    variants, opt_kw = VARIANTS[args.model], None
    shape = ({"sp": args.sp, "n_experts": args.n_experts, "seq": args.seq,
              "pp": args.pp, "tp": args.tp, "remat": args.remat, "fsdp": args.fsdp,
              "sp_use_flash": args.sp_use_flash, "ep": args.ep,
              "microbatches": args.microbatches}
             if args.model.startswith("gpt2") else {})
    if args.attn:
        variants = (args.attn,)
    if args.zero is not None:
        variants = ("flash",)
        opt_kw = {"zero": args.zero}
        if args.no_overlap:
            opt_kw["_schedule"] = "grouped"
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
        for variant in variants:
            rec = profile(args.model, variant, args.steps, opt_kw, **shape)
            rec.update(card=card, **shape)
            if opt_kw is not None:
                rec.update(world=hvd.size(), optimizer=opt_kw)
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
