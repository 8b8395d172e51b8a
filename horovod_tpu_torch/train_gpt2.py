"""GPT-2 training across the port's parallel axes (counterpart of
``examples/jax_gpt2_train.py``): any registry GPT-2 size over a pp x dp x
ep x sp x tp mesh, with ring or Ulysses attention, an optional Switch-MoE
FFN, the block stack pipelined over pp (``PipelinedLM``, GPipe), the
layers and the vocabulary cut over tp (``parallel/tensor.py``) and
per-block recomputation (``--remat``).

    torchrun --nproc-per-node 4 -m horovod_tpu_torch.train_gpt2 \\
        --model gpt2-small --seq-len 8192 --batch-size 2 --sp 4 \\
        --attn ulysses --sp-use-flash
    torchrun --nproc-per-node 4 -m horovod_tpu_torch.train_gpt2 \\
        --model gpt2-small --seq-len 2048 --batch-size 4 --ep 4 \\
        --n-experts 8 --attn flash
    torchrun --nproc-per-node 4 -m horovod_tpu_torch.train_gpt2 \\
        --model gpt2-1p3b --seq-len 2048 --batch-size 8 --pp 4 --attn flash
    torchrun --nproc-per-node 4 -m horovod_tpu_torch.train_gpt2 \\
        --model gpt2-1p3b --seq-len 2048 --batch-size 8 --dp 2 --tp 2 \\
        --attn flash --remat
    torchrun --nproc-per-node 4 -m horovod_tpu_torch.train_gpt2 \\
        --model gpt2-1p3b --seq-len 8192 --batch-size 2 --tp 2 --sp 2 \\
        --attn ring --remat
    torchrun --nproc-per-node 4 -m horovod_tpu_torch.train_gpt2 \\
        --model gpt2-1p3b --seq-len 2048 --batch-size 8 --tp 2 --ep 2 \\
        --n-experts 8 --attn flash --remat
    torchrun --nproc-per-node 4 -m horovod_tpu_torch.train_gpt2 \\
        --model gpt2-1p3b --seq-len 2048 --batch-size 8 --pp 2 --tp 2 \\
        --attn flash --remat
    torchrun --nproc-per-node 4 -m horovod_tpu_torch.train_gpt2 \\
        --model gpt2-1p3b --seq-len 8192 --batch-size 2 --pp 2 --sp 2 \\
        --attn ulysses --sp-use-flash --remat

One process per card; ``hvd.init()`` reads torchrun's ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``. ``--batch-size`` is
the global batch, cut over dp (and the sequence over sp); the ids are
seeded synthetic tokens. AdamW as ``optax.adamw(lr)`` (weight decay 1e-4),
bf16 logits, the gradients averaged over the ("dp", "sp") line, and the
MoE auxiliary loss at weight 0.01 when ``--n-experts`` is set, as the JAX
script trains; with ``--pp`` above 1 the layers take the scan-stacked
layout (``scan_layers``) and the model is ``PipelinedLM`` with S
microbatches. tp combines with dp, sp and ep under every ``--attn`` and
with ``--n-experts`` (each expert's d_ff cut over tp; Ulysses needs the
heads a tp rank holds to split over sp), and with pp (each stage's blocks,
the embedding and the head cut over tp, ``PipelinedLM``). pp combines with
sp under every ``--attn`` (each stage's blocks attend over the rank's sp
line) and with ep (a dense model replicated over it), but not with sp and
tp together. ``max_len`` is the larger of the model's and ``--seq-len``,
as the JAX script sets it. Rank 0 prints each step's loss and tokens/s.
``--device cpu`` runs on gloo (the default is the rank's card).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="gpt2-small")
    p.add_argument("--batch-size", type=int, default=8, help="global batch")
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--ep", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--attn", default="dense", choices=["dense", "ring", "ulysses", "flash"])
    p.add_argument("--sp-use-flash", action="store_true",
                   help="Ulysses' per-head-group attention through the flash kernels")
    p.add_argument("--n-experts", type=int, default=0)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--device", default=None, help="cpu, or a card (default: the rank's)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Trains and returns the losses (rank 0 prints them)."""
    args = parse_args(argv)
    import horovod_tpu_torch as hvd
    from .models.pipelined import PipelinedLM
    from .models.registry import get_model
    from .models.transformer import GPT2_CONFIGS
    from .parallel.train import lm_loss, make_train_step

    hvd.init(device=args.device)
    try:
        mesh = hvd.create_mesh({"pp": args.pp, "dp": args.dp, "ep": args.ep,
                                "sp": args.sp, "tp": args.tp})
        spec = get_model(args.model)
        if spec.kind != "lm":
            raise ValueError(f"--model {args.model}: a GPT-2 configuration is needed")
        dev = hvd.device()
        overrides = dict(
            max_len=max(GPT2_CONFIGS[args.model].max_len, args.seq_len), attn_impl=args.attn,
            sp_use_flash=args.sp_use_flash, n_experts=args.n_experts, remat=args.remat,
            scan_layers=args.pp > 1, logits_dtype=torch.bfloat16)
        cfg = dataclasses.replace(GPT2_CONFIGS[args.model], **overrides)
        gen = torch.Generator(device=dev).manual_seed(0)
        if args.pp > 1:
            model = PipelinedLM(cfg, mesh, device=dev, generator=gen)
        else:
            model = spec.make_model(device=dev, generator=gen, mesh=mesh, **overrides)
        ids = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (args.batch_size, args.seq_len), dtype=np.int32))
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4, eps=1e-8),
            axis_name=("dp", "sp"))
        init_fn, step_fn = make_train_step(
            model, opt, lm_loss, mesh=mesh, shard_seq=args.sp > 1,
            moe_aux_weight=0.01 if args.n_experts else 0.0)
        state = init_fn()
        losses = []
        for i in range(args.steps):
            t0 = time.perf_counter()
            state, loss = step_fn(state, ids, ids)
            loss = float(loss)
            losses.append(loss)
            if hvd.rank() == 0:
                toks = args.batch_size * args.seq_len / (time.perf_counter() - t0)
                print(f"step {i}: loss={loss:.4f}  {toks:,.0f} tokens/sec", flush=True)
        return losses
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
