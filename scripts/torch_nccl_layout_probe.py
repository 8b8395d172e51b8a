#!/usr/bin/env python3
"""Time one f32 all-reduce of GPT-2-small's gradient bytes on NCCL across n
cards in two process layouts, and print the transport NCCL chose in each.

    python3 scripts/torch_nccl_layout_probe.py [--cards 4] [--mb 652]

Layouts: ``shared``, every process sees every card and takes cuda:<rank>
(as torchrun and chip_smoke's spawned ranks run), and ``isolated``, each
process sees only its own card through CUDA_VISIBLE_DEVICES (as the
launcher's fake hosts ``card<i>`` run in chip_smoke's ``elastic_multi``).
One JSON line a layout: the median ms of 10 all-reduces by CUDA events
after 3 warm-ups, the algorithm bandwidth, and rank 0's NCCL lines that
name a transport (NCCL_DEBUG=INFO). Needs the cards; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile


def rank_main(args) -> None:
    if args.layout == "isolated":
        os.environ["CUDA_VISIBLE_DEVICES"] = str(args.rank)
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0 if args.layout == "isolated" else args.rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{args.store}", rank=args.rank,
                            world_size=args.cards)
    x = torch.ones(args.mb * 2 ** 20 // 4, device=dev)
    times = []
    for i in range(13):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_reduce(x)
        end.record()
        torch.cuda.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    if args.rank == 0:
        ms = statistics.median(times)
        print(json.dumps({"layout": args.layout, "cards": args.cards, "mb": args.mb,
                          "median_ms": ms, "algbw_gb_s": args.mb * 2 ** 20 / ms / 1e6}),
              flush=True)
    dist.destroy_process_group()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cards", type=int, default=4)
    p.add_argument("--mb", type=int, default=652)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--layout", default=None)
    p.add_argument("--store", default=None)
    args = p.parse_args()
    if args.rank is not None:
        rank_main(args)
        return 0
    for layout in ("shared", "isolated"):
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, NCCL_DEBUG="INFO")
            env.pop("CUDA_VISIBLE_DEVICES", None)
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--cards", str(args.cards), "--mb", str(args.mb),
                 "--rank", str(r), "--layout", layout, "--store", f"{tmp}/store"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(args.cards)]
            outs = [proc.communicate(timeout=300)[0] for proc in procs]
        if any(proc.returncode for proc in procs):
            print(outs[0][-3000:], file=sys.stderr)
            return 1
        lines = outs[0].splitlines()
        rec = json.loads(next(ln for ln in lines if ln.startswith("{")))
        rec["transport"] = sorted({ln.split(" via ", 1)[1].strip() for ln in lines
                                   if " via " in ln})[:6]
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
