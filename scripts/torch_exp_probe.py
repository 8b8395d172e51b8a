#!/usr/bin/env python3
"""How often PyTorch's CPU ``torch.exp`` comes out inaccurate in a fresh
process, on the case of ``tests/test_torch_port_flash.py::
test_forward_and_lse_match_jax[96-True-None]`` (B=2, S=96, H=2, D=32,
causal, numpy seed 0).

    python scripts/torch_exp_probe.py ab --runs 500 --jobs 6
    python scripts/torch_exp_probe.py steps --runs 600 --jobs 6
    python scripts/torch_exp_probe.py vml
    python scripts/torch_exp_probe.py pytest --runs 200 --jobs 4

Each run is one fresh Python process with ``OMP_NUM_THREADS`` cycling
through 2-5, ``--jobs`` of them at a time, beside ``--burn`` processes of
4-thread matrix products (the load is the point: the fault shows under
it). Modes:

* ``ab``: the port's plain flash forward with its exponentials from
  ``torch.exp`` and from ``torch.exp2`` of log2(e)-scaled differences, in
  turns; a run is off when its o is more than 2e-5 (the test's tolerance)
  from float64.
* ``steps``: the ``torch.exp`` form step by step (scores, row maxima, p,
  row sums, P.V, o), each against float64; a run is off when a step is.
* ``vml``: MKL VML's ``vmsExp``, as linked into ``libtorch_cpu``, in its
  high-accuracy, low-accuracy and enhanced-performance modes under each
  ``MKL_ENABLE_INSTRUCTIONS`` set, on the case's p arguments: the largest
  absolute error of each beside ``torch.exp``'s.
* ``pytest``: the test id itself, alone, once a process.

Prints one JSON object: the runs, those off, and the off runs' records.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import math
import os
import subprocess
import sys

S, B, H, D = 96, 2, 2, 32
TOL = 2e-5
LOG2E = 1.4426950408889634
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_ID = "tests/test_torch_port_flash.py::test_forward_and_lse_match_jax[96-True-None]"


def _case():
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    q, k, v, _ = [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]
    return (q, k, v), [torch.from_numpy(x) for x in (q, k, v)]


def _reference(q, k, v):
    """float64: the scaled scores (masked), row maxima, p, row sums, P.V, o."""
    import numpy as np

    qd, kd, vd = (x.astype(np.float64) for x in (q, k, v))
    tri = np.tril(np.ones((S, S), bool))[None, None]
    s = np.where(tri, np.einsum("bqhd,bkhd->bhqk", qd, kd) / math.sqrt(D), -1e30)
    m = s.max(-1, keepdims=True)
    p = np.where(tri, np.exp(s - m), 0.0)
    l = p.sum(-1)
    acc = np.einsum("bhqk,bkhd->bqhd", p, vd)
    return {"s": s, "m": m, "p": p, "l": l, "acc": acc,
            "o": acc / np.transpose(l, (0, 2, 1))[..., None]}


def _plain(qt, kt, vt, exp: str) -> dict:
    """The port's plain flash forward (``ops/flash_attention.py``
    ``_flash_fwd_plain``, mask-free and causal) with its exponentials from
    ``exp``, every step kept."""
    import torch

    s = torch.einsum("bqhd,bkhd->bhqk", qt, kt) * (1.0 / math.sqrt(D))
    valid = torch.ones(S, S, dtype=torch.bool).tril()[None, None]
    s = s.masked_fill(~valid, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) if exp == "exp" else torch.exp2((s - m) * LOG2E)
    p = p.masked_fill(~valid, 0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, vt)
    return {"s": s, "m": m, "p": p, "l": l, "acc": acc,
            "o": acc / l.permute(0, 2, 1)[..., None]}


def child(mode: str, exp: str) -> dict:
    import numpy as np

    (q, k, v), (qt, kt, vt) = _case()
    got = _plain(qt, kt, vt, exp)
    ref = _reference(q, k, v)
    names = ("s", "m", "p", "l", "acc", "o") if mode == "steps" else ("o",)
    rec = {"exp": exp, "omp": os.environ.get("OMP_NUM_THREADS")}
    off = False
    for name in names:
        err = np.abs(got[name].numpy().astype(np.float64) - ref[name])
        if name == "s":
            err = np.where(ref["s"] > -1e29, err, 0.0)
        rec[name] = float(err.max())
        bad = err > TOL
        if bad.any():
            off = True
            rec[name + "_off"] = int(bad.sum())
            if err.ndim == 4 and name in ("o", "acc"):     # (b, q, h, d)
                rows = np.argwhere(bad)
                rec[name + "_bh"] = sorted({(int(b), int(h)) for b, _, h, _ in rows})
                rec[name + "_q"] = [int(rows[:, 1].min()), int(rows[:, 1].max())]
    rec["off"] = off
    return rec


def _vml() -> dict:
    """``vmsExp`` in each mode beside ``torch.exp``, under this process's
    MKL instruction set."""
    import numpy as np
    import torch

    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cpu.so"))
    fn = lib.vmsExp
    fn.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    torch.set_num_threads(1)
    _, (qt, kt, _) = _case()
    s = torch.einsum("bqhd,bkhd->bhqk", qt, kt) * (1.0 / math.sqrt(D))
    valid = torch.ones(S, S, dtype=torch.bool).tril()[None, None]
    s = s.masked_fill(~valid, -1e30)
    x = (s - s.amax(-1, keepdim=True)).contiguous().numpy()
    ref = np.where(valid.numpy(), np.exp(x.astype(np.float64)), 0.0)
    mine = torch.exp(torch.from_numpy(x)).numpy()
    out = {"isa": os.environ.get("MKL_ENABLE_INSTRUCTIONS", "default"),
           "torch.exp": float(np.abs(np.where(valid.numpy(), mine, 0) - ref).max())}
    for name, mode in (("HA", 0x2), ("LA", 0x1), ("EP", 0x3)):
        y = np.empty_like(x)
        fn(x.size, x.ctypes.data, y.ctypes.data, mode)
        out[name] = float(np.abs(np.where(valid.numpy(), y, 0) - ref).max())
    return out


def _burn() -> None:
    """4-thread float32 matrix products until killed."""
    import torch

    torch.set_num_threads(4)
    a = torch.randn(1024, 1024)
    while True:
        a = (a @ a).tanh_()


def _spawn(args: list, env: dict) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__)] + args, cwd=REPO,
                          env={**os.environ, **env}, capture_output=True, text=True,
                          timeout=600)
    if args[0] == "pytest-child":
        return {"omp": env.get("OMP_NUM_THREADS"), "off": proc.returncode != 0,
                "tail": proc.stdout.strip().splitlines()[-1:] if proc.returncode else []}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("ab", "steps", "vml", "pytest", "child",
                                     "steps-child", "vml-child", "pytest-child",
                                     "burn-child"))
    ap.add_argument("--exp", choices=("exp", "exp2"), default="exp")
    ap.add_argument("--runs", type=int, default=100, help="runs of each variant")
    ap.add_argument("--jobs", type=int, default=6, help="processes at a time")
    ap.add_argument("--burn", type=int, default=2, help="load processes beside them")
    args = ap.parse_args()
    if args.mode == "burn-child":
        _burn()
        return 0
    if args.mode in ("child", "steps-child"):
        print(json.dumps(child("steps" if args.mode == "steps-child" else "ab", args.exp)))
        return 0
    if args.mode == "vml-child":
        print(json.dumps(_vml()))
        return 0
    if args.mode == "pytest-child":
        return subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                               "-p", "no:randomly", TEST_ID], cwd=REPO,
                              env={**os.environ, "JAX_PLATFORMS": "cpu"}).returncode
    if args.mode == "vml":
        print(json.dumps([_spawn(["vml-child"], {"MKL_ENABLE_INSTRUCTIONS": isa} if isa else {})
                          for isa in (None, "AVX512", "AVX2", "SSE4_2")]))
        return 0
    plan = []
    for i in range(args.runs):
        env = {"OMP_NUM_THREADS": str(2 + i % 4)}
        if args.mode == "ab":
            plan += [(["child", "--exp", exp], env) for exp in ("exp", "exp2")]
        elif args.mode == "steps":
            plan.append((["steps-child", "--exp", "exp"], env))
        else:
            plan.append((["pytest-child"], env))
    burners = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "burn-child"])
               for _ in range(args.burn)]
    try:
        with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
            recs = list(pool.map(lambda a: _spawn(*a), plan))
    finally:
        for proc in burners:
            proc.kill()
            proc.wait()
    out = {"mode": args.mode, "jobs": args.jobs, "burn": args.burn}
    for key in sorted({r.get("exp", "pytest") for r in recs}):
        mine = [r for r in recs if r.get("exp", "pytest") == key]
        out[key] = {"runs": len(mine), "off": sum(r["off"] for r in mine),
                    "off_runs": [r for r in mine if r["off"]][:8]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
