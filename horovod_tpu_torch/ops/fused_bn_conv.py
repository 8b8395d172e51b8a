"""Fused BatchNorm-apply + ReLU + 1x1-conv + output-stats: hand-written CUDA
kernels for Hopper, their plain PyTorch version, and the
``torch.autograd.Function`` that joins them.

Counterpart of ``horovod_tpu/ops/fused_bn_conv.py``, with the same
contract: ``fused_bn_relu_matmul(x, mu, var, gamma, beta, w)`` takes the raw
(pre-BN) activation x (M, Cin), the per-channel batch statistics and affine
parameters (Cin,) f32 and the 1x1-conv kernel w (Cin, Cout), and returns
``(y, sum(y, 0), sum(y * y, 0))`` with y = relu((x - mu) * rsqrt(var + eps)
* gamma + beta) @ w in x.dtype and the two sums in f32, taken from the f32
product before y is rounded. M and Cout must divide by the (clamped) block
sizes, as in the JAX function; the CUDA tiles themselves are internal.

Kernels (``horovod_tpu_torch/csrc/fused_bn_conv.cu``):

* ``fused_bn_conv_scratch_cuda`` -> K3, replaces the Pallas kernel of
  ``fused_bn_relu_matmul(accum="scratch")``: x-stationary: one persistent
  block per SM walks its row tiles, normalises each once in shared memory
  and sweeps every Cout tile of w;
* ``fused_bn_conv_revisit_cuda`` -> K4, replaces the ``accum="revisit"``
  kernel: w-stationary: each persistent block holds one 128-column tile of
  w and walks its partition of the row tiles, re-reading x once per Cout
  tile (the blocks of a partition walk together, so L2 can serve it).

Both are Hopper-only (TMA, wgmma), take bf16 x and w only, Cin a multiple
of 64 up to 512 and Cout a multiple of 8, and give the same y; their stats
are reduced in a fixed order (no atomics), so two launches give
bitwise-equal s1/s2. Each wrapper checks what it is given,
raises on anything its kernel does not take, and adds one to its
``launches`` count when it launches. The dispatcher takes the plain
version only for tensors on the CPU; a CUDA tensor launches a kernel or
raises.
"""
from __future__ import annotations

import torch

KERNEL_MAX_CIN = 512      # K3's x tile and K4's w tile live in shared memory
KERNEL_CIN_STEP = 64      # the kernels read x and w in boxes of 64 columns
KERNEL_COUT_STEP = 8      # their tensor maps need 16-byte row strides


# ---------------------------------------------------------------------------
# The plain PyTorch version (the CPU path, the reference the kernels are held
# against on the card, and what the backward differentiates).
def _reference_bn_relu_matmul(x, mu, var, gamma, beta, w, eps: float = 1e-5):
    """Unfused composition, the arithmetic of the JAX reference: normalise
    in f32, cast ``a`` to x.dtype, accumulate the product in f32, take the
    stats from the f32 ``y``, cast ``y`` to x.dtype."""
    xf = x.float()
    xhat = (xf - mu) * torch.rsqrt(var + eps)
    a = torch.relu(xhat * gamma + beta).to(x.dtype)
    y = a.float() @ w.float()
    return y.to(x.dtype), y.sum(0), (y * y).sum(0)


# ---------------------------------------------------------------------------
# Kernel wrappers.
def _check_kernel_inputs(x, mu, var, gamma, beta, w):
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    M, Cin = x.shape
    if w.dim() != 2 or w.shape[0] != Cin:
        raise ValueError(f"w has shape {tuple(w.shape)}, expected ({Cin}, Cout)")
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the fused BN kernels take bfloat16, got "
                            f"{t.dtype} (float32 runs only on the CPU)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in (("mu", mu), ("var", var), ("gamma", gamma), ("beta", beta)):
        if t.device != x.device or t.dtype != torch.float32 \
                or tuple(t.shape) != (Cin,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 ({Cin},) on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    Cout = w.shape[1]
    if M * max(Cin, Cout) >= 2**31:
        raise ValueError("x or y spans 2**31 elements or more; the kernels "
                         "index rows with int32")
    return M, Cin, Cout


def _check_kernel_shape(kernel: str, M: int, Cin: int, Cout: int) -> None:
    """The shape rules of K3 and K4 (their C entry points refuse the same
    shapes); ``kernel`` names the kernel in the message."""
    if M <= 0:
        raise ValueError(f"M={M}: {kernel} needs at least one row")
    if Cin % KERNEL_CIN_STEP or not 0 < Cin <= KERNEL_MAX_CIN:
        raise ValueError(f"Cin={Cin}: {kernel} takes a multiple of {KERNEL_CIN_STEP} "
                         f"up to {KERNEL_MAX_CIN}")
    if Cout % KERNEL_COUT_STEP or Cout <= 0:
        raise ValueError(f"Cout={Cout}: {kernel} takes a positive multiple of "
                         f"{KERNEL_COUT_STEP}")


def _launch(entry: str, kernel: str, x, mu, var, gamma, beta, w, eps: float):
    from ._build import library

    M, Cin, Cout = _check_kernel_inputs(x, mu, var, gamma, beta, w)
    _check_kernel_shape(kernel, M, Cin, Cout)
    lib = library()
    parts = getattr(lib, entry + "_parts")(M, Cout)
    y = torch.empty((M, Cout), dtype=x.dtype, device=x.device)
    s = torch.empty((2, Cout), dtype=torch.float32, device=x.device)
    ws = torch.empty((2, parts, Cout), dtype=torch.float32, device=x.device)
    err = getattr(lib, entry)(
        x.data_ptr(), mu.data_ptr(), var.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), w.data_ptr(), y.data_ptr(), s.data_ptr(),
        ws.data_ptr(), M, Cin, Cout, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: launch failed with error {err}")
    return y, s[0], s[1]


def fused_bn_conv_scratch_cuda(x, mu, var, gamma, beta, w, eps: float = 1e-5):
    """K3: (y, s1, s2) from the x-stationary kernel."""
    out = _launch("hvd_fused_bn_conv_scratch", "K3",
                  x, mu, var, gamma, beta, w, eps)
    fused_bn_conv_scratch_cuda.launches += 1
    return out


fused_bn_conv_scratch_cuda.launches = 0


def fused_bn_conv_revisit_cuda(x, mu, var, gamma, beta, w, eps: float = 1e-5):
    """K4: (y, s1, s2) from the w-stationary kernel."""
    out = _launch("hvd_fused_bn_conv_revisit", "K4",
                  x, mu, var, gamma, beta, w, eps)
    fused_bn_conv_revisit_cuda.launches += 1
    return out


fused_bn_conv_revisit_cuda.launches = 0

KERNELS = (fused_bn_conv_scratch_cuda, fused_bn_conv_revisit_cuda)
_BY_ACCUM = {"scratch": fused_bn_conv_scratch_cuda,
             "revisit": fused_bn_conv_revisit_cuda}


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__.removesuffix("_cuda"): fn.launches for fn in KERNELS}


# ---------------------------------------------------------------------------
# Dispatch on where the tensors lie, and the autograd.Function.
def fused_bn_relu_matmul(x, mu, var, gamma, beta, w, *, eps: float = 1e-5,
                         block_m: int = 512, block_n: int = 256,
                         accum: str = "scratch"):
    """Returns (y, sum(y, 0), sum(y*y, 0)) with y = relu(bn(x)) @ w.

    M and Cout must be multiples of the block sizes (clamped to M and
    Cout), as in the JAX function. ``accum`` picks the kernel on the card:
    "scratch" (K3, x read once) or "revisit" (K4, x re-read per Cout tile);
    both compute the same function."""
    if accum not in _BY_ACCUM:
        raise ValueError(f"accum={accum!r}: expected 'scratch' or 'revisit'")
    M, Cin = x.shape
    Cout = w.shape[1]
    block_m = min(block_m, M)
    block_n = min(block_n, Cout)
    if M % block_m or Cout % block_n:
        raise ValueError(f"M={M} / Cout={Cout} not divisible by blocks "
                         f"({block_m}, {block_n})")
    if x.device.type == "cpu":
        return _reference_bn_relu_matmul(x, mu, var, gamma, beta, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"the fused BN kernels run on cuda or cpu tensors, got {x.device}")
    return _BY_ACCUM[accum](x, mu, var, gamma, beta, w, eps)


class BNReluConv1x1(torch.autograd.Function):
    """Forward: the kernel (K3 on the card). Backward: autograd of the plain
    composition with respect to all six inputs, as the JAX custom_vjp."""

    @staticmethod
    def forward(ctx, x, mu, var, gamma, beta, w, eps):
        ctx.save_for_backward(x, mu, var, gamma, beta, w)
        ctx.eps = eps
        return fused_bn_relu_matmul(x, mu, var, gamma, beta, w, eps=eps)

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            outs = _reference_bn_relu_matmul(*leaves, ctx.eps)
            grads = torch.autograd.grad(outs, leaves, (dy, ds1, ds2))
        return (*grads, None)


def bn_relu_conv1x1(x, mu, var, gamma, beta, w, eps: float = 1e-5):
    """Differentiable fused op: (y, s1, s2) as ``fused_bn_relu_matmul``."""
    return BNReluConv1x1.apply(x, mu, var, gamma, beta, w, eps)
