"""Flash attention: hand-written CUDA kernels for Hopper, their plain
PyTorch versions, and the ``torch.autograd.Function`` that joins them.

Counterpart of ``horovod_tpu/ops/flash_attention.py``, with the same
(B, S, H, D) layout and semantics: an optional (B, S) key mask (1 = attend,
0 = pad), causal or not, fully masked rows give zeros, and the forward
saves only the output and the per-row logsumexp for the backward.

Kernels (``horovod_tpu_torch/csrc/flash_attention.cu``):

* ``flash_fwd_cuda``   -> K1, replaces the Pallas ``_kernel``;
* ``flash_bwd_dkdv_cuda`` and ``flash_bwd_dq_cuda`` -> K2, replace the
  fused Pallas ``_dqkv_kernel`` with two passes (dK/dV per key tile, dQ per
  query tile), because GPU blocks cannot carry dQ from one block to the next
  as the TPU grid does.

Each wrapper checks what it is given, raises on anything its kernel does
not take, allocates its outputs with ``torch.empty`` and adds one to its
``launches`` count when it launches. The dispatchers take the plain version
only for tensors on the CPU; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference the kernels are
# held against on the card).
def _valid(S: int, mask: Optional[torch.Tensor], causal: bool,
           device) -> Optional[torch.Tensor]:
    """(B or 1, 1, S, S) boolean validity of each (query, key) pair."""
    valid = None
    if causal:
        valid = torch.ones(S, S, dtype=torch.bool, device=device).tril()[None, None]
    if mask is not None:
        km = (mask > 0)[:, None, None, :]
        valid = km if valid is None else valid & km
    return valid


def _flash_fwd_plain(q, k, v, mask=None, causal: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward, materialising the scores: returns (o, lse) with o
    (B, S, H, D) in q.dtype and lse (B, H, S) f32. Same arithmetic as K1
    (f32 scores scaled after the product, -1e30 masking with explicit
    zeroing, p cast to v.dtype before P.V), without the streaming."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = _valid(S, mask, causal, q.device)
    if valid is not None:
        s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    l_safe = p.sum(dim=-1).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = acc / l_safe.permute(0, 2, 1)[..., None]
    lse = m[..., 0] + torch.log(l_safe)
    return o.to(q.dtype), lse


def _flash_bwd_plain(q, k, v, mask, dout, causal: bool):
    """(dq, dk, dv) as autograd of ``_flash_fwd_plain``."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o, _ = _flash_fwd_plain(*qkv, mask, causal)
        return torch.autograd.grad(o, qkv, dout)


# ---------------------------------------------------------------------------
# Kernel wrappers.
def check_tma_layout(x: torch.Tensor, name: str = "x"):
    """(b, s, h) element strides of a (B, S, H, D) view, checked against
    what the kernels' TMA tensor maps read in place: D in
    ``KERNEL_HEAD_DIMS`` and contiguous, a 16-byte-aligned base and (b, s,
    h) strides that are multiples of 16 bytes. Raises ``ValueError``
    otherwise. Takes a tensor on any device."""
    if x.dim() != 4:
        raise ValueError(f"{name}: expected a (B, S, H, D) view, got shape {tuple(x.shape)}")
    D = x.shape[-1]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D}: the kernels are built for {KERNEL_HEAD_DIMS}")
    sb, ss, sh, sd = x.stride()
    if sd != 1:
        raise ValueError(f"{name}: the head dimension must be contiguous, "
                         f"strides {tuple(x.stride())}")
    size = x.element_size()
    if x.data_ptr() % 16 or any((st * size) % 16 for st in (sb, ss, sh)):
        raise ValueError(f"{name}: strides {tuple(x.stride())} ({size}-byte elements) "
                         "and the data pointer must be multiples of 16 bytes")
    return sb, ss, sh


def _check_kernel_inputs(q, k, v, mask):
    B, S, H, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernels take bfloat16, got {t.dtype}")
        if tuple(t.shape) != (B, S, H, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q {tuple(q.shape)}")
    if max(t.storage_offset() + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
           for t in (q, k, v)) >= 2**31:
        raise ValueError("q/k/v span 2**31 elements or more; the kernels index with int32")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        strides.extend(check_tma_layout(t, name))
    if mask is not None:
        if tuple(mask.shape) != (B, S):
            raise ValueError(f"mask has shape {tuple(mask.shape)}, expected {(B, S)}")
        if mask.device != q.device:
            raise ValueError(f"mask is on {mask.device}, q on {q.device}")
        mask = mask.to(torch.float32).contiguous()
    return (B, S, H, D), strides, mask


def _check_rowstats(name: str, t: torch.Tensor, B: int, H: int, S: int, device):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != (B, H, S):
        raise ValueError(f"{name} must be contiguous float32 (B, H, S) = "
                         f"{(B, H, S)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_dout(dout: torch.Tensor, q: torch.Tensor):
    if dout.device != q.device or dout.dtype != torch.bfloat16 \
            or not dout.is_contiguous() or dout.shape != q.shape:
        raise ValueError("dout must be contiguous bfloat16 of q's shape on "
                         f"q's device, got {dout.dtype} {tuple(dout.shape)} "
                         f"contiguous={dout.is_contiguous()} on {dout.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# The entry points' own codes besides cudaError_t (csrc/flash_attention.cu).
_ERRORS = {-1: "head dim not 64 or 128",
           -2: "the driver offers no cuTensorMapEncodeTiled",
           -3: "the driver refused a tensor map"}


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")


def flash_fwd_cuda(q, k, v, mask=None, causal: bool = True):
    """K1: (o, lse) from the forward kernel. q/k/v bf16 (B, S, H, D) on the
    card, read in place; o is contiguous bf16, lse (B, H, S) f32."""
    from ._build import library

    (B, S, H, D), strides, mask = _check_kernel_inputs(q, k, v, mask)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = library()
    err = lib.hvd_flash_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(o), _ptr(lse),
        B, S, H, D, *strides, int(causal), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_fwd")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def flash_bwd_dkdv_cuda(q, k, v, mask, dout, lse, delta, causal: bool = True):
    """K2, first kernel: (dk, dv), contiguous bf16 (B, S, H, D)."""
    from ._build import library

    (B, S, H, D), strides, mask = _check_kernel_inputs(q, k, v, mask)
    _check_dout(dout, q)
    _check_rowstats("lse", lse, B, H, S, q.device)
    _check_rowstats("delta", delta, B, H, S, q.device)
    dk = torch.empty((B, S, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, H, D), dtype=v.dtype, device=q.device)
    err = library().hvd_flash_bwd_dkdv(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(dout), _ptr(lse),
        _ptr(delta), _ptr(dk), _ptr(dv), B, S, H, D, *strides, int(causal),
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_bwd_dkdv")
    flash_bwd_dkdv_cuda.launches += 1
    return dk, dv


flash_bwd_dkdv_cuda.launches = 0


def flash_bwd_dq_cuda(q, k, v, mask, dout, lse, delta, causal: bool = True):
    """K2, second kernel: dq, contiguous bf16 (B, S, H, D)."""
    from ._build import library

    (B, S, H, D), strides, mask = _check_kernel_inputs(q, k, v, mask)
    _check_dout(dout, q)
    _check_rowstats("lse", lse, B, H, S, q.device)
    _check_rowstats("delta", delta, B, H, S, q.device)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    err = library().hvd_flash_bwd_dq(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(dout), _ptr(lse),
        _ptr(delta), _ptr(dq), B, S, H, D, *strides, int(causal),
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_bwd_dq")
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0

KERNELS = (flash_fwd_cuda, flash_bwd_dkdv_cuda, flash_bwd_dq_cuda)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__.removesuffix("_cuda"): fn.launches for fn in KERNELS}


# ---------------------------------------------------------------------------
# Dispatch on where the tensors lie, and the autograd.Function.
def _on_cpu(q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type == "cuda":
        return False
    raise ValueError(f"flash attention runs on cuda or cpu tensors, got {q.device}")


def _flash_fwd(q, k, v, mask, causal: bool):
    if _on_cpu(q):
        return _flash_fwd_plain(q, k, v, mask, causal)
    return flash_fwd_cuda(q, k, v, mask, causal)


def _flash_bwd(q, k, v, mask, o, lse, dout, causal: bool):
    if _on_cpu(q):
        return _flash_bwd_plain(q, k, v, mask, dout, causal)
    dout = dout.contiguous()
    # delta = rowsum(dO * O) in f32, outside the kernels as in the TPU path.
    delta = (dout.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = flash_bwd_dkdv_cuda(q, k, v, mask, dout, lse, delta, causal)
    dq = flash_bwd_dq_cuda(q, k, v, mask, dout, lse, delta, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Forward saves q, k, v, mask, o and lse; backward runs K2. The mask
    gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        o, lse = _flash_fwd(q, k, v, mask, causal)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, mask, o, lse, dout, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                    causal: bool = True) -> torch.Tensor:
    """Fused attention. q/k/v: (B, S, H, D); mask: optional (B, S) key
    validity (1 = attend). Returns (B, S, H, D) in q.dtype. On the card
    the kernels run (bf16, head dim 64 or 128); on the CPU the plain
    version does."""
    return FlashAttention.apply(q, k, v, mask, causal)
