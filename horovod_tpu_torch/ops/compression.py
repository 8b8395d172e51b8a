"""Gradient compression (counterpart of ``horovod_tpu/ops/compression.py``;
ref: horovod/torch/compression.py:20-74).

A compressor casts the tensor the collective then carries end to end: the
all-reduce runs in the compressed dtype, and ``decompress`` casts the
result back to the dtype ``compress`` saw. Only floating tensors are cast.
As in the JAX package, ``Compression.fp16`` maps to bfloat16 (the same
bytes as fp16, fp32's exponent range); ``Compression.true_fp16`` keeps
IEEE fp16. ``Compressor`` and ``NoneCompressor`` are the port's own copy
of ``horovod_tpu/common/compression.py:58-80``; the wire codecs there are
not ported.
"""
from __future__ import annotations

import torch

__all__ = ["Compressor", "NoneCompressor", "BF16Compressor", "FP16Compressor",
           "Compression"]


class Compressor:
    """Interface for framework-level gradient compression
    (ref: compression.py:24-35)."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity compressor (ref: compression.py NoneCompressor)."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    """Casts floating tensors to ``wire`` and back."""

    wire: torch.dtype

    @classmethod
    def compress(cls, tensor: torch.Tensor):
        ctx = tensor.dtype
        if tensor.is_floating_point() and tensor.dtype != cls.wire:
            tensor = tensor.to(cls.wire)
        return tensor, ctx

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        return tensor.to(ctx) if ctx is not None and tensor.dtype != ctx else tensor


class BF16Compressor(_CastCompressor):
    """Compress float tensors to bfloat16 for the wire."""

    wire = torch.bfloat16


class FP16Compressor(_CastCompressor):
    """(ref: compression.py FP16Compressor)"""

    wire = torch.float16


class Compression:
    """(ref: compression.py Compression namespace)"""

    none = NoneCompressor
    fp16 = BF16Compressor   # bf16 on the wire, as in the JAX package
    true_fp16 = FP16Compressor
    bf16 = BF16Compressor
