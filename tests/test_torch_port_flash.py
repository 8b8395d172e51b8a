"""The port's flash attention (horovod_tpu_torch.ops.flash_attention) against
the JAX package's Pallas kernel, run in interpret mode as the JAX tests run
it on the CPU. On the CPU the port's wrapper takes the plain PyTorch
version, through the same autograd.Function the card uses.

Tolerances: o and lse 2e-5 (the JAX flash tests' own, f32); gradients 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd
from horovod_tpu.ops.flash_attention import flash_attention as jax_flash
from horovod_tpu_torch.ops import flash_attention as fa

B, H, D = 2, 2, 32
FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(S, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _mask(S, kind):
    if kind is None:
        return None
    m = np.ones((B, S), np.float32)
    if kind == "padded":
        m[0, S - 20:] = 0.0
        m[1, 10:] = 0.0
    else:  # "full": the second sequence is all padding
        m[1, :] = 0.0
    return m


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("mask_kind", [None, "padded"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [64, 96])   # 96: a ragged edge for block_q=64
def test_forward_and_lse_match_jax(S, causal, mask_kind):
    q, k, v, _ = _inputs(S)
    mask = _mask(S, mask_kind)
    o_j, lse_j = jax_flash_fwd(_j(q), _j(k), _j(v), _j(mask), causal, 64, True)
    o_t, lse_t = fa._flash_fwd(_t(q), _t(k), _t(v), _t(mask), causal)
    assert lse_t.shape == (B, H, S) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j).reshape(B, H, S),
                               rtol=FWD_TOL, atol=FWD_TOL)
    got = fa.flash_attention(_t(q), _t(k), _t(v), _t(mask), causal=causal)
    want = jax_flash(_j(q), _j(k), _j(v), _j(mask), causal=causal, block_q=64,
                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_fully_masked_sequence_gives_zero_rows(causal):
    q, k, v, _ = _inputs(64)
    mask = _mask(64, "full")
    o_t, lse_t = fa._flash_fwd(_t(q), _t(k), _t(v), _t(mask), causal)
    o_j, lse_j = jax_flash_fwd(_j(q), _j(k), _j(v), _j(mask), causal, 64, True)
    assert np.all(o_t[1].numpy() == 0.0)
    assert np.isfinite(o_t.numpy()).all()
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j).reshape(B, H, 64),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("mask_kind", [None, "padded", "full"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [64, 96])
def test_gradients_match_jax(S, causal, mask_kind):
    q, k, v, g = _inputs(S, seed=1)
    mask = _mask(S, mask_kind)

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, _j(mask), causal=causal, block_q=64,
                         interpret=True)

    _, vjp = jax.vjp(f, _j(q), _j(k), _j(v))
    want = vjp(jnp.asarray(g))

    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    mt = _t(mask)
    out = fa.flash_attention(qt, kt, vt, mt, causal=causal)
    out.backward(torch.from_numpy(g))
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_mask_gets_no_gradient_and_kernels_do_not_launch_on_cpu():
    q, k, v, g = _inputs(64, seed=2)
    mask = torch.from_numpy(_mask(64, "padded")).requires_grad_(True)
    fa.reset_launches()
    qt = torch.from_numpy(q).requires_grad_(True)
    out = fa.flash_attention(qt, _t(k), _t(v), mask, causal=True)
    out.backward(torch.from_numpy(g))
    assert mask.grad is None and qt.grad is not None
    assert fa.launches() == {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}


def test_tma_layout_accepts_the_models_qkv_views():
    """q, k, v as models/transformer.py makes them: unbound views of the
    (B, S, 3, H, D) projection, read in place by the tensor maps."""
    for D in (64, 128):
        qkv = torch.zeros(2, 96, 3, 4, D, dtype=torch.bfloat16)
        for t in qkv.unbind(dim=2):
            assert fa.check_tma_layout(t) == (96 * 3 * 4 * D, 3 * 4 * D, D)


def _odd_row_stride_view():
    # Rows of 4 * 64 + 1 elements: the s stride is 514 bytes, not a multiple of 16.
    buf = torch.zeros(2 * 8 * (4 * 64 + 1), dtype=torch.bfloat16)
    return buf.as_strided((2, 8, 4, 64), (8 * (4 * 64 + 1), 4 * 64 + 1, 64, 1))


@pytest.mark.parametrize("make, match", [
    (_odd_row_stride_view, "16 bytes"),
    (lambda: torch.zeros(2, 8, 4, 96, dtype=torch.bfloat16), "head dim 96"),
    (lambda: torch.zeros(2, 8, 4, 128, dtype=torch.bfloat16)[..., ::2], "contiguous"),
], ids=["odd_row_stride", "head_dim_96", "strided_head_dim"])
def test_tma_layout_refuses_what_the_tensor_maps_cannot_read(make, match):
    with pytest.raises(ValueError, match=match):
        fa.check_tma_layout(make())


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, _ = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(64))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q, k, v, None, True)
    assert fa.flash_fwd_cuda.launches == 0
