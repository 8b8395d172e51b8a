"""The port's fused BN + ReLU + 1x1-conv op (horovod_tpu_torch.ops.fused_bn_conv)
against the JAX package's Pallas kernel, run in interpret mode as the JAX
tests run it on the CPU. On the CPU the port's dispatcher takes the plain
PyTorch version, through the same autograd.Function the card uses.

Tolerances are those of tests/test_fused_bn_conv.py: y 2e-2 (bf16), s1
rtol 2e-2 / atol 2 and s2 rtol 3e-2 / atol 3 (atol 4 and 6 at M=2048);
gradients (f32) 1e-3; the module's output and running stats 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.resnet import FusedBNReluConv1x1 as JaxFused
from horovod_tpu.ops.fused_bn_conv import bn_relu_conv1x1 as jax_bn_relu_conv1x1
from horovod_tpu.ops.fused_bn_conv import fused_bn_relu_matmul as jax_fused
from horovod_tpu_torch.models.resnet import FusedBNReluConv1x1
from horovod_tpu_torch.ops import fused_bn_conv as fb

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _inputs(m=1024, cin=256, cout=128, seed=0, dtype="bfloat16"):
    """numpy arrays, the draw of tests/test_fused_bn_conv.py; x and w are
    rounded to ``dtype`` on both sides."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, cin)
    mu = rng.randn(cin).astype(np.float32) * 0.1
    var = (rng.rand(cin) + 0.5).astype(np.float32)
    gamma = (rng.rand(cin) + 0.5).astype(np.float32)
    beta = (rng.randn(cin) * 0.1).astype(np.float32)
    w = rng.randn(cin, cout) / np.sqrt(cin)
    jdt = getattr(jnp, dtype)
    x, w = (np.asarray(jnp.asarray(a, jdt).astype(jnp.float32)) for a in (x, w))
    return x, mu, var, gamma, beta, w, dtype


def _jax(args):
    *arrs, dtype = args
    jdt = getattr(jnp, dtype)
    x, mu, var, gamma, beta, w = (jnp.asarray(a) for a in arrs)
    return x.astype(jdt), mu, var, gamma, beta, w.astype(jdt)


def _torch(args):
    *arrs, dtype = args
    x, mu, var, gamma, beta, w = (torch.from_numpy(np.array(a)) for a in arrs)
    tdt = TORCH_DTYPES[dtype]
    return x.to(tdt), mu, var, gamma, beta, w.to(tdt)


def _f32(a):
    return np.asarray(torch.as_tensor(a).float()) if isinstance(a, torch.Tensor) \
        else np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("accum", ["scratch", "revisit"])
def test_forward_matches_jax(accum):
    args = _inputs()
    y, s1, s2 = fb.fused_bn_relu_matmul(*_torch(args), accum=accum)
    yj, s1j, s2j = jax_fused(*_jax(args), interpret=True, accum=accum)
    assert y.dtype == torch.bfloat16 and y.shape == (1024, 128)
    assert s1.dtype == s2.dtype == torch.float32
    np.testing.assert_allclose(_f32(y), _f32(yj), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s1j), rtol=2e-2, atol=2.0)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2j), rtol=3e-2, atol=3.0)


@pytest.mark.parametrize("accum", ["scratch", "revisit"])
def test_multiblock_stats_match_jax(accum):
    """M spans several of the JAX kernel's row blocks (M=2048, block_m 512)."""
    args = _inputs(m=2048, cin=128, cout=256)
    y, s1, s2 = fb.fused_bn_relu_matmul(*_torch(args), block_m=512, accum=accum)
    yj, s1j, s2j = jax_fused(*_jax(args), interpret=True, block_m=512, accum=accum)
    np.testing.assert_allclose(_f32(y), _f32(yj), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s1j), rtol=2e-2, atol=4.0)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2j), rtol=3e-2, atol=6.0)


@pytest.mark.parametrize("accum", ["scratch", "revisit"])
def test_block_divisibility_error(accum):
    args = _inputs(m=1000)   # not divisible by 512
    with pytest.raises(ValueError, match="divisible"):
        fb.fused_bn_relu_matmul(*_torch(args), accum=accum)
    with pytest.raises(ValueError, match="divisible"):
        jax_fused(*_jax(args), interpret=True, accum=accum)


def test_unknown_accum_raises():
    with pytest.raises(ValueError, match="accum"):
        fb.fused_bn_relu_matmul(*_torch(_inputs()), accum="atomic")


def test_gradients_match_jax_all_six_inputs():
    """f32, as tests/test_fused_bn_conv.py: the loss reads y, s1 and s2,
    and the gradient reaches mu and var too, as the JAX custom_vjp's."""
    args = _inputs(m=512, cin=128, cout=128, dtype="float32")

    def jax_loss(*a):
        y, s1, s2 = jax_bn_relu_conv1x1(*a)
        return (jnp.sum(y.astype(jnp.float32) ** 2) * 1e-3
                + jnp.sum(s1) * 1e-3 + jnp.sum(s2) * 1e-4)

    want = jax.grad(jax_loss, argnums=tuple(range(6)))(*_jax(args))
    leaves = [t.clone().requires_grad_(True) for t in _torch(args)]
    y, s1, s2 = fb.bn_relu_conv1x1(*leaves)
    loss = (y.float() ** 2).sum() * 1e-3 + s1.sum() * 1e-3 + s2.sum() * 1e-4
    loss.backward()
    for name, t, g in zip(("x", "mu", "var", "gamma", "beta", "w"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-3, atol=1e-3,
                                   err_msg=name)


def test_unused_stats_outputs_get_zero_cotangents():
    args = _inputs(m=64, cin=32, cout=16, dtype="float32")
    x = _torch(args)[0].requires_grad_(True)
    y, _, _ = fb.bn_relu_conv1x1(x, *_torch(args)[1:])
    y.sum().backward()
    want = jax.grad(lambda a: jnp.sum(jax_bn_relu_conv1x1(a, *_jax(args)[1:])[0]))(
        _jax(args)[0])
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("shape", [(2, 4, 4, 64), (3, 16, 16, 64)])
def test_module_matches_flax(shape):
    """FusedBNReluConv1x1 against the flax module with the same parameters,
    train mode: output and both running stats. (3, 16, 16, 64) has M=768,
    above the 512 block and not a multiple of it: the pad-and-slice path."""
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    jmod = JaxFused(128, dtype=jnp.float32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    want, updates = jmod.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])

    mod = FusedBNReluConv1x1(64, 128, dtype=torch.float32)
    p = jax.tree.map(np.array, variables["params"])
    with torch.no_grad():
        for name in ("scale", "bias", "kernel"):
            getattr(mod, name).copy_(torch.from_numpy(p[name]))
        mod.running_mean.zero_()
        mod.running_var.fill_(1.0)
    mod.train()
    got = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (shape[0], 128, shape[1], shape[2])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=2e-4, atol=2e-4)
    stats = updates["batch_stats"]
    np.testing.assert_allclose(mod.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=2e-4, atol=1e-6)

    # Eval mode reads the running stats, as the flax module with train=False.
    mod.eval()
    evars = {"params": variables["params"], "batch_stats": stats}
    want_eval = jmod.apply(evars, jnp.asarray(x), train=False)
    got_eval = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_eval.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want_eval), rtol=2e-4, atol=2e-4)


def test_cpu_takes_the_plain_version_and_launches_nothing():
    fb.reset_launches()
    args = _torch(_inputs(m=512, cin=64, cout=64))
    for accum in ("scratch", "revisit"):
        got = fb.fused_bn_relu_matmul(*args, accum=accum)
        want = fb._reference_bn_relu_matmul(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert fb.launches() == {"fused_bn_conv_scratch": 0, "fused_bn_conv_revisit": 0}


@pytest.mark.parametrize("fn", [fb.fused_bn_conv_scratch_cuda, fb.fused_bn_conv_revisit_cuda])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    fb.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        fn(*_torch(_inputs(m=512, cin=64, cout=64)))
    assert fn.launches == 0


@pytest.mark.parametrize("cin, cout, what", [
    (32, 256, "Cin=32"), (96, 256, "Cin=96"), (640, 256, "Cin=640"), (128, 12, "Cout=12"),
])
def test_k3_shape_rules_refuse(cin, cout, what):
    """K3 reads x in 64-column boxes (Cin a multiple of 64, at most 512)
    and its tensor maps need 16-byte row strides (Cout a multiple of 8)."""
    with pytest.raises(ValueError, match=f"{what}: K3 "):
        fb._check_kernel_shape("K3", 1024, cin, cout)


# chip_smoke's persistent edge shapes: several row tiles a block, a ragged
# last tile, Cout not a multiple of 128; the first two shaped for K3's grid
# (132 blocks), the last two for K4's (132 // Cout tiles row partitions).
PERSISTENT_EDGES = [(132 * 128 * 2 + 77, 512, 264), (132 * 128 * 3 + 5, 192, 200),
                    (33 * 128 * 5 + 3, 512, 392), (66 * 128 * 4 + 100, 128, 200)]


@pytest.mark.parametrize("shape", [(802816, 64, 256), (200704, 128, 512), (50176, 256, 1024),
                                   (12800, 512, 2048), (300, 64, 256), *PERSISTENT_EDGES])
def test_k3_shape_rules_take_the_resnet_stages_and_a_ragged_m(shape):
    fb._check_kernel_shape("K3", *shape)


@pytest.mark.parametrize("shape, what", [
    ((802816, 64, 256), None), ((200704, 128, 512), None), ((12800, 512, 2048), None),
    ((300, 64, 256), None), (PERSISTENT_EDGES[2], None), (PERSISTENT_EDGES[3], None),
    ((1024, 32, 256), "Cin=32"), ((1024, 96, 256), "Cin=96"), ((1024, 640, 256), "Cin=640"),
    ((1024, 128, 12), "Cout=12"), ((1024, 64, 0), "Cout=0"), ((0, 64, 256), "M=0"),
])
def test_k4_shape_rules_are_k3s(shape, what):
    """K4 reads x and w through the same 64-column boxes and writes y
    through the same tensor map as K3, so it takes the same shapes: Cin a
    multiple of 64 up to 512, Cout a multiple of 8. The messages name K4
    and the dimension at fault."""
    if what is None:
        fb._check_kernel_shape("K4", *shape)
    else:
        with pytest.raises(ValueError, match=f"{what}: K4 "):
            fb._check_kernel_shape("K4", *shape)
