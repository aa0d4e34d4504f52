"""The port's fused LayerNorm forward (paddle_tpu_torch.ops.kern.
layer_norm) on the CPU: its plain version against the JAX package's
Pallas kernel run in interpret mode (`interpret=True` passed as an
argument) and against the op's jnp statistics, within the kernel's
registered tolerance (2e-5, 2e-5; paddle_tpu/ops/kern/registrations.py);
the wrapper's dispatch (CPU tensors to the plain version, anything that
is neither all-CPU nor all-CUDA raises, no launch counted) and the op's
static check. The CUDA kernel itself is held against the plain version
on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import layer_norm as jln
from paddle_tpu_torch.ops import kern as tkern
from paddle_tpu_torch.ops.kern import layer_norm as tln

RTOL = ATOL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 0.5).astype(np.float32)
    g = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("shape", [(16, 128), (2, 8, 128), (8, 64),
                                   (3, 8, 256), (24, 32)])
def test_plain_matches_pallas_kernel_in_interpret_mode(shape):
    x, g, b = _inputs(shape)
    want = np.asarray(jln.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b), 1e-5, None, True))
    y, mean, var = tln.layer_norm_plain(*map(torch.from_numpy, (x, g, b)),
                                        1e-5)
    np.testing.assert_allclose(y.numpy(), want, rtol=RTOL, atol=ATOL)
    xf = x.astype(np.float64)
    np.testing.assert_allclose(mean.numpy(), xf.mean(-1), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(var.numpy(), xf.var(-1), rtol=RTOL,
                               atol=ATOL)
    assert mean.shape == var.shape == shape[:-1]


def test_wrapper_takes_plain_version_for_cpu_tensors():
    x, g, b = map(torch.from_numpy, _inputs((4, 5, 64), seed=1))
    before = dict(tkern.LAUNCHES)
    got = tln.layer_norm(x, g, b, 1e-5)
    want = tln.layer_norm_plain(x, g, b, 1e-5)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert tkern.LAUNCHES == before


@pytest.mark.parametrize("bad", ["rank1", "scale", "bias", "empty"])
def test_wrapper_rejects_mismatched_shapes(bad):
    x, g, b = map(torch.from_numpy, _inputs((4, 64), seed=2))
    if bad == "rank1":
        x = x[0]
    elif bad == "scale":
        g = g[:-1]
    elif bad == "bias":
        b = torch.cat([b, b])
    else:
        x = x[:0]
    with pytest.raises(ValueError, match="layer_norm wants"):
        tln.layer_norm(x, g, b)


def test_wrapper_never_sends_a_non_cpu_tensor_to_the_plain_version():
    x, g, b = map(torch.from_numpy, _inputs((4, 64), seed=3))
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        tln.layer_norm(x.to("meta"), g, b)
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        tln.layer_norm(x, g.to("meta"), b)


@pytest.mark.parametrize("ndim,begin,scale,bias,want", [
    (3, 2, True, True, True), (2, 1, True, True, True),
    (3, 1, True, True, False), (3, 2, False, True, False),
    (3, 2, True, False, False), (1, 0, True, True, False)])
def test_static_check_accepts_exactly_what_the_reference_kernel_path_does(
        ndim, begin, scale, bias, want):
    """The kernel runs for a norm over the last axis with scale and bias;
    the TPU's gates (128-lane C, 8 rows) are not inherited, so 7 rows of
    C 37 take the kernel too."""
    x = torch.ones((7,) * (ndim - 1) + (37,))
    g = torch.ones(37) if scale else None
    b = torch.zeros(37) if bias else None
    assert tln.supports(x, g, b, begin) is want
    got = tln.try_layer_norm(x, g, b, 1e-5, begin)
    assert (got is not None) is want


def test_try_squeezes_stats_as_the_op_composition_does():
    """Mean and Variance come out as the composition's `.squeeze()`
    makes them: a batch or time dim of 1 goes too."""
    x, g, b = map(torch.from_numpy, _inputs((1, 6, 32), seed=4))
    y, mean, var = tln.try_layer_norm(x, g, b, 1e-5, 2)
    assert y.shape == (1, 6, 32) and mean.shape == (6,) \
        and var.shape == (6,)
    y, mean, var = tln.try_layer_norm(x[:, :1], g, b, 1e-5, 2)
    assert mean.shape == () and var.shape == ()


def test_bf16_input_keeps_y_in_bf16_with_f32_stats():
    x, g, b = map(torch.from_numpy, _inputs((4, 96), seed=5))
    y, mean, var = tln.layer_norm(x.bfloat16(), g, b)
    assert y.dtype == torch.bfloat16
    assert mean.dtype == var.dtype == torch.float32
    yf, _m, _v = tln.layer_norm(x.bfloat16().float(), g, b)
    assert torch.equal(y, yf.bfloat16())
