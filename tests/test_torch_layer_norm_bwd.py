"""The port's LayerNorm backward (paddle_tpu_torch.ops.kern.layer_norm:
the autograd Function's backward, which takes the plain version of the
backward kernel on the CPU) against `jax.vjp` of the JAX package's
Pallas kernel run in interpret mode (`layer_norm(..., interpret=True)`,
passed as an argument): dx, dscale and dbias within the reference's own
LayerNorm-gradient tolerance (2e-4, tests/test_pallas_layer_norm.py:57),
on 2-D and 3-D inputs, row counts that do not fill a row block, and
C above 1024 (the kernel's eight-warp rows). Also the Function through
the `layer_norm` op (Mean and Variance carry no gradient), the plain
version against torch's own layer_norm at the row counts of the
kernel's partial-sum stage, and the backward wrapper's dispatch. The CUDA kernel is held against this plain version
on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import layer_norm as jln
from paddle_tpu_torch.ops import kern as tkern
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.kern import layer_norm as tln

RTOL = ATOL = 2e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 0.5).astype(np.float32)
    g = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, g, b, dy


@pytest.mark.parametrize("shape,block_rows", [
    ((32, 128), None), ((40, 128), 8), ((2, 16, 256), None),
    ((3, 8, 64), None), ((12, 2048), None)])
def test_backward_matches_jax_vjp_of_the_pallas_kernel(shape, block_rows):
    x, g, b, dy = _inputs(shape, seed=shape[-1] + len(shape))
    _y, vjp = jax.vjp(
        lambda x, s, b: jln.layer_norm(x, s, b, 1e-5, block_rows, True),
        *map(jnp.asarray, (x, g, b)))
    want = [np.asarray(a) for a in vjp(jnp.asarray(dy))]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, b)]
    y, _mean, _var = tln.layer_norm(*ts, 1e-5)
    y.backward(torch.from_numpy(dy))
    for name, t, w in zip(("dx", "dscale", "dbias"), ts, want):
        assert t.grad.shape == w.shape, name
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(7, 96), (3, 5, 1536)])
def test_plain_backward_matches_autograd_of_the_plain_forward(shape):
    """Row counts that fill no block of 8 rows, and a C > 1024 row: the
    explicit backward equals torch's own gradient of the plain
    forward."""
    x, g, b, dy = map(torch.from_numpy, _inputs(shape, seed=3))
    ts = [t.clone().requires_grad_(True) for t in (x, g, b)]
    tln.layer_norm_plain(*ts, 1e-5)[0].backward(dy)
    dx, dg, db = tln.layer_norm_bwd_plain(dy, x, g, 1e-5)
    for got, t in zip((dx, dg, db), ts):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_layer_norm_op_gradient_flows_through_the_function():
    """The `layer_norm` op under autograd: its kernel entry is the
    Function, so x, Scale and Bias get the backward's gradients and the
    Mean / Variance outputs need none."""
    x, g, b, dy = map(torch.from_numpy, _inputs((2, 6, 64), seed=4))
    ts = [t.clone().requires_grad_(True) for t in (x, g, b)]
    ctx = treg.KernelCtx(device=torch.device("cpu"))
    out = treg.get_kernel("layer_norm")(
        ctx, {"X": [ts[0]], "Scale": [ts[1]], "Bias": [ts[2]]},
        {"epsilon": 1e-5, "begin_norm_axis": 2})
    assert not out["Mean"][0].requires_grad
    assert not out["Variance"][0].requires_grad
    out["Y"][0].backward(dy)
    want = tln.layer_norm_bwd_plain(dy, x, g, 1e-5)
    for t, w in zip(ts, want):
        assert torch.equal(t.grad, w)


@pytest.mark.parametrize("shape", [
    (8192, 512), (7, 512), (9, 64), (300, 2048), (4000, 2048), (1, 8192)])
def test_plain_backward_matches_autograd_of_torch_layer_norm(shape):
    """The plain version at the row counts and widths of the kernel's
    partial-sum stage (one block, a ragged last block, the block cap,
    eight-warp rows), against autograd of torch's own layer_norm."""
    x, g, b, dy = map(torch.from_numpy, _inputs(shape, seed=len(shape)
                                                + shape[0]))
    got = tln.layer_norm_bwd_plain(dy, x, g, 1e-5)
    ts = [t.clone().requires_grad_(True) for t in (x, g, b)]
    torch.nn.functional.layer_norm(ts[0], (shape[-1],), ts[1], ts[2],
                                   1e-5).backward(dy)
    for name, a, t in zip(("dx", "dscale", "dbias"), got, ts):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_backward_wrapper_takes_the_plain_version_for_cpu_tensors():
    x, g, _b, dy = map(torch.from_numpy, _inputs((4, 5, 64), seed=5))
    before = dict(tkern.LAUNCHES)
    got = tln.layer_norm_bwd(dy, x, g, 1e-5)
    for a, w in zip(got, tln.layer_norm_bwd_plain(dy, x, g, 1e-5)):
        assert torch.equal(a, w)
    assert tkern.LAUNCHES == before


@pytest.mark.parametrize("bad", ["meta", "dy", "scale"])
def test_backward_wrapper_rejects_bad_inputs(bad):
    x, g, _b, dy = map(torch.from_numpy, _inputs((4, 64), seed=6))
    if bad == "meta":
        dy = dy.to("meta")
    elif bad == "dy":
        dy = dy[:2]
    else:
        g = g[:-1]
    with pytest.raises(ValueError):
        tln.layer_norm_bwd(dy, x, g)
