"""The port's blockwise int8 quantize (paddle_tpu_torch.ops.kern.quant)
against the JAX package's: `quantize_int8_blockwise_plain` against
`quantize_int8_blockwise_reference` and against the Pallas kernel
`quantize_int8_pallas` run in interpret mode, at block sizes 4, 64 and
256, on inputs with an all-zero block and with values whose quotient
x / scale falls exactly on k + 0.5 for even and odd k of both signs.
Codes are compared exactly against both, and scales exactly against
the reference (elementwise arithmetic with one exact max); against the
interpret-mode kernel, scales are exact except where XLA's lowering of
the kernel multiplies by 1/127 (see that test). Also the wrapper's
dispatch and the dequantize round trip."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.kern import quant as jq
from paddle_tpu_torch.ops.kern import quant as tq

BLOCK_SIZES = (4, 64, 256)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ties(bs):
    """Three blocks whose absmax makes the scale exactly 1, 2 and 0.5,
    so x / scale is exact and lands on k + 0.5 for even and odd k,
    positive and negative (half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2,
    126.5 -> 126)."""
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -125.5],
                      np.float32)
    out = []
    for unit in (1.0, 2.0, 0.5):
        block = np.resize(halves, bs) * unit
        block[-1] = 127.0 * unit          # absmax -> scale == unit
        out.append(block.astype(np.float32))
    return np.concatenate(out)


def _inputs(bs, seed):
    """[zero block | tie blocks | 60 random blocks of spread scales]."""
    rng = np.random.RandomState(seed)
    rand = (rng.randn(60, bs) * np.exp(rng.uniform(-6, 4, (60, 1))))
    return np.concatenate([np.zeros(bs, np.float32), _ties(bs),
                           rand.astype(np.float32).reshape(-1)])


def _plain(x, bs):
    codes, scales = tq.quantize_int8_blockwise_plain(torch.from_numpy(x),
                                                     bs)
    return codes.numpy(), scales.numpy()


@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_plain_is_bit_identical_to_the_jax_reference(bs):
    x = _inputs(bs, seed=bs)
    codes, scales = _plain(x, bs)
    rc, rs = jq.quantize_int8_blockwise_reference(jnp.asarray(x), bs)
    assert codes.dtype == np.int8 and scales.dtype == np.float32
    assert codes.shape == (len(x) // bs, bs) and scales.shape == \
        (len(x) // bs, 1)
    np.testing.assert_array_equal(codes, np.asarray(rc))
    np.testing.assert_array_equal(scales, np.asarray(rs))
    # the zero block stores the raw scale 0 (its divisor is 1), codes 0
    assert scales[0, 0] == 0.0 and not codes[0].any()
    # the tie blocks round half to even
    want = np.resize(np.array([0, 2, 2, 0, -2, -2, 126, -126], np.int8),
                     bs)
    want[-1] = 127
    for b in (1, 2, 3):
        np.testing.assert_array_equal(codes[b], want)
    np.testing.assert_array_equal(scales[1:4, 0], [1.0, 2.0, 0.5])


@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_plain_matches_the_jax_kernel_in_interpret_mode(bs):
    """Codes are bit-identical. Scales are bit-identical wherever the
    Pallas kernel divides: in interpret mode XLA lowers the kernel's
    `absmax / 127.0` to absmax * fl(1/127), which is 1 ulp off the
    reference's IEEE quotient in some blocks. The test pins exactly
    that: every scale equals the plain one or that product."""
    x = _inputs(bs, seed=100 + bs)
    codes, scales = _plain(x, bs)
    pc, ps = jq.quantize_int8_pallas(jnp.asarray(x), bs, interpret=True)
    np.testing.assert_array_equal(codes, np.asarray(pc))
    absmax = np.abs(x.reshape(-1, bs)).max(axis=1, keepdims=True)
    times_recip = absmax * np.float32(1.0 / 127.0)
    ps = np.asarray(ps)
    assert np.all((ps == scales) | (ps == times_recip))
    np.testing.assert_array_max_ulp(ps, scales, maxulp=1)
    # the zero block and the tie blocks' power-of-two scales are exact
    np.testing.assert_array_equal(ps[:4, 0], [0.0, 1.0, 2.0, 0.5])


def test_dequantize_round_trip_is_within_half_a_step():
    x = _inputs(64, seed=3)
    codes, scales = tq.quantize_int8_blockwise(torch.from_numpy(x), 64)
    back = tq.dequantize_int8_blockwise(codes, scales).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jq.dequantize_int8_blockwise(
            jnp.asarray(codes.numpy()), jnp.asarray(scales.numpy()))))
    step = np.repeat(scales.numpy()[:, 0], 64)
    assert np.all(np.abs(back - x) <= 0.5 * step * (1 + 1e-6))


def test_wrapper_takes_plain_version_for_cpu_tensors():
    x = torch.from_numpy(_inputs(64, seed=4))
    before = dict(tq.LAUNCHES)
    codes, scales = tq.quantize_int8_blockwise(x, 64)
    assert tq.LAUNCHES == before
    want = tq.quantize_int8_blockwise_plain(x, 64)
    np.testing.assert_array_equal(codes.numpy(), want[0].numpy())
    np.testing.assert_array_equal(scales.numpy(), want[1].numpy())


@pytest.mark.parametrize("shape,bs", [((64, 4), 4), ((60,), 8), ((0,), 4),
                                      ((64,), 0)])
def test_wrapper_rejects_inputs_that_are_not_whole_blocks(shape, bs):
    with pytest.raises(ValueError, match="multiple of block_size"):
        tq.quantize_int8_blockwise(torch.zeros(shape), bs)


def test_wrapper_never_sends_a_non_cpu_tensor_to_the_plain_version():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tq.quantize_int8_blockwise(torch.empty(256, device="meta"), 64)
