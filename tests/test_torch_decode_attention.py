"""The port's ragged decode attention (paddle_tpu_torch.ops.kern.
decode_attention) against the JAX package's: `decode_attend_plain`
against `decode_attend_reference` for pos >= 0 and against the Pallas
kernel run in interpret mode for pos that include -1, in fp32 at the
registered tolerance. Also the wrapper's dispatch: CPU tensors take the
plain version without counting a launch, malformed inputs and tensors
on other devices raise, and a build without nvcc raises."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.kern import decode_attention as jda
from paddle_tpu_torch.ops.kern import _build
from paddle_tpu_torch.ops.kern import decode_attention as tda

# the registered parity tolerance of the JAX kernel
# (paddle_tpu/ops/kern/registrations.py, decode_attend): fp32
RTOL = ATOL = 2e-5

# interpret mode runs the Pallas grid in Python: keep the shapes tiny
S, T, H, DH = 3, 256, 2, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(pos, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H, DH).astype(np.float32)
    k = rng.randn(S, T, H, DH).astype(np.float32)
    v = rng.randn(S, T, H, DH).astype(np.float32)
    return q, k, v, np.asarray(pos, np.int32)


def _plain(q, k, v, pos, scale=None):
    return tda.decode_attend_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(pos), scale).numpy()


@pytest.mark.parametrize("pos,scale", [([0, 100, T - 1], None),
                                       ([7, T + 40, 1], 0.3)])
def test_plain_matches_jax_reference(pos, scale):
    q, k, v, p = _inputs(pos, seed=1)
    ref = np.asarray(jda.decode_attend_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(p),
        scale))
    np.testing.assert_allclose(_plain(q, k, v, p, scale), ref,
                               rtol=RTOL, atol=ATOL)


def test_plain_matches_jax_kernel_in_interpret_mode():
    """pos -1 gives an all-zero row in the TPU kernel (the reference
    composition gives NaN there); pos >= T attends to every row."""
    q, k, v, p = _inputs([-1, 37, T + 5], seed=2)
    ref = np.asarray(jda.decode_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(p),
        interpret=True))
    got = _plain(q, k, v, p)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert not np.any(got[0])


def test_wrapper_takes_plain_version_for_cpu_tensors():
    q, k, v, p = _inputs([3, 0, 200], seed=3)
    before = tda.LAUNCHES
    got = tda.decode_attend(*map(torch.from_numpy, (q, k, v, p)))
    assert tda.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), _plain(q, k, v, p))


@pytest.mark.parametrize("bad", ["k_shape", "pos_shape", "v_heads"])
def test_wrapper_rejects_mismatched_shapes(bad):
    q, k, v, p = map(torch.from_numpy, _inputs([1, 2, 3]))
    if bad == "k_shape":
        k = k[:, :, :, :8]
    elif bad == "pos_shape":
        p = p[:2]
    else:
        v = v[:, :, :1]
    with pytest.raises(ValueError):
        tda.decode_attend(q, k, v, p)


def test_wrapper_never_sends_a_non_cpu_tensor_to_the_plain_version():
    q, k, v, p = (torch.empty(t.shape, dtype=torch.from_numpy(t).dtype,
                              device="meta")
                  for t in _inputs([1, 2, 3]))
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        tda.decode_attend(q, k, v, p)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("decode_attention")
    with pytest.raises(RuntimeError, match="missing"):
        _build.load("no_such_kernel")
