"""The port's ragged decode attention (paddle_tpu_torch.ops.kern.
decode_attention) against the JAX package's: `decode_attend_plain`
against `decode_attend_reference` for pos >= 0 and against the Pallas
kernel run in interpret mode for pos that include -1, in fp32 at the
registered tolerance; likewise `dequant_attend_plain` over the int8
cache against `dequant_attend_reference` and the interpret-mode
`dequant_attend`, with one scale per row (nb = 1) and several (nb > 1).
Also the wrappers' dispatch: CPU tensors take the plain version without
counting a launch, malformed inputs and tensors on other devices raise,
and a build without nvcc raises."""
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
    before = dict(tda.LAUNCHES)
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


# ------------------------------------------------------- int8 cache
def _int8_inputs(pos, nb, seed=0):
    """q, int8 codes in [-127, 127] and per-block scales drawn as the
    JAX registry's example draws them (uniform 0.005-0.02: block
    absmax 0.6-2.5), pos."""
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H, DH).astype(np.float32)
    kq, vq = (rng.randint(-127, 128, (S, T, H, DH)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.02, (S, T, H, nb)).astype(np.float32)
              for _ in range(2))
    return q, kq, ks, vq, vs, np.asarray(pos, np.int32)


def _dq_plain(args, scale=None):
    return tda.dequant_attend_plain(*map(torch.from_numpy, args),
                                    scale).numpy()


@pytest.mark.parametrize("nb", [1, 4])
def test_dequant_plain_matches_jax_reference(nb):
    args = _int8_inputs([0, 100, T - 1], nb, seed=4)
    ref = np.asarray(jda.dequant_attend_reference(*map(jnp.asarray, args),
                                                  0.3))
    np.testing.assert_allclose(_dq_plain(args, 0.3), ref, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("nb,pos", [(1, [-1, 0, 120]),
                                    (1, [T - 1, T + 5, 37]),
                                    (4, [-1, 0, 120]),
                                    (4, [T - 1, T + 5, 37])])
def test_dequant_plain_matches_jax_kernel_in_interpret_mode(nb, pos):
    """pos -1 gives an all-zero row; pos >= T attends to every row."""
    args = _int8_inputs(pos, nb, seed=5 + nb)
    ref = np.asarray(jda.dequant_attend(*map(jnp.asarray, args),
                                        interpret=True))
    got = _dq_plain(args)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    for s, p in enumerate(pos):
        assert np.any(got[s]) == (p >= 0)


def test_dequant_wrapper_takes_plain_version_for_cpu_tensors():
    args = _int8_inputs([3, 0, 200], 2, seed=6)
    before = dict(tda.LAUNCHES)
    got = tda.dequant_attend(*map(torch.from_numpy, args))
    assert tda.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), _dq_plain(args))


@pytest.mark.parametrize("bad", ["scales_not_dividing", "scale_shapes",
                                 "v_codes", "pos_shape", "q_heads"])
def test_dequant_wrapper_rejects_mismatched_shapes(bad):
    q, kq, ks, vq, vs, p = map(torch.from_numpy,
                               _int8_inputs([1, 2, 3], 2))
    if bad == "scales_not_dividing":
        ks, vs = ks.repeat(1, 1, 1, 2)[..., :3], vs.repeat(1, 1, 1, 2)[..., :3]
    elif bad == "scale_shapes":
        vs = vs[..., :1]
    elif bad == "v_codes":
        vq = vq[:, :, :1]
    elif bad == "pos_shape":
        p = p[:2]
    else:
        q = q[:, :1]
    with pytest.raises(ValueError):
        tda.dequant_attend(q, kq, ks, vq, vs, p)


def test_dequant_wrapper_never_sends_a_non_cpu_tensor_to_the_plain_version():
    args = [torch.from_numpy(t) for t in _int8_inputs([1, 2, 3], 2)]
    args[2] = torch.empty(args[2].shape, device="meta")
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        tda.dequant_attend(*args)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("decode_attention")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="missing"):
        _build.load("no_such_kernel")
