"""The port's flash-attention forward (paddle_tpu_torch.ops.kern.
flash_attention) on the CPU: its plain version, out and the per-row
logsumexp, against the JAX package's Pallas kernel run in interpret
mode (`flash_attention_with_lse(..., interpret=True)`, passed as an
argument), within the kernel's registered tolerance (2e-5, 2e-5;
paddle_tpu/ops/kern/registrations.py): with and without a per-key bias
of each accepted shape, causal and not, T != S, lengths that are not
tile multiples, a negative causal_offset (compared on the rows that
keep a key: a fully masked row is implementation-defined in both), and
both layouts. Also the wrapper's dispatch and the op's static check.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import kern as tkern
from paddle_tpu_torch.ops.kern import flash_attention as tfa

RTOL = ATOL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, H, T, S, D, bias_shape, seed=0, DV=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, H, S, D)).astype(np.float32)
    v = rng.standard_normal((B, H, S, DV or D)).astype(np.float32)
    bias = None
    if bias_shape is not None:
        lens = rng.integers(1, S + 1, B)
        keep = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
        pad = keep * 1e9 - 1e9
        bias = pad[:bias_shape[0]].reshape(bias_shape).astype(np.float32)
    return q, k, v, bias


CASES = [
    # B, H, T, S, D, bias shape (B or 1 rows), causal, causal_offset
    (2, 2, 32, 32, 16, None, False, 0),
    (2, 2, 32, 32, 16, (2, 1, 1, 32), True, 0),
    (2, 3, 37, 50, 16, (2, 50), False, 0),
    (2, 3, 50, 37, 8, (1, 37), True, 0),
    (1, 2, 24, 40, 32, (1, 1, 1, 40), True, 0),
    (2, 2, 32, 32, 16, (2, 1, 1, 32), True, -1),
    (2, 2, 40, 24, 16, None, True, -3),
]


@pytest.mark.parametrize("B,H,T,S,D,bshape,causal,off", CASES)
def test_plain_matches_pallas_kernel_in_interpret_mode(B, H, T, S, D,
                                                       bshape, causal,
                                                       off):
    q, k, v, bias = _inputs(B, H, T, S, D, bshape)
    scale = D ** -0.5
    out, lse = jfa.flash_attention_with_lse(
        *map(jnp.asarray, (q, k, v)),
        bias=None if bias is None else jnp.asarray(bias), causal=causal,
        scale=scale, interpret=True, causal_offset=off)
    pout, plse = tfa.flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)),
        None if bias is None else torch.from_numpy(bias), causal, scale,
        off)
    rows = np.arange(T) + (S - T + off if causal else S) >= 0
    np.testing.assert_allclose(pout.numpy()[:, :, rows],
                               np.asarray(out)[:, :, rows], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(plse.numpy()[:, :, rows],
                               np.asarray(lse)[:, :, rows], rtol=RTOL,
                               atol=ATOL)
    assert pout.shape == (B, H, T, D) and plse.shape == (B, H, T)


def test_bthd_layout_is_the_transposed_bhtd_result():
    q, k, v, bias = _inputs(2, 3, 20, 28, 8, (2, 1, 1, 28), seed=1, DV=12)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out, lse = tfa.flash_attention_plain(*t, torch.from_numpy(bias), True,
                                         0.3)
    tout, tlse = tfa.flash_attention(*(a.transpose(1, 2) for a in t),
                                     torch.from_numpy(bias), True, 0.3,
                                     layout="bthd")
    assert tout.shape == (2, 20, 3, 12)
    torch.testing.assert_close(tout, out.transpose(1, 2), rtol=0, atol=0)
    torch.testing.assert_close(tlse, lse, rtol=0, atol=0)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    q, k, v, bias = map(torch.from_numpy,
                        _inputs(2, 2, 16, 16, 8, (2, 16), seed=2))
    before = dict(tkern.LAUNCHES)
    got = tfa.flash_attention(q, k, v, bias, True, 0.5)
    want = tfa.flash_attention_plain(q, k, v, bias, True, 0.5)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert tkern.LAUNCHES == before


@pytest.mark.parametrize("bad", ["k", "v", "rank", "layout", "bias"])
def test_wrapper_rejects_mismatched_inputs(bad):
    q, k, v, _b = map(lambda a: None if a is None else torch.from_numpy(a),
                      _inputs(2, 2, 16, 12, 8, None, seed=3))
    bias = None
    layout = "bhtd"
    if bad == "k":
        k = k[:, :, :, :4]
    elif bad == "v":
        v = v[:, :1]
    elif bad == "rank":
        q = q[0]
    elif bad == "layout":
        layout = "tbhd"
    else:
        bias = torch.zeros(2, 2, 16, 12)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, bias, layout=layout)


def test_wrapper_never_sends_a_non_cpu_tensor_to_the_plain_version():
    q, k, v, _b = _inputs(1, 2, 8, 8, 8, None, seed=4)
    q, k, v = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        tfa.flash_attention(q.to("meta"), k, v)
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        tfa.flash_attention(q, k, v, torch.zeros(1, 8, device="meta"))


@pytest.mark.parametrize("bias_shape,layout,want", [
    (None, "bhtd", True), ((2, 12), "bhtd", True),
    ((2, 1, 1, 12), "bhtd", True), ((1, 12), "bhtd", True),
    ((1, 1, 1, 12), "bhtd", True), ((2, 2, 16, 12), "bhtd", False),
    ((2, 1, 16, 12), "bhtd", False), ((2, 1, 1, 12), "bthd", True)])
def test_static_check_takes_per_key_biases_only(bias_shape, layout, want):
    """A full [B,H,T,S] (or per-query) bias takes the op's sdpa
    composition, as in the reference; no sequence-length or tiling gate
    is inherited from the TPU."""
    B, H, T, S, D = 2, 2, 16, 12, 8
    shp = (lambda n: (B, H, n, D)) if layout == "bhtd" \
        else (lambda n: (B, n, H, D))
    q, k, v = torch.ones(shp(T)), torch.ones(shp(S)), torch.ones(shp(S))
    bias = None if bias_shape is None else torch.zeros(bias_shape)
    assert tfa.supports(q, k, v, bias, layout) is want
    got = tfa.try_flash(q, k, v, bias, layout=layout)
    assert (got is not None) is want
    if want:
        assert got.shape == q.shape
