"""The port's flash-attention backward (paddle_tpu_torch.ops.kern.
flash_attention: the autograd Function's backward, which takes the
plain versions of the dq and dk/dv kernels on the CPU) against
`jax.grad` of the JAX package's Pallas kernels run in interpret mode
(`flash_attention(..., interpret=True)` and
`flash_attention_with_lse(..., interpret=True)`, `interpret` passed as
an argument). dq, dk and dv within the reference's own flash-gradient
tolerance (1e-4, tests/test_flash_attention.py:74-78); the bias gradient
within tests/test_flash_bias_grad.py's (rtol 2e-4, atol 2e-5), for each
accepted bias shape; the lse cotangent; causal offsets; T != S with
lengths that are not tile multiples; both layouts. Rows that a negative
causal_offset leaves without a key (implementation-defined in both
packages) get a zero output cotangent. Also the backward wrappers'
dispatch. The CUDA kernels are held against these plain versions on the
card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import kern as tkern
from paddle_tpu_torch.ops.kern import flash_attention as tfa

GRAD_TOL = 1e-4
BIAS_RTOL, BIAS_ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(B, H, T, S, D, bias_shape, causal, off, seed):
    """q, k, v [B,H,*,D], a small random per-key bias (or None), and the
    cotangents of out and lse, zero on rows that see no key."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, H, S, D)).astype(np.float32)
    v = rng.standard_normal((B, H, S, D)).astype(np.float32)
    bias = None if bias_shape is None else \
        (0.5 * rng.standard_normal(bias_shape)).astype(np.float32)
    live = (np.arange(T) + (S - T + off if causal else S) >= 0)
    g = rng.standard_normal((B, H, T, D)).astype(np.float32)
    g *= live[None, None, :, None]
    g_lse = rng.standard_normal((B, H, T)).astype(np.float32) * live
    return q, k, v, bias, g, g_lse


def _ref_grads(q, k, v, bias, g, g_lse, causal, off, with_lse):
    """jax.grad of sum(out * g) (+ sum(lse * g_lse)) through the Pallas
    kernels in interpret mode, w.r.t. q, k, v and the bias."""
    D = q.shape[-1]

    def loss(q, k, v, b):
        if with_lse:
            out, lse = jfa.flash_attention_with_lse(
                q, k, v, bias=b, causal=causal, scale=D ** -0.5,
                interpret=True, causal_offset=off)
            return jnp.sum(out * g) + jnp.sum(lse * g_lse)
        out = jfa.flash_attention(q, k, v, bias=b, causal=causal,
                                  scale=D ** -0.5, interpret=True,
                                  causal_offset=off)
        return jnp.sum(out * g)

    args = [jnp.asarray(a) for a in (q, k, v)]
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    grads = jax.grad(loss, argnums=argnums)(
        *args, None if bias is None else jnp.asarray(bias))
    return [np.asarray(x) for x in grads]


def _port_grads(q, k, v, bias, g, g_lse, causal, off, with_lse,
                layout="bhtd"):
    """torch autograd of the same loss through the port's Function, in
    `layout` (the results are returned in bhtd)."""
    D = q.shape[-1]
    tr = (lambda a: a) if layout == "bhtd" \
        else (lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
    ts = [torch.from_numpy(tr(a)).requires_grad_(True) for a in (q, k, v)]
    tb = None if bias is None else \
        torch.from_numpy(bias).requires_grad_(True)
    out, lse = tfa.flash_attention(*ts, tb, causal, D ** -0.5, off, layout)
    loss = (out * torch.from_numpy(tr(g))).sum()
    if with_lse:
        loss = loss + (lse * torch.from_numpy(g_lse)).sum()
    loss.backward()
    grads = [tr(t.grad.numpy()) for t in ts]
    return grads + ([] if tb is None else [tb.grad.numpy()])


CASES = [
    # B, H, T, S, D, bias shape, causal, causal_offset, with_lse
    (2, 2, 32, 32, 16, None, False, 0, False),
    (2, 2, 32, 32, 16, (2, 1, 1, 32), True, 0, False),
    (2, 3, 37, 50, 16, (2, 50), False, 0, True),
    (2, 3, 50, 37, 8, (1, 37), True, 0, False),
    (1, 2, 24, 40, 32, (1, 1, 1, 40), True, 0, True),
    (2, 2, 32, 32, 16, (2, 32), True, -1, True),
    (2, 2, 40, 24, 16, None, True, -5, False),
]


@pytest.mark.parametrize("B,H,T,S,D,bshape,causal,off,with_lse", CASES)
def test_plain_backward_matches_jax_grad_of_the_pallas_kernels(
        B, H, T, S, D, bshape, causal, off, with_lse):
    q, k, v, bias, g, g_lse = _case(B, H, T, S, D, bshape, causal, off,
                                    seed=B * 100 + T + S)
    want = _ref_grads(q, k, v, bias, g, g_lse, causal, off, with_lse)
    got = _port_grads(q, k, v, bias, g, g_lse, causal, off, with_lse)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)
    if bias is not None:
        assert got[3].shape == bias.shape
        assert np.abs(want[3]).max() > 1e-3      # a gradient worth testing
        np.testing.assert_allclose(got[3], want[3], rtol=BIAS_RTOL,
                                   atol=BIAS_ATOL, err_msg="dbias")


@pytest.mark.parametrize("causal", [False, True])
def test_bias_grad_of_a_nonlinear_loss(causal):
    """tests/test_flash_bias_grad.py's loss sum(out * cos(out)) with a
    [B, S] bias, against jax.grad of the interpret-mode kernel."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 2, 32, 16)).astype(np.float32)
               for _ in range(3))
    bias = (0.1 * rng.standard_normal((2, 32))).astype(np.float32)

    def jloss(b):
        out = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), bias=b,
                                  causal=causal, interpret=True)
        return jnp.sum(out * jnp.cos(out))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(bias)))
    tb = torch.from_numpy(bias).requires_grad_(True)
    out, _lse = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), tb,
                                    causal)
    (out * torch.cos(out)).sum().backward()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(tb.grad.numpy(), want, rtol=BIAS_RTOL,
                               atol=BIAS_ATOL)


def test_bthd_layout_gives_the_transposed_bhtd_gradients():
    """The layout the op uses: the same gradients as bhtd, transposed."""
    q, k, v, bias, g, g_lse = _case(2, 3, 20, 28, 16, (2, 1, 1, 28), True,
                                    0, seed=5)
    a = _port_grads(q, k, v, bias, g, g_lse, True, 0, True, "bhtd")
    b = _port_grads(q, k, v, bias, g, g_lse, True, 0, True, "bthd")
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)


def test_no_bias_gradient_is_taken_for_a_bias_that_needs_none():
    """The op's pad bias does not require grad: dk/dv writes no bias
    rows then, and the plain dk/dv returns None for them."""
    q, k, v, bias, g, _gl = map(
        lambda a: None if a is None else torch.from_numpy(a),
        _case(1, 2, 16, 16, 8, (1, 16), False, 0, seed=6))
    lse = tfa.flash_attention_plain(q, k, v, bias)[1]
    delta = torch.zeros_like(lse)
    dk, dv, db = tfa.flash_attention_dkv(q, k, v, bias, g, lse, delta)
    assert db is None and dk.shape == k.shape and dv.shape == v.shape
    *_kv, db = tfa.flash_attention_dkv(q, k, v, bias, g, lse, delta,
                                       bias_grad=True)
    assert db.shape == (2, 16) and db.dtype == torch.float32


def test_backward_wrappers_take_plain_versions_for_cpu_tensors():
    q, k, v, bias, g, _gl = map(
        lambda a: None if a is None else torch.from_numpy(a),
        _case(2, 2, 16, 16, 8, (2, 16), True, 0, seed=7))
    lse = tfa.flash_attention_plain(q, k, v, bias, True)[1]
    delta = torch.ones_like(lse)
    before = dict(tkern.LAUNCHES)
    dq = tfa.flash_attention_dq(q, k, v, bias, g, lse, delta, True)
    dkv = tfa.flash_attention_dkv(q, k, v, bias, g, lse, delta, True,
                                  bias_grad=True)
    assert torch.equal(dq, tfa.flash_attention_dq_plain(
        q, k, v, bias, g, lse, delta, True))
    for a, w in zip(dkv, tfa.flash_attention_dkv_plain(
            q, k, v, bias, g, lse, delta, True, bias_grad=True)):
        assert torch.equal(a, w)
    assert tkern.LAUNCHES == before


@pytest.mark.parametrize("bad", ["meta", "dout", "lse"])
def test_backward_wrappers_reject_bad_inputs(bad):
    q, k, v, _b, g, _gl = map(
        lambda a: None if a is None else torch.from_numpy(a),
        _case(1, 2, 8, 8, 8, None, False, 0, seed=8))
    lse = torch.zeros((1, 2, 8))
    if bad == "meta":
        q = q.to("meta")
    elif bad == "dout":
        g = g[..., :4]
    else:
        lse = lse[:, :1]
    for fn in (tfa.flash_attention_dq, tfa.flash_attention_dkv):
        with pytest.raises(ValueError):
            fn(q, k, v, None, g, lse, torch.zeros((1, 2, 8)))
