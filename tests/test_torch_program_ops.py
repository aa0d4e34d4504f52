"""Per-op parity of the port's op kernels (paddle_tpu_torch.ops) against
the JAX package's (`paddle_tpu.ops.registry.get_kernel`) on the CPU,
for every op of Transformer inference's census: the same numpy inputs
and attrs through both registries, outputs compared slot by slot.

Tolerances: fp32 elementwise and matmul results within RTOL = ATOL =
1e-5 (XLA and PyTorch sum in different orders); integer outputs exact.
On the CPU the port's `layer_norm` and `flash_attention` ops run their
kernels' plain versions (the wrappers take them for CPU tensors), while
the JAX ops run their jnp compositions (the Pallas kernels are off off
the TPU); the flash op's `Weights` output is empty on the kernel path in
both packages and is not compared. The random ops cannot match
`jax.random`: their statistics are checked instead."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.core.dtypes import tensor_from_numpy
from paddle_tpu_torch.ops import kern as tkern
from paddle_tpu_torch.ops import registry as treg

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(op, ins, attrs, is_test=False, seed=0):
    """Run op in both packages; returns (jax outs, torch outs) as numpy."""
    jctx = jreg.KernelCtx(key=jax.random.PRNGKey(seed), is_test=is_test)
    jouts = jreg.get_kernel(op)(
        jctx, {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        dict(attrs, _op_type=op))
    tctx = treg.KernelCtx(seed=seed, is_test=is_test,
                          device=torch.device("cpu"))
    touts = treg.get_kernel(op)(
        tctx, {k: [tensor_from_numpy(a, "cpu") for a in v]
               for k, v in ins.items()}, dict(attrs, _op_type=op))
    conv = {k: [np.asarray(a) for a in v] for k, v in jouts.items()}
    tconv = {k: [a.float().numpy() if a.dtype == torch.bfloat16
                 else a.numpy() for a in v] for k, v in touts.items()}
    return conv, tconv


def _close(a, b, exact=False):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(b.astype(np.float64),
                                   a.astype(np.float64), rtol=RTOL,
                                   atol=ATOL)


def _cmp(op, ins, attrs, slots=("Out",), exact=False, **kw):
    j, t = _run(op, ins, attrs, **kw)
    for s in slots:
        assert len(j[s]) == len(t[s])
        for a, b in zip(j[s], t[s]):
            _close(a, b, exact)
    return j, t


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("xshape,yshape,xn", [((2, 3, 4), (4, 5), 2),
                                              ((2, 3, 4), (12, 5), 1)])
def test_mul(xshape, yshape, xn):
    rng = np.random.default_rng(0)
    _cmp("mul", {"X": [_randn(rng, *xshape)], "Y": [_randn(rng, *yshape)]},
         {"x_num_col_dims": xn, "y_num_col_dims": 1})


@pytest.mark.parametrize("yshape,axis", [((2, 3, 4), -1), ((4,), -1),
                                         ((4,), 2), ((3,), 1),
                                         ((3, 4), 1)])
def test_elementwise_add_with_fluid_axis(yshape, axis):
    rng = np.random.default_rng(1)
    _cmp("elementwise_add", {"X": [_randn(rng, 2, 3, 4)],
                             "Y": [_randn(rng, *yshape)]}, {"axis": axis})


@pytest.mark.parametrize("after", [True, False])
def test_scale(after):
    rng = np.random.default_rng(2)
    _cmp("scale", {"X": [_randn(rng, 3, 5)]},
         {"scale": 1e9, "bias": -1e9, "bias_after_scale": after})
    _cmp("scale", {"X": [_randn(rng, 3, 5)]},
         {"scale": 8.0, "bias": 0.5, "bias_after_scale": after})


def test_relu():
    _cmp("relu", {"X": [_randn(np.random.default_rng(3), 4, 6)]}, {})


@pytest.mark.parametrize("axis,keep", [(-1, False), (1, True), (0, False)])
def test_arg_max(axis, keep):
    j, t = _run("arg_max", {"X": [_randn(np.random.default_rng(4), 3, 4,
                                         7)]},
                {"axis": axis, "keepdims": keep})
    # the reference returns int32 (x32 mode), the port int64
    assert t["Out"][0].dtype == np.int64
    _close(j["Out"][0], t["Out"][0], exact=True)


@pytest.mark.parametrize("shape", [[0, 0, 4, 2], [-1, 8], [2, 0, 2, -1]])
def test_reshape(shape):
    _cmp("reshape", {"X": [_randn(np.random.default_rng(5), 2, 3, 8)]},
         {"shape": shape}, exact=True)


@pytest.mark.parametrize("attrs", [{"axis": 2, "num": 3},
                                   {"axis": 2, "sections": [2, 4, 6]},
                                   {"axis": 0, "num": 2}])
def test_split(attrs):
    _cmp("split", {"X": [_randn(np.random.default_rng(6), 4, 3, 12)]},
         attrs, exact=True)


@pytest.mark.parametrize("axes", [[1, 2], [0], [2]])
def test_unsqueeze(axes):
    _cmp("unsqueeze", {"X": [_randn(np.random.default_rng(7), 3, 5)]},
         {"axes": axes}, exact=True)


@pytest.mark.parametrize("ids_shape,pad", [((2, 3), -1), ((2, 3, 1), -1),
                                           ((2, 3), 2)])
def test_lookup_table(ids_shape, pad):
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 10, ids_shape).astype(np.int64)
    ids.reshape(-1)[:2] = 2
    _cmp("lookup_table", {"W": [_randn(rng, 10, 4)], "Ids": [ids]},
         {"padding_idx": pad}, exact=True)


def test_lookup_table_gradient_is_bitwise_repeatable_on_four_threads():
    """The table gradient adds the rows of repeated ids in a fixed
    order: backward passes on four CPU threads give the same bits. (The
    backward of `w[ids]`, index_put_ with accumulate, adds them from
    several threads in any order.)"""
    torch.set_num_threads(4)
    rng = np.random.default_rng(9)
    ids = torch.from_numpy(rng.integers(0, 50, (64, 128)))
    ids[:, 0] = 0
    w = torch.from_numpy(_randn(rng, 50, 512)).requires_grad_(True)
    dout = torch.from_numpy(_randn(rng, 64, 128, 512))
    ctx = treg.KernelCtx(seed=0, is_test=False, device=torch.device("cpu"))
    grads = []
    for _ in range(4):
        w.grad = None
        out = treg.get_kernel("lookup_table")(
            ctx, {"W": [w], "Ids": [ids]}, {"padding_idx": -1})["Out"][0]
        out.backward(dout)
        grads.append(w.grad.clone())
    assert all(torch.equal(grads[0], g) for g in grads[1:])


@pytest.mark.parametrize("dtype,value", [("float32", 1.5), ("int64", 3.0),
                                         ("float32", -1e9)])
def test_fill_constant(dtype, value):
    j, t = _cmp("fill_constant", {}, {"shape": [2, 3], "dtype": dtype,
                                      "value": value}, exact=True)
    assert t["Out"][0].dtype == np.dtype(dtype)


@pytest.mark.parametrize("out_dtype", ["float32", "int64"])
def test_sequence_mask(out_dtype):
    j, t = _cmp("sequence_mask",
                {"X": [np.array([1, 7, 3, 0], np.int64)]},
                {"maxlen": 7, "out_dtype": out_dtype}, slots=("Y",),
                exact=True)
    assert t["Y"][0].dtype == np.dtype(out_dtype)


@pytest.mark.parametrize("impl,p,attr_test,ctx_test", [
    ("upscale_in_train", 0.1, False, True),
    ("downgrade_in_infer", 0.1, False, True),
    ("downgrade_in_infer", 0.3, True, False),
    ("upscale_in_train", 0.0, False, False)])
def test_dropout_at_inference(impl, p, attr_test, ctx_test):
    """Under is_test (attr or executor mode): identity for
    upscale_in_train, a scale by 1 - p for downgrade_in_infer; p = 0 is
    the identity in training too."""
    _cmp("dropout", {"X": [_randn(np.random.default_rng(9), 3, 40)]},
         {"dropout_prob": p, "is_test": attr_test,
          "dropout_implementation": impl}, slots=("Out", "Mask"),
         is_test=ctx_test)


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_in_training_keeps_one_minus_p(impl):
    """Training draws from the op's generator: the kept share is 1 - p
    (binomial, 4 sigma), kept values are x / (1 - p) (upscale) or x, the
    rest 0; the same seed repeats the draw, another seed does not."""
    p, n = 0.3, 20000
    x = torch.from_numpy(_randn(np.random.default_rng(10), n) + 5.0)
    fn = treg.get_kernel("dropout")
    attrs = {"dropout_prob": p, "dropout_implementation": impl}

    def run(seed):
        ctx = treg.KernelCtx(seed=seed, device=torch.device("cpu"))
        return fn(ctx, {"X": [x]}, attrs)
    out = run(11)
    keep = out["Mask"][0].bool()
    share = float(keep.float().mean())
    assert abs(share - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n)
    want = x / (1 - p) if impl == "upscale_in_train" else x
    assert torch.equal(out["Out"][0][keep], want[keep])
    assert not out["Out"][0][~keep].any()
    assert torch.equal(run(11)["Mask"][0], out["Mask"][0])
    assert not torch.equal(run(12)["Mask"][0], out["Mask"][0])


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (0.5, 2.0)])
def test_add_position_encoding(alpha, beta):
    _cmp("add_position_encoding",
         {"X": [_randn(np.random.default_rng(13), 2, 9, 8)]},
         {"alpha": alpha, "beta": beta})


def _attn_ins(rng, layout, B=2, H=3, T=5, S=7, D=4, mask="key"):
    def mk(n):
        return _randn(rng, B, n, H, D) if layout == "bthd" \
            else _randn(rng, B, H, n, D)
    ins = {"Q": [mk(T)], "K": [mk(S)], "V": [mk(S)]}
    if mask == "key":
        lens = np.array([S, 3])[:B]
        keep = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
        ins["Mask"] = [(keep * 1e9 - 1e9)[:, None, None, :]]
    elif mask == "full":
        ins["Mask"] = [_randn(rng, B, H, T, S)]
    return ins


@pytest.mark.parametrize("layout", ["bthd", "bhtd"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", ["key", None])
def test_scaled_dot_product_attention(layout, causal, mask):
    _cmp("scaled_dot_product_attention",
         _attn_ins(np.random.default_rng(14), layout, mask=mask),
         {"causal": causal, "scale": 0.5, "layout": layout},
         slots=("Out", "Weights"))


@pytest.mark.parametrize("layout", ["bthd", "bhtd"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", ["key", None, "full"])
def test_flash_attention(layout, causal, mask):
    """The port's op takes its kernel (here the plain version) for a
    per-key bias or none, and the sdpa composition for a full bias; the
    reference runs its composition off the TPU. Out agrees either way;
    Weights is empty exactly where the kernel path ran."""
    ins = _attn_ins(np.random.default_rng(15), layout, mask=mask)
    attrs = {"causal": causal, "scale": 0.5, "layout": layout}
    before = dict(tkern.LAUNCHES)
    j, t = _cmp("flash_attention", ins, attrs)
    if mask == "full":
        _close(j["Weights"][0], t["Weights"][0])
    else:
        assert t["Weights"][0].size == 0
    assert tkern.LAUNCHES == before       # the plain version never counts


@pytest.mark.parametrize("shape,begin,affine,dtype", [
    ((2, 3, 8), 2, (True, True), np.float32),
    ((4, 16), 1, (True, True), np.float32),
    ((1, 5, 8), 2, (True, True), np.float32),
    ((2, 3, 8), 1, (True, True), np.float32),
    ((2, 3, 8), 2, (True, False), np.float32),
    ((2, 3, 8), 2, (False, False), np.float32),
    ((2, 3, 8), 2, (True, True), "bfloat16")])
def test_layer_norm(shape, begin, affine, dtype):
    """Kernel path (last axis, scale and bias) and composition (any
    other begin_norm_axis, or a missing scale or bias); Mean and
    Variance squeezed as the reference squeezes them (a batch dim of 1
    too). bf16 x keeps y in bf16, compared in f32 within one bf16
    step."""
    rng = np.random.default_rng(16)
    x = _randn(rng, *shape) * 3 + 1
    if dtype == "bfloat16":
        import ml_dtypes
        x = x.astype(ml_dtypes.bfloat16)
    C = int(np.prod(shape[begin:]))
    ins = {"X": [x]}
    if affine[0]:
        ins["Scale"] = [1 + 0.2 * _randn(rng, C)]
    if affine[1]:
        ins["Bias"] = [0.1 * _randn(rng, C)]
    j, t = _run("layer_norm", ins, {"epsilon": 1e-5,
                                    "begin_norm_axis": begin})
    for s in ("Mean", "Variance"):
        _close(j[s][0], t[s][0])
    if dtype == "bfloat16":
        a = np.asarray(j["Y"][0], np.float32)
        np.testing.assert_allclose(t["Y"][0], a, rtol=2 ** -7, atol=1e-5)
    else:
        _close(j["Y"][0], t["Y"][0])
