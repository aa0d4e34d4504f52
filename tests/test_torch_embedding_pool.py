"""The port's fused embedding lookup + pool (paddle_tpu_torch:
`ops.kern.embedding` and the `fused_embedding_seq_pool` op of
`ops.kernels_extra`) against the JAX package's on the CPU.

- `lookup_pool_plain` (what the wrapper runs for CPU tensors, and what
  the CUDA kernel is held to on the card) against the Pallas kernel run
  in interpret mode (`paddle_tpu.ops.pallas.embedding.lookup_pool(...,
  interpret=True)`) and against the reference's jnp composition
  `lookup_pool_reference`, which the port does not copy, within 2e-5 (the reference's registered
  kernel tolerance, ops/kern/registrations.py): sum and mean, weighted
  and not, with padding, ids repeated in a row and a row that is all
  padding;
- the backward (d table, d weights) against `jax.grad` through the JAX
  kernel, within the reference's 2e-4 (tests/test_pallas_embedding.py);
- d(table) bit for bit the same from one call to the next on four
  threads (a fixed-order segment sum, not a scatter-add);
- the port's `fused_embedding_seq_pool` op against the JAX op kernel
  (`get_kernel(...)(KernelCtx(), ...)`): ids clipped to the table,
  `padding_idx`, `Weight`, pooltype "average".

The Pallas kernel is called directly with `interpret=True`; nothing
here calls `flash_attention.set_mode` (rule (b) of ROADMAP.md)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops import kernels_extra as jextra
from paddle_tpu.ops import registry as jreg
from paddle_tpu.ops.pallas import embedding as jemb
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.kern import LAUNCHES
from paddle_tpu_torch.ops.kern import embedding as temb

TOL = 2e-5
GRAD_TOL = 2e-4
C, D, R, F = 40, 8, 16, 5


@pytest.fixture(autouse=True)
def _restore_threads():
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def _inputs(seed=0, C=C, D=D, R=R, F=F):
    """table, inv with ~10 % padding, ids repeated within rows, row 3
    all padding; weights in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((C, D)).astype(np.float32)
    inv = rng.integers(0, C, (R, F)).astype(np.int32)
    inv[rng.random((R, F)) < 0.1] = -1
    inv[1, :] = [7, 7, 7, 2, 7][:F]
    inv[3, :] = -1
    w = (0.5 + rng.random((R, F))).astype(np.float32)
    return table, inv, w


@pytest.mark.parametrize("pool", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_matches_the_jax_kernel_and_its_composition(pool, weighted):
    table, inv, w = _inputs()
    wj = jnp.asarray(w) if weighted else None
    want_k = np.asarray(jemb.lookup_pool(jnp.asarray(table),
                                         jnp.asarray(inv), wj, pool, None,
                                         True))
    want_r = np.asarray(jextra.lookup_pool_reference(
        jnp.asarray(table), jnp.asarray(inv), wj, pool))
    before = dict(LAUNCHES)
    got = temb.lookup_pool(torch.from_numpy(table),
                           torch.from_numpy(inv).long(),
                           torch.from_numpy(w) if weighted else None,
                           pool).numpy()
    assert LAUNCHES == before                  # the CPU runs no kernel
    np.testing.assert_allclose(got, want_k, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, want_r, rtol=0, atol=TOL)
    assert (got[3] == 0).all()                 # all padding: 0, count 1
    plain = temb.lookup_pool_plain(torch.from_numpy(table),
                                   torch.from_numpy(inv),
                                   torch.from_numpy(w) if weighted
                                   else None, pool).numpy()
    np.testing.assert_array_equal(got, plain)


def test_one_field_sum_is_an_exact_gather():
    """The sharded engine's call (F = 1, sum): a copy of the rows."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((64, 8)).astype(np.float32)
    table[5] = -0.0
    inv = rng.integers(0, 64, (96, 1))
    inv[::7] = 5
    got = temb.lookup_pool(torch.from_numpy(table), torch.from_numpy(inv))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  table[inv[:, 0]].view(np.int32))


def test_a_nan_row_reaches_only_the_rows_that_look_it_up():
    table, inv, _w = _inputs(seed=2)
    table[0] = np.nan          # where clipped padding would read
    table[9] = np.nan
    inv[inv == 9] = 10
    inv[5, 2] = 9
    got = temb.lookup_pool_plain(torch.from_numpy(table),
                                 torch.from_numpy(inv), None, "mean")
    bad = np.isnan(got.numpy()).any(1)
    looks = ((inv == 9) | (inv == 0)).any(1)
    np.testing.assert_array_equal(bad, looks)
    assert bad[5]


@pytest.mark.parametrize("pool", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_backward_matches_jax_grad_through_the_kernel(pool, weighted):
    table, inv, w = _inputs(seed=3)
    cot = np.random.default_rng(4).standard_normal((R, D)).astype(
        np.float32)

    def jloss(tab, wts):
        out = jemb.lookup_pool(tab, jnp.asarray(inv),
                               wts if weighted else None, pool, None, True)
        return jnp.sum(out * jnp.asarray(cot))

    jd_tab, jd_w = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                                   jnp.asarray(w))
    tab_t = torch.from_numpy(table).requires_grad_(True)
    w_t = torch.from_numpy(w).requires_grad_(True)
    out = temb.lookup_pool(tab_t, torch.from_numpy(inv),
                           w_t if weighted else None, pool)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tab_t.grad.numpy(), np.asarray(jd_tab),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    if weighted:
        np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(jd_w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
        assert (w_t.grad.numpy()[inv < 0] == 0).all()
    else:
        assert w_t.grad is None


def test_table_gradient_is_bitwise_repeatable_on_four_threads():
    torch.set_num_threads(4)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((50, 16)).astype(
        np.float32))
    inv = torch.from_numpy(rng.integers(0, 6, (4096, 26)))  # many repeats
    w = torch.from_numpy(rng.random((4096, 26)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((4096, 16)).astype(
        np.float32))
    grads = []
    for _ in range(3):
        tab = table.clone().requires_grad_(True)
        out = temb.lookup_pool(tab, inv, w, "mean")
        out.backward(dy)
        grads.append(tab.grad.numpy().copy())
    for g in grads[1:]:
        np.testing.assert_array_equal(g.view(np.int32),
                                      grads[0].view(np.int32))


def test_wrapper_takes_cpu_or_cuda_tensors_only_and_checks_shapes():
    table, inv, _w = _inputs()
    t = torch.from_numpy(table)
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        temb.lookup_pool(t.to("meta"), torch.from_numpy(inv).to("meta"))
    with pytest.raises(ValueError, match="inv \\[R, F\\]"):
        temb.lookup_pool(t, torch.from_numpy(inv)[:, :0])
    with pytest.raises(ValueError, match="pool"):
        temb.lookup_pool(t, torch.from_numpy(inv), None, "max")
    with pytest.raises(TypeError, match="int32 or int64"):
        temb.lookup_pool(t, torch.from_numpy(inv).float())
    assert temb.try_lookup_pool(t, torch.from_numpy(inv), None,
                                "max") is None
    assert temb.try_lookup_pool(t, torch.from_numpy(inv)[:, 0]) is None
    assert temb.try_lookup_pool(t, torch.from_numpy(inv).float()) is None
    # the table's dtype is no part of the static check
    got = temb.try_lookup_pool(t.double(), torch.from_numpy(inv))
    assert got.dtype == torch.float64


@pytest.mark.parametrize("entry", ["lookup_pool", "try_lookup_pool",
                                   "fused_embedding_seq_pool"])
def test_a_bf16_table_on_the_card_raises_and_takes_no_plain_path(
        monkeypatch, entry):
    """On CUDA tensors nothing gives way to the plain version: a table
    that is not fp32 reaches the kernel's dtype check and raises. The
    CUDA side is stood in for by reporting the CPU tensors as not on
    the CPU; the check raises before any build or launch."""
    table, inv, w = _inputs()
    t = torch.from_numpy(table).bfloat16()
    ids = torch.from_numpy(inv).long()
    monkeypatch.setattr(temb, "on_cpu", lambda ts, name: False)
    monkeypatch.setattr(temb, "lookup_pool_plain", None)
    with pytest.raises(TypeError, match="fp32 table"):
        if entry == "fused_embedding_seq_pool":
            treg.get_kernel(entry)(
                treg.KernelCtx(), {"W": [t], "Ids": [ids.clamp(min=0)],
                                   "Weight": [torch.from_numpy(w)]},
                {"pooltype": "sum", "padding_idx": 3})
        else:
            getattr(temb, entry)(t, ids)


@pytest.mark.parametrize("attrs,weighted,ids_shape", [
    ({"pooltype": "sum"}, False, (R, F)),
    ({"pooltype": "average", "padding_idx": 3}, False, (R, F, 1)),
    ({"combiner": "sum", "padding_idx": 0}, True, (R, F)),
    ({"pooltype": "mean"}, True, (R,)),
])
def test_fused_embedding_seq_pool_op_matches_the_jax_op(attrs, weighted,
                                                        ids_shape):
    rng = np.random.default_rng(6)
    table = rng.standard_normal((C, D)).astype(np.float32)
    ids = rng.integers(0, C + 9, ids_shape).astype(np.int64)  # some clip
    ids.reshape(-1)[::5] = attrs.get("padding_idx", 0)
    w = (0.5 + rng.random(ids.shape[:2] if len(ids_shape) > 1
                          else ids_shape)).astype(np.float32)
    jins = {"W": [jnp.asarray(table)], "Ids": [jnp.asarray(ids)]}
    tins = {"W": [torch.from_numpy(table)], "Ids": [torch.from_numpy(ids)]}
    if weighted:
        # [R] ids with an [R] Weight: the reference broadcasts the two to
        # [R, R] (it reshapes only a Weight of rank > 2); the port
        # weights row r by Weight[r], which the reference computes for
        # the same numbers given as [R, 1].
        jins["Weight"] = [jnp.asarray(w.reshape(-1, 1) if w.ndim == 1
                                      else w)]
        tins["Weight"] = [torch.from_numpy(w)]
    want = np.asarray(jreg.get_kernel("fused_embedding_seq_pool")(
        jreg.KernelCtx(), jins, dict(attrs))["Out"][0])
    got = treg.get_kernel("fused_embedding_seq_pool")(
        treg.KernelCtx(device=torch.device("cpu")), tins,
        dict(attrs))["Out"][0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    with pytest.raises(NotImplementedError, match="pooltype"):
        treg.get_kernel("fused_embedding_seq_pool")(
            treg.KernelCtx(), tins, {"pooltype": "max"})
