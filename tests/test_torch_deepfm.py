"""DeepFM through the port's plain Executor with row-sparse tables
(paddle_tpu_torch: `models.deepfm`, `layers.embedding(is_sparse=True)`,
the dense/sparse partition of `core.backward`, the row taps of
`core.trace`, `optimizer.SGD` / `Adam` with `sparse_sgd` /
`sparse_adam`) against the JAX package's on the CPU.

- the DeepFM training program's and startup program's `to_desc()`
  equal the reference's (`is_sparse`, and `is_distributed`, with SGD
  and Adam);
- the `is_sparse` row gradients (`<delta>@GRAD`) of one step equal the
  reference's, also where a lookup's ids are made inside the forward
  (the shape probe);
- the stacked Adam tail leaves `sparse_adam` out of its groups, and
  gives the per-parameter updates bit for bit;
- the training losses match the reference's within 1e-5 over 3 SGD
  steps from its initialized scope, at bench.py's deepfm shape scaled
  down (F 26, D 16, vocab 1000, B 32).

Tolerance: both sides run the same fp32 ops; XLA and PyTorch order the
sums of the 400-wide tower differently (measured ~1e-7 on losses of
0.69)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import layers as jl
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.core import framework as tfw
from paddle_tpu_torch.core import trace as ttrace
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                         scope_to_numpy)
from paddle_tpu_torch.models import deepfm as tdeepfm

LOSS_TOL = 1e-5
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
F, VOCAB, D, B = 26, 1000, 16, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(fw, un, model, opt_mod, opt="sgd", dist=False, vocab=VOCAB):
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup), un.guard():
        _feeds, loss, prob = model.build_program(
            num_fields=F, vocab_size=vocab, embed_dim=D,
            is_distributed=dist)
        (opt_mod.SGD(0.1) if opt == "sgd" else opt_mod.Adam(1e-3)
         ).minimize(loss)
    main.random_seed = startup.random_seed = 1
    return main, startup, loss, prob


def _both(opt="sgd", dist=False, vocab=VOCAB):
    return (_build(pt, pt.unique_name, jdeepfm, pt.optimizer, opt, dist,
                   vocab),
            _build(tfw, tun, tdeepfm, topt, opt, dist, vocab))


def _feed(step):
    rng = np.random.RandomState(step)
    return {"feat_ids": rng.randint(0, VOCAB, (B, F, 1)).astype("int64"),
            "feat_vals": rng.rand(B, F).astype("float32"),
            "label": rng.randint(0, 2, (B, 1)).astype("float32")}


def _jax_state(main, startup):
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    names = [v.name for v in main.persistable_vars()]
    return exe, scope, scope_to_numpy(scope, names)


def _row_grads(main):
    bop = [op for op in main.global_block().ops
           if op.type == "backward_macro"][0]
    return [t["grad"] for s in bop.attrs["sparse_params"] for t in s["taps"]]


@pytest.mark.parametrize("opt,dist", [("sgd", False), ("adam", False),
                                      ("sgd", True), ("adam", True)])
def test_program_descriptions_equal_the_reference(opt, dist):
    (jm, js, _jl, _jp), (tm, ts, _tl, _tp) = _both(opt, dist, 100000)
    assert tm.to_desc() == jm.to_desc()
    assert ts.to_desc() == js.to_desc()
    types = [op.type for op in tm.global_block().ops]
    sparse_op = "sparse_sgd" if opt == "sgd" else "sparse_adam"
    assert types.count(sparse_op) == 2 and types.count("lookup_table") == 2
    assert all(op.attrs.get("is_distributed", False) == dist
               for op in tm.global_block().ops if op.type == "lookup_table")


def test_row_gradients_equal_the_reference():
    (jm, js, jloss, _jp), (tm, _ts, tloss, _tp) = _both("adam")
    jexe, jscope, init = _jax_state(jm, js)
    gnames = _row_grads(tm)
    assert gnames == _row_grads(jm) and len(gnames) == 2
    feed = _feed(0)
    want = jexe.run(jm, feed=feed, fetch_list=[jloss.name] + gnames,
                    scope=jscope)
    got = Executor(CPUPlace()).run(tm, feed=feed,
                                   fetch_list=[tloss] + gnames,
                                   scope=scope_from_numpy(init, "cpu"))
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)
    assert got[1].shape == (B, F, 1) and got[2].shape == (B, F, D)


def _derived_ids_model(fw, un, L, opt_mod):
    """A lookup whose ids are a reshape of the feed: their shape is
    known only by running the forward."""
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup), un.guard():
        raw = L.data("raw", shape=[6], dtype="int64")
        ids = L.reshape(raw, [-1, 3, 1])
        y = L.data("y", shape=[4], dtype="float32")
        emb = L.embedding(ids, size=[50, 4], is_sparse=True,
                          param_attr="tbl")
        loss = L.mean(L.square_error_cost(L.reduce_sum(emb, dim=1), y))
        opt_mod.SGD(0.5).minimize(loss)
    main.random_seed = startup.random_seed = 2
    return main, startup, loss


def test_row_gradients_of_ids_made_in_the_forward():
    jm, js, jloss = _derived_ids_model(pt, pt.unique_name, jl, pt.optimizer)
    tm, _ts, tloss = _derived_ids_model(tfw, tun, tl, topt)
    jexe, jscope, init = _jax_state(jm, js)
    rng = np.random.RandomState(9)
    feed = {"raw": rng.randint(0, 50, (5, 6)).astype("int64"),
            "y": rng.randn(10, 4).astype("float32")}
    g = _row_grads(tm)
    want = jexe.run(jm, feed=feed, fetch_list=[jloss.name] + g + ["tbl"],
                    scope=jscope)
    got = Executor(CPUPlace()).run(tm, feed=feed,
                                   fetch_list=[tloss] + g + ["tbl"],
                                   scope=scope_from_numpy(init, "cpu"))
    assert got[1].shape == (10, 3, 4)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(w), **GRAD_TOL)


def test_stacked_adam_tail_leaves_sparse_adam_out():
    (_j, _js, _jl, _jp), (tm, ts, tloss, _tp) = _both("adam")
    ops = tm.global_block().ops
    bi = [op.type for op in ops].index("backward_macro")
    plan = ttrace._plan_update_tail([(op, i) for i, op in
                                     enumerate(ops[bi + 1:], start=bi + 1)])
    grouped = [op.type for e in plan if e[0] == "adam_run"
               for op, _i in e[1]]
    alone = [e[1].type for e in plan if e[0] == "op"]
    assert set(grouped) == {"adam"} and alone == ["sparse_adam"] * 2
    exe = Executor(CPUPlace())
    scope = Scope()
    exe.run_startup(ts, scope=scope)
    init = scope_to_numpy(scope)
    state = []
    for fuse in (True, False):
        ttrace.FUSE_OPTIMIZER_TAIL = fuse
        try:
            scope = scope_from_numpy(init, "cpu")
            for step in range(2):
                exe.run(tm, feed=_feed(step), fetch_list=[tloss],
                        scope=scope)
            state.append(scope_to_numpy(scope))
        finally:
            ttrace.FUSE_OPTIMIZER_TAIL = True
    for n in state[0]:
        np.testing.assert_array_equal(state[0][n], state[1][n])


def test_dense_is_sparse_training_matches_the_reference():
    (jm, js, jloss, _jp), (tm, _ts, tloss, _tp) = _both("sgd")
    jexe, jscope, init = _jax_state(jm, js)
    tscope = scope_from_numpy(init, "cpu")
    texe = Executor(CPUPlace())
    jl_, tl_ = [], []
    for step in range(3):
        feed = _feed(step)
        jl_.append(float(np.asarray(jexe.run(jm, feed=feed,
                                             fetch_list=[jloss.name],
                                             scope=jscope)[0])))
        tl_.append(float(texe.run(tm, feed=feed, fetch_list=[tloss],
                                  scope=tscope)[0]))
    np.testing.assert_allclose(tl_, jl_, rtol=0, atol=LOSS_TOL)
    names = [v.name for v in jm.persistable_vars()]
    want = scope_to_numpy(jscope, names)
    got = scope_to_numpy(tscope, names)
    for n in names:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-6)
