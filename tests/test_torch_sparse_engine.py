"""The port's sharded embedding engine (paddle_tpu_torch:
`parallel.sparse`, `parallel.parallel_executor`, `parallel.mesh`, the
row-sparse updates of `ops.kernels_optim`) against the JAX package's on
the CPU.

- `unique_static` and `dedup_rows` exactly equal to the reference's
  (a stable sort on both sides; the segment sums add in one order);
- the policy grammar, `kernel=0` refused, a mesh of two members refused;
- the engine on one member against the JAX engine on the suite's
  8-device CPU mesh and against the JAX dense `is_sparse` Executor
  path, with the reference tests' table model
  (tests/test_sparse_engine.py:22-80) and a tiny DeepFM (F 4, vocab 64,
  D 4, deep (8, 8)): losses and tables (through `to_logical`) for SGD
  and Adam, `stale=1`, a capacity that drops ids (against the JAX
  engine on a one-device mesh, whose buckets are the port's) and
  `padding_idx`; both start from the reference's initialized scope;
- `strip_table_init` + `init_shards`: shapes, zero moments, and the
  same rows from two processes.

Tolerances: the port on one member sums the loss and the row gradients
as the JAX dense path does (1e-6); the JAX engine on eight members
takes the loss as a mean of member means and merges row gradients
across members, a different order of the same float sums (rtol 1e-4,
atol 1e-6, the reference's own bound between its engine and its dense
path, tests/test_sparse_engine.py:123)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu import layers as jl
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.ops import kernels_optim as jopt
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import sparse as jsp
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.core import framework as tfw
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                         scope_to_numpy)
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.ops import kernels_optim as topt_k
from paddle_tpu_torch.parallel import ParallelExecutor, local_mesh
from paddle_tpu_torch.parallel import sparse as tsp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, DIM, B = 64, 8, 16
EXACT_TOL = dict(rtol=1e-6, atol=1e-6)
MESH8_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ builders
def _table_model(fw, un, L, opt_mod, opt, dist, padding_idx=None):
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup), un.guard():
        i = L.data("ids", shape=[4, 1], dtype="int64")
        y = L.data("y", shape=[DIM], dtype="float32")
        emb = L.embedding(i, size=[VOCAB, DIM], is_sparse=True,
                          is_distributed=dist, padding_idx=padding_idx,
                          param_attr="tbl")
        loss = L.mean(L.square_error_cost(L.reduce_sum(emb, dim=1), y))
        {"adam": lambda: opt_mod.Adam(1e-2),
         "sgd": lambda: opt_mod.SGD(1e-1)}[opt]().minimize(loss)
    main.random_seed = startup.random_seed = 17
    return main, startup, loss


def _deepfm_model(fw, un, L, model, opt_mod, opt, dist):
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup), un.guard():
        ids = L.data("feat_ids", shape=[4], dtype="int64")
        vals = L.data("feat_vals", shape=[4], dtype="float32")
        label = L.data("label", shape=[1], dtype="float32")
        logit = model.deepfm(ids, vals, 4, VOCAB, 4, deep_layers=(8, 8),
                             is_distributed=dist)
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
        {"adam": lambda: opt_mod.Adam(1e-2),
         "sgd": lambda: opt_mod.SGD(1e-1)}[opt]().minimize(loss)
    main.random_seed = startup.random_seed = 11
    return main, startup, loss


def _table_feeds(steps, padding_idx=None):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(steps):
        ids = rng.randint(0, VOCAB, (B, 4, 1)).astype("int64")
        if padding_idx is not None:
            ids[::3, 1] = padding_idx
        out.append({"ids": ids,
                    "y": rng.randn(B, DIM).astype("float32")})
    return out


def _deepfm_feeds(steps):
    rng = np.random.RandomState(5)
    return [{"feat_ids": rng.randint(0, VOCAB, (B, 4, 1)).astype("int64"),
             "feat_vals": rng.rand(B, 4).astype("float32"),
             "label": rng.randint(0, 2, (B, 1)).astype("float32")}
            for _ in range(steps)]


def _models(kind, opt, dist, padding_idx=None):
    if kind == "table":
        return (_table_model(pt, pt.unique_name, jl, pt.optimizer, opt,
                             dist, padding_idx),
                _table_model(tfw, tun, tl, topt, opt, dist, padding_idx))
    return (_deepfm_model(pt, pt.unique_name, jl, jdeepfm, pt.optimizer,
                          opt, dist),
            _deepfm_model(tfw, tun, tl, tdeepfm, topt, opt, dist))


def _jax_run(model, feeds, engine, spec="shard", mesh=None):
    """The reference: its startup, then the dense Executor or the
    engine; -> (init arrays, losses, {row var: logical table}, stats)."""
    main, startup, loss = model
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        init = {v.name: np.asarray(scope.get(v.name))
                for v in main.persistable_vars()}
        if engine:
            pexe = pt.ParallelExecutor(loss_name=loss.name,
                                       main_program=main, scope=scope,
                                       sparse=spec, mesh=mesh)
            run = lambda f: pexe.run(feed=f, fetch_list=[loss])  # noqa
        else:
            run = lambda f: exe.run(main, feed=f, fetch_list=[loss])  # noqa
        losses = [float(np.asarray(run(f)[0])) for f in feeds]
        if engine:
            eng = pexe.sparse_engine
            rows = {n: eng.to_logical(eng.owner_table(n),
                                      np.asarray(scope.get(n)))
                    for n in eng.row_var_names}
            stats = {t: np.asarray(scope.get(jsp.STATS_PREFIX + t))
                     for t in eng.tables}
        else:
            rows = {n: np.asarray(scope.get(n)) for n in init}
            stats = None
    return init, losses, rows, stats


def _port_run(model, init, feeds, spec="shard"):
    main, _startup, loss = model
    scope = scope_from_numpy(init, "cpu")
    pexe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                            main_program=main, scope=scope, sparse=spec)
    losses = [float(pexe.run(feed=f, fetch_list=[loss])[0]) for f in feeds]
    eng = pexe.sparse_engine
    rows = {n: eng.to_logical(n, scope.get(n)) for n in eng.row_var_names}
    stats = {t: scope.get(tsp.STATS_PREFIX + t).numpy() for t in eng.tables}
    return losses, rows, stats, scope, pexe


# ------------------------------------------------------- pure helpers
def test_unique_static_equals_the_reference():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 37, 200).astype("int32")
    want = [np.asarray(x) for x in jsp.unique_static(jnp.asarray(ids))]
    got = [x.numpy() for x in tsp.unique_static(torch.from_numpy(ids))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][got[1]], ids)


def test_dedup_rows_equals_the_reference_bit_for_bit():
    rng = np.random.RandomState(1)
    ids = rng.randint(-3, 50, (30, 7))            # some clip at both ends
    rows = rng.randn(30, 7, 5).astype("float32")
    ju, js = jopt.dedup_rows(jnp.asarray(ids, jnp.int32), jnp.asarray(rows),
                             40)
    tu, ts = topt_k.dedup_rows(torch.from_numpy(ids), torch.from_numpy(rows),
                               40)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))


def test_policy_grammar_and_refusals(monkeypatch):
    p = tsp.parse_policy("shard:stale=2,cap=128")
    assert (p.stale_steps, p.capacity) == (2, 128)
    assert tsp.parse_policy("on").mode == "shard"
    assert tsp.parse_policy("off") is None and tsp.parse_policy(None) is None
    for bad in ("shard:bogus=1", "rows", "shard:stale", "shard:cap=0"):
        with pytest.raises(ValueError):
            tsp.parse_policy(bad)
    with pytest.raises(NotImplementedError, match="turns a kernel off"):
        tsp.parse_policy("shard:kernel=0")
    assert tsp.parse_policy("shard:kernel=1").mode == "shard"
    monkeypatch.setenv("PADDLE_TPU_SPARSE", "shard:stale=1")
    assert tsp.resolve_policy().stale_steps == 1
    assert tsp.resolve_policy("off") is None


def test_two_member_mesh_and_other_slices_are_refused():
    _jm, (main, _s, loss) = _models("table", "sgd", True)
    two = local_mesh(devices=["cpu", "cpu"])
    assert two.shape == {"dp": 2}
    with pytest.raises(NotImplementedError, match="queue A 10"):
        ParallelExecutor(loss_name=loss.name, main_program=main,
                         sparse="shard", mesh=two)
    with pytest.raises(NotImplementedError, match="queue A 10"):
        tsp.SparseEngine(main, tsp.parse_policy("shard"), two)
    with pytest.raises(NotImplementedError, match="grad_sync"):
        ParallelExecutor(use_cuda=False, main_program=main, sparse="shard",
                         grad_sync="int8")
    _jm, (dmain, _s, _l) = _models("table", "sgd", False)
    with pytest.raises(ValueError, match="no distributed lookup table"):
        ParallelExecutor(use_cuda=False, main_program=dmain, sparse="shard")
    assert tsp.discover_tables(main) == ["tbl"]


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("kind", ["table", "deepfm"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_engine_matches_the_jax_engine_and_the_dense_path(kind, opt):
    feeds = (_table_feeds if kind == "table" else _deepfm_feeds)(3)
    (jm_e, tm_e) = _models(kind, opt, True)
    init, j_eng, j_rows, j_stats = _jax_run(jm_e, feeds, engine=True)
    jm_d, _tm = _models(kind, opt, False)
    _i, j_dense, jd_rows, _s = _jax_run(jm_d, feeds, engine=False)
    losses, rows, stats, _scope, pexe = _port_run(tm_e, init, feeds)
    np.testing.assert_allclose(losses, j_dense, **EXACT_TOL)
    np.testing.assert_allclose(losses, j_eng, **MESH8_TOL)
    assert set(rows) == set(j_rows)
    for n, v in rows.items():
        np.testing.assert_allclose(v, jd_rows[n], **EXACT_TOL)
        np.testing.assert_allclose(v, j_rows[n], **MESH8_TOL)
    # stats: [ids, distinct ids, overflow, lookups] as a member mean:
    # the reference's members look up 1/8 of the ids each
    for t, s in stats.items():
        assert s[0] == 8 * j_stats[t][0] == len(feeds) * B * 4
        assert s[2] == j_stats[t][2] == 0
        assert s[3] == j_stats[t][3] == len(feeds)
    untouched = np.setdiff1d(np.arange(VOCAB), np.concatenate(
        [f["ids" if kind == "table" else "feat_ids"].ravel()
         for f in feeds]))
    for t in pexe.sparse_engine.tables:
        np.testing.assert_array_equal(rows[t][untouched], init[t][untouched])


def test_stale_engine_matches_the_jax_engine():
    feeds = _table_feeds(5)
    jm, tm = _models("table", "adam", True)
    init, j_losses, j_rows, _js = _jax_run(jm, feeds, True, "shard:stale=1")
    losses, rows, _s, scope, _p = _port_run(tm, init, feeds, "shard:stale=1")
    np.testing.assert_allclose(losses, j_losses, **MESH8_TOL)
    np.testing.assert_allclose(rows["tbl"], j_rows["tbl"], **MESH8_TOL)
    # the first step's update is still pending after one step
    assert scope.get(tsp.PEND_PREFIX + "tbl.ids").shape == (1, 1, B * 4)


def test_capacity_drops_ids_as_the_one_member_jax_engine_does():
    feeds = _table_feeds(3)
    jm, tm = _models("table", "sgd", True)
    one = jmesh.local_mesh("dp", jax.devices()[:1])
    init, j_losses, j_rows, j_stats = _jax_run(jm, feeds, True,
                                               "shard:cap=20", one)
    losses, rows, stats, _sc, _p = _port_run(tm, init, feeds, "shard:cap=20")
    np.testing.assert_allclose(losses, j_losses, **EXACT_TOL)
    np.testing.assert_allclose(rows["tbl"], j_rows["tbl"], **EXACT_TOL)
    np.testing.assert_array_equal(stats["tbl"], j_stats["tbl"])
    assert stats["tbl"][2] > 0                    # ids were dropped


def test_padding_idx_matches_the_jax_dense_path():
    feeds = _table_feeds(3, padding_idx=0)
    jm_e, tm_e = _models("table", "sgd", True, padding_idx=0)
    jm_d, _tm = _models("table", "sgd", False, padding_idx=0)
    init, _l, _r, _s = _jax_run(jm_e, feeds[:0], engine=True)
    _i, j_losses, j_rows, _s = _jax_run(jm_d, feeds, engine=False)
    losses, rows, _st, _sc, _p = _port_run(tm_e, init, feeds)
    np.testing.assert_allclose(losses, j_losses, **EXACT_TOL)
    np.testing.assert_allclose(rows["tbl"], j_rows["tbl"], **EXACT_TOL)
    np.testing.assert_array_equal(rows["tbl"][0], init["tbl"][0])


def test_dense_is_sparse_executor_matches_the_jax_executor():
    """The port's plain Executor on the same is_sparse program (no
    engine): the lazy sparse_adam updates in place, like the
    reference's functional ones."""
    feeds = _deepfm_feeds(3)
    jm, tm = _models("deepfm", "adam", False)
    init, j_losses, j_rows, _s = _jax_run(jm, feeds, engine=False)
    main, _startup, loss = tm
    scope = scope_from_numpy(init, "cpu")
    exe = Executor(CPUPlace())
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    np.testing.assert_allclose(losses, j_losses, **EXACT_TOL)
    got = scope_to_numpy(scope, list(j_rows))
    for n in j_rows:
        np.testing.assert_allclose(got[n], j_rows[n], **EXACT_TOL)


def test_a_jax_engine_scope_carries_over_and_back():
    """The JAX engine trains two steps on 8 devices; its state, tables
    and moments read out through its `to_logical`, loads into the port
    (`scope_from_numpy`, then `prepare_persist` lays it out); both take
    a third step, and the port's state comes back out (`to_logical`,
    `export_shards`) equal to the reference's."""
    feeds = _deepfm_feeds(3)
    jm, tm = _models("deepfm", "adam", True)
    main, startup, loss = jm
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(startup)
        pexe = pt.ParallelExecutor(loss_name=loss.name, main_program=main,
                                   scope=scope, sparse="shard")
        for f in feeds[:2]:
            pexe.run(feed=f, fetch_list=[loss])
        eng = pexe.sparse_engine
        state = {}
        for v in main.persistable_vars():
            val = np.asarray(scope.get(v.name))
            t = eng.owner_table(v.name)
            state[v.name] = eng.to_logical(t, val) if t else val
        j_loss = float(np.asarray(pexe.run(feed=feeds[2],
                                           fetch_list=[loss])[0]))
        j_rows = {n: eng.to_logical(eng.owner_table(n),
                                    np.asarray(scope.get(n)))
                  for n in eng.row_var_names}
    losses, rows, _st, tscope, tpexe = _port_run(tm, state, feeds[2:])
    np.testing.assert_allclose(losses[0], j_loss, **MESH8_TOL)
    assert set(rows) == set(j_rows) and len(rows) == 6   # 2 tables + moments
    for n in rows:
        np.testing.assert_allclose(rows[n], j_rows[n], **MESH8_TOL)
    layout, files = tpexe.sparse_engine.export_shards(tscope)
    for n in rows:
        np.testing.assert_array_equal(files[layout[n]["files"]["0"]],
                                      rows[n])


# ---------------------------------------------------------- placement
def test_strip_table_init_and_init_shards():
    _jm, (main, startup, loss) = _models("deepfm", "adam", True)
    tables = tsp.discover_tables(main)
    tsp.strip_table_init(startup, tables)
    assert not any(set(op.output_names()) & set(tables)
                   for op in startup.global_block().ops)
    scope = Scope()
    Executor(CPUPlace()).run_startup(startup, scope=scope)
    pexe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                            main_program=main, scope=scope, sparse="shard")
    eng = pexe.sparse_engine
    eng.init_shards(scope, seed=1)
    for t in eng.tables.values():
        val = scope.get(t.name)
        assert tuple(val.shape) == t.physical_shape == (VOCAB, t.dim)
        assert 0.01 < float(val.std()) < 0.03
        for m in t.moments:
            assert not scope.get(m).any()
    before = scope.get(tables[1]).clone()
    f = _deepfm_feeds(1)[0]
    assert np.isfinite(pexe.run(feed=f, fetch_list=[loss])[0]).all()
    assert scope.get(tables[1]) is not before         # laid out, not copied
    layout, files = eng.export_shards(scope)
    rec = layout[tables[1]]
    assert rec["world"] == 1 and rec["local_rows"] == VOCAB
    np.testing.assert_array_equal(files[rec["files"]["0"]],
                                  scope.get(tables[1]).numpy())


_SEED_PROBE = """
import hashlib, sys
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.core import framework as fw
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch import unique_name as un, layers as L, optimizer as o
from paddle_tpu_torch.parallel import local_mesh, sparse as sp
main, startup = fw.Program(), fw.Program()
with fw.program_guard(main, startup), un.guard():
    i = L.data("ids", shape=[2, 1], dtype="int64")
    e = L.embedding(i, size=[1000, 4], is_sparse=True, is_distributed=True)
    o.SGD(0.1).minimize(L.mean(e))
eng = sp.SparseEngine(main, sp.parse_policy("shard"),
                      local_mesh(devices=["cpu"]))
scope = Scope()
eng.init_shards(scope, seed=7)
print(hashlib.sha256(scope.get(sp.discover_tables(main)[0]).numpy()
                     .tobytes()).hexdigest())
"""


def test_init_shards_draws_the_same_rows_in_two_processes():
    code = _SEED_PROBE.format(repo=REPO)
    procs = []
    for hashseed in ("1", "2"):            # two processes at once
        env = dict(os.environ, PYTHONHASHSEED=hashseed)
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    digests = set()
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        digests.add(out.strip())
    assert len(digests) == 1
