"""The port's Executor (paddle_tpu_torch.core.executor, core.trace,
core.scope) against the JAX package's on the CPU, on the tiny
Transformer inference program built by each package: the reference's
scope, read out as numpy arrays, loaded into the port with
`scope_from_numpy`; `Executor.run` logits within a stated fp32
tolerance; `greedy_decode` ids identical; `run_startup` draws each
parameter from its initializer's distribution; pruning, the run cache,
feeds, the scope and the entry points' guards."""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import unique_name as jun
from paddle_tpu.core import framework as jfw
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.core.scope import scope_guard as jscope_guard
from paddle_tpu.models import transformer as jtfm
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.core import framework as tfw
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.place import CPUPlace, CUDAPlace
from paddle_tpu_torch.core.scope import (Scope, global_scope,
                                         scope_from_numpy, scope_guard)
from paddle_tpu_torch.models import transformer as ttfm
from paddle_tpu_torch.ops import kern as tkern

# fp32 on both sides through 2 encoder and 2 decoder layers; XLA and
# PyTorch sum the matmuls in different orders (measured 1.8e-6 of the
# largest logit, ~2e-5 absolute, with these weights; weights twice as
# wide make the attention sharp enough to amplify that to ~2e-4 of it)
LOGIT_RTOL = LOGIT_ATOL = 2e-4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(fw, un, tm, maxlen=16, **cfg_kw):
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup), un.guard():
        cfg = tm.TransformerConfig.tiny()
        for k, v in cfg_kw.items():
            setattr(cfg, k, v)
        _feeds, logits = tm.build_infer_program(cfg, maxlen=maxlen)
    return main, startup, logits


def wide_params(program, seed):
    """Numpy parameters for every parameter of `program`, drawn wide
    (std 2/sqrt(fan_in); layer-norm scales 1 +- 0.2, biases 0.1) so that
    greedy tokens vary."""
    rng = np.random.default_rng(seed)
    out = {}
    for v in sorted(program.all_parameters(), key=lambda v: v.name):
        a = rng.standard_normal(v.shape).astype(np.float32)
        if v.name.startswith("layer_norm"):
            a = 1 + 0.2 * a if v.name.endswith(".w_0") else 0.1 * a
        elif v.name.endswith(".b_0"):
            a = 0.1 * a
        elif v.name.endswith("_emb.w_0"):
            a = a * 2 / np.sqrt(v.shape[1])
        else:
            a = a * 2 / np.sqrt(v.shape[0])
        out[v.name] = a.astype(np.float32)
    return out


def feeds(B, T, seed):
    rng = np.random.default_rng(seed)
    src_len = rng.integers(1, T + 1, B).astype(np.int64)
    trg_len = rng.integers(1, T + 1, B).astype(np.int64)
    src_len[0] = trg_len[0] = T
    return {"src": rng.integers(2, 128, (B, T)).astype(np.int64),
            "src_len": src_len,
            "trg": rng.integers(2, 128, (B, T)).astype(np.int64),
            "trg_len": trg_len}


@pytest.fixture(scope="module")
def pair():
    """Both packages' tiny programs; the reference's initialized scope
    overwritten with wide numpy weights, and the port's scope loaded
    from the same arrays."""
    jmain, jstart, jlogits = build(jfw, jun, jtfm)
    tmain, tstart, tlogits = build(tfw, tun, ttfm)
    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = JScope()
    jexe.run(jstart, scope=jscope)
    arrays = {n: np.asarray(jscope.get(n)) for n in
              (v.name for v in jmain.persistable_vars())}
    wide = wide_params(jmain, seed=7)
    assert {n: a.shape for n, a in wide.items()} == \
        {n: a.shape for n, a in arrays.items()}
    for n, a in wide.items():
        jscope.set(n, a)
    tscope = scope_from_numpy(wide, CPU)
    return dict(jmain=jmain, jlogits=jlogits, jexe=jexe, jscope=jscope,
                tmain=tmain, tlogits=tlogits, texe=Executor(CPUPlace()),
                tscope=tscope)


@pytest.mark.parametrize("seed", [0, 1])
def test_run_logits_match_the_reference_executor(pair, seed):
    f = feeds(3, 16, seed)
    want = pair["jexe"].run(pair["jmain"], feed=f,
                            fetch_list=[pair["jlogits"]],
                            scope=pair["jscope"], is_test=True)[0]
    got = pair["texe"].run(pair["tmain"], feed=f,
                           fetch_list=[pair["tlogits"]],
                           scope=pair["tscope"], is_test=True)[0]
    assert got.shape == (3, 16, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)


def test_greedy_decode_ids_are_identical(pair):
    rng = np.random.default_rng(3)
    src = rng.integers(2, 128, (4, 16)).astype(np.int64)
    src_len = np.array([16, 5, 9, 12], np.int64)
    with jscope_guard(pair["jscope"]):
        want = jtfm.greedy_decode(pair["jexe"], pair["jmain"],
                                  pair["jlogits"], src, src_len,
                                  fetch_argmax=True)
    with scope_guard(pair["tscope"]):
        got = ttfm.greedy_decode(pair["texe"], pair["tmain"],
                                 pair["tlogits"], src, src_len,
                                 fetch_argmax=True)
        # the logits fetch takes the argmax on the host: same ids
        logits_ids = ttfm.greedy_decode(pair["texe"], pair["tmain"],
                                        pair["tlogits"], src, src_len)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(logits_ids, got)
    assert got.shape == (4, 16) and (got[:, 0] == 0).all()
    assert len(np.unique(got[:, 1:])) > 1      # not one token throughout


def test_greedy_decode_stops_at_eos_and_checks_the_built_length(pair):
    src = np.full((2, 16), 5, np.int64)
    src_len = np.array([16, 3], np.int64)
    with scope_guard(pair["tscope"]):
        ids = ttfm.greedy_decode(pair["texe"], pair["tmain"],
                                 pair["tlogits"], src, src_len,
                                 fetch_argmax=True)
        eos = int(ids[0, 1])
        stopped = ttfm.greedy_decode(pair["texe"], pair["tmain"],
                                     pair["tlogits"], src, src_len,
                                     eos=eos, fetch_argmax=True)
        with pytest.raises(ValueError, match="built length"):
            ttfm.greedy_decode(pair["texe"], pair["tmain"],
                               pair["tlogits"], src[:, :8], src_len)
    done = (stopped[:, 1:] == eos).any(axis=1)
    assert done.all()
    last = max(int(np.argmax(stopped[r, 1:] == eos)) for r in range(2)) + 1
    assert not stopped[:, last + 1:].any()


@pytest.mark.parametrize("fused", [False, True])
def test_run_startup_draws_each_parameter_from_its_initializer(fused):
    """uniform_random (Xavier) params: mean ~0 and variance limit^2/3;
    gaussian_random (embeddings, N(0, 0.02)); fill_constant (layer-norm
    scales 1, biases 0). Bounds are 6 sigma of the sample statistics.
    Every parameter gets the declared shape and dtype, the same seed
    repeats the draw, and distinct parameters get distinct draws."""
    main, startup, _l = build(tfw, tun, ttfm, fused_qkv=fused)
    scope = Scope()
    Executor(CPUPlace()).run_startup(startup, scope=scope)
    ops = {op.outputs["Out"][0]: op for op in startup.global_block().ops}
    seen = set()
    for v in main.all_parameters():
        t = scope.get(v.name)
        assert tuple(t.shape) == v.shape and t.dtype == torch.float32
        op = ops[v.name]
        a = t.double().numpy().ravel()
        n = a.size
        if op.type == "fill_constant":
            assert (a == op.attrs["value"]).all()
            continue
        if op.type == "uniform_random":
            lo, hi = op.attrs["min"], op.attrs["max"]
            assert a.min() >= lo and a.max() <= hi
            mu, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
            sd_var = (hi - lo) ** 2 * np.sqrt(1 / 180) / np.sqrt(n)
        else:
            mu, var = op.attrs["mean"], op.attrs["std"] ** 2
            sd_var = var * np.sqrt(2 / n)
        assert abs(a.mean() - mu) <= 6 * np.sqrt(var / n)
        assert abs(a.var() - var) <= 6 * sd_var
        key = a[:4].tobytes()
        assert key not in seen
        seen.add(key)
    again = Scope()
    Executor(CPUPlace()).run_startup(startup, scope=again)
    for v in main.all_parameters():
        assert torch.equal(again.get(v.name), scope.get(v.name))


def test_run_prunes_to_the_fetches_and_caches_per_fetch_set(pair):
    exe = Executor(CPUPlace())
    main, _startup, logits = build(tfw, tun, ttfm)
    with scope_guard(pair["tscope"]):
        f = feeds(2, 16, 5)
        exe.run(main, feed=f, fetch_list=[logits], is_test=True)
        # the source mask needs only src_len: nothing else runs
        mask = main.global_block().ops[0].outputs["Y"][0]
        got = exe.run(main, feed={"src_len": f["src_len"]},
                      fetch_list=[mask], is_test=True)[0]
    assert got.shape == (2, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, (np.arange(16)[None] < f["src_len"][:, None]).astype(
            np.float32))
    sizes = sorted(len(fn.ops) for fn in exe._cache.values())
    assert sizes[0] == 1 and sizes[1] == len(main.global_block().ops)


def test_feeds_keep_their_declared_dtype_and_missing_state_raises(pair):
    exe = Executor(CPUPlace())
    main = pair["tmain"]
    f = feeds(2, 16, 6)
    f32 = {k: v.astype(np.float64) for k, v in f.items()}
    with scope_guard(pair["tscope"]):
        a = exe.run(main, feed=f, fetch_list=[pair["tlogits"]],
                    is_test=True)[0]
        b = exe.run(main, feed=f32, fetch_list=[pair["tlogits"]],
                    is_test=True, return_numpy=False)[0]
    assert isinstance(b, torch.Tensor)
    np.testing.assert_array_equal(a, b.numpy())
    with scope_guard(Scope()):
        with pytest.raises(RuntimeError, match="not initialized"):
            exe.run(main, feed=f, fetch_list=[pair["tlogits"]])


def test_a_program_with_a_backward_op_names_the_training_slice():
    """A program with a backward_macro op is run by the training slice:
    its forward under autograd, then its update ops, which change the
    parameters in the scope; the part of that slice the port leaves out
    (`program._remat`, memory_optimize) is refused by name."""
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup), tun.guard():
        x = tlayers.data("x", shape=[4])
        loss = tlayers.reduce_sum(tlayers.fc(x, 1))
        topt.Adam(0.1).minimize(loss)
    exe, scope = Executor(CPUPlace()), Scope()
    exe.run_startup(startup, scope=scope)
    w0 = scope.get("fc_0.w_0").clone()
    feed = {"x": np.ones((2, 4), np.float32)}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert exe._step_fn(main, [loss.name], False).trains
    assert not torch.equal(scope.get("fc_0.w_0"), w0)
    main._remat = True
    with pytest.raises(NotImplementedError, match="_remat"):
        Executor(CPUPlace()).run(main, feed=feed, fetch_list=[loss],
                                 scope=scope)


def test_scope_surface_and_bf16_arrays_keep_their_dtype():
    import ml_dtypes
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    s = scope_from_numpy({"a": a, "b": a.astype(ml_dtypes.bfloat16),
                          "i": np.arange(3)}, CPU)
    assert s.get("a").dtype == torch.float32
    assert s.get("b").dtype == torch.bfloat16
    assert s.get("i").dtype == torch.int64
    assert torch.equal(s.get("b").float(), torch.from_numpy(a))
    assert "a" in s and "z" not in s and s.get("z", 3) == 3
    assert s.keys() == {"a", "b", "i"}
    before = global_scope()
    with scope_guard(s):
        assert global_scope() is s
    assert global_scope() is before


def test_executor_runs_on_the_card_by_default_and_raises_without_cuda(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Executor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Executor(CUDAPlace(0))
    assert Executor(CPUPlace()).device == CPU


def test_argmax_layer_runs_int64_and_no_kernel_counts_on_the_cpu(pair):
    main = pair["tmain"].clone()
    with tfw.program_guard(main):
        ids = tlayers.argmax(main.global_block().var(pair["tlogits"].name),
                             axis=-1)
    before = dict(tkern.LAUNCHES)
    with scope_guard(pair["tscope"]):
        got = Executor(CPUPlace()).run(main, feed=feeds(2, 16, 8),
                                       fetch_list=[ids], is_test=True)[0]
    assert got.dtype == np.int64 and got.shape == (2, 16)
    assert tkern.LAUNCHES == before
