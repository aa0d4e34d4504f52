"""The port's training step (paddle_tpu_torch: `models.transformer.
build_program`, `optimizer.Adam.minimize`, `core.backward.
append_backward`, the `backward_macro` branch of `core.trace.
build_step_fn` with its stacked Adam tail, and `core.executor.Executor`)
against the JAX package's on the CPU, at `TransformerConfig.tiny()`
with fused q/k/v, B 4 and T 16:

- the training program's and the startup program's `to_desc()` equal
  the reference's;
- from the reference's initialized scope, copied with `scope_to_numpy`
  / `scope_from_numpy`, dropout 0, three steps: the losses within 2e-4
  (tests/test_flash_attention.py:144), every parameter gradient of step
  1 within GRAD_RTOL / GRAD_ATOL, and every persistable after step 3
  within the bounds stated below;
- the `adam` op against the reference's kernel; the stacked Adam tail
  bit for bit equal to the per-parameter updates; the label-smoothed
  cross entropy's loss and gradient;
- training-mode dropout under autograd (statistics: rule (a) of
  ROADMAP.md), and the Executor's guards.

The reference runs its three steps once, in a module fixture (its
Executor compiles the step twice)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as fluid
from paddle_tpu import unique_name as jun
from paddle_tpu.core import framework as jfw
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as jtfm
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.core import framework as tfw
from paddle_tpu_torch.core import trace as ttrace
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.place import CPUPlace, CUDAPlace
from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                         scope_to_numpy)
from paddle_tpu_torch.models import transformer as ttfm
from paddle_tpu_torch.ops import registry as treg

B, T, STEPS = 4, 16, 3
LOSS_TOL = 2e-4
# step-1 gradients, same state on both sides: XLA and PyTorch sum the
# matmuls and the backward reductions in different orders (measured
# 4.5e-08 at most, on gradients up to 0.12)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# after 3 Adam steps at lr 1e-3. Adam moves an element by about
# lr * m / sqrt(v), i.e. by nearly lr whatever the gradient's size, so
# a summation-order difference in a small gradient shows in the
# parameter: parameters within 1/20 of one step (measured 8.5e-06);
# moments within 1e-4 relative (measured 1.4e-08 absolute on values up
# to 2e-2); the learning rate and the beta powers exactly.
PARAM_ATOL = 5e-5
MOMENT_RTOL, MOMENT_ATOL = 1e-4, 1e-7
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(fw, un, tm, opt, fused=True, dropout=0.0):
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup), un.guard():
        cfg = tm.TransformerConfig.tiny()
        cfg.fused_qkv, cfg.dropout = fused, dropout
        _feeds, avg_cost, _tok = tm.build_program(cfg, maxlen=T)
        opt.Adam(1e-3).minimize(avg_cost)
    return main, startup, avg_cost


def copy_task_feed(step):
    """bench.py's copy task at B 4, T 16, with ragged lengths."""
    rng = np.random.default_rng(step)
    src = rng.integers(3, 128, (B, T)).astype(np.int64)
    src_len = rng.integers(4, T + 1, B).astype(np.int64)
    trg_len = rng.integers(4, T + 1, B).astype(np.int64)
    src_len[0] = trg_len[0] = T
    trg = np.concatenate([np.zeros((B, 1), np.int64),
                          (src[:, :-1] + 1) % 128], axis=1)
    return {"src": src, "src_len": src_len, "trg": trg,
            "trg_len": trg_len, "label": (src + 1) % 128}


def grad_names(main):
    return [op for op in main.global_block().ops
            if op.type == "backward_macro"][0].outputs["Grads"]


@pytest.fixture(scope="module")
def trained():
    """Both packages trained 3 steps from the reference's initialized
    scope, fetching the loss and every gradient each step."""
    jmain, jstart, jloss = build(jfw, jun, jtfm, fluid.optimizer)
    tmain, tstart, tloss = build(tfw, tun, ttfm, topt)
    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = JScope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jmain.persistable_vars()]
    init = scope_to_numpy(jscope, names)
    tscope = scope_from_numpy(init, CPU)
    texe = Executor(CPUPlace())
    gnames = grad_names(jmain)
    out = {"j": [], "t": []}
    for step in range(STEPS):
        feed = copy_task_feed(step)
        out["j"].append([np.asarray(a) for a in jexe.run(
            jmain, feed=feed, fetch_list=[jloss.name] + gnames,
            scope=jscope)])
        out["t"].append(texe.run(tmain, feed=feed,
                                 fetch_list=[tloss.name] + gnames,
                                 scope=tscope))
    return dict(jmain=jmain, jstart=jstart, tmain=tmain, tstart=tstart,
                names=names, gnames=gnames, init=init, fetched=out,
                jfinal=scope_to_numpy(jscope, names),
                tfinal=scope_to_numpy(tscope, names))


@pytest.mark.parametrize("fused", [True, False])
def test_training_programs_describe_the_reference_programs(fused):
    jmain, jstart, _ = build(jfw, jun, jtfm, fluid.optimizer, fused)
    tmain, tstart, _ = build(tfw, tun, ttfm, topt, fused)
    assert tmain.to_desc() == jmain.to_desc()
    assert tstart.to_desc() == jstart.to_desc()
    ops = [op.type for op in tmain.global_block().ops]
    assert ops.count("backward_macro") == 1
    assert ops.count("adam") == len(tmain.all_parameters())


def test_clone_for_test_drops_the_backward_and_the_updates():
    tmain, _ts, _l = build(tfw, tun, ttfm, topt)
    test = tmain.clone(for_test=True)
    types = {op.type for op in test.global_block().ops}
    assert "backward_macro" not in types and "adam" not in types
    assert test._backward_sections == [] \
        and len(tmain._backward_sections) == 1
    assert tmain.clone()._backward_sections == tmain._backward_sections


def test_three_steps_of_losses_match(trained):
    f = trained["fetched"]
    jl = [float(np.asarray(s[0]).reshape(())) for s in f["j"]]
    tl = [float(np.asarray(s[0]).reshape(())) for s in f["t"]]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert tl[2] < tl[0] and all(np.isfinite(tl))


def test_step_one_gradients_match(trained):
    f = trained["fetched"]
    for name, g_j, g_t in zip(trained["gnames"], f["j"][0][1:],
                              f["t"][0][1:]):
        assert g_t.shape == g_j.shape and g_t.dtype == np.float32, name
        np.testing.assert_allclose(g_t, g_j, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_every_persistable_matches_after_three_steps(trained):
    j, t = trained["jfinal"], trained["tfinal"]
    assert set(j) == set(t) == set(trained["names"])
    params = {v.name for v in trained["jmain"].all_parameters()}
    for n in trained["names"]:
        assert t[n].shape == j[n].shape and t[n].dtype == j[n].dtype, n
        if n in params:
            np.testing.assert_allclose(t[n], j[n], rtol=0, atol=PARAM_ATOL,
                                       err_msg=n)
            assert not np.array_equal(t[n], trained["init"][n]), n
        elif "_moment" in n:
            np.testing.assert_allclose(t[n], j[n], rtol=MOMENT_RTOL,
                                       atol=MOMENT_ATOL, err_msg=n)
        else:           # learning rate, beta1 / beta2 powers
            np.testing.assert_array_equal(t[n], j[n], err_msg=n)


def test_adam_op_matches_the_reference_kernel():
    rng = np.random.default_rng(4)
    shp = (6, 5)
    ins = {"Param": rng.standard_normal(shp), "Grad": rng.standard_normal(shp),
           "Moment1": 0.1 * rng.standard_normal(shp),
           "Moment2": np.abs(0.01 * rng.standard_normal(shp)),
           "Beta1Pow": np.array([0.81]), "Beta2Pow": np.array([0.998]),
           "LearningRate": np.array([1e-3])}
    ins = {k: [v.astype(np.float32)] for k, v in ins.items()}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    want = jreg.get_kernel("adam")(
        jreg.KernelCtx(), {k: [jnp.asarray(v[0])] for k, v in ins.items()},
        attrs)
    got = treg.get_kernel("adam")(
        treg.KernelCtx(device=CPU),
        {k: [torch.from_numpy(v[0])] for k, v in ins.items()}, attrs)
    assert set(got) == set(want)
    for slot in want:
        np.testing.assert_allclose(got[slot][0].numpy(),
                                   np.asarray(want[slot][0]), rtol=1e-6,
                                   atol=1e-7, err_msg=slot)


def _train_port(steps, fuse, monkeypatch):
    monkeypatch.setattr(ttrace, "FUSE_OPTIMIZER_TAIL", fuse)
    tmain, tstart, tloss = build(tfw, tun, ttfm, topt)
    exe = Executor(CPUPlace())
    scope = Scope()
    tstart.random_seed = 5
    exe.run_startup(tstart, scope=scope)
    losses = [float(exe.run(tmain, feed=copy_task_feed(s),
                            fetch_list=[tloss], scope=scope)[0])
              for s in range(steps)]
    return losses, scope_to_numpy(scope)


def test_stacked_adam_tail_equals_per_parameter_updates(monkeypatch):
    """With FUSE_OPTIMIZER_TAIL the small same-shape parameters update
    as one stacked adam kernel: bit for bit the per-parameter result on
    the CPU (tests/test_fused_optimizer_tail.py:56 holds the reference
    to ULPs, since XLA may fuse the two differently)."""
    l_fused, p_fused = _train_port(2, True, monkeypatch)
    l_plain, p_plain = _train_port(2, False, monkeypatch)
    assert l_fused == l_plain
    assert set(p_fused) == set(p_plain)
    for n in p_fused:
        np.testing.assert_array_equal(p_fused[n], p_plain[n], err_msg=n)


def test_update_plan_groups_consecutive_adam_ops_of_one_signature():
    class Op:
        def __init__(self, type, lr="lr0", b1=0.9):
            self.type, self.attrs = type, {"beta1": b1}
            self.inputs = {"LearningRate": [lr]}

    ops = [(Op("adam"), 0), (Op("adam"), 1), (Op("scale"), 2),
           (Op("adam"), 3), (Op("adam", lr="lr1"), 4),
           (Op("adam", b1=0.8), 5)]
    plan = ttrace._plan_update_tail(ops)
    assert [e[0] for e in plan] == ["adam_run", "op", "adam_run",
                                    "adam_run", "adam_run"]
    assert [len(e[1]) for e in plan if e[0] == "adam_run"] == [2, 1, 1, 1]


def _labels_with_edge_cases(rng, shape, K):
    lbl = rng.integers(0, K, shape).astype(np.int64)
    lbl.reshape(-1)[:3] = (-100, K, -1)     # ignored, out of range x2
    return lbl


@pytest.mark.parametrize("eps", [0.1, 0.0])
def test_softmax_with_cross_entropy_loss_and_gradient(eps):
    rng = np.random.default_rng(6)
    logits = (3 * rng.standard_normal((3, 5, 11))).astype(np.float32)
    label = _labels_with_edge_cases(rng, (3, 5, 1), 11)
    w = rng.standard_normal((3, 5, 1)).astype(np.float32)
    attrs = {"soft_label": False, "ignore_index": -100,
             "smooth_epsilon": eps}

    def jloss(lg):
        out = jreg.get_kernel("softmax_with_cross_entropy")(
            jreg.KernelCtx(), {"Logits": [lg], "Label": [jnp.asarray(label)]},
            attrs)
        return jnp.sum(out["Loss"][0] * w), out

    (_v, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tout = treg.get_kernel("softmax_with_cross_entropy")(
        treg.KernelCtx(device=CPU),
        {"Logits": [tl], "Label": [torch.from_numpy(label)]}, attrs)
    (tout["Loss"][0] * torch.from_numpy(w)).sum().backward()
    for slot in ("Loss", "Softmax"):
        np.testing.assert_allclose(tout[slot][0].detach().numpy(),
                                   np.asarray(jout[slot][0]), rtol=1e-5,
                                   atol=1e-6, err_msg=slot)
    assert float(tout["Loss"][0].detach().reshape(-1)[:3].abs().max()) == 0.0
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl,scale", [("upscale_in_train", 1 / 0.7),
                                        ("downgrade_in_infer", 1.0)])
def test_training_dropout_keeps_one_minus_p_and_its_gradient_is_the_mask(
        impl, scale):
    """Rule (a): random streams differ from JAX's, so the mask is held
    to its distribution (keep share within 5 sigma of 0.7), the same
    seed gives the same mask and another seed another, and under
    autograd the gradient is the mask times the scale."""
    n, p = 200_000, 0.3
    x = torch.randn(n, generator=torch.Generator().manual_seed(1))
    fn = treg.get_kernel("dropout")
    attrs = {"dropout_prob": p, "dropout_implementation": impl}
    xs = x.clone().requires_grad_(True)
    out = fn(treg.KernelCtx(seed=3, device=CPU), {"X": [xs]}, attrs)
    out["Out"][0].backward(torch.ones(n))
    mask = out["Mask"][0]
    keep = float(mask.mean())
    assert abs(keep - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    np.testing.assert_allclose(xs.grad.numpy(), mask.numpy() * scale,
                               rtol=1e-6, atol=0)
    kept = x / (1 - p) if impl == "upscale_in_train" else x
    assert torch.equal(out["Out"][0].detach(),
                       torch.where(mask.bool(), kept, torch.zeros(())))
    again = fn(treg.KernelCtx(seed=3, device=CPU), {"X": [x]}, attrs)
    other = fn(treg.KernelCtx(seed=4, device=CPU), {"X": [x]}, attrs)
    assert torch.equal(again["Mask"][0], mask)
    assert not torch.equal(other["Mask"][0], mask)


def test_dropout_training_step_is_seeded_by_the_program():
    """The tiny model with dropout 0.1 through the Executor: the same
    program seed gives the same loss, another seed another."""
    def loss(seed):
        tmain, tstart, tloss = build(tfw, tun, ttfm, topt, dropout=0.1)
        tmain.random_seed = seed
        exe = Executor(CPUPlace())
        scope = Scope()
        exe.run_startup(tstart, scope=scope)
        return float(exe.run(tmain, feed=copy_task_feed(0),
                             fetch_list=[tloss], scope=scope)[0])
    a, b, c = loss(1), loss(1), loss(2)
    assert a == b and a != c and np.isfinite(a)


def test_backward_program_needs_cpuplace_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmain, tstart, tloss = build(tfw, tun, ttfm, topt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Executor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Executor(CUDAPlace(0))
    exe = Executor(CPUPlace())
    scope = Scope()
    exe.run_startup(tstart, scope=scope)
    before = scope_to_numpy(scope, ["proj.w_0"])["proj.w_0"]
    got = exe.run(tmain, feed=copy_task_feed(0), fetch_list=[tloss],
                  scope=scope)[0]
    assert np.isfinite(got).all()
    assert not np.array_equal(scope_to_numpy(scope, ["proj.w_0"])[
        "proj.w_0"], before)


def test_parts_of_other_slices_are_refused():
    tmain, tstart, tloss = build(tfw, tun, ttfm, topt)
    with pytest.raises(NotImplementedError, match="regularization"):
        topt.Adam(1e-3, regularization=object())
    with pytest.raises(NotImplementedError, match="lazy_mode"):
        topt.Adam(1e-3, lazy_mode=True)
    with pytest.raises(NotImplementedError, match="scheduler"):
        topt.Adam(tloss)
    with pytest.raises(NotImplementedError, match="grad_sync"):
        topt.Adam(1e-3).minimize(tloss, grad_sync="int8")
    with pytest.raises(NotImplementedError, match="numeric_stable_mode"):
        with tfw.program_guard(tfw.Program(), tfw.Program()):
            x = tlayers.data("x", shape=[4])
            y = tlayers.data("y", shape=[1], dtype="int64")
            tlayers.softmax_with_cross_entropy(x, y,
                                               numeric_stable_mode=False)
    tmain._remat = True
    with pytest.raises(NotImplementedError, match="_remat"):
        Executor(CPUPlace()).run(tmain, feed=copy_task_feed(0),
                                 fetch_list=[tloss])
