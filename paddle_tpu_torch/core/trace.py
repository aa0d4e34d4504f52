"""Program -> step function (counterpart of `paddle_tpu/core/trace.py`:
`exec_op`, `_find_backward` :265, `_prune_ops` :296,
`_collect_sparse_deltas` :316, `build_step_fn` :339 with its
`backward_macro` branch and its `sparse_engine` hook, and the stacked
Adam tail `_plan_update_tail` :47, `_exec_adam_group` :72 and
`_exec_adam_run` :108 under `FUSE_OPTIMIZER_TAIL` / `FUSE_MAX_ELEMS`).

The reference traces the whole op list into one pure JAX function and
jit-compiles it. The port runs the same op list eagerly, op by op, on
the program's device: `build_step_fn` prunes the ops to those the
fetches (or a persistable write) need and returns

    step(persist, feed, seed) -> (fetches, new_persist)

Op i of the pruned list gets a `KernelCtx` whose generator is seeded
from (seed, i), as the reference folds the op index into its key.

A program with a `backward_macro` op (`core/backward.py`) trains:

1. the forward ops before it run once under `torch.enable_grad()`,
   with each parameter it names as a fresh leaf tensor that requires
   grad (the reference replays them inside `jax.value_and_grad`);
2. `torch.autograd.grad` of sum(loss.float()) gives every parameter's
   gradient, which goes into the env under `grad_var_name` in the
   parameter's dtype (zeros for a parameter the loss does not reach,
   as JAX gives);
3. the update ops after it run without autograd. With
   `FUSE_OPTIMIZER_TAIL`, each run of consecutive `adam` ops with the
   same hyperparameters and learning rate is grouped by (shape, dtype),
   and a group of two or more parameters of at most `FUSE_MAX_ELEMS`
   elements runs the registered `adam` kernel once on stacked inputs;
   the rest (`sparse_adam` and `sparse_sgd` among them) run one by one.

Row-sparse tables (`embedding(is_sparse=True)`): every is_sparse
lookup's `SparseDelta` input is a scalar zero, except that the training
replay makes each tap named in the backward macro's `sparse_params` a
leaf of zeros of the gathered shape (ids' shape less a trailing 1, then
the table's width), whose gradient is the tap's row gradient
(`<delta>@GRAD`); the table itself is never differentiated. Where a
tap's ids are made inside the forward, their shape comes from one
replay of the forward ops without autograd (the reference's
`jax.eval_shape` probe).

`sparse_engine` (parallel/sparse.py `SparseEngine`): ops it `owns`
(lookups on its tables and their `sparse_sgd` / `sparse_adam` updates)
run through `engine.exec(env, op)` instead of their kernels, and the
engine's own persistables (`engine.collect(env)`) join new_persist.

As in the reference, an op output whose variable is `stop_gradient`,
floating-point and not persistable is cut from the graph (`detach`).

Not ported: `grad_transform` (the parallel slice), `program._remat`
(`memory_optimize`) and the control-flow ops (`cond`, `while_loop`,
`scan`, `static_rnn`), so the delta scan does not enter sub-blocks. A
program that asks for `_remat` raises.
"""
import torch

from ..ops.registry import KernelCtx, accel, get_kernel
from .framework import grad_var_name

__all__ = ["build_step_fn", "exec_op", "FUSE_OPTIMIZER_TAIL",
           "FUSE_MAX_ELEMS"]

_SEED_MIX = 0x9E3779B97F4A7C15

# the reference's values: stack only small parameters (biases, norms),
# for which one launch per parameter costs more than the stack copy
FUSE_OPTIMIZER_TAIL = True
FUSE_MAX_ELEMS = 1 << 18


def op_seed(seed, op_idx):
    """A 63-bit generator seed for op `op_idx` of a program seeded
    `seed`: distinct ops draw independent streams."""
    x = (int(seed) * _SEED_MIX + int(op_idx) + 1) & ((1 << 64) - 1)
    x ^= x >> 31
    x = (x * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 29
    return x & ((1 << 63) - 1)


def exec_op(env, op, op_idx, seed, is_test, device, cut=frozenset()):
    """Execute one op against env (name -> tensor); outputs named in
    `cut` are detached from the autograd graph."""
    kern = get_kernel(op.type)
    ins = {}
    for slot, names in op.inputs.items():
        if not names:
            continue
        vals = []
        for n in names:
            if n not in env:
                raise KeyError(
                    f"op {op.type!r} input {slot}:{n!r} not materialized; "
                    f"did you run the startup program / feed it?")
            vals.append(env[n])
        ins[slot] = vals
    ctx = KernelCtx(seed=op_seed(seed, op_idx), is_test=is_test,
                    device=device, accel=accel)
    outs = kern(ctx, ins, dict(op.attrs))
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for n, v in zip(names, vals):
            if n in cut and v.is_floating_point():
                v = v.detach()
            env[n] = v


def _find_backward(ops):
    idxs = [i for i, op in enumerate(ops) if op.type == "backward_macro"]
    if not idxs:
        return None
    if len(idxs) > 1:
        raise NotImplementedError("multiple backward sections in one program")
    return idxs[0]


def _prune_ops(program, ops, fetch_names):
    """Keep only the ops the fetches need, and those that write
    persistable state, as the reference Executor prunes its program."""
    persistable = {v.name for v in program.persistable_vars()}
    needed = set(fetch_names)
    kept = []
    for op in reversed(ops):
        outs = op.output_names()
        if (needed & set(outs)) or any(o in persistable for o in outs):
            kept.append(op)
            needed |= set(op.input_names())
            if op.type == "backward_macro":
                needed.add(op.attrs["loss_name"])
    return list(reversed(kept))


def _collect_sparse_deltas(ops):
    """(delta name, table name) for every is_sparse lookup in `ops`."""
    return [(op.inputs["SparseDelta"][0], op.inputs["W"][0])
            for op in ops
            if op.attrs.get("is_sparse") and op.inputs.get("SparseDelta")]


def _adam_sig(op):
    a = op.attrs
    return (a.get("beta1", 0.9), a.get("beta2", 0.999),
            a.get("epsilon", 1e-8), op.inputs["LearningRate"][0])


def _plan_update_tail(tail_ops):
    """Split the update ops [(op, idx)] into plan entries: ("op", op,
    idx) runs alone, ("adam_run", [(op, idx), ...]) is a run of
    consecutive adam ops with one signature. Other ops keep their
    program order."""
    plan = []
    i = 0
    while i < len(tail_ops):
        op, idx = tail_ops[i]
        if op.type != "adam":
            plan.append(("op", op, idx))
            i += 1
            continue
        sig = _adam_sig(op)
        j = i + 1
        while j < len(tail_ops) and tail_ops[j][0].type == "adam" \
                and _adam_sig(tail_ops[j][0]) == sig:
            j += 1
        plan.append(("adam_run", tail_ops[i:j]))
        i = j
    return plan


def _exec_adam_group(env, ops_, is_test, device):
    """One stacked update for the parameters of one (shape, dtype)
    group: the registered `adam` kernel runs once on [N, ...] inputs,
    with the [1] beta-pow scalars stacked as [N, 1, ...] rows that
    broadcast along the leading axis."""
    def stack(slot):
        return torch.stack([env[op.inputs[slot][0]] for op in ops_])

    p = stack("Param")
    bshape = (len(ops_),) + (1,) * (p.dim() - 1)
    ins = {"Param": [p], "Grad": [stack("Grad")],
           "Moment1": [stack("Moment1")], "Moment2": [stack("Moment2")],
           "Beta1Pow": [stack("Beta1Pow").reshape(bshape)],
           "Beta2Pow": [stack("Beta2Pow").reshape(bshape)],
           "LearningRate": [env[ops_[0].inputs["LearningRate"][0]]]}
    out = get_kernel("adam")(KernelCtx(is_test=is_test, device=device),
                             ins, ops_[0].attrs)
    for i, op in enumerate(ops_):
        for slot in ("ParamOut", "Moment1Out", "Moment2Out"):
            env[op.outputs[slot][0]] = out[slot][0][i]
        for slot, src in (("Beta1PowOut", "Beta1Pow"),
                          ("Beta2PowOut", "Beta2Pow")):
            env[op.outputs[slot][0]] = out[slot][0][i].reshape(
                env[op.inputs[src][0]].shape)


def _exec_adam_run(env, run, seed, is_test, device):
    """One run of consecutive adam ops: parameters of one (shape,
    dtype) and at most FUSE_MAX_ELEMS elements, two or more of them,
    update stacked; the rest through exec_op."""
    groups = {}
    for op, idx in run:
        pv = env[op.inputs["Param"][0]]
        groups.setdefault((tuple(pv.shape), pv.dtype), []).append((op, idx))
    for (shape, _dtype), members in groups.items():
        n_elems = 1
        for s in shape:
            n_elems *= s
        if len(members) >= 2 and n_elems <= FUSE_MAX_ELEMS:
            _exec_adam_group(env, [op for op, _ in members], is_test,
                             device)
        else:
            for op, idx in members:
                exec_op(env, op, idx, seed, is_test, device)


def build_step_fn(program, fetch_names, is_test, device,
                  sparse_engine=None):
    """Returns step(persist, feed, seed) -> (fetches, new_persist),
    running the pruned op list eagerly on `device`; with a
    `backward_macro` op, the forward under autograd, then the
    gradients, then the update ops. Ops `sparse_engine` owns run
    through it."""
    if getattr(program, "_remat", False):
        raise NotImplementedError(
            "program._remat (memory_optimize) is not ported")
    block = program.global_block()
    ops = _prune_ops(program, list(block.ops), fetch_names)
    persist_names = [v.name for v in program.persistable_vars()]
    bi = _find_backward(ops)
    sparse_deltas = _collect_sparse_deltas(ops)
    eng = sparse_engine
    cut = frozenset(n for n, v in block.vars.items()
                    if v.stop_gradient and not v.persistable)

    def run_op(env, op, i, seed, cut=frozenset()):
        if eng is not None and eng.owns(op):
            eng.exec(env, op)
        else:
            exec_op(env, op, i, seed, is_test, device, cut)

    def start_env(persist, feed):
        env = dict(feed)
        env.update(persist)
        for dname, wname in sparse_deltas:
            if wname in env:
                env[dname] = torch.zeros((), dtype=env[wname].dtype,
                                         device=env[wname].device)
        return env

    def forward(persist, feed, seed):
        env = start_env(persist, feed)
        for i, op in enumerate(ops):
            run_op(env, op, i, seed)
        return env

    def tap_leaves(env, bop, seed):
        """{delta name: zero leaf of the gathered shape} for every tap
        of the backward macro's row-sparse tables."""
        taps = [(spec["param"], tap) for spec in bop.attrs["sparse_params"]
                for tap in spec["taps"]]
        shapes = {t["ids"]: tuple(env[t["ids"]].shape) for _p, t in taps
                  if t["ids"] in env}
        missing = {t["ids"] for _p, t in taps} - set(shapes)
        if missing:
            probe = dict(env)
            for i, op in enumerate(ops[:bi]):
                run_op(probe, op, i, seed)
            shapes.update((n, tuple(probe[n].shape)) for n in missing)
        leaves = {}
        for pname, tap in taps:
            w = env[pname]
            ishape = shapes[tap["ids"]]
            if ishape and ishape[-1] == 1:
                ishape = ishape[:-1]
            leaves[tap["delta"]] = torch.zeros(
                ishape + (w.shape[-1],), dtype=w.dtype,
                device=w.device).requires_grad_(True)
        return leaves

    def train(persist, feed, seed):
        bop = ops[bi]
        pnames = bop.attrs["param_names"]
        env = start_env(persist, feed)
        leaves = {n: env[n].detach().requires_grad_(True) for n in pnames}
        leaves.update(tap_leaves(env, bop, seed))
        env.update(leaves)
        with torch.enable_grad():
            for i, op in enumerate(ops[:bi]):
                run_op(env, op, i, seed, cut)
            loss = env[bop.attrs["loss_name"]].float().sum()
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        gname = {n: grad_var_name(n) for n in pnames}
        gname.update((tap["delta"], tap["grad"])
                     for spec in bop.attrs["sparse_params"]
                     for tap in spec["taps"])
        for (n, leaf), g in zip(leaves.items(), grads):
            env[n] = leaf = leaf.detach()
            env[gname[n]] = (torch.zeros_like(leaf) if g is None
                             else g.to(leaf.dtype))
        tail = list(enumerate(ops[bi + 1:], start=bi + 1))
        if not FUSE_OPTIMIZER_TAIL:
            for i, op in tail:
                run_op(env, op, i, seed)
            return env
        for entry in _plan_update_tail([(op, i) for i, op in tail]):
            if entry[0] == "op":
                run_op(env, entry[1], entry[2], seed)
            else:
                _exec_adam_run(env, entry[1], seed, is_test, device)
        return env

    run_ops = forward if bi is None else train

    def step(persist, feed, seed):
        env = run_ops(persist, feed, seed)
        new_persist = {n: env[n].detach() for n in persist_names
                       if n in env}
        if eng is not None:
            new_persist.update(eng.collect(env))
        return [env[n].detach() for n in fetch_names], new_persist

    step.ops = ops
    step.trains = bi is not None
    return step
