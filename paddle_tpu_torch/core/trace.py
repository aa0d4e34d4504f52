"""Program -> step function (counterpart of `paddle_tpu/core/trace.py`:
`exec_op`, `_prune_ops` :296 and `build_step_fn` :348, for programs
without a `backward_macro`).

The reference traces the whole op list into one pure JAX function and
jit-compiles it. The port runs the same op list eagerly, op by op, on
the program's device: `build_step_fn` prunes the ops to those the
fetches (or a persistable write) need and returns

    step(persist, feed, seed) -> (fetches, new_persist)

Op i of the pruned list gets a `KernelCtx` whose generator is seeded
from (seed, i), as the reference folds the op index into its key.

Not ported: the `backward_macro` autodiff replay, the stacked Adam tail
(`FUSE_OPTIMIZER_TAIL`), `grad_transform`, the sparse engine and the
control-flow ops (`cond`, `while_loop`, `scan`, `static_rnn`). A
program with a backward op raises NotImplementedError: training is a
later slice of the port.
"""
from ..ops.registry import KernelCtx, accel, get_kernel

__all__ = ["build_step_fn", "exec_op"]

_SEED_MIX = 0x9E3779B97F4A7C15


def op_seed(seed, op_idx):
    """A 63-bit generator seed for op `op_idx` of a program seeded
    `seed`: distinct ops draw independent streams."""
    x = (int(seed) * _SEED_MIX + int(op_idx) + 1) & ((1 << 64) - 1)
    x ^= x >> 31
    x = (x * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 29
    return x & ((1 << 63) - 1)


def exec_op(env, op, op_idx, seed, is_test, device):
    """Execute one op against env (name -> tensor)."""
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
            env[n] = v


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
    return list(reversed(kept))


def build_step_fn(program, fetch_names, is_test, device):
    """Returns step(persist, feed, seed) -> (fetches, new_persist),
    running the pruned op list eagerly on `device`."""
    block = program.global_block()
    if any(op.type == "backward_macro" for op in block.ops):
        raise NotImplementedError(
            "this program has a backward_macro op: training (autodiff, the "
            "optimizer tail) belongs to the port's training slice, which "
            "is not ported yet; run a forward program, e.g. "
            "program.clone(for_test=True) of an inference build")
    ops = _prune_ops(program, list(block.ops), fetch_names)
    persist_names = [v.name for v in program.persistable_vars()]

    def step(persist, feed, seed):
        env = dict(feed)
        env.update(persist)
        for i, op in enumerate(ops):
            exec_op(env, op, i, seed, is_test, device)
        new_persist = {n: env[n] for n in persist_names if n in env}
        return [env[n] for n in fetch_names], new_persist

    step.ops = ops
    return step
