"""Core IR: Program / Block / Operator / Variable (counterpart of
`paddle_tpu/core/framework.py`).

The Program is the reference's lightweight op list: operators carry an
op type string, named input/output slots of variable names, and attrs,
never a callable, so a program serializes (`to_desc` / `from_desc`)
and the same program description comes out of both packages. The
port's Executor runs the op list eagerly, op by op (see core/trace.py).

Ported: `Variable`, `Parameter`, `Operator`, `Block`, `Program`
(`global_block`, `current_block`, `all_parameters`, `list_vars`,
`persistable_vars`, `clone(for_test)`, `to_desc`, `from_desc`),
`default_main_program`, `default_startup_program`,
`switch_main_program`, `switch_startup_program`, `program_guard` and
`grad_var_name` (with the `_backward_sections` record that
`core/backward.py` fills). Left out: sub-blocks (`create_block`,
`rollback`: the control-flow layers are not ported),
`Block.prepend_op` / `has_var`, the static verifier (`Program.verify`),
`Variable.astype` / `ndim` (the `cast` layer is not ported),
`name_scope`, the LR-scheduler list and the proto attr types of loaded
fluid models.
"""
import contextlib
import copy

import numpy as np

from .. import unique_name
from .dtypes import convert_dtype

__all__ = [
    "Variable", "Parameter", "Operator", "Block", "Program",
    "default_main_program", "default_startup_program", "program_guard",
    "switch_main_program", "switch_startup_program", "grad_var_name",
]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name):
    """The name of `name`'s gradient variable."""
    return name + GRAD_SUFFIX


class Variable:
    """Symbolic tensor in a Block. Shapes may hold -1 for dims known
    only at feed time (the batch)."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 persistable=False, stop_gradient=False, is_data=False,
                 lod_level=0, trainable=False):
        self.block = block
        self.name = name if name is not None else unique_name.generate("tmp")
        self.shape = tuple(int(s) for s in shape) if shape is not None \
            else ()
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.lod_level = lod_level
        self.trainable = trainable

    def __str__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")

    __repr__ = __str__


class Parameter(Variable):
    """Trainable persistable variable."""

    def __init__(self, block, shape, dtype, optimize_attr=None, **kwargs):
        kwargs.setdefault("persistable", True)
        kwargs.setdefault("trainable", True)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}


class Operator:
    """One op node: type + named input/output slots (variable names) +
    attrs. The kernel for `type` lives in ops/registry.py."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = self._normalize_slots(inputs)
        self.outputs = self._normalize_slots(outputs)
        self.attrs = dict(attrs or {})

    @staticmethod
    def _normalize_slots(slots):
        out = {}
        for k, vs in (slots or {}).items():
            if not isinstance(vs, (list, tuple)):
                vs = (vs,)
            out[k] = [v.name if isinstance(v, Variable) else v
                      for v in vs if v is not None]
        return out

    def input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def __str__(self):
        return f"Op(type={self.type}, in={self.inputs}, out={self.outputs})"

    __repr__ = __str__


class Block:
    """Ordered op list + var table."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError(f"variable {name!r} not found in block "
                             f"{self.idx}")
        return v

    def create_var(self, **kwargs):
        name = kwargs.get("name") or unique_name.generate("tmp")
        kwargs["name"] = name
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[name] = v
        return v

    def create_parameter(self, **kwargs):
        name = kwargs.get("name") or unique_name.generate("param")
        kwargs["name"] = name
        p = Parameter(self, kwargs.pop("shape"), kwargs.pop("dtype"),
                      **kwargs)
        self.vars[name] = p
        # parameters are global: mirror into block 0
        g = self.program.global_block()
        if g is not self:
            g.vars[name] = p
        return p

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type=type, inputs=inputs, outputs=outputs,
                      attrs=attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]


class Program:
    """A whole computation graph. `random_seed` seeds every random op:
    the Executor draws op i's numbers from a generator seeded by
    (seed, i)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0
        self.random_seed = 0
        self._backward_sections = []    # filled by core/backward.py
        self._is_test = False

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _bump_version(self):
        self._version += 1

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def persistable_vars(self):
        seen = {}
        for v in self.list_vars():
            if v.persistable:
                seen[v.name] = v
        return list(seen.values())

    def clone(self, for_test=False):
        """A copy; with for_test, dropout ops get is_test=True and the
        grad / optimizer / train-only ops are dropped."""
        p = Program.__new__(Program)
        p.blocks = []
        p.current_block_idx = 0
        p._version = self._version
        p.random_seed = self.random_seed
        p._is_test = for_test or self._is_test
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            for op in b.ops:
                attrs = dict(op.attrs)
                if for_test and op.type in ("dropout", "batch_norm"):
                    attrs["is_test"] = True
                nop = Operator(nb, op.type, {}, {}, attrs)
                nop.inputs = {k: list(v) for k, v in op.inputs.items()}
                nop.outputs = {k: list(v) for k, v in op.outputs.items()}
                nb.ops.append(nop)
            p.blocks.append(nb)
        if for_test:
            p._backward_sections = []
            p._prune_backward_for_test()
        else:
            p._backward_sections = list(self._backward_sections)
        return p

    def _prune_backward_for_test(self):
        b = self.global_block()
        b.ops = [op for op in b.ops
                 if not op.attrs.get("is_optimizer_op", False)
                 and not op.attrs.get("is_backward_op", False)
                 and not op.attrs.get("is_train_only", False)]
        self._bump_version()

    def to_desc(self):
        return {
            "version": 1,
            "random_seed": self.random_seed,
            "blocks": [{
                "idx": b.idx,
                "parent_idx": b.parent_idx,
                "vars": [{
                    "name": v.name, "shape": list(v.shape),
                    "dtype": v.dtype, "persistable": v.persistable,
                    "trainable": v.trainable, "is_data": v.is_data,
                    "lod_level": v.lod_level,
                    "stop_gradient": v.stop_gradient,
                    "is_parameter": isinstance(v, Parameter),
                } for v in b.vars.values()],
                "ops": [{
                    "type": op.type, "inputs": op.inputs,
                    "outputs": op.outputs,
                    "attrs": _jsonable_attrs(op.attrs),
                } for op in b.ops],
            } for b in self.blocks],
        }

    @staticmethod
    def from_desc(desc):
        p = Program()
        p.random_seed = desc.get("random_seed", 0)
        p.blocks = []
        for bd in desc["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                if vd.get("is_parameter"):
                    b.vars[vd["name"]] = Parameter(
                        b, vd["shape"], vd["dtype"], name=vd["name"],
                        trainable=vd.get("trainable", True))
                else:
                    b.vars[vd["name"]] = Variable(
                        b, name=vd["name"], shape=vd["shape"],
                        dtype=vd["dtype"], persistable=vd["persistable"],
                        is_data=vd.get("is_data", False),
                        lod_level=vd.get("lod_level", 0),
                        stop_gradient=vd.get("stop_gradient", False))
            for od in bd["ops"]:
                op = Operator(b, od["type"])
                op.inputs = {k: list(v) for k, v in od["inputs"].items()}
                op.outputs = {k: list(v) for k, v in od["outputs"].items()}
                op.attrs = od["attrs"]
                b.ops.append(op)
            p.blocks.append(b)
        p._bump_version()
        return p


def _jsonable_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        elif callable(v):
            out[k] = f"<callable:{getattr(v, '__name__', 'fn')}>"
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# default programs & guards
# ---------------------------------------------------------------------------
_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program):
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_start = None
    if startup_program is not None:
        prev_start = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_start is not None:
            switch_startup_program(prev_start)
