"""ParallelExecutor on one card (counterpart of
`paddle_tpu/parallel/parallel_executor.py`: `ParallelExecutor` :45 and
its `run` :444), as far as the sharded embedding engine needs.

`ParallelExecutor(loss_name, main_program, scope, sparse="shard")`
finds the program's distributed lookup tables
(`embedding(is_distributed=True)`) and, with a sparse policy (the
`sparse=` argument, else `PADDLE_TPU_SPARSE`), builds a
`sparse.SparseEngine` on its mesh; `sparse=` without a distributed
table raises, as in the reference. `run(feed, fetch_list)` puts the
feeds on the mesh's device in their variables' dtypes, plans the
engine for the feed shapes, places the engine's tables and moments
(`prepare_persist`: the logical layout of `run_startup` is permuted
once, `init_shards` tables pass as they are) and its state (stats,
stale rings) beside the other persistables, runs the program through
`core.trace.build_step_fn(..., sparse_engine=engine)` under
`torch.no_grad()`, writes the persistables it produced back to the
scope and returns the fetches (numpy with `return_numpy`). Like the
port's Executor it seeds every run from `program.random_seed`.

The mesh is `mesh.local_mesh("dp")`, one member on the card
(`use_cuda=False`: on the CPU), unless one is given. With one member
data parallelism is the single-device step: the reference's default
gradient sync, `GradSyncPolicy("fp32")`, takes the mean of the
gradients over the members, which over one member is the identity.
Refused with NotImplementedError: a mesh of more than one member (the
`torch.distributed` slice, ROADMAP queue A 10), `grad_sync` other than
None or "fp32", `transpiler=`, `async_steps`, `share_vars_from`,
`exec_strategy`, `build_strategy` and several trainers. Not ported: `verify`, telemetry, chaos, the
recompile explainer and multi-host feeds.
"""
import torch

from ..core.dtypes import tensor_from_numpy, tensor_to_numpy
from ..core.framework import default_main_program
from ..core.scope import global_scope
from ..core.trace import build_step_fn
from . import sparse as _sparse
from .mesh import local_mesh

__all__ = ["ParallelExecutor"]


class ParallelExecutor:
    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None, mesh=None, transpiler=None, grad_sync=None,
                 sparse=None):
        if transpiler is not None:
            raise NotImplementedError(
                "ParallelExecutor(transpiler=...) is not ported (ROADMAP "
                "queue A 10)")
        if grad_sync not in (None, "fp32"):
            raise NotImplementedError(
                f"grad_sync={grad_sync!r} is not ported; over one member "
                f"the reference's default fp32 mean is the identity")
        if share_vars_from is not None or exec_strategy is not None \
                or build_strategy is not None or num_trainers != 1 \
                or trainer_id != 0:
            raise NotImplementedError(
                "share_vars_from, exec_strategy, build_strategy and "
                "several trainers are not ported")
        self.program = main_program or default_main_program()
        self.loss_name = loss_name
        self.scope = scope or global_scope()
        self.mesh = mesh if mesh is not None else local_mesh(
            "dp", None if use_cuda else ["cpu"])
        n = len(self.mesh.devices)
        if n != 1:
            raise NotImplementedError(
                f"ParallelExecutor runs on one member; a mesh of {n} "
                f"needs the torch.distributed slice (ROADMAP queue A 10)")
        self.device = self.mesh.devices[0]
        self.sparse_engine = None
        has_tables = any(op.type == "lookup_table"
                         and op.attrs.get("is_distributed")
                         for op in self.program.global_block().ops)
        policy = _sparse.resolve_policy(sparse)
        if policy is not None:
            if not has_tables:
                raise ValueError(
                    "sparse= engine requested but the program has no "
                    "distributed lookup table; build the embedding with "
                    "is_distributed=True (and is_sparse=True)")
            self.sparse_engine = _sparse.SparseEngine(self.program, policy,
                                                      self.mesh)
        self._cache = {}

    @property
    def device_count(self):
        return len(self.mesh.devices)

    def _step_fn(self, fetch_names, is_test):
        key = (self.program._version, tuple(fetch_names), bool(is_test))
        fn = self._cache.get(key)
        if fn is None:
            fn = build_step_fn(self.program, fetch_names, is_test,
                               self.device, sparse_engine=self.sparse_engine)
            self._cache[key] = fn
        return fn

    def run(self, fetch_list=None, feed=None, feed_dict=None,
            return_numpy=True, is_test=False, async_steps=None):
        if async_steps:
            raise NotImplementedError(
                "ParallelExecutor.run(async_steps=...) is not ported")
        program = self.program
        block = program.global_block()
        fetch_names = [f.name if hasattr(f, "name") else f
                       for f in (fetch_list or [])]
        engine = self.sparse_engine
        engine_rows = set(engine.row_var_names) if engine else set()
        with torch.no_grad():
            feeds = {}
            for k, v in dict(feed or feed_dict or {}).items():
                var = block.vars.get(k)
                feeds[k] = tensor_from_numpy(
                    v, self.device, var.dtype if var is not None else None)
            persist = {}
            for v in program.persistable_vars():
                if v.name in engine_rows:
                    continue
                val = self.scope.get(v.name)
                if val is None:
                    raise RuntimeError(
                        f"persistable var {v.name!r} not initialized; run "
                        f"the startup program first")
                persist[v.name] = val
            if engine is not None:
                engine.plan_run({k: tuple(t.shape) for k, t in feeds.items()})
                engine.prepare_persist(persist, self.scope)
                for name, shape, dtype, fill in engine.state_entries():
                    val = self.scope.get(name)
                    if val is None or tuple(val.shape) != tuple(shape):
                        val = torch.full(shape, fill, dtype=dtype,
                                         device=self.device)
                        self.scope.set(name, val)
                    persist[name] = val
            step = self._step_fn(fetch_names, is_test)
            fetches, new_persist = step(persist, feeds, program.random_seed)
        for name, val in new_persist.items():
            self.scope.set(name, val)
        if not return_numpy:
            return fetches
        return [tensor_to_numpy(f) for f in fetches]
