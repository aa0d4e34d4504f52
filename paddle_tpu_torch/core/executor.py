"""The Executor (counterpart of `paddle_tpu/core/executor.py`:
`Executor(place)`, `run` :443 and `run_startup` :998), for inference
programs and for training programs (a `backward_macro` op and the
update ops that `optimizer.SGD` / `Adam` `minimize` appends).

`Executor(place)` runs programs on one device: `CUDAPlace(i)` (and the
default, None, which is the card and raises without CUDA) or
`CPUPlace()`. `run` puts the feeds on the device in each data var's
dtype (int64 stays int64, where the reference truncates to int32),
reads the program's persistables from the scope, runs the pruned op
list eagerly (see core/trace.py), writes the persistables the run
produced back to the scope, and returns the fetches (numpy arrays with
`return_numpy`, a bf16 fetch as float32). A forward program with
`is_test` runs under `torch.inference_mode()`, any other under
`torch.no_grad()`, inside which a training step turns autograd on for
its forward replay only; its update ops' outputs (the new parameters,
moments and beta powers) replace the persistables in the scope (a
row-sparse table's `sparse_sgd` / `sparse_adam` writes its rows in
place, so the scope keeps the same tensor). Nothing
in a run waits for the device except reading the fetches. The pruned
op list is cached per (program, program version, fetch names).

Not ported, and not accepted as arguments: readers (`py_reader`,
`open_files`), `async_steps`, chaos, telemetry, the memory ledger, NaN
checks (`check_nan_inf`), `validate`, `use_program_cache`,
`run_scanned` and the feed reuse cache.
"""
import torch

from .dtypes import tensor_from_numpy, tensor_to_numpy
from .framework import default_main_program, default_startup_program
from .place import place_to_device
from .scope import global_scope
from .trace import build_step_fn

__all__ = ["Executor"]


class Executor:
    def __init__(self, place=None):
        self.place = place
        self.device = place_to_device(place)
        self._cache = {}

    def _put_feeds(self, program, feed):
        block = program.global_block()
        out = {}
        for name, value in feed.items():
            var = block.vars.get(name)
            out[name] = tensor_from_numpy(
                value, self.device, var.dtype if var is not None else None)
        return out

    @staticmethod
    def _collect_persist(program, scope):
        persist, missing = {}, []
        for v in program.persistable_vars():
            val = scope.get(v.name)
            if val is None:
                missing.append(v.name)
            else:
                persist[v.name] = val
        if missing:
            produced = {n for op in program.global_block().ops
                        for n in op.output_names()}
            hard = [n for n in missing if n not in produced]
            if hard:
                raise RuntimeError(
                    f"persistable vars not initialized: {hard[:5]} "
                    f"(+{max(0, len(hard) - 5)} more); run the startup "
                    f"program first")
        return persist

    def _step_fn(self, program, fetch_names, is_test):
        key = (id(program), program._version, tuple(fetch_names),
               bool(is_test))
        fn = self._cache.get(key)
        if fn is None:
            fn = build_step_fn(program, fetch_names, is_test, self.device)
            # the entry holds its program, so the id in its key is never
            # reused by another program while the entry lives
            fn.program = program
            self._cache[key] = fn
        return fn

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, is_test=None):
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [f.name if hasattr(f, "name") else f
                       for f in (fetch_list or [])]
        if is_test is None:
            is_test = getattr(program, "_is_test", False)
        step = self._step_fn(program, fetch_names, is_test)
        mode = torch.inference_mode() if is_test and not step.trains \
            else torch.no_grad()
        with mode:
            feeds = self._put_feeds(program, dict(feed or {}))
            persist = self._collect_persist(program, scope)
            fetches, new_persist = step(persist, feeds, program.random_seed)
        for name, val in new_persist.items():
            scope.set(name, val)
        if not return_numpy:
            return fetches
        return [tensor_to_numpy(f) for f in fetches]

    def run_startup(self, startup_program=None, scope=None):
        return self.run(startup_program or default_startup_program(),
                        feed={}, fetch_list=[], scope=scope)

