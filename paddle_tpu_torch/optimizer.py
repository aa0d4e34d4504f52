"""Optimizers (counterpart of `paddle_tpu/optimizer.py`: `Optimizer` :30,
`SGD` :142 and `Adam` :207, with their row-sparse updates
`_append_sparse_optimize_op` :150 and :238).

`minimize(loss)` appends, as in the reference, the `backward_macro` op
(`core/backward.py`) and then one update op per parameter to the same
program, with the learning rate and the accumulators declared as
persistable global variables whose `fill_constant` initializers go into
the startup program. The program description, the startup program's
included, equals the reference's op for op, so the reference's
initialized scope loads into the port.

A table with row gradients (`embedding(is_sparse=True)`, see
core/backward.py) gets one `sparse_sgd` / `sparse_adam` op with every
lookup tap's (ids, row gradients), after the dense parameters' ops; it
bypasses clipping and regularization, as in the reference.

Not ported, and refused with NotImplementedError when asked for: a
`regularization`, a learning rate given as a scheduler Variable,
`Adam(lazy_mode=True)` (which the reference accepts and ignores: a
row-sparse table's update is always lazy) and `minimize(health=...,
grad_sync=...)`. Gradient clipping (the port's
`ParamAttr` has no clip field) is not ported either. The other
optimizers (Momentum, Adagrad, ...), `ModelAverage` and
`ExponentialMovingAverage` are not ported.
"""
from . import unique_name
from .core.backward import append_backward
from .core.framework import grad_var_name
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper

__all__ = ["Optimizer", "SGD", "Adam", "SGDOptimizer", "AdamOptimizer"]


class Optimizer:
    op_type = None

    def __init__(self, learning_rate, regularization=None, name=None):
        if regularization is not None:
            raise NotImplementedError(
                "optimizer regularization is not ported (regularizers "
                "come after the training slice)")
        if hasattr(learning_rate, "name"):
            raise NotImplementedError(
                "a learning-rate scheduler Variable is not ported; pass a "
                "float")
        self._lr = learning_rate
        self.regularization = None
        self._name = name
        self._accumulators = {}   # name -> {param_name: var}
        self._lr_var = None

    def _create_lr_var(self):
        if self._lr_var is not None:
            return
        helper = LayerHelper(self.__class__.__name__.lower() + "_lr")
        var = helper.create_global_variable(
            [1], "float32", persistable=True,
            name=unique_name.generate("learning_rate"))
        helper.set_variable_initializer(
            var, ConstantInitializer(float(self._lr)))
        self._lr_var = var

    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype="float32"):
        helper = LayerHelper(f"{name}_acc")
        var = helper.create_global_variable(
            shape or list(param.shape), dtype, persistable=True,
            name=unique_name.generate(f"{param.name}_{name}"))
        helper.set_variable_initializer(var, ConstantInitializer(fill_value))
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, params):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _append_sparse_optimize_op(self, block, param):
        raise NotImplementedError(
            f"{type(self).__name__} has no row-sparse update; use Adam "
            "or SGD for embedding(is_sparse=True) tables")

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        """Append one update op per dense (param, grad) and one row-sparse
        op per `is_sparse` table, after the learning rate and the
        accumulators; returns the ops."""
        block = params_grads[0][0].block.program.global_block()
        sparse = [p for p, _ in params_grads
                  if getattr(p, "_sparse_lookup", None)]
        dense = [pg for pg in params_grads
                 if not getattr(pg[0], "_sparse_lookup", None)]
        self._create_lr_var()
        self._create_accumulators([p for p, _ in dense] + sparse)
        ops = [self._append_optimize_op(block, pg) for pg in dense]
        for p in sparse:
            ops.extend(self._append_sparse_optimize_op(block, p))
        for op in ops:
            op.attrs["is_optimizer_op"] = True
        return ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, health=False, grad_sync=None):
        """Append the backward section and the update ops for `loss`;
        returns (update ops, [(param, grad)])."""
        if health or grad_sync is not None:
            raise NotImplementedError(
                "minimize(health=..., grad_sync=...) is not ported")
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads


def _taps(block, p):
    """The row-sparse op's Grad and Ids slots: every lookup tap of `p`."""
    return {"Grad": [block.var(grad_var_name(t["delta"]))
                     for t in p._sparse_lookup],
            "Ids": [block.var(t["ids"]) for t in p._sparse_lookup]}


class SGD(Optimizer):
    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "sgd",
            {"Param": [p], "Grad": [g], "LearningRate": [self._lr_var]},
            {"ParamOut": [p]}, {})

    def _append_sparse_optimize_op(self, block, p):
        return [block.append_op(
            "sparse_sgd",
            {"Param": [p], **_taps(block, p),
             "LearningRate": [self._lr_var]},
            {"ParamOut": [p]}, {})]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        if lazy_mode:
            raise NotImplementedError(
                "Adam(lazy_mode=True) is not ported: the reference ignores "
                "it, and an embedding(is_sparse=True) table's update is "
                "always lazy")
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, params):
        for p in params:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=1.0, shape=[1])
            self._add_accumulator("beta2_pow", p, fill_value=1.0, shape=[1])

    def _append_optimize_op(self, block, pg):
        p, g = pg
        acc = {n: self._get_accumulator(n, p)
               for n in ("moment1", "moment2", "beta1_pow", "beta2_pow")}
        return block.append_op(
            "adam",
            {"Param": [p], "Grad": [g], "Moment1": [acc["moment1"]],
             "Moment2": [acc["moment2"]], "Beta1Pow": [acc["beta1_pow"]],
             "Beta2Pow": [acc["beta2_pow"]],
             "LearningRate": [self._lr_var]},
            {"ParamOut": [p], "Moment1Out": [acc["moment1"]],
             "Moment2Out": [acc["moment2"]],
             "Beta1PowOut": [acc["beta1_pow"]],
             "Beta2PowOut": [acc["beta2_pow"]]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})

    def _append_sparse_optimize_op(self, block, p):
        """One lazy `sparse_adam` op for the table, all its taps merged,
        so its beta powers advance once a step."""
        acc = {n: self._get_accumulator(n, p)
               for n in ("moment1", "moment2", "beta1_pow", "beta2_pow")}
        return [block.append_op(
            "sparse_adam",
            {"Param": [p], **_taps(block, p),
             "Moment1": [acc["moment1"]], "Moment2": [acc["moment2"]],
             "Beta1Pow": [acc["beta1_pow"]], "Beta2Pow": [acc["beta2_pow"]],
             "LearningRate": [self._lr_var]},
            {"ParamOut": [p], "Moment1Out": [acc["moment1"]],
             "Moment2Out": [acc["moment2"]],
             "Beta1PowOut": [acc["beta1_pow"]],
             "Beta2PowOut": [acc["beta2_pow"]]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})]


SGDOptimizer = SGD
AdamOptimizer = Adam
