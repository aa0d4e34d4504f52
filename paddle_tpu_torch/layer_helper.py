"""LayerHelper, the machinery shared by layer functions (counterpart of
`paddle_tpu/layer_helper.py`): it creates parameters (declared in the
main program, initialized by an op in the startup program), temporary
output variables, and the bias and activation ops, minting names with
`unique_name` in the reference's order so the two packages build equal
programs; the optimizer's global variables (the learning rate, the
accumulators) come from `create_global_variable` and
`set_variable_initializer`. Left out: `create_tmp_variable`."""
from . import unique_name
from .core.framework import (Parameter, default_main_program,
                             default_startup_program)
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.block.append_op(type=type, inputs=inputs,
                                    outputs=outputs, attrs=attrs)

    def create_parameter(self, attr, shape, dtype="float32",
                         is_bias=False, default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if default_initializer is None:
            default_initializer = (ConstantInitializer(0.0) if is_bias
                                   else XavierInitializer())
        init = attr._default_initializer(default_initializer)
        name = attr.name or unique_name.generate(
            f"{self.name}.w" if not is_bias else f"{self.name}.b")
        shape = [int(s) for s in shape]
        if any(s <= 0 for s in shape):
            raise ValueError(
                f"parameter {name!r} has unresolved shape {shape}; "
                f"specify static dims for parameter-creating layers")
        existing = self.main_program.global_block().vars.get(name)
        if existing is not None:
            if tuple(existing.shape) != tuple(shape):
                raise ValueError(
                    f"parameter name {name!r} reused with a different "
                    f"shape ({tuple(existing.shape)} vs {tuple(shape)})")
            if str(existing.dtype) != str(dtype):
                raise ValueError(
                    f"parameter name {name!r} reused with a different "
                    f"dtype ({existing.dtype} vs {dtype})")
            if not isinstance(existing, Parameter):
                raise ValueError(
                    f"name {name!r} already belongs to a non-parameter "
                    f"variable")
            # intentional sharing: reuse the declared parameter
            return existing
        param = self.main_program.global_block().create_parameter(
            name=name, shape=shape, dtype=dtype, trainable=attr.trainable,
            optimize_attr={"learning_rate": attr.learning_rate})
        sblock = self.startup_program.global_block()
        sblock.create_parameter(name=name, shape=shape, dtype=dtype,
                                trainable=attr.trainable)
        init(param, sblock)
        return param

    def create_variable_for_type_inference(self, dtype, shape=(),
                                           stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, shape=tuple(shape), stop_gradient=stop_gradient)

    def create_global_variable(self, shape, dtype, persistable=True,
                               name=None, stop_gradient=True):
        return self.main_program.global_block().create_var(
            name=name or unique_name.generate(".".join([self.name,
                                                        "global"])),
            shape=tuple(shape), dtype=dtype, persistable=persistable,
            stop_gradient=stop_gradient)

    def set_variable_initializer(self, var, initializer):
        """Declare `var` in the startup program and append its
        initializer op there."""
        sblock = self.startup_program.global_block()
        sblock.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                          persistable=True)
        initializer(var, sblock)

    def append_bias_op(self, input_var, dim_start=1, bias_attr=None,
                       size=None):
        bias_attr = bias_attr if bias_attr is not None \
            else self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = size if size is not None else input_var.shape[-1]
        b = self.create_parameter(bias_attr, shape=[int(size)],
                                  dtype=input_var.dtype, is_bias=True)
        if b is None:
            return input_var
        out = self.create_variable_for_type_inference(
            input_var.dtype, input_var.shape)
        self.append_op("elementwise_add", {"X": [input_var], "Y": [b]},
                       {"Out": [out]}, {"axis": dim_start})
        return out

    def append_activation(self, input_var, act=None):
        act = act if act is not None else self.kwargs.get("act")
        if act is None:
            return input_var
        out = self.create_variable_for_type_inference(
            input_var.dtype, input_var.shape)
        self.append_op(act, {"X": [input_var]}, {"Out": [out]}, {})
        return out
