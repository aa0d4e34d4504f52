"""Parameter initializers (counterpart of `paddle_tpu/initializer.py`:
`Initializer`, `ConstantInitializer`, `UniformInitializer`,
`NormalInitializer` and `XavierInitializer`, with their Fluid aliases).

Each initializer appends one op to the STARTUP program
(`fill_constant`, `uniform_random`, `gaussian_random`), exactly as the
reference does, so the two packages' startup programs are equal; the
Executor runs the startup program once to put the parameters in the
Scope. Left out: `TruncatedNormal`, `MSRA`, `Bilinear`,
`NumpyArrayInitializer` and `init_on_cpu`, which nothing of this slice
uses.
"""
import numpy as np

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "Xavier",
           "ConstantInitializer", "UniformInitializer",
           "NormalInitializer", "XavierInitializer"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "min": self.low, "max": self.high,
                               "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": self.loc, "std": self.scale,
                               "seed": self.seed})


def _fans(var):
    shape = var.shape
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) >= 2:
        rf = int(np.prod(shape[2:]))
        return shape[1] * rf, shape[0] * rf
    return int(np.prod(shape)), int(np.prod(shape))


class XavierInitializer(Initializer):
    """Glorot init: uniform in +-sqrt(6 / (fan_in + fan_out)), or normal
    with std sqrt(2 / (fan_in + fan_out))."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / (fi + fo)))
            NormalInitializer(0.0, std, self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
