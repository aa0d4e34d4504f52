"""ParamAttr, per-parameter configuration (counterpart of
`paddle_tpu/param_attr.py`: `ParamAttr` with its name, initializer,
learning-rate scale and trainable flag). Left out: the regularizer,
gradient clip and model-average fields and `WeightNormParamAttr`, which
belong to the training slice."""
from .initializer import XavierInitializer

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 trainable=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.trainable = trainable

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return False
        # an Initializer instance
        return ParamAttr(initializer=arg)

    def _default_initializer(self, default=None):
        if self.initializer is not None:
            return self.initializer
        return default if default is not None else XavierInitializer()
