"""Weight-decay regularizers (mirrors ``paddle_tpu/regularizer.py``): an
optimizer's ``weight_decay`` may be a float (L2), ``L2Decay`` or
``L1Decay``."""


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L1Decay(WeightDecayRegularizer):
    pass


class L2Decay(WeightDecayRegularizer):
    pass
