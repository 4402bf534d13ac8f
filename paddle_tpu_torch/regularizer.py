"""Regularizers (counterpart of ``paddle_tpu/regularizer.py``).

An optimizer's ``weight_decay`` may be a float or one of these; the
optimizers read the coefficient with ``optimizer._decay_value``, which
takes ``_coeff`` as the JAX package does (``paddle_tpu/optimizer/
optimizer.py:218``). ``L1Decay`` is carried for API parity: like the
JAX optimizers, the port's fold its coefficient in as an L2 term.
"""
from __future__ import annotations


class WeightDecayRegularizer:
    pass


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay({self._coeff})"


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __repr__(self):
        return f"L1Decay({self._coeff})"
