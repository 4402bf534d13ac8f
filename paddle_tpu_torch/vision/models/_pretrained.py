"""The zoo's ``pretrained`` flag.

The JAX package's factories accept ``pretrained=True`` and return random
weights all the same: the weights cannot be downloaded. A model with
random weights under a pretrained name is a wrong answer, so the port
refuses it; ``pretrained=False`` builds the model as the JAX package
does. Load trained weights with ``set_state_dict`` instead.
"""


def no_pretrained(pretrained, arch):
    if pretrained:
        raise ValueError(
            f"{arch}(pretrained=True): no pretrained weights are available "
            "(nothing is downloaded); build it with pretrained=False and "
            "load trained weights with set_state_dict")
