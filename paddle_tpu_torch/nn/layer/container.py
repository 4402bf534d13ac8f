"""Containers: Sequential, LayerList, LayerDict, ParameterList,
ParameterDict (counterpart of ``paddle_tpu/nn/layer/container.py``)."""
from __future__ import annotations

import collections

from .layers import Layer


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           (list, tuple)) and layers[0] and \
                isinstance(layers[0][0], (list, tuple)):
            for name, layer in layers[0]:
                self.add_sublayer(str(name), layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(str(layer[0]), layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._sub_layers.values())[idx])
        keys = list(self._sub_layers.keys())
        return self._sub_layers[keys[idx]]

    def __setitem__(self, idx, layer):
        keys = list(self._sub_layers.keys())
        self._sub_layers[keys[idx]] = layer

    def __delitem__(self, idx):
        keys = list(self._sub_layers.keys())
        del self._sub_layers[keys[idx]]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def forward(self, input):
        for layer in self._sub_layers.values():
            input = layer(input)
        return input


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, l in enumerate(sublayers):
                self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        if idx < 0:
            idx += len(self)
        return self._sub_layers[str(idx)]

    def __setitem__(self, idx, layer):
        if idx < 0:
            idx += len(self)
        self._sub_layers[str(idx)] = layer

    def __delitem__(self, idx):
        if isinstance(idx, slice):
            items = list(self._sub_layers.values())
            del items[idx]
            self._sub_layers.clear()
            for i, l in enumerate(items):
                self._sub_layers[str(i)] = l
            return
        del self._sub_layers[str(idx)]
        items = list(self._sub_layers.values())
        self._sub_layers.clear()
        for i, l in enumerate(items):
            self._sub_layers[str(i)] = l

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        items = list(self._sub_layers.values())
        items.insert(index, layer)
        self._sub_layers.clear()
        for i, l in enumerate(items):
            self._sub_layers[str(i)] = l

    def extend(self, layers):
        for l in layers:
            self.append(l)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def clear(self):
        self._sub_layers.clear()

    def pop(self, key):
        layer = self._sub_layers[key]
        del self._sub_layers[key]
        return layer

    def keys(self):
        return self._sub_layers.keys()

    def items(self):
        return self._sub_layers.items()

    def values(self):
        return self._sub_layers.values()

    def update(self, sublayers):
        if isinstance(sublayers, (dict, collections.OrderedDict)):
            for k, v in sublayers.items():
                self.add_sublayer(k, v)
        else:
            for k, v in sublayers:
                self.add_sublayer(k, v)


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        return self._parameters[str(idx)]

    def __setitem__(self, idx, param):
        self._parameters[str(idx)] = param

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self


class ParameterDict(Layer):
    """Dict-style Parameter container (reference: nn.ParameterDict)."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            self.update(parameters)

    def __getitem__(self, key):
        return self._parameters[key]

    def __setitem__(self, key, parameter):
        self.add_parameter(key, parameter)

    def __delitem__(self, key):
        del self._parameters[key]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters)

    def __contains__(self, key):
        return key in self._parameters

    def keys(self):
        return self._parameters.keys()

    def values(self):
        return self._parameters.values()

    def items(self):
        return self._parameters.items()

    def update(self, parameters):
        if hasattr(parameters, "items"):
            for k, v in parameters.items():
                self[k] = v
        else:
            for k, v in parameters:
                self[k] = v
