"""paddle.text of the port (counterpart of ``paddle_tpu/text``): the model
families (``models``), ``generate`` / ``beam_search``, the CRF Viterbi
(``ViterbiDecoder``, ``viterbi_decode``) and the seven synthetic
datasets."""
from . import datasets, generation, models
from .datasets import (Conll05st, Imdb, Imikolov, Movielens, UCIHousing,
                       WMT14, WMT16)
from .generation import beam_search, generate
from .viterbi import ViterbiDecoder, viterbi_decode

import importlib as _importlib  # noqa: E402

# importing the submodule rebinds the package attribute to the module;
# the function wins, as in the reference
viterbi_decode_module = _importlib.import_module(".viterbi_decode", __name__)
from .viterbi import viterbi_decode  # noqa: E402,F811

__all__ = ["beam_search", "generate", "generation", "models", "datasets",
           "ViterbiDecoder", "viterbi_decode", "Conll05st", "Imdb",
           "Imikolov", "Movielens", "UCIHousing", "WMT14", "WMT16"]
