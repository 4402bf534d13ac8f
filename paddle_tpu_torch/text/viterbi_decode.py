"""Module alias (the reference's text/viterbi_decode.py)."""
from .viterbi import ViterbiDecoder, viterbi_decode  # noqa: F401

__all__ = ["viterbi_decode", "ViterbiDecoder"]
