"""The model stack: parameter specs, layers, attention, the LM."""
from .lm import LM, build_model

__all__ = ["LM", "build_model"]
