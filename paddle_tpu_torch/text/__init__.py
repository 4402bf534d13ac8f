from . import generation, models

__all__ = ["generation", "models"]
