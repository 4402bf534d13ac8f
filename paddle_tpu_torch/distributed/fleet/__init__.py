from .recompute import (checkpoint_name, recompute, recompute_sequential,
                        save_only_names)

__all__ = ["recompute", "recompute_sequential", "checkpoint_name",
           "save_only_names"]
