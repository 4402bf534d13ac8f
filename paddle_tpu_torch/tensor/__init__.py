"""paddle.tensor (counterpart of ``paddle_tpu/tensor/__init__.py``): the
functional tensor library the top level re-exports, laid out as the
reference lays it out, so ``from paddle.tensor import creation`` works.
The implementation modules are the port's ``ops``."""
from ..ops import creation, linalg, logic, manipulation, search, stat  # noqa: F401
from ..ops import math  # noqa: F401
from ..ops.creation import *  # noqa: F401,F403
from ..ops.math import *  # noqa: F401,F403
from ..ops.manipulation import *  # noqa: F401,F403
from ..ops.logic import *  # noqa: F401,F403
from ..ops.search import *  # noqa: F401,F403
from ..ops.stat import *  # noqa: F401,F403
from ..ops.inplace import *  # noqa: F401,F403

random = creation  # the reference's tensor/random.py: sampling creation ops
attribute = manipulation  # shape / rank / is_* live in manipulation
