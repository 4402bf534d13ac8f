from . import distributed_strategy, role_maker, topology  # noqa: F401
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .role_maker import PaddleCloudRoleMaker, Role  # noqa: F401
