from . import mpu  # noqa: F401
