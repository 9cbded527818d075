from .logger import setup_logger
from .profiling import StepTimer, memory_stats, trace
from .scalars import ScalarWriter, read_scalars

__all__ = ["ScalarWriter", "StepTimer", "memory_stats", "read_scalars", "setup_logger", "trace"]
