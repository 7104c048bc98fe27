from .compression import (compressed_grad_sync,  # noqa: F401
                          int8_compress, int8_decompress)
from .straggler import StragglerMonitor  # noqa: F401
from .supervisor import Supervisor, TrainingFailure  # noqa: F401
