"""Host utilities of the port (counterpart of ``skyplane_tpu/utils``)."""

from skyplane_tpu_torch.utils.fn import do_parallel, wait_for
from skyplane_tpu_torch.utils.retry import retry_backoff
from skyplane_tpu_torch.utils.timer import Timer
from skyplane_tpu_torch.utils.logger import logger

__all__ = ["do_parallel", "wait_for", "retry_backoff", "Timer", "logger"]
