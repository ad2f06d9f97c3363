from .config import ServeConfig, coerce_serve_config  # noqa: F401
from .engine import ServingEngine  # noqa: F401
from .kv import KVArena, PagedKVArena, SlotPool  # noqa: F401
from .request import Request  # noqa: F401
from .scheduler import ContinuousBatchingScheduler  # noqa: F401
