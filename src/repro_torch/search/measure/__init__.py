"""Measurement subsystem: builder/runner split, parallel execution, caching.

See :mod:`protocol` for the interface contract and :mod:`registry` for
selecting a runner by name (``"local"``, ``"pool"``, ``"rpc://..."``,
``"cached+pool"``).
"""

from .cached import CachedRunner  # noqa: F401
from .hashing import structural_hash  # noqa: F401
from .local import LocalBuilder, LocalRunner, MeasurementFault  # noqa: F401
from .pool import ProcessPoolRunner  # noqa: F401
from .protocol import (  # noqa: F401
    Builder,
    BuildResult,
    LegacyRunnerAdapter,
    MeasureInput,
    MeasureResult,
    Runner,
)
from .registry import (  # noqa: F401
    as_runner,
    create_runner,
    parse_runner_spec,
    register_runner,
    register_wrapper,
    runner_names,
)
from .rpc import (  # noqa: F401
    PROTOCOL_VERSION,
    ProtocolError,
    RPCRunner,
    spawn_local_workers,
)
