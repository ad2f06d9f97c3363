"""Measurement subsystem: builder/runner split and trace-hash caching.

See :mod:`protocol` for the interface contract and :mod:`registry` for
selecting a runner by name (``"local"``, ``"cached+local"``).
"""

from .cached import CachedRunner  # noqa: F401
from .hashing import structural_hash  # noqa: F401
from .local import LocalBuilder, LocalRunner  # noqa: F401
from .protocol import (  # noqa: F401
    Builder,
    BuildResult,
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
