from .registry import (  # noqa: F401
    DEFAULT_BACKEND,
    Backend,
    Lowered,
    backend_names,
    get_backend,
    register_backend,
)
