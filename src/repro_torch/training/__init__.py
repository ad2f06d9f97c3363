from .optimizer import adamw_init, adamw_update, OptConfig  # noqa: F401
