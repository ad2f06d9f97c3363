from .registry import build_model  # noqa: F401
