from .pipeline import SyntheticTokenPipeline  # noqa: F401
