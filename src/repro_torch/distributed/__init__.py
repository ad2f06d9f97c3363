"""Mesh sharding rules and the single-controller mesh (``sharding``)."""

from . import sharding  # noqa: F401
