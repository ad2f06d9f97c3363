"""Runner registry: measurement backends selectable by one spec grammar.

Every runner spec has the shape::

    [wrapper+]name[://options]

* the rightmost ``+``-separated part names a base runner, parts to its
  left name wrappers applied outside-in;
* ``options`` after ``://`` are ``&``-separated ``key=value`` segments
  that become factory kwargs (values parse as int, then float, then bool,
  then stay strings).

Built-ins in this package::

    "local"          in-process serial measurement on one device
    "cached+local"   trace-hash cache over it (the default for tuning runs)

The process-pool and RPC runners of the JAX package are not ported yet;
naming them raises ``KeyError`` listing what is available.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

from .cached import CachedRunner
from .local import LocalRunner
from .protocol import Runner

_RUNNERS: Dict[str, Callable[..., Runner]] = {}
_WRAPPERS: Dict[str, Callable[..., Runner]] = {}


def register_runner(name: str):
    def deco(factory: Callable[..., Runner]):
        _RUNNERS[name] = factory
        return factory

    return deco


def register_wrapper(name: str):
    def deco(factory: Callable[..., Runner]):
        _WRAPPERS[name] = factory
        return factory

    return deco


@register_runner("local")
def _make_local(**kw) -> Runner:
    return LocalRunner(**kw)


@register_wrapper("cached")
def _make_cached(inner: Runner, **kw) -> Runner:
    return CachedRunner(inner, **kw)


def runner_names() -> list:
    bases = sorted(_RUNNERS)
    return bases + [f"{w}+{b}" for w in sorted(_WRAPPERS) for b in bases]


def _coerce_option(v: str) -> Any:
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def parse_runner_spec(spec: str) -> Tuple[List[str], str, Dict[str, Any]]:
    """Parse ``[wrapper+]name[://options]`` -> (wrappers, base, options).

    >>> parse_runner_spec("local://repeats=5&device=cpu")
    ([], 'local', {'repeats': 5, 'device': 'cpu'})

    Unknown runner or wrapper names raise ``KeyError`` listing what is
    available; a malformed spec or option raises ``ValueError``.
    """
    head, sep, rest = spec.partition("://")
    parts = head.split("+")
    if not head or any(not p for p in parts):
        raise ValueError(
            f"malformed runner spec {spec!r}: expected [wrapper+]name[://options]"
        )
    *wrappers, base = parts
    if base not in _RUNNERS:
        raise KeyError(
            f"unknown runner {base!r}; available: {', '.join(runner_names())}"
        )
    for w in wrappers:
        if w not in _WRAPPERS:
            raise KeyError(
                f"unknown runner wrapper {w!r}; available: "
                f"{', '.join(sorted(_WRAPPERS))}"
            )
    options: Dict[str, Any] = {}
    if sep:
        for seg in rest.split("&"):
            if not seg:
                continue
            key, eq, value = seg.partition("=")
            if not (eq and key.isidentifier()):
                raise ValueError(
                    f"runner option {seg!r} in {spec!r} is not key=value"
                )
            options[key] = _coerce_option(value)
    return wrappers, base, options


def create_runner(spec: str, **kwargs) -> Runner:
    """Instantiate a runner from a ``[wrapper+]name[://options]`` spec.

    ``kwargs`` go to the base runner's factory; spec options win over
    ``kwargs`` on collision.  ``backend=`` selects the lowering backend and
    ``device=`` the device the runner measures on.
    """
    wrappers, base, options = parse_runner_spec(spec)
    merged = {**kwargs, **options}
    try:
        runner = _RUNNERS[base](**merged)
    except TypeError as e:
        raise ValueError(f"invalid options for runner {base!r}: {e}") from e
    for w in reversed(wrappers):
        runner = _WRAPPERS[w](runner)
    return runner


def as_runner(obj, backend=None, device="cuda") -> Runner:
    """Normalize a runner argument to the batch ``Runner`` protocol:
    ``None`` -> default LocalRunner, str -> registry spec, Runner -> itself.
    ``backend`` and ``device`` thread into runners created here; an
    already-built ``Runner`` keeps its own."""
    if obj is None:
        return LocalRunner(backend=backend, device=device)
    if isinstance(obj, str):
        return create_runner(obj, backend=backend, device=device)
    if isinstance(obj, Runner):
        return obj
    raise TypeError(f"cannot interpret {type(obj).__name__} as a Runner")
