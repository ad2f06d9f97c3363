"""Runner registry: measurement backends selectable by one spec grammar.

Every runner spec has the shape::

    [wrapper+]name[://options]

* the rightmost ``+``-separated part names a base runner, parts to its
  left name wrappers applied outside-in;
* ``options`` after ``://`` are ``&``-separated.  ``key=value`` segments
  become factory kwargs (values parse as int, then float, then bool,
  then stay strings); segments without ``=`` (e.g. ``host:port`` lists)
  are joined into the ``address`` kwarg.

Built-ins::

    "local"                      in-process serial measurement on one device
    "pool"                       process-pool parallel with timeouts +
                                 crash quarantine (spawned workers sharing
                                 the device; timing one at a time)
    "pool://workers=4"           ... with an explicit pool width
    "rpc://127.0.0.1:7070,7071"  fan out across measurement worker
                                 processes (see measure/rpc.py)
    "cached+local"               trace-hash cache over the serial runner
    "cached+pool"                ... over the pool
    "cached+rpc://host:7070"     ... over the fleet

Every base runner takes ``device=`` (``"cuda"`` by default).  Unknown
runner or wrapper names raise ``KeyError`` listing what is available.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

from .cached import CachedRunner
from .local import LocalRunner
from .pool import ProcessPoolRunner
from .protocol import LegacyRunnerAdapter, Runner

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


@register_runner("pool")
def _make_pool(workers=None, **kw) -> Runner:
    if workers is not None:  # spec-grammar alias for max_workers
        kw.setdefault("max_workers", workers)
    r = ProcessPoolRunner(**kw)
    r.warm()  # overlap worker spawn, torch import and context creation
    return r


@register_runner("rpc")
def _make_rpc(address: str = "", **kw) -> Runner:
    from .rpc import RPCRunner

    return RPCRunner(address=address, **kw)


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

    >>> parse_runner_spec("pool://workers=4&timeout_s=30")
    ([], 'pool', {'workers': 4, 'timeout_s': 30})
    >>> parse_runner_spec("cached+rpc://127.0.0.1:7070,127.0.0.1:7071")
    (['cached'], 'rpc', {'address': '127.0.0.1:7070,127.0.0.1:7071'})

    Unknown runner or wrapper names raise ``KeyError`` listing what is
    available; a malformed spec raises ``ValueError``.
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
    address: List[str] = []
    if sep:
        for seg in rest.split("&"):
            if not seg:
                continue
            key, eq, value = seg.partition("=")
            if eq and key.isidentifier():
                options[key] = _coerce_option(value)
            else:
                # bare segments (host:port lists) form the address
                address.append(seg)
    if address:
        options["address"] = ",".join(address)
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
    ``None`` -> default LocalRunner, str -> registry spec, Runner -> itself,
    legacy ``.measure()`` objects (:mod:`repro_torch.search.runner`) ->
    adapter.  ``backend`` and ``device`` thread into runners created here;
    an already-built runner keeps its own."""
    if obj is None:
        return LocalRunner(backend=backend, device=device)
    if isinstance(obj, str):
        return create_runner(obj, backend=backend, device=device)
    if isinstance(obj, Runner):
        return obj
    if hasattr(obj, "measure"):
        return LegacyRunnerAdapter(obj)
    raise TypeError(f"cannot interpret {type(obj).__name__} as a Runner")
