"""Execution tracing (paper §4, Figure 6).

Running a MetaSchedule program records a linearized trace of sampling and
transformation instructions; host-language control flow is *not* recorded.
Traces are the genome of the learning-driven search: they can be

  * replayed onto a fresh :class:`~repro_torch.core.schedule.Schedule` (with the
    recorded decisions, or with overridden/mutated decisions),
  * serialized to JSON for the tuning database,
  * pretty-printed as a Python script (paper Appendix A.3 style).

Random variables are remapped *positionally* during replay: the i-th output
of the i-th instruction in the replayed schedule stands for the i-th output
recorded in the original trace, so a mutated decision transparently re-binds
every downstream use.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

# ---------------------------------------------------------------------------
# Random-variable handles
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockRV:
    name: str

    def __repr__(self):
        return f"b({self.name})"


@dataclass(frozen=True)
class LoopRV:
    var: str

    def __repr__(self):
        return f"l({self.var})"


# sentinels for sample_compute_location
ROOT_LOOP = LoopRV("__root__")
INLINE_LOOP = LoopRV("__inline__")


@dataclass(frozen=True)
class ExprRV:
    """An integer random variable.  ``uid`` makes each draw a distinct
    object so positional remapping during replay never conflates two
    draws that happen to share a value."""

    value: int
    uid: int = 0

    def __int__(self):
        return self.value

    def __repr__(self):
        return f"v({self.value})"


_RV_COUNTER = [0]


def new_expr_rv(value: int) -> ExprRV:
    _RV_COUNTER[0] += 1
    return ExprRV(int(value), _RV_COUNTER[0])


RV = Union[BlockRV, LoopRV, ExprRV]
RVLike = Union[RV, int, float, str, None]

SAMPLING_INSTRUCTIONS = (
    "sample_perfect_tile",
    "sample_categorical",
    "sample_compute_location",
)


@dataclass
class Instruction:
    name: str
    inputs: List[RVLike]
    attrs: Dict[str, Any]
    outputs: List[RV]
    decision: Optional[Any] = None

    @property
    def is_sampling(self) -> bool:
        return self.name in SAMPLING_INSTRUCTIONS


class Trace:
    """A linearized probabilistic program over schedule instructions."""

    def __init__(self, insts: Optional[List[Instruction]] = None):
        self.insts: List[Instruction] = insts if insts is not None else []

    def append(self, inst: Instruction) -> None:
        self.insts.append(inst)

    def __len__(self):
        return len(self.insts)

    def sampling_indices(self) -> List[int]:
        return [i for i, it in enumerate(self.insts) if it.is_sampling]

    def decisions(self) -> Dict[int, Any]:
        return {
            i: it.decision for i, it in enumerate(self.insts) if it.is_sampling
        }

    def with_decision(self, idx: int, decision: Any) -> "Trace":
        """New trace with one sampling decision replaced (mutation)."""
        return self.with_decisions({idx: decision})

    def with_decisions(self, decisions: Dict[int, Any]) -> "Trace":
        """New trace with several sampling decisions replaced at once —
        the entry point for learned sampling distributions, which override
        every matched decision site of a freshly generated trace in one
        shot (see :mod:`repro_torch.search.distributions`)."""
        insts = []
        for i, it in enumerate(self.insts):
            if i in decisions:
                insts.append(
                    Instruction(
                        it.name, it.inputs, it.attrs, it.outputs, decisions[i]
                    )
                )
            else:
                insts.append(it)
        return Trace(insts)

    # -- replay -------------------------------------------------------------

    def replay(self, sch, decisions: Optional[Dict[int, Any]] = None) -> None:
        """Re-execute this trace onto schedule ``sch``.

        ``decisions`` optionally overrides recorded sampling decisions by
        instruction index.  Raises ``ScheduleError`` when a decision is out
        of the current support (the validator relies on this).
        """
        remap: Dict[RV, RV] = {}

        def m(x):
            if isinstance(x, (BlockRV, LoopRV, ExprRV)):
                return remap.get(x, x)
            return x

        for i, it in enumerate(self.insts):
            dec = it.decision
            if decisions and i in decisions:
                dec = decisions[i]
            ins = [m(x) for x in it.inputs]
            outs = _execute(sch, it.name, ins, it.attrs, dec)
            for old, new in zip(it.outputs, outs):
                remap[old] = new

    # -- serialization --------------------------------------------------------

    def to_json(self) -> str:
        # ids come from an independent counter, NOT len(rv_ids): an
        # instruction may re-output an RV equal to an earlier output
        # (e.g. get_loops after split returns the same loop vars), which
        # re-keys the dict without growing it — deriving ids from its
        # length would then hand the same id to two different outputs and
        # alias every downstream reference.
        rv_ids: Dict[RV, int] = {}
        next_id = [0]
        out = []

        def enc(x):
            if isinstance(x, (BlockRV, LoopRV, ExprRV)):
                if x in rv_ids:
                    return {"$": rv_ids[x]}
                # untraced query result (e.g. get_consumers): name-resolved.
                # Block names are stable across replays; loop vars are
                # counter-deterministic given the same instruction sequence.
                if isinstance(x, BlockRV):
                    return {"block": x.name}
                if isinstance(x, LoopRV):
                    return {"loop": x.var}
                return {"expr": x.value}
            return x

        for it in self.insts:
            rec = {
                "name": it.name,
                "attrs": it.attrs,
                "inputs": [],
                "outputs": [],
                "decision": it.decision,
            }
            rec["inputs"] = [enc(x) for x in it.inputs]
            for o in it.outputs:
                oid = next_id[0]
                next_id[0] += 1
                rv_ids[o] = oid
                kind = {"BlockRV": "block", "LoopRV": "loop", "ExprRV": "expr"}[
                    type(o).__name__
                ]
                rec["outputs"].append({"$": oid, "kind": kind})
            out.append(rec)
        return json.dumps(out)

    @staticmethod
    def from_json(s: str) -> "Trace":
        data = json.loads(s)
        rvs: Dict[int, RV] = {}
        insts = []
        for rec in data:
            outs = []
            for o in rec["outputs"]:
                if o["kind"] == "block":
                    rv: RV = BlockRV(f"__b{o['$']}")
                elif o["kind"] == "loop":
                    rv = LoopRV(f"__l{o['$']}")
                else:
                    rv = new_expr_rv(0)
                rvs[o["$"]] = rv
                outs.append(rv)
            ins = []
            for x in rec["inputs"]:
                if isinstance(x, dict) and "$" in x:
                    ins.append(rvs[x["$"]])
                elif isinstance(x, dict) and "block" in x:
                    ins.append(BlockRV(x["block"]))
                elif isinstance(x, dict) and "loop" in x:
                    ins.append(LoopRV(x["loop"]))
                elif isinstance(x, dict) and "expr" in x:
                    ins.append(new_expr_rv(x["expr"]))
                else:
                    ins.append(x)
            insts.append(
                Instruction(rec["name"], ins, rec["attrs"], outs, rec["decision"])
            )
        return Trace(insts)

    # -- pretty print ----------------------------------------------------------

    def as_python(self) -> str:
        """Render as a MetaSchedule Python script (paper A.3 style)."""
        names: Dict[RV, str] = {}
        counters = {"b": 0, "l": 0, "v": 0}
        lines = []

        def nm(x):
            if isinstance(x, (BlockRV, LoopRV, ExprRV)) and x in names:
                return names[x]
            if isinstance(x, str):
                return repr(x)
            return repr(x)

        for it in self.insts:
            for o in it.outputs:
                k = {"BlockRV": "b", "LoopRV": "l"}.get(type(o).__name__, "v")
                names[o] = f"{k}{counters[k]}"
                counters[k] += 1
            lhs = ", ".join(names[o] for o in it.outputs)
            args = [nm(x) for x in it.inputs]
            args += [f"{k}={v!r}" for k, v in it.attrs.items()]
            if it.decision is not None:
                args.append(f"decision={it.decision!r}")
            call = f"sch.{it.name}({', '.join(args)})"
            lines.append(f"{lhs} = {call}" if lhs else call)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Instruction executor (dispatch by name onto Schedule methods)
# ---------------------------------------------------------------------------


def _execute(sch, name: str, inputs: List, attrs: Dict, decision) -> List[RV]:
    if name == "get_block":
        return [sch.get_block(attrs["name"])]
    if name == "get_loops":
        return sch.get_loops(inputs[0])
    if name == "sample_perfect_tile":
        return sch.sample_perfect_tile(
            inputs[0],
            attrs["n"],
            attrs.get("max_innermost_factor", 16),
            decision=decision,
        )
    if name == "sample_categorical":
        return [
            sch.sample_categorical(
                attrs["candidates"], attrs.get("probs"), decision=decision
            )
        ]
    if name == "sample_compute_location":
        return [sch.sample_compute_location(inputs[0], decision=decision)]
    if name == "split":
        return sch.split(inputs[0], inputs[1:])
    if name == "fuse":
        return [sch.fuse(*inputs)]
    if name == "reorder":
        sch.reorder(*inputs)
        return []
    if name == "parallel":
        sch.parallel(inputs[0])
        return []
    if name == "vectorize":
        sch.vectorize(inputs[0])
        return []
    if name == "unroll":
        sch.unroll(inputs[0])
        return []
    if name == "bind":
        sch.bind(inputs[0], attrs["thread"])
        return []
    if name == "compute_at":
        sch.compute_at(inputs[0], inputs[1])
        return []
    if name == "reverse_compute_at":
        sch.reverse_compute_at(inputs[0], inputs[1])
        return []
    if name == "compute_inline":
        sch.compute_inline(inputs[0])
        return []
    if name == "reverse_compute_inline":
        sch.reverse_compute_inline(inputs[0])
        return []
    if name == "cache_read":
        return [sch.cache_read(inputs[0], attrs["buffer"], attrs["scope"])]
    if name == "cache_write":
        return [sch.cache_write(inputs[0], attrs["scope"])]
    if name == "annotate":
        sch.annotate(inputs[0], attrs["key"], inputs[1])
        return []
    if name == "unannotate":
        sch.unannotate(inputs[0], attrs["key"])
        return []
    if name == "tensorize_mxu":
        sch.tensorize_mxu(inputs[0])
        return []
    if name == "storage_align":
        sch.storage_align(inputs[0], attrs["dim"], attrs["factor"], attrs["offset"])
        return []
    if name == "set_scope":
        sch.set_scope(inputs[0], attrs["scope"])
        return []
    if name == "decompose_reduction":
        sch.decompose_reduction(inputs[0], inputs[1])
        return []
    if name == "add_unit_loop":
        return [sch.add_unit_loop(inputs[0])]
    raise KeyError(f"unknown instruction {name}")
