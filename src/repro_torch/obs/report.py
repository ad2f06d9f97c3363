"""Fold a structured trace (see :mod:`repro_torch.obs.trace`) into a tuning
diagnostics report.

The report answers the questions the search loop itself cannot:

* **Where did tuning wall-clock go?**  build vs run vs search overhead,
  computed against the ``tune.session`` span(s) so the three buckets
  account for the whole session by construction (overhead is the
  remainder; with parallel runners build+run sums can legitimately
  exceed wall-clock — the report says so instead of hiding it).
* **Is the cost model learning?**  per-round Spearman rank correlation
  between predicted scores and measured latencies (``costmodel.round``).
* **What actually got served?**  per-workload-key dispatch
  hit/miss/fallback table with miss reasons, and the ``mode="best"``
  hit rate the CI gate consumes.
* **What wasted the budget?**  top-N slowest measured candidates,
  timeouts, crash quarantines, cache effectiveness.

The port emits the JAX package's ``tune.*``, ``costmodel.*``,
``measure.*`` (``measure.rpc.*`` included), ``dispatch.*`` and ``serve.*``
events with the same fields, so this is the reference's fold unchanged.
``chip_smoke.py`` folds its fleet phase with :func:`fold` and prints
:func:`render_text`.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Tuple


def load_events(paths: Iterable[str]) -> List[Dict[str, Any]]:
    """Read one or more JSONL trace files (bad lines are skipped)."""
    events: List[Dict[str, Any]] = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(ev, dict) and "ev" in ev:
                    events.append(ev)
    return events


def _session_windows(events) -> List[Tuple[float, float]]:
    wins = []
    for e in events:
        if e.get("ev") == "tune.session" and "dur_s" in e:
            end = float(e["ts"])
            wins.append((end - float(e["dur_s"]), end))
    return wins


def _in_windows(ts: float, wins: List[Tuple[float, float]]) -> bool:
    return any(lo <= ts <= hi for lo, hi in wins)


def fold(events: List[Dict[str, Any]], top_n: int = 10) -> Dict[str, Any]:
    by_type: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        by_type.setdefault(e["ev"], []).append(e)

    # -- wall clock and the build/run/overhead breakdown ---------------------
    wins = _session_windows(events)
    if wins:
        wall = sum(hi - lo for lo, hi in wins)
        in_tuning = lambda e: _in_windows(float(e.get("ts", 0.0)), wins)  # noqa: E731
    else:
        # no session span recorded: treat the whole trace as one window
        ts = [float(e["ts"]) for e in events if "ts" in e]
        wall = (max(ts) - min(ts)) if len(ts) >= 2 else 0.0
        in_tuning = lambda e: True  # noqa: E731

    builds = [e for e in by_type.get("measure.build", []) if in_tuning(e)]
    runs = [e for e in by_type.get("measure.run", []) if in_tuning(e)]
    build_s = sum(float(e.get("dur_s", 0.0)) for e in builds)
    run_s = sum(float(e.get("dur_s", 0.0)) for e in runs)
    overhead_s = max(0.0, wall - build_s - run_s)
    accounted = (build_s + run_s + overhead_s) / wall if wall > 0 else 1.0

    # -- per-task round/latency table ----------------------------------------
    tasks: Dict[str, Dict[str, Any]] = {}
    for e in by_type.get("tune.round", []):
        t = tasks.setdefault(
            str(e.get("task", "?")),
            {"rounds": 0, "best_latency_us": None, "round_s": 0.0},
        )
        t["rounds"] += 1
        t["round_s"] += float(e.get("dur_s", 0.0))
        lat = e.get("best_latency_s")
        if lat is not None and lat == lat and lat != float("inf"):
            t["best_latency_us"] = round(float(lat) * 1e6, 2)

    # -- cost-model rank correlation per round -------------------------------
    cost_model: Dict[str, Dict[str, Any]] = {}
    for e in by_type.get("costmodel.round", []):
        task = str(e.get("task", "?"))
        entry = cost_model.setdefault(task, {"rounds": [], "mean_spearman": None})
        entry["rounds"].append(
            {
                "round": e.get("round"),
                "n": e.get("n"),
                "spearman": e.get("spearman"),
                "trained": e.get("trained"),
            }
        )
    for entry in cost_model.values():
        vals = [
            r["spearman"] for r in entry["rounds"] if r["spearman"] is not None
        ]
        if vals:
            entry["mean_spearman"] = round(sum(vals) / len(vals), 4)

    # -- learned search: warm starts, rollout pruning, learned sampling ------
    learned: Optional[Dict[str, Any]] = None
    warm_evs = by_type.get("costmodel.warm_start", [])
    prune_evs = by_type.get("costmodel.prune", [])
    sample_evs = by_type.get("search.sample", [])
    dist_evs = by_type.get("search.dists", [])
    n_learned = sum(int(e.get("learned", 0)) for e in sample_evs)
    n_sampled = sum(int(e.get("valid", 0)) for e in sample_evs)
    if warm_evs or prune_evs or dist_evs or n_learned:
        scored = sum(int(e.get("scored", 0)) for e in prune_evs)
        kept = sum(int(e.get("kept", 0)) for e in prune_evs)
        learned = {
            "warm_starts": len(warm_evs),
            "warm_model_samples": max(
                (int(e.get("model_samples", 0)) for e in warm_evs), default=0
            ),
            "warm_dist_sites": max(
                (int(e.get("dist_sites", 0)) for e in warm_evs), default=0
            ),
            "prune_rounds": len(prune_evs),
            "candidates_scored": scored,
            "candidates_kept": kept,
            "pruned_frac": round(1 - kept / scored, 4) if scored else None,
            "samples": n_sampled,
            "learned_samples": n_learned,
            "learned_frac": (
                round(n_learned / n_sampled, 4) if n_sampled else None
            ),
            "dist_sites": max(
                (int(e.get("sites", 0)) for e in dist_evs), default=0
            ),
        }

    # -- measurement health --------------------------------------------------
    ok_runs = [e for e in runs if e.get("ok")]
    measure = {
        "measured": len(runs),
        "ok": len(ok_runs),
        "failed": len(runs) - len(ok_runs),
        "build_failures": sum(1 for e in builds if not e.get("ok", True)),
        "timeouts": len(by_type.get("measure.timeout", [])),
        "crashes": len(by_type.get("measure.crash", [])),
        "quarantined": len(by_type.get("measure.crash_quarantine", [])),
        "cache_hits": len(by_type.get("cache.hit", [])),
        "cache_misses": len(by_type.get("cache.miss", [])),
    }
    denom = measure["cache_hits"] + measure["cache_misses"]
    measure["cache_hit_rate"] = (
        round(measure["cache_hits"] / denom, 4) if denom else None
    )

    # -- dispatch coverage ---------------------------------------------------
    by_key: Dict[str, Dict[str, Any]] = {}
    counts = {"hit": 0, "miss": 0, "fallback": 0}
    best_counts = {"hit": 0, "miss": 0}
    for outcome in ("hit", "miss", "fallback"):
        for e in by_type.get(f"dispatch.{outcome}", []):
            counts[outcome] += 1
            if e.get("mode", "best") == "best" and outcome != "fallback":
                best_counts[outcome] += 1
            key = str(e.get("key") or f"site:{e.get('site', '?')}")
            row = by_key.setdefault(
                key, {"hits": 0, "misses": 0, "fallbacks": 0, "reasons": {}}
            )
            row[outcome + ("es" if outcome == "miss" else "s")] += 1
            reason = e.get("reason")
            if reason:
                row["reasons"][reason] = row["reasons"].get(reason, 0) + 1
    best_total = best_counts["hit"] + best_counts["miss"]
    dispatch = {
        "hits": counts["hit"],
        "misses": counts["miss"],
        "fallbacks": counts["fallback"],
        "hit_rate": (
            round(best_counts["hit"] / best_total, 4) if best_total else None
        ),
        "by_key": by_key,
    }

    # -- slowest measured candidates -----------------------------------------
    slowest = sorted(
        (
            {
                "key": e.get("key"),
                "hash": e.get("hash"),
                "latency_us": round(float(e["latency_s"]) * 1e6, 2),
            }
            for e in ok_runs
            if e.get("latency_s") is not None
        ),
        key=lambda r: -r["latency_us"],
    )[:top_n]

    # -- extraction skips (dispatch-coverage loss) ---------------------------
    extract_skips: Optional[Dict[str, int]] = None
    skips = by_type.get("extract.skip", [])
    if skips:
        extract_skips = {}
        for e in skips:
            key = f"{e.get('site', '?')}/{e.get('reason', '?')}"
            extract_skips[key] = extract_skips.get(key, 0) + 1

    # -- rpc fleet -----------------------------------------------------------
    rpc: Optional[Dict[str, Any]] = None
    dispatches = by_type.get("measure.rpc.dispatch", [])
    deaths = by_type.get("measure.rpc.worker_death", [])
    retries = by_type.get("measure.rpc.retry", [])
    if dispatches or deaths or retries:
        workers: Dict[str, Dict[str, Any]] = {}
        for e in dispatches:
            row = workers.setdefault(
                str(e.get("worker", "?")),
                {"batches": 0, "candidates": 0, "failed_batches": 0,
                 "dispatch_s": 0.0, "deaths": 0},
            )
            row["batches"] += 1
            row["candidates"] += int(e.get("n", 0))
            if not e.get("ok", True):
                row["failed_batches"] += 1
            row["dispatch_s"] += float(e.get("dur_s", 0.0))
        for e in deaths:
            row = workers.setdefault(
                str(e.get("worker", "?")),
                {"batches": 0, "candidates": 0, "failed_batches": 0,
                 "dispatch_s": 0.0, "deaths": 0},
            )
            row["deaths"] += 1
        for row in workers.values():
            row["dispatch_s"] = round(row["dispatch_s"], 4)
        rpc = {
            "workers": workers,
            "batches": len(dispatches),
            "candidates": sum(int(e.get("n", 0)) for e in dispatches),
            "worker_deaths": len(deaths),
            "retries": len(retries),
        }

    # -- serving -------------------------------------------------------------
    serving: Optional[Dict[str, Any]] = None
    prefills = by_type.get("serve.prefill", [])
    decodes = by_type.get("serve.decode", [])
    admits = by_type.get("serve.admit", [])
    evicts = by_type.get("serve.evict", [])
    if prefills or decodes or admits or evicts:
        p_tok = sum(int(e.get("tokens", 0)) for e in prefills)
        p_s = sum(float(e.get("dur_s", 0.0)) for e in prefills)
        d_tok = sum(int(e.get("tokens", 0)) for e in decodes)
        d_s = sum(float(e.get("dur_s", 0.0)) for e in decodes)
        chunked = [e for e in prefills if e.get("chunked")]
        serving = {
            "prefill_tokens": p_tok,
            "prefill_tok_s": round(p_tok / p_s, 2) if p_s > 0 else None,
            "decode_tokens": d_tok,
            "decode_tok_s": round(d_tok / d_s, 2) if d_s > 0 else None,
            "chunked_prefill_events": len(chunked),
            "chunked_prefill_tokens": sum(
                int(e.get("tokens", 0)) for e in chunked
            ),
        }
        if admits or evicts:
            # scheduler lifecycle: admissions, completions, TTFT/latency
            # quantiles from the per-request evict events
            serving["requests_admitted"] = len(admits)
            serving["requests_completed"] = len(evicts)
            ttfts = sorted(
                float(e["ttft_s"]) for e in evicts
                if e.get("ttft_s") is not None
            )
            lats = sorted(
                float(e["latency_s"]) for e in evicts
                if e.get("latency_s") is not None
            )
            if ttfts:
                serving["ttft_s_p50"] = round(ttfts[len(ttfts) // 2], 6)
                serving["ttft_s_max"] = round(ttfts[-1], 6)
            if lats:
                serving["latency_s_p50"] = round(lats[len(lats) // 2], 6)
                serving["latency_s_max"] = round(lats[-1], 6)

    # -- serving router ------------------------------------------------------
    router: Optional[Dict[str, Any]] = None
    r_submits = by_type.get("serve.router.submit", [])
    r_completes = by_type.get("serve.router.complete", [])
    r_deaths = by_type.get("serve.router.worker_death", [])
    r_resubmits = by_type.get("serve.router.resubmit", [])
    if r_submits or r_completes or r_deaths or r_resubmits:
        rworkers: Dict[str, Dict[str, int]] = {}
        for e in r_completes:
            row = rworkers.setdefault(
                str(e.get("worker", "?")), {"completed": 0, "deaths": 0}
            )
            row["completed"] += 1
        for e in r_deaths:
            row = rworkers.setdefault(
                str(e.get("worker", "?")), {"completed": 0, "deaths": 0}
            )
            row["deaths"] += 1
        router = {
            "submitted": len(r_submits),
            "completed": len(r_completes),
            "worker_deaths": len(r_deaths),
            "resubmits": len(r_resubmits),
            "workers": rworkers,
        }

    return {
        "benchmark": "tuning_report",
        "n_events": len(events),
        "wall_s": round(wall, 4),
        "time_breakdown": {
            "build_s": round(build_s, 4),
            "run_s": round(run_s, 4),
            "search_overhead_s": round(overhead_s, 4),
            "accounted_frac": round(accounted, 4),
        },
        "rounds": len(by_type.get("tune.round", [])),
        "tasks": tasks,
        "cost_model": cost_model,
        "learned": learned,
        "measure": measure,
        "dispatch": dispatch,
        "extract_skips": extract_skips,
        "slowest": slowest,
        "rpc": rpc,
        "serving": serving,
        "serving_router": router,
    }


def _pct(part: float, whole: float) -> str:
    return f"{100.0 * part / whole:5.1f}%" if whole > 0 else "    -"


def render_text(report: Dict[str, Any]) -> str:
    lines: List[str] = []
    add = lines.append
    tb = report["time_breakdown"]
    wall = report["wall_s"]
    add("== tuning diagnostics report ==")
    add(f"events: {report['n_events']}   tuning wall-clock: {wall:.2f}s   "
        f"rounds: {report['rounds']}")
    add("")
    add("-- time breakdown (vs tuning wall-clock) --")
    add(f"  build            {tb['build_s']:9.2f}s  {_pct(tb['build_s'], wall)}")
    add(f"  run              {tb['run_s']:9.2f}s  {_pct(tb['run_s'], wall)}")
    add(f"  search overhead  {tb['search_overhead_s']:9.2f}s  "
        f"{_pct(tb['search_overhead_s'], wall)}")
    add(f"  accounted: {100.0 * tb['accounted_frac']:.1f}%"
        + ("  (build+run exceed wall-clock: parallel measurement)"
           if tb["build_s"] + tb["run_s"] > wall > 0 else ""))
    add("")
    if report["tasks"]:
        add("-- tasks --")
        for key, t in report["tasks"].items():
            best = (f"{t['best_latency_us']:.1f}us"
                    if t["best_latency_us"] is not None else "-")
            add(f"  {key}: rounds={t['rounds']} best={best} "
                f"round_time={t['round_s']:.2f}s")
        add("")
    if report["cost_model"]:
        add("-- cost model rank correlation (predicted vs measured) --")
        for task, entry in report["cost_model"].items():
            mean = entry["mean_spearman"]
            add(f"  {task}: mean_spearman="
                f"{mean if mean is not None else '-'}")
            for r in entry["rounds"]:
                rho = r["spearman"]
                add(f"    round {r['round']}: n={r['n']} "
                    f"spearman={f'{rho:.3f}' if rho is not None else '-'}"
                    f"{'' if r.get('trained') else ' (untrained)'}")
        add("")
    if report.get("learned"):
        ln = report["learned"]
        add("-- learned search --")
        if ln["warm_starts"]:
            add(f"  warm starts: {ln['warm_starts']} "
                f"(model_samples={ln['warm_model_samples']} "
                f"dist_sites={ln['warm_dist_sites']})")
        lf = ln["learned_frac"]
        add(f"  sampling: {ln['learned_samples']}/{ln['samples']} learned "
            f"({f'{100 * lf:.0f}%' if lf is not None else '-'}), "
            f"{ln['dist_sites']} distribution sites")
        pf = ln["pruned_frac"]
        add(f"  rollout pruning: {ln['prune_rounds']} rounds, "
            f"scored={ln['candidates_scored']} kept={ln['candidates_kept']}"
            f"{f' (pruned {100 * pf:.0f}%)' if pf is not None else ''}")
        add("")
    m = report["measure"]
    add("-- measurement health --")
    add(f"  measured={m['measured']} ok={m['ok']} failed={m['failed']} "
        f"build_failures={m['build_failures']}")
    add(f"  timeouts={m['timeouts']} crashes={m['crashes']} "
        f"quarantined={m['quarantined']}")
    if m["cache_hit_rate"] is not None:
        add(f"  cache: hits={m['cache_hits']} misses={m['cache_misses']} "
            f"hit_rate={m['cache_hit_rate']:.2f}")
    add("")
    d = report["dispatch"]
    add("-- dispatch coverage --")
    rate = d["hit_rate"]
    add(f"  hits={d['hits']} misses={d['misses']} fallbacks={d['fallbacks']} "
        f"hit_rate(best)={f'{rate:.2f}' if rate is not None else '-'}")
    for key, row in sorted(d["by_key"].items()):
        reasons = (
            " reasons=" + ",".join(
                f"{k}:{v}" for k, v in sorted(row["reasons"].items())
            )
            if row["reasons"] else ""
        )
        add(f"  {key}: hits={row['hits']} misses={row['misses']} "
            f"fallbacks={row['fallbacks']}{reasons}")
    add("")
    if report.get("extract_skips"):
        add("-- extraction skips (dispatch-coverage loss) --")
        for key, n in sorted(report["extract_skips"].items()):
            add(f"  {key}: {n}")
        add("")
    if report["slowest"]:
        add("-- slowest measured candidates --")
        for r in report["slowest"]:
            add(f"  {r['latency_us']:10.1f}us  {r['key']}  "
                f"hash={str(r['hash'])[:12]}")
        add("")
    if report.get("rpc"):
        r = report["rpc"]
        add("-- rpc fleet --")
        add(f"  batches={r['batches']} candidates={r['candidates']} "
            f"worker_deaths={r['worker_deaths']} retries={r['retries']}")
        for addr, row in sorted(r["workers"].items()):
            add(f"  {addr}: batches={row['batches']} "
                f"candidates={row['candidates']} "
                f"failed_batches={row['failed_batches']} "
                f"dispatch={row['dispatch_s']:.2f}s deaths={row['deaths']}")
        add("")
    if report["serving"]:
        s = report["serving"]
        add("-- serving --")
        add(f"  prefill: {s['prefill_tokens']} tokens @ "
            f"{s['prefill_tok_s']} tok/s")
        if s.get("chunked_prefill_events"):
            add(f"  chunked prefill: {s['chunked_prefill_tokens']} tokens "
                f"over {s['chunked_prefill_events']} in-tick chunks")
        add(f"  decode:  {s['decode_tokens']} tokens @ "
            f"{s['decode_tok_s']} tok/s")
        if s.get("requests_completed") is not None:
            add(f"  requests: admitted={s.get('requests_admitted')} "
                f"completed={s['requests_completed']}")
            if s.get("ttft_s_p50") is not None:
                add(f"  ttft: p50={s['ttft_s_p50']}s max={s['ttft_s_max']}s")
            if s.get("latency_s_p50") is not None:
                add(f"  latency: p50={s['latency_s_p50']}s "
                    f"max={s['latency_s_max']}s")
        add("")
    if report.get("serving_router"):
        r = report["serving_router"]
        add("-- serving router --")
        add(f"  submitted={r['submitted']} completed={r['completed']} "
            f"worker_deaths={r['worker_deaths']} resubmits={r['resubmits']}")
        for wid, row in sorted(r["workers"].items()):
            add(f"  worker {wid}: completed={row['completed']} "
                f"deaths={row['deaths']}")
        add("")
    return "\n".join(lines)
