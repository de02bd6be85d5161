"""Rollups of a telemetry capture: per-stage aggregates and per-series
summaries of the ``meta["telemetry"]`` records the pipeline emits (the
port's copy of the reference's ``obs/report.py``; the key tuples are the
reference's, which a test holds).

Two consumers:

  * :func:`rollup` -- aggregate a whole capture window (every span name ->
    count/total/mean/max plus counters, last-value gauges and histogram
    summaries): the "where did the time go" table of the reference's
    ``docs/observability.md``.
  * :func:`series_rollup` -- aggregate the per-step ``meta["telemetry"]``
    dicts of a compressed series (each step carries its own stage
    timings; the series view sums the times and bytes and keeps the
    per-step entropy ratios).  Works on ``CompressedStep`` objects or on
    bare meta dicts.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from repro_torch.obs import telemetry

__all__ = ["rollup", "series_rollup", "STEP_TELEMETRY_KEYS",
           "READ_TELEMETRY_KEYS"]

# Canonical per-step telemetry keys (core.pipeline.finalize_step).  The
# set is identical across drivers (single-device vs sharded) and overlap
# modes so trajectory tooling can diff rollups structurally.
STEP_TELEMETRY_KEYS = ("analyze_s", "encode_s", "exceptions_s", "entropy_s",
                       "finalize_s", "bytes_in", "bytes_out",
                       "entropy_ratio", "codec", "device_entropy")

# Canonical per-read telemetry keys (``meta["telemetry_read"]``, written
# by ``core.compress.record_read``).  Mirrors the encode taxonomy on the
# decode side and -- like STEP_TELEMETRY_KEYS -- is identical across the
# single-device, sharded, and anchor read paths.
READ_TELEMETRY_KEYS = ("entropy_s", "dequant_s", "patch_s", "fetch_s",
                       "bytes_in", "bytes_out", "codec", "device_decode")


def rollup(reg: Optional[telemetry.Registry] = None) -> Dict[str, Any]:
    """Aggregate a capture: span-name totals, counters, gauges, hists."""
    reg = reg if reg is not None else telemetry.active()
    if reg is None:
        raise ValueError("no registry: pass one or run inside capture()")
    snap = reg.snapshot()
    spans: Dict[str, Dict[str, float]] = {}
    for rec in snap["spans"]:
        agg = spans.setdefault(rec.name, {"count": 0, "total_s": 0.0,
                                          "max_s": 0.0, "errors": 0})
        agg["count"] += 1
        agg["total_s"] += rec.duration
        agg["max_s"] = max(agg["max_s"], rec.duration)
        if rec.error is not None:
            agg["errors"] += 1
    for agg in spans.values():
        agg["mean_s"] = agg["total_s"] / max(agg["count"], 1)
    gauges = {name: {"last": samples[-1][1],
                     "min": min(v for _, v in samples),
                     "max": max(v for _, v in samples),
                     "samples": len(samples)}
              for name, samples in snap["gauges"].items() if samples}
    hists = {name: {"count": len(vs), "mean": sum(vs) / len(vs),
                    "min": min(vs), "max": max(vs)}
             for name, vs in snap["hists"].items() if vs}
    return {"spans": spans, "counters": dict(snap["counters"]),
            "gauges": gauges, "hists": hists}


def _step_tele(step) -> Optional[Dict[str, Any]]:
    meta = step if isinstance(step, dict) else getattr(step, "meta", None)
    if not meta:
        return None
    return meta.get("telemetry")


def series_rollup(steps: Iterable[Any]) -> Dict[str, Any]:
    """Aggregate the per-step ``meta["telemetry"]`` dicts of a series.

    Sums the stage seconds and byte counts over every step that carries a
    telemetry record (anchors included) and reports per-step entropy
    ratios; steps compressed with telemetry disabled are skipped (and
    counted in ``steps_without_telemetry``).
    """
    time_keys = ("analyze_s", "encode_s", "exceptions_s", "entropy_s",
                 "finalize_s")
    totals = {k: 0.0 for k in time_keys}
    bytes_in = bytes_out = 0
    ratios: List[float] = []
    codecs: Dict[str, int] = {}
    n_with = n_without = 0
    for step in steps:
        tele = _step_tele(step)
        if tele is None:
            n_without += 1
            continue
        n_with += 1
        for k in time_keys:
            totals[k] += float(tele.get(k, 0.0))
        bytes_in += int(tele.get("bytes_in", 0))
        bytes_out += int(tele.get("bytes_out", 0))
        if "entropy_ratio" in tele:
            ratios.append(float(tele["entropy_ratio"]))
        c = tele.get("codec")
        if c:
            codecs[c] = codecs.get(c, 0) + 1
    return {"steps": n_with, "steps_without_telemetry": n_without,
            "totals": totals, "bytes_in": bytes_in, "bytes_out": bytes_out,
            "entropy_ratio_mean": (sum(ratios) / len(ratios)) if ratios
            else None, "codecs": codecs}
