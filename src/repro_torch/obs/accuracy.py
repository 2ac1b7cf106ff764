"""Estimation-accuracy telemetry: HLL estimate vs exact output nnz.

Ocean's thesis replaces the exact symbolic pass with HyperLogLog
estimation plus a workflow selector — this module makes the quality of
that bet observable. After the numeric pass has produced exact per-row
output sizes, :func:`measure_accuracy` compares them against the per-row
prediction the plan was binned from (persisted on
``ExecutionPlan.pred_row_nnz``) and reports:

* a **signed relative error** distribution, ``(pred - exact) /
  max(exact, 1)`` over live rows (negative = underprediction), with
  headline ``est_err_p50`` / ``est_err_p95`` percentiles of \\|err\\|;
* **per-rung misprediction counts** — for every dense-window / hash /
  ESC bin, how many rows underpredicted (exact size exceeded the rung's
  capacity, forcing the overflow fallback) or overpredicted (the rung's
  capacity was >= ``OVERPREDICT_FACTOR`` x the exact need, i.e. the row
  paid for a rung at least two pow2 steps too large);
* **overflow-fallback attribution by cause** — which bin family's
  capacity the overflowed rows broke (``dense_window`` / ``longrow_slab``
  / ``hash_spill``), with a ``+stale_feed`` qualifier when the plan was
  sized from feed-forward sizes (workflow ``"known"``), since a stale
  feed is then the likely culprit.

:func:`record_decision` captures the matching per-plan **workflow-decision
audit record** at plan-build time: the workflow/rung family chosen and
every input to that choice (ER, sampled CR, average products, the Table-1
thresholds in force, ablation forcing). See ``docs/observability.md`` for
the glossary.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from . import metrics as metrics_mod

__all__ = ["EstimationAccuracy", "measure_accuracy", "record_decision",
           "SIGNED_ERR_EDGES", "OVERPREDICT_FACTOR"]

# signed-relative-error histogram bin edges (open-ended on both sides);
# negative = underprediction (estimate too small -> overflow risk)
SIGNED_ERR_EDGES = (-1.0, -0.5, -0.2, -0.05, 0.05, 0.2, 0.5, 1.0, 2.0, 5.0)

# a rung "overpredicted" a row when its capacity is at least this factor
# above the exact need — two pow2 ladder steps of wasted accumulator
OVERPREDICT_FACTOR = 4.0


def _hist_labels() -> List[str]:
    edges = SIGNED_ERR_EDGES
    labels = [f"(-inf,{edges[0]:g})"]
    labels += [f"[{lo:g},{hi:g})" for lo, hi in zip(edges, edges[1:])]
    labels.append(f"[{edges[-1]:g},inf)")
    return labels


@dataclasses.dataclass
class EstimationAccuracy:
    """Estimate-vs-exact report for one executed plan.

    ``per_rung`` maps rung name (``dense_w{window}`` / ``longrow`` /
    ``hash_t{table}`` / ``esc``) to ``{"rows", "capacity",
    "underpredicted", "overpredicted"}``; ESC rows never underpredict
    (the pass is exact with upper-bound capacity).
    """
    workflow: str
    n_rows: int                      # live rows (products > 0) measured
    est_err_p50: float               # median |signed relative error|
    est_err_p95: float
    signed_err_hist: Dict[str, int]
    per_rung: Dict[str, Dict[str, int]]
    overflow_causes: Dict[str, int]
    feed_forward: bool = False

    @property
    def rung_mispredict_rate(self) -> float:
        """Mispredicted rows (under- or overpredicted) over all binned
        rows."""
        total = sum(r["rows"] for r in self.per_rung.values())
        bad = sum(r["underpredicted"] + r["overpredicted"]
                  for r in self.per_rung.values())
        return bad / max(total, 1)

    def summary(self) -> Dict:
        """Flat JSON-ready digest (the shape benchmark rows carry)."""
        return {
            "workflow": self.workflow,
            "n_rows": self.n_rows,
            "est_err_p50": self.est_err_p50,
            "est_err_p95": self.est_err_p95,
            "rung_mispredict_rate": self.rung_mispredict_rate,
            "overflow_fallback_causes": dict(self.overflow_causes),
        }


def _rung_entry(name: str, rows: np.ndarray, capacity: Optional[int],
                exact: np.ndarray, per_rung: Dict[str, Dict[str, int]]
                ) -> None:
    if not len(rows):
        return
    e = exact[rows].astype(np.float64)
    if capacity is None:            # ESC: exact pass, upper-bound capacity
        under = over = 0
    else:
        under = int((e > capacity).sum())
        over = int((capacity >= OVERPREDICT_FACTOR
                    * np.maximum(e, 1.0)).sum())
    cur = per_rung.setdefault(name, {"rows": 0, "capacity": 0,
                                     "underpredicted": 0,
                                     "overpredicted": 0})
    cur["rows"] += int(len(rows))
    cur["capacity"] = max(cur["capacity"], int(capacity or 0))
    cur["underpredicted"] += under
    cur["overpredicted"] += over


def measure_accuracy(plan, exact_row_nnz: np.ndarray,
                     overflow_causes: Optional[Dict[str, int]] = None
                     ) -> Optional[EstimationAccuracy]:
    """Build the accuracy report for one executed plan.

    ``exact_row_nnz`` is the exact per-row nnz of the *raw* product (the
    output's own ``indptr`` diff, or the merge state's raw counts when
    fused post-ops filtered the output). Returns ``None`` when the plan
    carries no per-row prediction (plans frozen before this telemetry
    existed)."""
    pred = getattr(plan, "pred_row_nnz", None)
    if pred is None:
        return None
    pred = np.asarray(pred, np.float64)
    exact = np.asarray(exact_row_nnz, np.int64)
    products = np.asarray(plan.products, np.int64)
    live = products > 0
    n_live = int(live.sum())
    if n_live:
        err = (pred[live] - exact[live]) / np.maximum(exact[live], 1)
        abs_err = np.abs(err)
        p50 = float(np.percentile(abs_err, 50.0))
        p95 = float(np.percentile(abs_err, 95.0))
        edges = np.concatenate(([-np.inf], SIGNED_ERR_EDGES, [np.inf]))
        counts, _ = np.histogram(err, bins=edges)
    else:
        p50 = p95 = 0.0
        counts = np.zeros(len(SIGNED_ERR_EDGES) + 1, np.int64)
    hist = {lbl: int(c) for lbl, c in zip(_hist_labels(), counts)}

    per_rung: Dict[str, Dict[str, int]] = {}
    for bn in plan.dense:
        name = "longrow" if bn.is_longrow else f"dense_w{bn.window}"
        _rung_entry(name, bn.rows, bn.cap, exact, per_rung)
    for hb in plan.hash:
        _rung_entry(f"hash_t{hb.table}", hb.rows, hb.table + hb.spill,
                    exact, per_rung)
    if plan.esc is not None:
        _rung_entry("esc", plan.esc.rows, None, exact, per_rung)

    causes = dict(overflow_causes or {})
    acc = EstimationAccuracy(
        workflow=plan.workflow, n_rows=n_live, est_err_p50=p50,
        est_err_p95=p95, signed_err_hist=hist, per_rung=per_rung,
        overflow_causes=causes, feed_forward=plan.feed_forward)

    reg = metrics_mod.active_registry()
    if reg is not None:
        reg.counter("ocean.executions", workflow=plan.workflow).inc()
        reg.histogram("ocean.est_err_abs").record(p50)
        for cause, n in causes.items():
            reg.counter("ocean.overflow_fallback_rows", cause=cause).inc(n)
        for name, r in per_rung.items():
            reg.counter("ocean.rung_rows", rung=name).inc(r["rows"])
            reg.counter("ocean.rung_underpredicted",
                        rung=name).inc(r["underpredicted"])
            reg.counter("ocean.rung_overpredicted",
                        rung=name).inc(r["overpredicted"])
    return acc


def record_decision(*, workflow: str, forced: Optional[str],
                    feed_forward: bool, er: float,
                    sampled_cr: Optional[float], nproducts_avg: float,
                    cfg) -> Dict:
    """Audit record of one plan-build workflow decision: what was chosen
    and every input to the choice (paper Table 1). Stored on the plan
    (``ExecutionPlan.decision``) and surfaced on each report; counted
    into the active metrics registry when one is installed."""
    rec = {
        "workflow": workflow,
        "forced": forced,
        "feed_forward": feed_forward,
        "er": float(er),
        "sampled_cr": None if sampled_cr is None else float(sampled_cr),
        "nproducts_avg": float(nproducts_avg),
        "er_threshold": cfg.er_threshold,
        "cr_threshold": cfg.cr_threshold,
        "upper_bound_avg_products": cfg.upper_bound_avg_products,
    }
    reg = metrics_mod.active_registry()
    if reg is not None:
        reg.counter("plan.workflow_decisions", workflow=workflow,
                    forced=forced or "").inc()
    return rec
