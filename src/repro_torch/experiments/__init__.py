"""Trace-driven experiment harness, as the port's own copy of the JAX
package's ``experiments``: declarative sweeps over (trace x cluster x
scheduler x seed) grids with on-disk caching, a metrics warehouse,
paired-bootstrap statistics, the regime atlas, decision-trace telemetry, the
paper's §5 evaluation, the fluid surrogate's sweeps and calibration, and the
CLI (``python -m repro_torch.experiments``).  Everything here but the fluid
surrogate (``repro_torch.experiments.surrogate``, imported on demand) is
pure Python on the host and imports no ``torch``.

Quickstart::

    PYTHONPATH=src python -m repro_torch.experiments paper --quick
    PYTHONPATH=src python -m repro_torch.experiments generate --preset bursty \
        --seed 0 --out traces/bursty.jsonl
    PYTHONPATH=src python -m repro_torch.experiments compare \
        --trace traces/bursty.jsonl --a proposed --b fair --seeds 0:5
"""
from repro_torch.experiments.metrics import (JobRecord, RunRecord,
                                             run_record_from_result)
from repro_torch.experiments.regimes import (RegimeCell, RegimeReport,
                                             regime_spec, run_regimes)
from repro_torch.experiments.runner import (ExperimentSpec, SweepReport,
                                            TraceRef, run_experiment)
from repro_torch.experiments.stats import (PairedComparison,
                                           bootstrap_mean_ci,
                                           compare_completion_by_workload,
                                           compare_throughput,
                                           paired_bootstrap)
from repro_torch.experiments.paperfig import PaperReport, run_paper

__all__ = [
    "ExperimentSpec", "JobRecord", "PairedComparison", "PaperReport",
    "RegimeCell", "RegimeReport", "RunRecord", "SweepReport", "TraceRef",
    "bootstrap_mean_ci", "compare_completion_by_workload",
    "compare_throughput", "paired_bootstrap", "regime_spec",
    "run_experiment", "run_paper", "run_record_from_result", "run_regimes",
]
