"""The cluster model of the paper: workloads, traces, the discrete-event
engine (pure Python on the host), the frozen seed engine it is held to
(``_legacy``), the large-fleet scenarios, and the batched fluid surrogate,
whose scan runs on the card (``repro_torch.simcluster.surrogate``, imported
on demand)."""
from repro_torch.simcluster.sim import ClusterSim, SimResult
from repro_torch.simcluster.largescale import (SCENARIOS, Scenario,
                                               run_scenario)
from repro_torch.simcluster.traces import (PRESETS, ArrivalConfig, SizeConfig,
                                           Trace, TraceConfig, TraceJob,
                                           generate_trace, paper_trace,
                                           trace_from_rows)
from repro_torch.simcluster.workloads import (PAPER_TABLE2_ROWS, WORKLOADS,
                                              make_job, paper_cluster,
                                              paper_job_mix,
                                              paper_table2_jobs)
