"""First-class policy API: composable, serializable scheduler specs, as the
port's own copy of the JAX package's ``core/policies.py``.

A registration declares a policy's parameter schema (names, types and
defaults), its *components* along the proposed scheduler's seams — job
**ordering** (``edf`` / ``fair_deficit`` / ``fifo``), **park admission**
(``off`` / ``fixed`` / ``adaptive``), **overload** policy (``none`` /
``latch`` / ``reduce_aware``) and service-core **harvest** (``off`` /
``ewma``) — and a builder that constructs the event engine's scheduler.
:class:`PolicySpec` is a named policy plus typed parameter overrides, with
a canonical serialized form and a **stable cache key**: for a spec with
all-default parameters the cache descriptor is the bare policy name, so the
port's sweep cells hash exactly as the original's do.

The same eight policies are registered in the same order, with the same
components, defaults and builders (a test holds every spec's cache key,
components and effective parameters to the original's, and the event
engine's records under every policy byte-equal to the original's).  The
fluid surrogate reads only the components and parameters
(``repro_torch.simcluster.surrogate.lower_policy``).

Not copied: the original's frozen seed engine (``simcluster/_legacy.py``)
and its builders; ``build(..., legacy=True)`` raises ``PolicyError`` until
ROADMAP's M10c ports it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.types import ClusterSpec


class PolicyError(ValueError):
    """Unknown policy, unknown parameter, or ill-typed parameter value."""


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

#: the component axes every registration must declare, and their vocabulary.
#: Axes whose vocabulary includes "off" may be omitted from a registration
#: and default to "off" — adding a new axis must not break existing
#: registrations (the ``harvest`` axis arrived after the presets).
COMPONENT_AXES: Dict[str, Tuple[str, ...]] = {
    "ordering": ("edf", "fair_deficit", "fifo"),
    "park": ("off", "fixed", "adaptive"),
    "overload": ("none", "latch", "reduce_aware"),
    # Borg-style service-core harvesting (repro_torch.simcluster.serving): off,
    # or utilization-EWMA borrowing against ServeConfig's headroom bar
    "harvest": ("off", "ewma"),
}


@dataclass(frozen=True)
class Policy:
    """One registry entry: schema + builder(s) for a named policy."""

    name: str
    description: str
    components: Mapping[str, str]          # axis -> value (COMPONENT_AXES)
    defaults: Mapping[str, object]         # param name -> default value
    builder: Callable[[ClusterSpec, Dict[str, object]], object]

    def validate_params(self, params: Mapping[str, object]) -> Dict[str, object]:
        """Type-check ``params`` against the schema and return only the
        entries that differ from the defaults (the canonical form: adding
        a new parameter with a default never changes existing specs'
        serialized form or cache keys)."""
        out: Dict[str, object] = {}
        for key in sorted(params):
            if key not in self.defaults:
                raise PolicyError(
                    f"policy {self.name!r} has no parameter {key!r}; "
                    f"available: {', '.join(sorted(self.defaults))}")
            default = self.defaults[key]
            value = params[key]
            if isinstance(default, bool):
                if not isinstance(value, bool):
                    raise PolicyError(
                        f"{self.name}.{key} must be a bool, got {value!r}")
            elif isinstance(default, float):
                if isinstance(value, bool) or not isinstance(value, (int, float)):
                    raise PolicyError(
                        f"{self.name}.{key} must be a number, got {value!r}")
                value = float(value)
            elif isinstance(default, int):
                if isinstance(value, bool) or not isinstance(value, int):
                    raise PolicyError(
                        f"{self.name}.{key} must be an int, got {value!r}")
            elif isinstance(default, str):
                if not isinstance(value, str):
                    raise PolicyError(
                        f"{self.name}.{key} must be a string, got {value!r}")
            if value != default:
                out[key] = value
        return out


_REGISTRY: Dict[str, Policy] = {}

#: the four names the pre-policy string factory understood; their default
#: specs must stay bit-identical to it and keep its cache descriptors
PRESET_NAMES: Tuple[str, ...] = ("proposed", "adaptive", "fair", "fifo")


def register_policy(name: str, *, description: str,
                    components: Mapping[str, str],
                    defaults: Optional[Mapping[str, object]] = None):
    """Decorator registering ``fn(cluster, params) -> scheduler`` under
    ``name``.  ``components`` must cover every axis in ``COMPONENT_AXES``
    (axes with an "off" value may be omitted and default to it)."""
    components = dict(components)
    for axis, vocab in COMPONENT_AXES.items():
        if axis not in components and "off" in vocab:
            components[axis] = "off"
        if components.get(axis) not in vocab:
            raise PolicyError(
                f"policy {name!r}: component {axis!r} must be one of "
                f"{vocab}, got {components.get(axis)!r}")

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise PolicyError(f"policy {name!r} already registered")
        _REGISTRY[name] = Policy(
            name=name, description=description,
            components=dict(components), defaults=dict(defaults or {}),
            builder=fn)
        return fn
    return deco


def get_policy(name: str) -> Policy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise PolicyError(
            f"unknown policy {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def registered_policies() -> Dict[str, Policy]:
    """Name -> registration, in registration order."""
    return dict(_REGISTRY)


def partition_policies(predicate) -> Tuple[List[str], List[str]]:
    """Split registered policy names by a predicate over their default
    ``PolicySpec``: ``(accepted, rejected)``, each in registration order.

    The canonical consumer is engine-capability gating — e.g. the fluid
    surrogate partitions the registry into policies it can lower and
    policies that stay oracle-only (``repro_torch.simcluster.surrogate
    .surrogate_supported``), and its fuzz wall iterates the rejected side
    asserting every one raises rather than silently approximating."""
    accepted: List[str] = []
    rejected: List[str] = []
    for name in _REGISTRY:
        (accepted if predicate(PolicySpec.parse(name)) else
         rejected).append(name)
    return accepted, rejected


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

@dataclass
class PolicySpec:
    """A scheduler policy as a value: registry name + parameter overrides.

    ``params`` is canonicalized on construction: unknown names and ill-typed
    values raise :class:`PolicyError`, and entries equal to the registered
    defaults are dropped — so two specs describing the same policy compare
    equal, serialize identically and share one cache key."""

    name: str
    params: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self) -> None:
        policy = get_policy(self.name)
        self.params = policy.validate_params(self.params)

    # -- construction --------------------------------------------------------
    @classmethod
    def parse(cls, value) -> "PolicySpec":
        """Coerce a policy-shaped value: a ``PolicySpec`` (returned as is),
        a bare name, a JSON object string (the CLI's ``--policy``), or a
        ``{"name": ..., "params": {...}}`` mapping."""
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            text = value.strip()
            if text.startswith("{"):
                try:
                    value = json.loads(text)
                except json.JSONDecodeError as e:
                    raise PolicyError(f"bad policy JSON: {e}") from None
            else:
                return cls(name=text)
        if isinstance(value, Mapping):
            return cls.from_dict(value)
        raise PolicyError(f"cannot parse a policy from {value!r}")

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "PolicySpec":
        extra = set(d) - {"name", "params"}
        if extra or "name" not in d:
            raise PolicyError(
                "policy dict must be {'name': ..., 'params': {...}}, got "
                f"keys {sorted(d)}")
        if not isinstance(d["name"], str):
            raise PolicyError(f"policy name must be a string, "
                              f"got {d['name']!r}")
        params = d.get("params", {})
        if not isinstance(params, Mapping):
            raise PolicyError(f"policy params must be a mapping, got {params!r}")
        return cls(name=d["name"], params=dict(params))

    # -- canonical forms -----------------------------------------------------
    def to_dict(self) -> Dict[str, object]:
        """Canonical serialized form; ``from_dict(to_dict(s)) == s``."""
        return {"name": self.name,
                "params": {k: self.params[k] for k in sorted(self.params)}}

    def cache_descriptor(self):
        """Value embedded in experiment-cache cell descriptors.  A spec with
        all-default parameters collapses to the bare name — byte-identical
        to the descriptors the old string-keyed factory produced, so
        pre-policy cache cells keep hitting."""
        return self.name if not self.params else self.to_dict()

    def cache_key(self) -> str:
        """Stable 16-hex content key of the canonical form (pinned by
        ``tests/test_policies.py`` — changing it orphans sweep caches)."""
        blob = json.dumps(self.cache_descriptor(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    @property
    def label(self) -> str:
        """Short human/warehouse identifier: the name, plus any non-default
        parameters in canonical order."""
        if not self.params:
            return self.name
        inner = ",".join(f"{k}={self.params[k]}" for k in sorted(self.params))
        return f"{self.name}[{inner}]"

    # -- schema views --------------------------------------------------------
    @property
    def policy(self) -> Policy:
        return get_policy(self.name)

    @property
    def components(self) -> Dict[str, str]:
        return dict(self.policy.components)

    def effective_params(self) -> Dict[str, object]:
        """Defaults overlaid with this spec's overrides."""
        out = dict(self.policy.defaults)
        out.update(self.params)
        return out

    # -- building ------------------------------------------------------------
    def build(self, cluster: ClusterSpec, *, legacy: bool = False):
        """Construct the scheduler this spec describes on ``cluster``.

        ``legacy=True`` (the frozen seed engine's counterpart) raises
        PolicyError: that engine waits for ROADMAP's M10c."""
        if legacy:
            raise PolicyError(
                f"policy {self.name!r}: the frozen seed engine "
                "(simcluster/_legacy.py) is not ported yet (ROADMAP M10c)")
        sched = self.policy.builder(cluster, self.effective_params())
        sched.policy = self
        sched.name = self.label
        return sched


def build_policy(spec, cluster: ClusterSpec, *, legacy: bool = False):
    """Functional spelling of ``PolicySpec.parse(spec).build(cluster)``."""
    return PolicySpec.parse(spec).build(cluster, legacy=legacy)


# ---------------------------------------------------------------------------
# registrations: the canonical presets + the composed extras
# ---------------------------------------------------------------------------

#: AdaptiveConfig knobs the adaptive presets expose as PolicySpec params
#: (searchable dimensions; ROADMAP direction 2).  Values mirror the
#: AdaptiveConfig field defaults, so a default-built spec leaves the
#: cluster's config untouched and keeps the bare-name cache descriptor.
_ADAPTIVE_PARAM_KNOBS: Dict[str, object] = {
    "surge_width": 16.0,
    "crash_discount": True,
    "ewma_gap_cap": 4.0,
}


def _adaptive_cluster(cluster: ClusterSpec,
                      p: Optional[Mapping[str, object]] = None) -> ClusterSpec:
    """The cluster with its AdaptiveConfig switched on (the adaptive knobs
    themselves live on ``ClusterSpec`` and are part of the *cluster* cache
    identity, exactly as before).  ``p`` (the policy's effective params)
    may override the ``_ADAPTIVE_PARAM_KNOBS`` fields — e.g. the
    ``surge_width=0`` ablation recovers the pre-PR-8 latch."""
    overrides = {}
    if p is not None:
        overrides = {k: p[k] for k in _ADAPTIVE_PARAM_KNOBS
                     if k in p and p[k] != getattr(cluster.adaptive, k)}
    if cluster.adaptive.enabled and not overrides:
        return cluster
    return dataclasses.replace(
        cluster,
        adaptive=dataclasses.replace(cluster.adaptive, enabled=True,
                                     **overrides))


@register_policy(
    "proposed",
    description="The paper's completion-time scheduler (Algorithm 2) with "
                "fixed-patience VM-reconfiguration parking (Algorithm 1).",
    components={"ordering": "edf", "park": "fixed", "overload": "none"},
    defaults={"max_wait": 30.0, "park_depth": 2})
def _build_proposed(cluster: ClusterSpec, p: Dict[str, object]):
    from repro_torch.core.reconfigurator import Reconfigurator
    from repro_torch.core.scheduler import CompletionTimeScheduler
    # NB: the ctor's overload default ("latch") is deliberately left in
    # place rather than pinned to the declared "none" component: on the
    # preset's own terms the overload machinery is inert (it requires
    # ``cluster.adaptive.enabled``, which `proposed` does not set), and a
    # caller who hands in a cluster that *does* enable it must get the
    # pre-policy factory's behaviour bit-exactly — that construction used
    # the ctor default, and the cache descriptor for this preset is still
    # the bare string "proposed".
    return CompletionTimeScheduler(
        cluster, Reconfigurator(cluster, max_wait=p["max_wait"]),
        park_depth=p["park_depth"])


@register_policy(
    "adaptive",
    description="Proposed scheduler with the pressure-adaptive "
                "reconfiguration policy (AdaptiveConfig) and the latching "
                "overload detector switched on.",
    components={"ordering": "edf", "park": "adaptive", "overload": "latch"},
    defaults={"max_wait": 30.0, "park_depth": 2, **_ADAPTIVE_PARAM_KNOBS})
def _build_adaptive(cluster: ClusterSpec, p: Dict[str, object]):
    from repro_torch.core.reconfigurator import Reconfigurator
    from repro_torch.core.scheduler import CompletionTimeScheduler
    cluster = _adaptive_cluster(cluster, p)
    return CompletionTimeScheduler(
        cluster, Reconfigurator(cluster, max_wait=p["max_wait"]),
        park_depth=p["park_depth"], overload="latch")


@register_policy(
    "adaptive_ra",
    description="Adaptive policy with the reduce-aware overload latch: the "
                "crowd bar counts only map-open jobs and the latch releases "
                "when the map backlog drains, so long reduce backlogs "
                "neither trip nor hold it.",
    components={"ordering": "edf", "park": "adaptive",
                "overload": "reduce_aware"},
    defaults={"max_wait": 30.0, "park_depth": 2, **_ADAPTIVE_PARAM_KNOBS})
def _build_adaptive_ra(cluster: ClusterSpec, p: Dict[str, object]):
    from repro_torch.core.reconfigurator import Reconfigurator
    from repro_torch.core.scheduler import CompletionTimeScheduler
    cluster = _adaptive_cluster(cluster, p)
    return CompletionTimeScheduler(
        cluster, Reconfigurator(cluster, max_wait=p["max_wait"]),
        park_depth=p["park_depth"], overload="reduce_aware")


@register_policy(
    "harvest",
    description="Adaptive policy plus Borg-style service-core harvesting: "
                "with ServeConfig active, idle service cores (utilization "
                "EWMA under the headroom bar) are lent to the batch side "
                "to plug parked maps and returned preemptively on load "
                "spikes before the p99 SLO is breached.  Identical to "
                "`adaptive` when serving is off.",
    components={"ordering": "edf", "park": "adaptive", "overload": "latch",
                "harvest": "ewma"},
    defaults={"max_wait": 30.0, "park_depth": 2, **_ADAPTIVE_PARAM_KNOBS})
def _build_harvest(cluster: ClusterSpec, p: Dict[str, object]):
    from repro_torch.core.reconfigurator import Reconfigurator
    from repro_torch.core.scheduler import CompletionTimeScheduler
    cluster = _adaptive_cluster(cluster, p)
    sched = CompletionTimeScheduler(
        cluster, Reconfigurator(cluster, max_wait=p["max_wait"]),
        park_depth=p["park_depth"], overload="latch")
    sched.harvest = True
    return sched


@register_policy(
    "fair",
    description="Hadoop Fair Scheduler: equal instantaneous share, deficit "
                "round-robin; no deadlines, estimator or reconfiguration.",
    components={"ordering": "fair_deficit", "park": "off", "overload": "none"},
    defaults={"locality_delay": 0})
def _build_fair(cluster: ClusterSpec, p: Dict[str, object]):
    from repro_torch.core.baselines import FairScheduler
    return FairScheduler(cluster, locality_delay=p["locality_delay"])


@register_policy(
    "fifo",
    description="Hadoop default FIFO scheduler: submission order.",
    components={"ordering": "fifo", "park": "off", "overload": "none"})
def _build_fifo(cluster: ClusterSpec, p: Dict[str, object]):
    from repro_torch.core.baselines import FIFOScheduler
    return FIFOScheduler(cluster)


@register_policy(
    "delay",
    description="Delay scheduling [Zaharia, EuroSys'10]: fair deficit order; "
                "a job skips up to locality_delay scheduling offers while it "
                "has no data-local task on the offered node, then launches "
                "remotely.",
    components={"ordering": "fair_deficit", "park": "off", "overload": "none"},
    defaults={"locality_delay": 8})
def _build_delay(cluster: ClusterSpec, p: Dict[str, object]):
    from repro_torch.core.baselines import FairScheduler
    return FairScheduler(cluster, locality_delay=p["locality_delay"])


@register_policy(
    "edf_nopark",
    description="Ablation: the proposed EDF/demand scheduler with parking "
                "disabled — every non-local map launches remotely at once "
                "(Algorithm 2 without Algorithm 1).",
    components={"ordering": "edf", "park": "off", "overload": "none"},
    defaults={"max_wait": 30.0, "park_depth": 2})
def _build_edf_nopark(cluster: ClusterSpec, p: Dict[str, object]):
    from repro_torch.core.reconfigurator import Reconfigurator
    from repro_torch.core.scheduler import CompletionTimeScheduler
    return CompletionTimeScheduler(
        cluster, Reconfigurator(cluster, max_wait=p["max_wait"]),
        park_depth=p["park_depth"], parking=False, overload="none")


# ---------------------------------------------------------------------------
# smoke check (CI: `python -m repro_torch.experiments policies --smoke`)
# ---------------------------------------------------------------------------

def smoke_test_policies(*, num_machines: int = 2,
                        seed: int = 0) -> List[str]:
    """Instantiate every registered policy on a tiny cluster, drive a short
    scenario to completion and flag stranded work.  Returns failure strings
    (empty = all policies healthy)."""
    import random

    from repro_torch.simcluster.sim import ClusterSim
    from repro_torch.simcluster.workloads import default_deadline, make_job

    failures: List[str] = []
    for name in registered_policies():
        spec = PolicySpec(name)
        cluster = ClusterSpec(num_machines=num_machines, vms_per_machine=2,
                              replication=1)
        rng = random.Random(seed)
        jobs = [make_job(f"{w}-{i}", w, 0.25,
                         default_deadline(w, 0.25), cluster, rng,
                         submit_time=float(i))
                for i, w in enumerate(("wordcount", "grep"))]
        try:
            sched = spec.build(cluster)
            result = ClusterSim(cluster, sched, seed=seed).run(jobs)
        except Exception as e:           # noqa: BLE001 - smoke surface
            failures.append(f"{name}: {type(e).__name__}: {e}")
            continue
        for jid, rt in result.jobs.items():
            if rt.finish_time is None:
                failures.append(f"{name}: job {jid} never finished")
            elif rt.pending_map or rt.pending_reduce:
                failures.append(f"{name}: job {jid} left stranded tasks")
        if result.scheduler != spec.label:
            failures.append(f"{name}: result labelled {result.scheduler!r}")
    return failures
