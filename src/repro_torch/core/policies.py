"""Policies as values: the registry and ``PolicySpec``, as the port's own
copy of the JAX package's ``core/policies.py``.

A registration declares a policy's parameter schema (names, types and
defaults) and its *components* along the proposed scheduler's seams — job
**ordering** (``edf`` / ``fair_deficit`` / ``fifo``), **park admission**
(``off`` / ``fixed`` / ``adaptive``), **overload** policy (``none`` /
``latch`` / ``reduce_aware``) and service-core **harvest** (``off`` /
``ewma``).  :class:`PolicySpec` is a named policy plus typed parameter
overrides, with a canonical serialized form and a **stable cache key**: for
a spec with all-default parameters the cache descriptor is the bare policy
name, so the port's sweep cells hash exactly as the original's do.

The same eight policies are registered in the same order, with the same
components and defaults (a test holds every spec's cache key, components
and effective parameters to the original's).  The original's
``build`` / ``build_policy`` construct the event engine's schedulers; they
are not copied, and wait for the port's event engine.  The fluid surrogate reads only the components
and parameters (``repro_torch.simcluster.surrogate.lower_policy``).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple


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
    # Borg-style service-core harvesting (the event engine's serving layer): off,
    # or utilization-EWMA borrowing against ServeConfig's headroom bar
    "harvest": ("off", "ewma"),
}


@dataclass(frozen=True)
class Policy:
    """One registry entry: the schema of a named policy."""

    name: str
    description: str
    components: Mapping[str, str]          # axis -> value (COMPONENT_AXES)
    defaults: Mapping[str, object]         # param name -> default value

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
                    defaults: Optional[Mapping[str, object]] = None) -> Policy:
    """Register a policy under ``name``.  ``components`` must cover every
    axis in ``COMPONENT_AXES`` (axes with an "off" value may be omitted and
    default to it)."""
    components = dict(components)
    for axis, vocab in COMPONENT_AXES.items():
        if axis not in components and "off" in vocab:
            components[axis] = "off"
        if components.get(axis) not in vocab:
            raise PolicyError(
                f"policy {name!r}: component {axis!r} must be one of "
                f"{vocab}, got {components.get(axis)!r}")
    if name in _REGISTRY:
        raise PolicyError(f"policy {name!r} already registered")
    policy = Policy(name=name, description=description,
                    components=dict(components), defaults=dict(defaults or {}))
    _REGISTRY[name] = policy
    return policy


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


# ---------------------------------------------------------------------------
# registrations: the canonical presets + the composed extras, in the
# original's order
# ---------------------------------------------------------------------------

#: AdaptiveConfig knobs the adaptive presets expose as PolicySpec params.
#: Values mirror the AdaptiveConfig field defaults, so a default-built spec
#: keeps the bare-name cache descriptor.
_ADAPTIVE_PARAM_KNOBS: Dict[str, object] = {
    "surge_width": 16.0,
    "crash_discount": True,
    "ewma_gap_cap": 4.0,
}

register_policy(
    "proposed",
    description="The paper's completion-time scheduler (Algorithm 2) with "
                "fixed-patience VM-reconfiguration parking (Algorithm 1).",
    components={"ordering": "edf", "park": "fixed", "overload": "none"},
    defaults={"max_wait": 30.0, "park_depth": 2})
register_policy(
    "adaptive",
    description="Proposed scheduler with the pressure-adaptive "
                "reconfiguration policy (AdaptiveConfig) and the latching "
                "overload detector switched on.",
    components={"ordering": "edf", "park": "adaptive", "overload": "latch"},
    defaults={"max_wait": 30.0, "park_depth": 2, **_ADAPTIVE_PARAM_KNOBS})
register_policy(
    "adaptive_ra",
    description="Adaptive policy with the reduce-aware overload latch: the "
                "crowd bar counts only map-open jobs and the latch releases "
                "when the map backlog drains, so long reduce backlogs "
                "neither trip nor hold it.",
    components={"ordering": "edf", "park": "adaptive",
                "overload": "reduce_aware"},
    defaults={"max_wait": 30.0, "park_depth": 2, **_ADAPTIVE_PARAM_KNOBS})
register_policy(
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
register_policy(
    "fair",
    description="Hadoop Fair Scheduler: equal instantaneous share, deficit "
                "round-robin; no deadlines, estimator or reconfiguration.",
    components={"ordering": "fair_deficit", "park": "off", "overload": "none"},
    defaults={"locality_delay": 0})
register_policy(
    "fifo",
    description="Hadoop default FIFO scheduler: submission order.",
    components={"ordering": "fifo", "park": "off", "overload": "none"})
register_policy(
    "delay",
    description="Delay scheduling [Zaharia, EuroSys'10]: fair deficit order; "
                "a job skips up to locality_delay scheduling offers while it "
                "has no data-local task on the offered node, then launches "
                "remotely.",
    components={"ordering": "fair_deficit", "park": "off", "overload": "none"},
    defaults={"locality_delay": 8})
register_policy(
    "edf_nopark",
    description="Ablation: the proposed EDF/demand scheduler with parking "
                "disabled — every non-local map launches remotely at once "
                "(Algorithm 2 without Algorithm 1).",
    components={"ordering": "edf", "park": "off", "overload": "none"},
    defaults={"max_wait": 30.0, "park_depth": 2})
