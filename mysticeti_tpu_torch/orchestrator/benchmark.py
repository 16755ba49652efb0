"""Benchmark parameters and the max-load search state machine.

The port's copy of ``mysticeti_tpu.orchestrator.benchmark``.

Capability parity with ``orchestrator/src/benchmark.rs``:

* ``BenchmarkParameters`` {nodes, faults, load, duration} (:33-45)
* ``LoadType``: fixed list of loads, or binary ``Search`` for the maximum
  sustainable load (:99-135)
* out-of-capacity rule: avg latency > 5x the previous run's, or tps < 2/3 of
  the offered load (:202-220)
* ``register_result`` driving the search: double until breaking point, then
  binary search between the last good and first bad load (:224-271)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .faults import FaultsType
from .measurement import MeasurementsCollection

MAX_LATENCY_RATIO = 5.0  # benchmark.rs:205
MIN_TPS_RATIO = 2.0 / 3.0  # benchmark.rs:212


@dataclass
class BenchmarkParameters:
    nodes: int
    load: int  # offered tx/s across the committee
    duration_s: float
    faults: FaultsType = field(default_factory=FaultsType.none)

    def describe(self) -> str:
        return (
            f"{self.nodes} nodes ({self.faults.describe()}) - "
            f"{self.load} tx/s for {self.duration_s:.0f}s"
        )

    def to_dict(self) -> dict:
        return {
            "nodes": self.nodes,
            "load": self.load,
            "duration_s": self.duration_s,
            "faults": self.faults.to_dict(),
        }


class LoadType:
    FIXED = "fixed"
    SEARCH = "search"

    def __init__(self, kind: str, loads: Optional[List[int]] = None,
                 starting_load: int = 0, latency_increase_tolerance: float = MAX_LATENCY_RATIO,
                 max_iterations: int = 5) -> None:
        self.kind = kind
        self.loads = loads or []
        self.starting_load = starting_load
        self.latency_increase_tolerance = latency_increase_tolerance
        self.max_iterations = max_iterations

    @classmethod
    def fixed(cls, loads: List[int]) -> "LoadType":
        return cls(cls.FIXED, loads=loads)

    @classmethod
    def search(cls, starting_load: int, max_iterations: int = 5) -> "LoadType":
        return cls(cls.SEARCH, starting_load=starting_load, max_iterations=max_iterations)


class ParametersGenerator:
    """Yields the next BenchmarkParameters given past results (benchmark.rs:137-271)."""

    def __init__(
        self,
        nodes: int,
        load_type: LoadType,
        duration_s: float = 180.0,
        faults: Optional[FaultsType] = None,
    ) -> None:
        self.nodes = nodes
        self.load_type = load_type
        self.duration_s = duration_s
        self.faults = faults or FaultsType.none()
        self._fixed_index = 0
        self._search_lower = 0
        self._search_upper: Optional[int] = None
        self._search_current = load_type.starting_load
        self._iterations = 0
        self._previous_latency: Optional[float] = None
        self._done = False

    def _params(self, load: int) -> BenchmarkParameters:
        return BenchmarkParameters(
            nodes=self.nodes,
            load=load,
            duration_s=self.duration_s,
            faults=self.faults,
        )

    def next_parameters(self) -> Optional[BenchmarkParameters]:
        if self._done:
            return None
        if self.load_type.kind == LoadType.FIXED:
            if self._fixed_index >= len(self.load_type.loads):
                return None
            return self._params(self.load_type.loads[self._fixed_index])
        return self._params(self._search_current)

    def out_of_capacity(
        self, parameters: BenchmarkParameters, collection: MeasurementsCollection
    ) -> bool:
        """benchmark.rs:202-220."""
        avg_latency = collection.aggregate_average_latency_s()
        if (
            self._previous_latency is not None
            and self._previous_latency > 0
            and avg_latency > self.load_type.latency_increase_tolerance * self._previous_latency
        ):
            return True
        if collection.aggregate_tps() < MIN_TPS_RATIO * parameters.load:
            return True
        return False

    def register_result(
        self, parameters: BenchmarkParameters, collection: MeasurementsCollection
    ) -> None:
        """Advance the state machine (benchmark.rs:224-271)."""
        if self.load_type.kind == LoadType.FIXED:
            self._fixed_index += 1
            return
        over = self.out_of_capacity(parameters, collection)
        if not over:
            self._previous_latency = collection.aggregate_average_latency_s()
        self._iterations += 1
        # Record this probe's bound BEFORE the iteration cutoff: a run whose
        # final probe sustains must count toward max_sustainable_load.
        if over:
            self._search_upper = parameters.load
        else:
            self._search_lower = parameters.load
        if self._iterations >= self.load_type.max_iterations:
            self._done = True
            return
        if self._search_upper is None:
            self._search_current = parameters.load * 2  # still probing upward
        else:
            if self._search_upper - self._search_lower <= max(
                1, self._search_lower // 10
            ):
                self._done = True
                return
            self._search_current = (self._search_lower + self._search_upper) // 2

    def max_sustainable_load(self) -> int:
        return self._search_lower

    def out_of_capacity_load(self) -> Optional[int]:
        """The lowest load a search probe ran out of capacity at; None while
        every probe kept up (a search that ends so stopped on its iteration
        cap, and ``max_sustainable_load`` is only a floor)."""
        return self._search_upper
