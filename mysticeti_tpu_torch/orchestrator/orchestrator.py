"""The benchmark lifecycle driver.

The port's copy of ``mysticeti_tpu.orchestrator.orchestrator``.

Capability parity with ``orchestrator/src/orchestrator.rs`` ``run_benchmarks``
(:664-727) and the scrape/fault loop (:523-597): for each BenchmarkParameters
from the generator — cleanup, configure (genesis), boot nodes, scrape every
``scrape_interval_s`` while stepping the fault schedule, then summarize and
feed the result back into the (possibly searching) generator.
"""
from __future__ import annotations

import asyncio
import os
from typing import List

from ..health import cluster_snapshot_from_texts
from .benchmark import BenchmarkParameters, ParametersGenerator
from .faults import CrashRecoverySchedule
from .measurement import Measurement, MeasurementsCollection
from .runner import Runner

SCRAPE_INTERVAL_S = 15.0  # orchestrator.rs:523-530


class Orchestrator:
    def __init__(
        self,
        runner: Runner,
        generator: ParametersGenerator,
        results_dir: str = "benchmark-results",
        scrape_interval_s: float = SCRAPE_INTERVAL_S,
        workload: str = "shared",
    ) -> None:
        self.runner = runner
        self.generator = generator
        self.results_dir = results_dir
        self.scrape_interval_s = scrape_interval_s
        self.workload = workload
        self.collections: List[MeasurementsCollection] = []

    async def run_benchmarks(self) -> List[MeasurementsCollection]:
        os.makedirs(self.results_dir, exist_ok=True)
        run_index = 0
        while (parameters := self.generator.next_parameters()) is not None:
            collection = await self._run_one(parameters)
            self.collections.append(collection)
            collection.save(
                os.path.join(self.results_dir, f"measurements-{run_index}.json")
            )
            self.generator.register_result(parameters, collection)
            run_index += 1
        return self.collections

    async def _run_one(self, parameters: BenchmarkParameters) -> MeasurementsCollection:
        await self.runner.cleanup()
        await self.runner.configure(parameters.nodes, parameters.load)
        for authority in range(parameters.nodes):
            await self.runner.boot_node(authority)

        collection = MeasurementsCollection(parameters.to_dict())
        faults = CrashRecoverySchedule(parameters.faults, parameters.nodes)
        elapsed = 0.0
        next_fault_at = parameters.faults.interval_s
        while elapsed < parameters.duration_s:
            step = min(self.scrape_interval_s, parameters.duration_s - elapsed)
            await asyncio.sleep(step)
            elapsed += step
            # Scrape every node (orchestrator.rs:523-541).
            texts = {}
            for authority in range(parameters.nodes):
                text = await self.runner.scrape(authority)
                texts[str(authority)] = text
                if text is not None:
                    collection.add(
                        str(authority),
                        Measurement.from_prometheus(text, self.workload),
                    )
            # Host-level sample alongside the node scrapes (node_exporter
            # equivalent): attributes saturation to the host, not the node.
            host = await self.runner.host_sample()
            if host is not None:
                collection.add_host_sample(host)
            # Fleet health snapshot from the same scrape (health.py): the
            # run's artifact carries its own diagnosis — which authority
            # straggled, how far commits skewed, whether SLO alerts fired.
            snapshot = cluster_snapshot_from_texts(texts, parameters.nodes)
            snapshot["t"] = round(elapsed, 3)
            if host is not None:
                snapshot["weather"] = {
                    k: host[k]
                    for k in ("cpu_pct", "load_1m", "mem_available_mb")
                    if k in host
                }
            collection.add_health_sample(snapshot)
            # Fault schedule (orchestrator.rs:543-583).
            if (
                parameters.faults.kind != "none"
                and elapsed >= next_fault_at
            ):
                next_fault_at += parameters.faults.interval_s
                to_kill, to_boot = faults.update()
                for node in to_kill:
                    await self.runner.kill_node(node)
                for node in to_boot:
                    await self.runner.boot_node(node)
        await self.runner.cleanup()
        return collection
