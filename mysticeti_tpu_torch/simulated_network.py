"""In-memory network with seeded random latency and partition control.

The port's copy of ``mysticeti_tpu.simulated_network``.

Capability parity with ``mysticeti-core/src/simulated_network.rs``: connection
pairs among all committee members with 50-100 ms one-way latency injected per
message (:14-95), plus explicit partition/heal control used by the partition
sim-test (net_sync.rs:753-780).

Drop-in for :class:`mysticeti_tpu_torch.network.TcpNetwork`: exposes the same
``connections`` queue of :class:`Connection` objects.  Message delivery is a
``loop.call_later`` on the DeterministicLoop, so ordering is reproducible by
seed.

Broadcast-once parity: dissemination streams enqueue
:class:`~mysticeti_tpu_torch.network.EncodedFrame` wrappers (encode-once
fan-out).  The pumps move them verbatim — the payload property is lazy, so
a simulation never pays for serialization — and ``Connection.recv`` unwraps
to the message on the receiving side; fault injectors see one object per
message exactly as before, keeping same-seed fault logs byte-identical.
"""
from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Set, Tuple

from .network import Connection, NetworkMessage
from .tracing import logger
from .utils.tasks import spawn_logged

log = logger(__name__)


class SimulatedNetwork:
    LATENCY_RANGE = (0.050, 0.100)  # one-way seconds (simulated_network.rs:20)

    def __init__(self, num_authorities: int, latency_ranges=None) -> None:
        self.n = num_authorities
        # Geo-latency profile (scenario matrix): optional per-directed-link
        # (src, dst) -> (lo, hi) one-way latency ranges; links not named
        # fall back to LATENCY_RANGE.  Draws still come from the loop RNG
        # in delivery order, so a profiled sim stays seed-reproducible.
        self.latency_ranges = latency_ranges or {}
        # per-node queue of fresh connections (what TcpNetwork.connections is).
        self.node_connections: List[asyncio.Queue] = [
            asyncio.Queue() for _ in range(num_authorities)
        ]
        self._links: Dict[Tuple[int, int], tuple] = {}  # (ca, cb, pump_a, pump_b)
        self._severed: Set[Tuple[int, int]] = set()
        self._down: Set[int] = set()
        # Fault seam (the JAX package's chaos.py drives it; here
        # chip_smoke.py's forged copies): when set, every src->dst batch is
        # routed through ``filter_batch(src, dst, batch) -> [(extra_delay_s,
        # messages), ...]`` which may drop, duplicate, or delay individual
        # messages.  None = faithful delivery (one group, zero extra delay).
        self.fault_injector = None

    async def connect_all(self) -> None:
        for a in range(self.n):
            for b in range(a + 1, self.n):
                await self._connect_pair(a, b)

    async def _connect_pair(self, a: int, b: int) -> None:
        ca = Connection(b)  # a's handle, peer=b
        cb = Connection(a)
        pump_a = spawn_logged(self._pump(a, b, ca, cb), log, name=f"pump {a}->{b}")
        pump_b = spawn_logged(self._pump(b, a, cb, ca), log, name=f"pump {b}->{a}")
        self._links[(a, b)] = (ca, cb, pump_a, pump_b)
        await self.node_connections[a].put(ca)
        await self.node_connections[b].put(cb)

    def _latency(self, src: int = -1, dst: int = -1) -> float:
        loop = asyncio.get_event_loop()
        rng = getattr(loop, "rng", None)
        lo, hi = self.latency_ranges.get((src, dst), self.LATENCY_RANGE)
        if rng is None:
            import random

            # Reached only on a loop without a seeded .rng — i.e. a real
            # event loop, which is nondeterministic anyway; DeterministicLoop
            # always carries one.
            return random.uniform(lo, hi)  # lint: ignore[sim-taint]
        return rng.uniform(lo, hi)

    async def _pump(self, src: int, dst: int, c_src: Connection, c_dst: Connection):
        """Move messages src->dst with latency.

        Messages already queued together ride ONE timer with one latency
        draw (a burst sent back-to-back arrives back-to-back — the same
        in-order, latency-delayed semantics), which cuts the simulator's
        scheduler events per message several-fold: at 50 authorities the
        per-message timer/task churn, not the consensus logic, dominated
        the wall clock."""
        loop = asyncio.get_event_loop()
        while not c_src.is_closed():
            batch = [await c_src.sender.get()]
            while True:
                try:
                    batch.append(c_src.sender.get_nowait())
                except asyncio.QueueEmpty:
                    break

            injector = self.fault_injector
            groups = (
                [(0.0, batch)]
                if injector is None
                else injector.filter_batch(src, dst, batch)
            )
            if not groups:
                continue
            base_latency = self._latency(src, dst)
            for extra_delay, messages in groups:
                if not messages:
                    continue

                def deliver(ms=messages):
                    if not c_dst.is_closed():
                        for m in ms:
                            try:
                                c_dst.receiver.put_nowait(m)
                            except asyncio.QueueFull:
                                break

                loop.call_later(base_latency + extra_delay, deliver)

    # -- fault injection --

    def _sever(self, a: int, b: int) -> None:
        key = (min(a, b), max(a, b))
        link = self._links.pop(key, None)
        if link is None:
            return
        ca, cb, pump_a, pump_b = link
        ca.close()
        cb.close()
        pump_a.cancel()
        pump_b.cancel()
        self._severed.add(key)

    def partition(self, group_a: List[int], group_b: List[int]) -> None:
        """Cut all links between the two groups.  Like a real partition over
        TCP, the connections BREAK (peers see closure) — healing re-establishes
        them, which re-runs the subscribe/catch-up path (net_sync.rs:753-780)."""
        for a in group_a:
            for b in group_b:
                self._sever(a, b)

    def isolate(self, node: int) -> None:
        self.partition([node], [i for i in range(self.n) if i != node])

    def crash(self, node: int) -> None:
        """Take a node off the network abruptly: every link breaks (peers
        observe closure mid-protocol) and queued-but-unaccepted fresh
        connections are discarded, so a restarted node's accept loop only
        ever sees post-restart connections."""
        self._down.add(node)
        for peer in range(self.n):
            if peer != node:
                self._sever(node, peer)
        queue = self.node_connections[node]
        while True:
            try:
                queue.get_nowait()
            except asyncio.QueueEmpty:
                break

    async def restart(self, node: int) -> None:
        """Bring a crashed node back: re-establish links to every live peer
        (both ends receive fresh Connection objects, re-running the
        subscribe/catch-up path exactly like a healed partition)."""
        self._down.discard(node)
        for key in sorted(k for k in self._severed if node in k):
            a, b = key
            other = b if a == node else a
            if other in self._down:
                continue
            self._severed.discard(key)
            await self._connect_pair(a, b)

    async def heal(self) -> None:
        """Reconnect every severed pair (the reconnect-forever workers' job in
        the real transport, network.rs:218-242).  Pairs touching a crashed
        node stay severed until that node restarts."""
        severed, self._severed = self._severed, set()
        for a, b in sorted(severed):
            if a in self._down or b in self._down:
                self._severed.add((a, b))
                continue
            await self._connect_pair(a, b)

    def close(self) -> None:
        for ca, cb, pump_a, pump_b in self._links.values():
            ca.close()
            cb.close()
            pump_a.cancel()
            pump_b.cancel()
