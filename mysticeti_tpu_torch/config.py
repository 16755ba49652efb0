"""Node configuration: protocol parameters, synchronizer tuning, storage layout.

The port's copy of ``mysticeti_tpu.config``; ``yaml`` is imported only by
the YAML round-trip, so a host without it still runs the node.  Capability
parity with ``mysticeti-core/src/config.rs``:

* ``Parameters`` (config.rs:38-117) — identifiers (hostname/ports per authority),
  wave length, leader timeout, rounds per epoch, shutdown grace, leaders per
  round, pipelining, store retention, cleanup switch, synchronizer parameters,
  network latency breaker threshold.
* ``SynchronizerParameters`` (config.rs:76-100).
* YAML print/load (config.rs:16-29).
* ``PrivateConfig`` / ``StorageDir`` (config.rs:197-251) — per-authority key +
  storage paths: wal, certified tx log, committed tx log.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, asdict
from typing import List, Optional, Tuple

ROUNDS_IN_EPOCH_MAX = 2**63  # effectively "never close the epoch"

DEFAULT_PORT_BASE = 1500
DEFAULT_METRICS_PORT_OFFSET = 1000


@dataclass
class Identifier:
    """Network identity of one authority (config.rs:31-36)."""

    hostname: str
    port: int
    metrics_port: int


@dataclass
class SynchronizerParameters:
    """Dissemination/fetch tuning (config.rs:76-100).

    ``disseminate_others_blocks`` arms the helper streams the reference
    keeps dormant (synchronizer.rs:169-205): when on, a node missing a live
    connection to some authority asks up to ``maximum_helpers_per_authority``
    of its connected peers (``absolute_maximum_helpers`` total across
    authorities) to relay that authority's blocks as a push stream.  Off by
    default — it emits a wire tag pre-knob receivers reset on
    (docs/wire-format.md §7), and the pull fetcher already covers the gap
    at higher latency."""

    absolute_maximum_helpers: int = 32
    maximum_helpers_per_authority: int = 2
    batch_size: int = 100
    sample_precision_s: float = 0.25
    stream_interval_s: float = 1.0
    new_stream_threshold: int = 10
    disseminate_others_blocks: bool = False
    # Stamp outgoing block push frames with the sender's monotonic+wall
    # clocks (wire tag 12, docs/wire-format.md §5): the receiver surfaces
    # per-link transit (dissemination_transit_seconds{peer}) and records
    # `transit` spans the fleet-trace merger's skew estimator aligns.  Off
    # by default — like the other soft tags, pre-knob receivers reset the
    # connection on it.
    timestamp_frames: bool = False


@dataclass
class StorageParameters:
    """The storage lifecycle plane's knobs, unified (storage.py).

    Retention used to be scattered: ``Parameters.enable_cleanup`` switched
    the periodic cleanup task, ``Parameters.store_retain_rounds`` sized the
    in-memory cache window, and nothing at all bounded the disk.  This block
    owns all of it:

    * ``segment_bytes`` — the WAL rolls to a new ``wal.NNNNNN`` segment when
      the active one would exceed this size (``<= 0`` = legacy single-file
      log: no rolling, no checkpoints, no GC).
    * ``checkpoint_interval`` — commits between durable checkpoints; ``0``
      disables checkpointing (recovery then replays the whole log).
    * ``gc_depth`` — rounds retained behind the last committed leader;
      segments whose every block is older are deleted.  ``0`` = never GC.
    * ``retain_rounds`` — the in-memory cache-unload window (the old
      ``store_retain_rounds``); independent of the on-disk ``gc_depth``.
    * ``snapshot_catchup`` — arm the snapshot catch-up streams (wire tags
      9/10/11, docs/wire-format.md §5): a far-behind peer bootstraps from a
      serving node's commit baseline + post-GC block window instead of
      pulling all history block-by-block.  Off by default: it is a soft
      wire extension pre-knob receivers reset on.
    * ``catchup_threshold_commits`` — minimum commit-height gap before a
      snapshot is requested/served (below it, the ordinary streams win).
    """

    segment_bytes: int = 64 * 1024 * 1024
    checkpoint_interval: int = 512
    gc_depth: int = 10_000
    retain_rounds: int = 500
    enable_cleanup: bool = True
    snapshot_catchup: bool = False
    catchup_threshold_commits: int = 200


@dataclass
class IngressParameters:
    """The overload-resilient ingress plane's knobs (ingress.py).

    Transactions used to enter through ``BenchmarkFastPathBlockHandler.submit``
    into an UNBOUNDED queue with nothing but the per-block SOFT_MAX drain cap:
    past saturation the queue (and end-to-end latency) grew without limit and
    committed throughput collapsed (in the JAX package's max-load
    measurement: 40.3k committed at 57.6k offered).  This block configures the bounded, admission-controlled mempool
    and the client gateway that replace it:

    * ``mempool_max_transactions`` / ``mempool_max_bytes`` — hard caps on the
      pool; submissions beyond them are SHED with a typed reject, never
      silently queued or dropped.
    * ``lane_max_transactions`` — per-client fairness-lane cap.  The
      default equals the pool cap (single-tenant benchmark profile: the one
      generator lane may use the whole pool, so the POOL watermark — the
      AIMD congestion signal — is reachable); multi-tenant deployments set
      it lower so one flooding client fills its own lane, not the pool.
    * ``priority_weight`` — weighted-round-robin drain weight of priority
      lanes relative to normal ones.
    * ``dedup_window`` — recently-admitted transaction keys remembered for
      nonce/digest dedup (count-bounded so seeded sims stay deterministic).
    * ``admission`` — arm the AIMD admission controller: the admitted rate
      closes the loop from live core signals (WAL backlog, core owner queue
      depth, verifier pipeline occupancy, mempool occupancy) so at 2-5x
      offered overload the core keeps running at its measured saturation
      point instead of collapsing.
    * ``admission_initial_tx_s`` / ``admission_min_tx_s`` /
      ``admission_additive_tx_s`` / ``admission_decrease_factor`` — AIMD
      shape: additive raise per tick while healthy, multiplicative cut on
      congestion, floor so a transient stall cannot starve ingress forever.
    * ``high_watermark`` / ``low_watermark`` — mempool occupancy fractions:
      above high = congested (cut), below low = recovered (raise); between
      them the rate holds (hysteresis, so the controller cannot flap).
    * ``queued_watermark`` — occupancy above which an accepted submission is
      acknowledged QUEUED instead of ACK (the gateway's early-backpressure
      hint to well-behaved clients).
    * ``max_per_proposal`` — per-proposal drain budget (0 = the handler's
      SOFT_MAX); sims use a small value to reproduce saturation in virtual
      time.
    * ``gateway_port_base`` — when > 0, serve the client RPC gateway on
      ``gateway_port_base + authority`` (wire tags 13-16,
      docs/wire-format.md); 0 = no gateway listener.
    * ``tick_interval_s`` — admission controller cadence.
    * ``shed_log_capacity`` — bounded structured shed log (the deterministic
      overload sim asserts it byte-identical across same-seed runs).
    * ``finality_sample_every`` — the finality SLI plane's content-based
      count-sampling stride (finality.py): an ingress key participates in
      the submit→finality phase join iff ``key_bytes % N == 0``, so all
      nodes (and client generators) sample the SAME transactions without
      coordination.  1 = every transaction, 0 = tracker disabled.
    """

    enabled: bool = True
    mempool_max_transactions: int = 200_000
    mempool_max_bytes: int = 256 * 1024 * 1024
    lane_max_transactions: int = 200_000
    priority_weight: int = 4
    dedup_window: int = 100_000
    admission: bool = True
    admission_initial_tx_s: float = 100_000.0
    admission_min_tx_s: float = 500.0
    admission_max_tx_s: float = 1_000_000.0
    admission_additive_tx_s: float = 1_000.0
    admission_decrease_factor: float = 0.7
    high_watermark: float = 0.85
    low_watermark: float = 0.5
    queued_watermark: float = 0.5
    max_per_proposal: int = 0
    gateway_port_base: int = 0
    tick_interval_s: float = 0.5
    shed_log_capacity: int = 10_000
    finality_sample_every: int = 16


@dataclass
class Parameters:
    identifiers: List[Identifier] = field(default_factory=list)
    wave_length: int = 3
    leader_timeout_s: float = 2.0
    rounds_in_epoch: int = ROUNDS_IN_EPOCH_MAX
    shutdown_grace_period_s: float = 2.0
    number_of_leaders: int = 1
    enable_pipelining: bool = True
    # Leader liveness scoring (core.ready_new_block): stop gating proposals
    # on a leader whose blocks have not been accepted locally for more than
    # this many rounds (it is crashed, partitioned away, withholding, or
    # signing invalidly — the leader timeout would fire anyway).  0 (the
    # default) disables the filter: rounds are a LOAD-dependent clock, and
    # on a contended host an honest-but-stalled leader can fall a fixed
    # round count behind in well under the leader timeout — measured 18%
    # fewer committed leaders on a loaded 4-validator testbed with an
    # 8-round horizon, every lost slot an honest leader skipped.  The
    # Byzantine scenario profile (scenarios.py) arms it at 4 where silent
    # adversaries are declared and the round clock is the sim's own.
    leader_liveness_horizon_rounds: int = 0
    # Commit-anchored epoch reconfiguration (reconfig.py): committee-change
    # transactions in the committed sequence derive new epochs; the commit
    # rule becomes slot-sequential (one decided leader per try_commit batch)
    # so every node switches stake arithmetic at the same sequence point,
    # and the EpochInfo wire extension (tag 17, docs/wire-format.md §8) is
    # armed.  Off by default: pre-knob peers reset connections on the soft
    # tag, and the frozen-committee fast path skips the per-commit scan.
    reconfig: bool = False
    # Deterministic execution plane (execution.py): fold every committed
    # sub-dag through the account/transfer state machine and chain a
    # per-commit state root.  Off by default: the fold costs a per-commit
    # payload scan, and the checkpoint/manifest soft tail grows with the
    # account table.
    execution: bool = False
    # Legacy spellings of the storage block's knobs: accepted at construction
    # and in YAML for back-compat, migrated into ``storage`` by __post_init__
    # (which then rebinds these names to the storage block's values, so every
    # existing reader keeps working).
    enable_cleanup: Optional[bool] = None
    store_retain_rounds: Optional[int] = None
    storage: StorageParameters = field(default_factory=StorageParameters)
    synchronizer: SynchronizerParameters = field(default_factory=SynchronizerParameters)
    ingress: IngressParameters = field(default_factory=IngressParameters)
    network_connection_max_latency_s: float = 5.0

    def __post_init__(self) -> None:
        if self.enable_cleanup is not None:
            self.storage.enable_cleanup = bool(self.enable_cleanup)
        if self.store_retain_rounds is not None:
            self.storage.retain_rounds = int(self.store_retain_rounds)
        self.enable_cleanup = self.storage.enable_cleanup
        self.store_retain_rounds = self.storage.retain_rounds

    @classmethod
    def new_for_benchmarks(cls, ips: List[str]) -> "Parameters":
        """Benchmark defaults mirroring Parameters::new_for_benchmarks (config.rs:57-72).

        ``MYSTICETI_RETAIN_ROUNDS`` (genesis-time env) overrides the store
        retain window: crash-recovery experiments need peers to retain the
        whole downtime's worth of rounds or the rebooted node cannot fetch
        its backlog (the default 500 rounds is seconds at saturation)."""
        identifiers = [
            Identifier(
                hostname=ip,
                port=DEFAULT_PORT_BASE + i,
                metrics_port=DEFAULT_PORT_BASE + DEFAULT_METRICS_PORT_OFFSET + i,
            )
            for i, ip in enumerate(ips)
        ]
        overrides = {}
        retain = int(os.environ.get("MYSTICETI_RETAIN_ROUNDS", "0") or 0)
        if retain > 0:
            overrides["store_retain_rounds"] = retain
        # Local fleets don't need the 2 s WAN leader timeout; fault benches
        # override it so a crashed leader's slots cost ms, not seconds.
        timeout = float(os.environ.get("MYSTICETI_LEADER_TIMEOUT", "0") or 0)
        if timeout > 0:
            overrides["leader_timeout_s"] = timeout
        return cls(identifiers=identifiers, **overrides)

    def address(self, authority: int) -> Tuple[str, int]:
        ident = self.identifiers[authority]
        return ident.hostname, ident.port

    def metrics_address(self, authority: int) -> Tuple[str, int]:
        ident = self.identifiers[authority]
        return ident.hostname, ident.metrics_port

    def all_network_addresses(self) -> List[Tuple[str, int]]:
        return [(i.hostname, i.port) for i in self.identifiers]

    # -- YAML round-trip (config.rs:16-29) --

    def dump(self, path: str) -> None:
        raw = asdict(self)
        # The storage block is the canonical spelling; the migrated legacy
        # keys would otherwise shadow a hand-edited storage block on reload.
        raw.pop("enable_cleanup", None)
        raw.pop("store_retain_rounds", None)
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(raw, f, sort_keys=False)

    @classmethod
    def load(cls, path: str) -> "Parameters":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f)
        sync = SynchronizerParameters(**raw.pop("synchronizer", {}))
        storage = StorageParameters(**raw.pop("storage", {}))
        # Absent on older parameter files: defaults apply (the ingress
        # plane is on with generous caps, same as a fresh genesis).
        ingress = IngressParameters(**raw.pop("ingress", {}))
        identifiers = [Identifier(**i) for i in raw.pop("identifiers", [])]
        return cls(
            identifiers=identifiers, synchronizer=sync, storage=storage,
            ingress=ingress, **raw
        )


@dataclass
class PrivateConfig:
    """Per-authority private material + storage paths (config.rs:197-251)."""

    authority: int
    storage_path: str
    keypair_seed: bytes = b""

    @classmethod
    def new_in_dir(cls, authority: int, dir_: str) -> "PrivateConfig":
        os.makedirs(dir_, exist_ok=True)
        return cls(authority=authority, storage_path=dir_)

    def wal(self) -> str:
        return os.path.join(self.storage_path, "wal")

    def certified_transactions_log(self) -> str:
        return os.path.join(self.storage_path, "certified.txt")

    def committed_transactions_log(self) -> str:
        return os.path.join(self.storage_path, "committed.txt")
