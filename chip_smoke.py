#!/usr/bin/env python3
"""Drive the PyTorch/CUDA verify path on one NVIDIA card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit, builds the four CUDA kernels
   (one nvcc per source, in parallel) and prints the build time and ptxas's
   register / stack report.
2. For each kernel, at the largest bucket (16,384 lanes) with a 50-key
   committee (BASELINE config 4), holds the kernel against its plain PyTorch
   version on the card, lane for lane, over the seven case classes (valid,
   corrupt R, corrupt s, corrupt message, wrong key, non-canonical s,
   corrupt pk) with the keys in random order; checks the verdicts against
   the labels the cases were built with and a sample against the Ed25519
   oracle; times kernel and plain version with CUDA events (each timed run
   queued behind a spin of the card, so a time is the device's alone).  The
   prologue, the generic kernel and the keyed kernel's lane form (one key
   per lane, as the committee dispatch runs it) are also held to their plain
   versions and timed on 256 lanes (the collector's flush) and on one lane;
   the keyed kernel's tile form (lanes grouped 32 to a key) at 16,384.  The
   keyed plain version reads the 13-bit key combs, the kernel the 51-bit
   lines converted from them.  Then the device time of one 256-signature
   flush of the committee: the prologue and the keyed lane form.  The
   tolerance is zero: every output is an integer or a bit, so "equal" means
   equal on every element.
3. Drives the main path: the signed blocks of a 50-authority committee over
   20 rounds (some tampered) are serialized, decoded, checked with
   ``verify_structure`` and verified through the node's verifier
   (``_make_verifier("cuda-only")``); then one committee dispatch of 15,000
   signatures (one 16,384-lane bucket) with a few unknown-key stragglers.
   Verdicts must equal the oracle's.  The block path must launch the keyed
   kernel and never the generic one; the committee dispatch the keyed
   kernel once and the generic one once (the stragglers).
4. Flat keyed upload: the 15,000-signature grouped chunk of step 2 as the
   flat layout (96 B per signature plus one ok bit), through
   ``verify_keyed_flat``; ``prologue_flat`` must equal its plain version on
   every output, and the verdicts the 26-column keyed path's and the labels.
   Times both layouts, host-to-device copy included.
5. Sharded dispatch: the committee burst of step 3 through
   ``sharded_verify_batch_indexed`` and ``sharded_verify_batch_fused`` on a
   mesh of the distinct cards (with two or more), else of 4 shards on
   ``cuda:0``; verdicts must equal the single-device dispatch, the labels
   and an oracle sample, and the valid count their sum.
6. Hybrid node kind: the blocks of step 3 through ``_make_verifier("cuda")``
   (the CPU/GPU router); verdicts must equal the oracle's, at least one
   batch must take the GPU route and the breaker must end closed.  Prints
   the router's calibration and how many batches took each route.
7. Entry: ``mysticeti_tpu_torch.entry.entry()`` on the card, its 8 verdicts
   all True and the oracle's; a copy with a bit flipped in R, A, M or s
   gives the oracle's verdicts.  Then ``dryrun_multichip(4)`` over the cards
   there are (4 shards on one card).
8. Service: a ``VerifierServer`` on a unix socket under ``build/``, in a
   thread, its backend on ``cuda:0`` and prewarmed; the blocks of step 3
   through ``_make_verifier("cuda-only")`` and then ``("cuda")`` with
   ``MYSTICETI_VERIFIER_SOCKET`` set.  Verdicts must equal the oracle's,
   HELLO_OK must carry a calibration and "cuda", the server must launch the
   keyed kernel and never the generic one, and the hybrid router must not
   be pinned to the CPU.
9. Metrics: the block path of step 3 runs with a ``metrics.Metrics`` and a
   span tracer; prints the pack, device and fetch stage seconds (sums and
   counts), the bytes moved each way, the kernels' build hits and misses,
   and checks the Chrome trace written under ``build/`` has the
   ``verify_*`` spans.
10. Receive: config 4's blocks at full width (50 authorities, 4,000
   transactions of 512 B a block), 5 rounds = 250 blocks, one in 25
   tampered, honest children including only valid blocks, and one forged
   block included by fewer than a quorum.  Authority 0 sends them in
   ``Blocks`` frames under ``MAX_FRAME`` over loopback between two port
   ``TcpNetwork`` endpoints; authority 1 receives them through
   ``_FrameReceiver`` and ``decode_message``, decodes each frame with
   ``StatementBlock.from_bytes_many`` (native, off the loop through
   ``DataPlaneOffload``) and runs ``verify_structure``.  The native
   extension must be built and active.  All 250 blocks go at once through
   ``cuda-only``, ``cuda-only-agg`` and ``cuda-agg``: verdicts equal to the
   oracle's, the forged block rejected, the aggregate kinds skipping blocks
   (skipped + direct = 250), the path launching the keyed kernel and never
   the generic one.  Then ``cuda-only`` and ``cuda-only-agg`` in turns,
   three pairs.  Also timed: the 250 blocks' decode native against the
   pure-Python fallback in this process.
11. Consensus (the consensus-50 cell): config 4's 50 authorities
   (``Committee.new_for_benchmarks(50)``, the benchmark signers) as 50
   ``Syncer``s over a ``Core``, a ``TestBlockHandler``, a
   ``TestCommitObserver`` and a WAL each, under the port's deterministic
   loop for 2.2 virtual seconds: each new own block goes to every peer after
   a seeded 50-100 ms, with 1 s leader timeouts and a 0.25 s relay pump.
   Every delivery is decoded through ``from_bytes_many`` (under the
   simulator's decode memo that is one ``from_bytes`` a block: the batched
   native decode of step 10 is bypassed) and awaited in the receiving
   node's own collector (5 ms window, 256 lanes); all 50 share
   one ``TorchSignatureVerifier`` on cuda:0; the accepted blocks go to
   ``add_blocks``.  One delivery in 50 (seeded) is preceded by a copy with
   a signature bit flipped.  Then the same seed over the ``cpu`` kind.
   Checks: every node commits at least 8 leaders; the committed sequences
   are prefixes of the longest; every forged copy is rejected and none is
   in a store; the sequences and every node's own blocks equal the ``cpu``
   run's; the path launches the prologue and the keyed kernel and never the
   generic one; the signatures that reached the card equal those of the
   deliveries verified.
12. Net sync: the node's own network plane in place of step 11's stand-in
   relay.  netsync-50: the 50 authorities of step 11, each a
   ``NetworkSyncer`` over its ``Core``, ``TestBlockHandler``,
   ``TestCommitObserver``, WAL and flight recorder, connected through the
   port's ``SimulatedNetwork`` (50-100 ms one way) under the deterministic
   loop for 2.2 virtual seconds with a 1 s leader timeout; one shared
   ``Metrics`` on every node's whole stack and collector; each node's block
   verifier its own collector over one ``TorchSignatureVerifier`` on cuda:0.
   A fault injector on the network (seeded) puts, before one src->dst
   batch in 50 that carries blocks, a ``Blocks`` message with a copy of
   that batch's last block with a signature bit flipped, and delivers one
   such batch in 50 a second time, right behind it or up to 100 ms later.
   Then the same seed over the ``cpu`` kind.  Checks: every node commits
   at least 8 leaders; the committed sequences are prefixes of the
   longest; every forged copy that reached a verifier is rejected, in no
   store, and counted by
   ``mysticeti_invalid_blocks_total{reason="signature"}`` and by the flight
   recorders' ``invalid-block`` events, and no honest block is rejected;
   the sequences and every node's own blocks equal the ``cpu`` run's; the
   path launches the prologue and the keyed kernel and never the generic
   one; every verdict a node acted on came back from the card, every card
   verdict it did not act on belongs to a verify call still open at stop,
   and the signatures on the card equal the collectors' dispatched lanes
   (so the blocks sent to a verifier less those on the card are the open
   calls' blocks pending at stop); re-delivered blocks were dropped before
   a verifier and the card verified no block twice for one node.
   netsync-tcp-10: 10 ``NetworkSyncer``s over the port's ``TcpNetwork`` on
   127.0.0.1 on a real event loop for 10 wall seconds, each with its own
   ``_make_verifier("cuda-only")``, every connection's sends putting a
   forged copy before one block-carrying message in 50.  Checks: every
   node commits at least 3 leaders; the sequences agree; the forged copies
   are held as in netsync-50 and no honest block is rejected; the verdicts
   and the card agree as in netsync-50; the collectors' device stage has
   time (the executor path ran, not the inline one); the keyed kernel
   launched and the generic one did not.  Prints the rounds, commits,
   blocks received and verified, the blocks open at stop, forged and
   re-delivered blocks, flushes and live lanes, stage seconds, the core
   queue's counters, missing blocks, the frame caches' builds and reuses
   and the wall seconds of each run.
13. Storage (storage-10): config 3's 10 validators
   (``Committee.new_for_benchmarks(10)``), each booted by ``open_store`` from
   its own segmented WAL directory into a ``Core`` over its
   ``StorageLifecycle`` and a ``NetworkSyncer`` over the port's
   ``SimulatedNetwork`` (50-100 ms one way, 1 s leader timeout), with
   16 KiB segments, a checkpoint every 5 commits, GC 80 rounds behind the
   last committed leader and snapshot catch-up on (threshold 50 commits),
   for 32 virtual s.  Node 3 crashes at 3 s and restarts at 21 s, after the
   fleet's GC pass at 20 s retired its history, so it rejoins through a
   snapshot manifest and the streamed window; node 1 crashes at 24 s for
   2 s with 11 bytes torn off its active segment and boots from a
   checkpoint.  A crash stops the node, closes its WAL writer and block
   store and tears the segment; the restart rebuilds the node from its
   directory with a fresh collector.  Every node's every incarnation
   verifies through its own collector (5 ms window, 256 lanes) over one
   ``TorchSignatureVerifier`` on cuda:0; the network's fault injector forges
   a copy ahead of one block-carrying batch in 50 and re-delivers one in
   50, and the first snapshot chunk is preceded by a forged copy of its last
   block.  Then the same seed over the ``cpu`` kind.  Checks: the committed
   sequences equal the ``cpu`` run's and agree across nodes at every shared
   height (the rejoiner's adopted anchor included), the counts equal the
   ``cpu`` run's and ``STORAGE_SEEDED``; node 3 adopted one snapshot whose
   floor lies above every round it had stored, resumed more than 25
   heights past its crash height and committed more than 50 further
   heights; node 1 booted from a checkpoint and replayed less than a fifth
   of its lifetime WAL bytes; every node reclaimed segments (first live
   offset above 0), keeps ``CHECKPOINT_KEEP`` checkpoint files and counted
   its restarts in ``crash_recovery_total``; snapshot blocks were served;
   every forged copy, the snapshot stream's included, was rejected and
   counted; the card's verdicts are accounted for as in step 12, an
   incarnation at a time, and no block reached the card twice within one
   incarnation; the prologue and
   the keyed kernel launched once a flush and the generic kernel never.
   Prints the live lanes a flush in the rejoiner's catch-up against the
   nodes that never crashed, the catch-up's wall seconds and the WAL bytes
   written against those live.
14. Epoch (epoch-10): step 13's fleet shape (10 validators, each booted by
   ``open_store`` from its own segmented WAL, 16 KiB segments, a checkpoint
   every 5 commits) with ``Parameters(reconfig=True, execution=True,
   leader_liveness_horizon_rounds=4)`` for 12 virtual s: node 1 is
   reweighted to stake 3 through node 0 at 2 s, node 4 removed through node
   0 at 5 s and stopped for good at 7 s; every 0.5 s each live node plants
   an execution batch (a CREATE, two TRANSFERs and an overdraft) on its
   block handler; node 2 is down from 8 s to 9.5 s and boots from its
   checkpoint.  Every incarnation of every node verifies through its own
   ``_make_verifier("cuda-only")`` on cuda:0, made and warmed before the
   launch counts are set to 0; the network's fault injector forges and
   re-delivers as in step 12.  Then the same seed over the ``cpu`` kind.
   Checks: every live node ends in epoch 2 and node 4 saw at least epoch
   1, with the same boundaries (height, round, committee digest) fleet-wide
   and in both runs; the committed sequences agree and equal the ``cpu``
   run's; the execution roots agree at every height nodes share and equal
   the ``cpu`` run's, the verdict counts equal, every node holds each
   committed planted account at (400, 3) and, where it never restarted,
   counts 3 applied and 1 ``insufficient_balance`` a batch; node 2's
   checkpoint boot is in epoch 2 on the fleet's root at its height; every
   forged copy is rejected and counted; the counts equal the ``cpu`` run's
   and ``EPOCH_SEEDED``; the generic kernel never launched, the prologue
   and the keyed kernel once a flush; the verdicts are accounted for as in
   step 12; each collector saw one ``note_committee`` a boundary it
   crossed; and ``FinalizationInterpreter`` over the first 48 rounds (past
   both boundaries, below its last committed leader) of node 0's, the
   rebooter's and the retiree's stores finds finalized transactions, each
   with a certifying block in that leader's causal history.
15. Ingress (ingress-10): config 3's 10 validators over the port's
   ``SimulatedNetwork`` (50-100 ms one way, 1 s leader timeout, step 12's
   fault injector), each with a synchronous WAL, its own
   ``_make_verifier("cuda-only")`` on cuda:0 (made and warmed before the
   launch counts are set to 0) and its ingress plane wired as ``Validator``
   wires it (an ``IngressPlane`` behind a ``BenchmarkFastPathBlockHandler``
   and the commit observer, attached to the core, the ``NetworkSyncer`` and
   the collector, whose ``health_state`` feeds admission), driven for 12
   virtual s by one closed-loop ``TransactionGenerator`` a node: 1,000
   transactions of 512 B a second, three times that from 5 s on, the
   parameters from ``OverloadScenario(...).ingress_parameters()`` (200
   transactions a block at most, a 4,000-transaction mempool).  Then the
   same seed over the ``cpu`` kind.  Checks: the committed sequences, the
   committed transactions, the sheds by reason, every node's shed schedule
   digest, every generator's stats and the fleet's server- and client-side
   finality percentiles equal the ``cpu`` run's and ``INGRESS_SEEDED``; on
   every node offered = admitted + shed, no transaction is committed twice,
   and shed mode is entered (on some node) only in the 3x step, where
   admission sheds and the clients retry; every
   node's sampled finality keys are closed on both sides, as many on each;
   every forged copy is rejected and counted; the verdicts are accounted
   for as in step 12; the prologue and the keyed kernel launch once a flush
   and the generic kernel never; the ingress and finality families equal
   the planes' and the generators' own counts.
16. Health (the observability plane).  health-tcp-10: config 3's 10
   validators, each built as in step 15 (``build_ingress_node``) with its
   own ``Metrics``, its own ``_make_verifier("cuda-only")`` and one
   closed-loop ``TransactionGenerator`` at 1,000 transactions of 512 B a
   second, over the port's ``TcpNetwork`` on 127.0.0.1 for 10 wall s, with
   step 12's forged copies; on every node a started ``HostMonitor`` (50 ms
   blocking threshold) as the dispatcher's ``blocking_monitor``, a
   ``HealthProbe`` (the JAX package's ``Validator`` SLOs) attached to the
   core, the syncer, the collector, the observer, the ingress plane, the
   host monitor and the node's flight recorder, sampling every second and
   fed the commit critical path from an installed ``SpanTracer``, and a
   ``serve_metrics`` endpoint with ``/health`` and
   ``/debug/flight-recorder``; one process-wide ``SamplingProfiler`` and
   ``SubsystemAccountant`` (started through ``MYSTICETI_PROFILE``) bound to
   every node's ``Metrics``.  At the end each node is scraped over HTTP
   (``/health``, ``/metrics``, ``/debug/flight-recorder``) and the scrapes
   go through ``cluster_snapshot_from_texts``.  Then the same over the
   ``cpu`` kind.  Checks, each run: step 12's commits and forged copies and
   the card accounting; every ``/health`` body parses (200 when ok, 503
   when degraded), names the run's backend, a breaker never open, loop-lag
   samples and an ingress block; every alert's stage is its kind's; every
   flight-recorder dump parses, is its node's and holds events; the
   cluster snapshot reaches every node; every sampled tick resolves to a
   registered subsystem and none holding a port frame lands in "other";
   on the card, ticks of ``verifier-pack``; the keyed kernel launched and
   the generic one did not.  Alerts are printed, not failed: ten nodes
   share one loop and one interpreter lock.  Prints the CPU seconds by
   subsystem and thread class, the convoy ratio, the "other" share by leaf
   frame, loop lag p50 / p99, blocking calls by site, the critical path's
   top 5 and the collectors' stage seconds.  health-sim-10: step 13's node
   shape (no GC) under the deterministic loop for 10 virtual s, node 3
   crashed at 3 s and rebooted from its WAL at 8 s, every incarnation its
   own verifier; each authority one ``HealthProbe`` (authority-lag SLO of 5
   rounds, its recorder dumping on alerts) that outlives restarts, attached
   with a ``HostMonitor`` to every incarnation and detached at the crash; a
   ``FleetHealthMonitor`` ticking every virtual second.  Then the ``cpu``
   kind.  Checks: node 3 reads down in every tick of its outage; every
   other node raises ``authority-lag`` naming node 3 at stage ``receive``
   during it; every host block is all-zero; the alert dumps on disk equal
   the recorders' ledgers and ``flight_recorder_dumps_total``, one an
   alerting recorder (debounced); the timeline (``HEALTH_STRIPPED`` keys
   stripped) and the alert stream are byte-equal to the ``cpu`` run's and
   their digests and counts equal ``HEALTH_SEEDED``; forged copies and the
   card accounting as in step 13; prologue = keyed = flushes, generic 0.
17. Node (the node assembly as users start it): genesis through ``python -m
   mysticeti_tpu_torch benchmark-genesis --ips 127.0.0.1`` x10 (config 3's
   committee; on its ports 1500+i and metrics 2500+i when they are free,
   else on the first free base from 20,000 up, printed), then ten OS
   processes, each ``python3 chip_smoke.py --node run ...``: the port's
   ``cli.main(["run", ...])`` unchanged (``node_child`` reads the kernels'
   launch counts and the collector's dispatches from the moment its
   verifier is ready, and at exit whether CUDA was initialized and the
   committed leaders), started by
   ``tools.perf_attr.run_fleet`` with ``MYSTICETI_PROFILE`` /
   ``MYSTICETI_PERF_REPORT``, ``MYSTICETI_EXIT_AFTER`` (12 s), ``TPS``
   1,000 of 512 B and ``MYSTICETI_FLIGHT_RECORDER``; a thread polls every
   node's ``/metrics``, ``/health`` and ``/debug/consensus``.  Three fleets
   in turn: node-proc-10 (``--verifier cuda-only``: ten CUDA contexts on
   cuda:0), node-svc-10 (the same with ``MYSTICETI_VERIFIER_SOCKET`` on one
   verifier service on cuda:0 hosted here) and the ``cpu`` kind.  Checks,
   each fleet: every process exits 0 within 12 + 60 s of its start; every
   node commits at least ``NODE_10["min_commits"]`` leaders and the
   sequences agree on their common prefixes; every node answered the three
   routes (``/debug/consensus`` naming it); each final exposition holds the
   reporter's ``histogram_pct`` sweep, no invalid block and no batch
   degraded to the CPU oracle; each node left its shutdown flight-recorder
   dump and its perf report.  node-proc-10: on each node, since its
   verifier was ready, prologue = keyed launches = its dispatches > 0 and
   generic 0.  node-svc-10: the service's prologue = keyed launches = its
   dispatches > 0 = the nodes' dispatches summed, generic 0, and no node
   process initialized CUDA.
   Prints, each fleet: commits a node a wall second, flushes and live
   lanes, a node's ``verifier-pack`` and busy thread-s, convoy ratio and
   mean runnable threads (its own perf report), loop lag p50 / p99,
   ``/health`` statuses, ``transaction_committed_latency`` p50 / p99, the
   seconds to the verifier's ``ready`` and the kernels' build hits.
18. Orchestrator (orchestrator-10): config 3's fleet as the reference's
   orchestrator runs it: the port's ``Orchestrator`` over its
   ``LocalProcessRunner(verifier="cuda-only", transaction_size=512)`` and a
   ``ParametersGenerator`` of two fixed loads, 10,000 and 30,000
   transactions a second over the 10 nodes (the whole script runs the
   10,000 one alone, ``ORCHESTRATOR_SCRIPT_LOADS``), 12 s a run, every node scraped
   every 4 s (``Measurement.from_prometheus``, the host sample, the health
   snapshot); each run's genesis on config 3's ports or a free base, ten
   ``python -m mysticeti_tpu_torch run`` processes behind one verifier
   service on cuda:0 that the runner starts and warms; then
   ``plot_latency_throughput`` and ``analyze_logs``.  The runner runs
   unchanged; around its steps the phase reads the card's compute processes
   (``nvidia-smi --query-compute-apps``) before each run and at every
   scrape, each node's last ``/metrics``, and the service's launch counts
   (through ``FLEET_HOOK``, a ``sitecustomize`` the phase puts on the
   children's ``PYTHONPATH``: the service snapshots them once it is warm,
   before the first node boots, and writes them when the runner's
   ``cleanup`` stops it with SIGTERM, once every node is killed).  Checks, each run: every node scraped at least
   twice; a benchmark duration and tps above 0 and a finite average
   latency; ``measurements-<i>.json`` written and loading back equal; the
   last health sample reaching every node; no invalid block and no batch
   degraded to the CPU oracle on any node; the service the only compute
   process the run added to the card (so no node opened a CUDA context); the
   service launching the prologue and the keyed kernel once a dispatch, at
   least as often as the nodes' flushes at their last scrape, and the
   generic kernel never.  Prints, each run: the offered load, tps, average
   and stdev latency, the benchmark duration, the nodes' flushes and live
   lanes, the service's launches, and the phase's seconds.
19. Watch and trace the fleet, on step 18's 10,000 tx/s run (``WATCH_10``):
   its ten nodes boot with ``MYSTICETI_TRACE=<working dir>/trace-%p.json``
   and the wire timestamps on (``timestamp_frames`` in the parameters
   file), and once the last is booted the port's fleetmon runs as a child
   for the run's length, as its docstring tells users to watch an
   orchestrator run
   (``python -m mysticeti_tpu_torch.tools.fleetmon --fleet-dir <working
   dir> --no-dashboard --interval 2 --duration 12 --out <working
   dir>/fleetmon.json``); the nodes are killed after it ends.  After the
   phase, the port's tools run as children on what the run left:
   ``trace_report`` over node 0's trace, plain and with
   ``--critical-path``; ``fleet_trace`` over the ten traces with ``--out``;
   ``trace_report`` over step 9's ``build/chip_smoke_trace.json``; and the
   port's lint (``python -m mysticeti_tpu_torch.analysis --no-cache``).
   Checks (``watch_checks``): fleetmon's last snapshot reached all 10
   nodes; a fleetmon snapshot within one scrape interval of the phase's
   last scrape has its quorum participation and a commit skew apart by at
   most the fleet's highest commit round moved between them, plus one;
   fleetmon exits 0 or 3 as its own last status says (3 when degraded);
   one trace a node, each parsing; the stage table holds ``receive``,
   ``verify``, ``dag_add`` and ``commit``; the critical path attributes a
   committed leader; the merge's skew table covers the 10 authorities, the
   traces hold transit samples and a journey is a committed block's; step
   9's trace reports its ``verify_dispatch`` stage; the lint exits 0 with 0
   findings.  Step 18's checks hold for the traced run as for the other.
   Prints fleetmon's exit code and last frame, the merge's largest absolute
   skew and journeys, the traced run's tps and latency beside its untraced
   readings (not a gate), the lint's seconds, and the tools' output.
20. Byzantine (byzantine-10): the resilience matrix's ``byzantine-at-f``
   through the port's ``scenarios.run_scenario(..., real_crypto=True)``:
   config 3's 10 validators (``Committee.new_for_benchmarks(10)``, seed 7,
   0.3 s leader timeout) as a ``ChaosSimHarness`` fleet under the
   deterministic loop for 10 virtual s, node 7 equivocating (a re-signed
   variant of each own block to half its peers), node 8 withholding its
   blocks from all but two peers and node 9 shipping its blocks with a
   flipped signature; then the clean twin (same seed, no adversaries).
   Every node's collector (the scenario's 0.002 s window) dispatches to one
   ``TorchSignatureVerifier`` on cuda:0, made and warmed before the counts
   are set to 0; the counts are read and set to 0 between the twins.
   Checks: safety held and no divergence names an honest node; the honest
   committed sequences are prefixes of one; every honest node commits at
   least half its seeded leaders; the attacks and their ledger digest, every
   honest node's ``invalid_blocks`` census of ``authority=9,reason=
   signature`` and the per-node counts equal ``BYZANTINE_SEEDED``; every
   equivocation is attributed to node 7 alone; node 9 has at most one
   committed block (its genesis) in any honest store; every verdict the
   card gave equals the sim re-sign oracle's on the same (key, digest,
   signature) (computed after the run) and they reject as many; each twin
   launches one prologue and one keyed kernel a collector flush and the
   generic kernel never; the scenario's own verdict passes (ratio at least
   its 0.8, every attack detected, safety) and its document's digest is
   the seeded one.  ``byzantine_only`` also runs the sim re-sign oracle's
   twin here and requires the same document.
21. Bench: ``python -m mysticeti_tpu_torch.bench`` as a child with 2
   workers, 8 iterations, 2 trials and a 30 s budget; its JSON line must
   come from rung 0 with a value above 0, and it appends its record (with
   the card's name and power limit) to the trend index under
   ``build/chip_smoke/``.
22. Tools: the port's kernel and storage tools as users run them, each
   ``python -m mysticeti_tpu_torch.tools.<name>`` in a child, artifacts under
   ``build/chip_smoke/``.  ``kernel_parity --n 12288 --seed 2026``: the RFC
   8032 vectors (0-2 byte messages, hashed on the host, through the generic
   kernel) accepted and their corrupted copies rejected, and 12,288 seeded
   cases in the 7 classes through ``verify_batch`` (prologue + generic) and
   ``verify_batch_table`` (prologue + keyed, the ``corrupt_pk`` lanes on the
   generic straggler patch), every bit equal to the ``cryptography``
   oracle's, zero mismatches in every class on both paths.  ``bench_probe``:
   null round trip, host-to-device MB/s, the keyed chain's time on a resident
   16,384-lane blob and the end-to-end time of a bench batch, every reading
   above 0 and the kernels' below the end-to-end time.  ``mesh_scaling
   --sizes 1 --real``: the one card's point, every lane valid and the summed
   count equal to the batch.  ``storage_probe --quick --verifier cuda-only
   --scenario bounded-disk`` (the snapshot catch-up scenario is left to
   tier-1, see ``STORAGE_PROBE_SCENARIOS``): it passes with every node's
   collector over one ``TorchSignatureVerifier`` on the card, its seeded
   fields equal ``STORAGE_PROBE_SEEDED``'s and it launches the prologue and
   the keyed kernel as often and the generic kernel never.  ``bench_trend
   --repo build/chip_smoke``: exit 0 and a non-empty trajectory, every
   record carrying the card.  Riding earlier phases: ``wal_inspect --json``
   over storage-10's node 0 WAL and its rejoiner's, before the run's
   directory goes (exit 0, segmented, no problem, a valid checkpoint, blocks
   in the census; the rejoiner's checkpoints all at or above the height of
   the snapshot it adopted); ``commit_explain --url`` on node 0 of
   orchestrator-10's
   10,000 tx/s run while it runs, ``--last 10`` then ``--skips`` (exit 0,
   every explanation naming its commit rule).
23. Fleet benches: the port's load and catch-up fleet benches as users run
   them, each ``python -m mysticeti_tpu_torch.tools.<name>`` in a child on a
   free port base, its document under ``build/chip_smoke/``
   (``FLEET_BENCH_RUNS``): maxload-4 (``maxload_bench --verifiers cuda-only
   --nodes 4 --start-load 400 --iterations 1 --duration 8``, with its same-
   window cpu reference probe), chipwindow-4 (``chip_window_ab --card-flavor
   cuda-only``, one 8 s iteration a kind), node-bench-4 (``node_bench
   --verifiers cuda-only``, 200 tx/s for 8 s, then the saturation of 5 x
   4,096 signatures), catchup-7 (``catchup_bench --verifiers cuda-only``, 7
   nodes at 3,200 tx/s, node 6 down 10 s) and overload-4 (``overload_bench
   --verifier cuda-only --base-load OVERLOAD_BASE_LOAD --multipliers 1 3``,
   15 s rungs, then the seeded determinism leg); then ``bench_trend --repo
   build/chip_smoke``.  A ``sitecustomize`` on the tools' ``PYTHONPATH``
   (``FLEET_HOOK``) makes each verifier service the runner starts snapshot
   its launch counts once warm and write them when the runner's ``cleanup``
   stops it (SIGTERM), and makes a node report if it ever initializes CUDA;
   the script samples ``nvidia-smi --query-compute-apps`` every second while
   a tool runs.  Checks, each tool: it exits 0 (``overload_bench`` 3 only
   when its own acceptance reads a collapse) and its document loads; every
   probe, run and rung has tps above 0 and a finite latency (catch-up: a
   steady tps above 0); every fleet's last scrape reached every node and
   counted no batch degraded to the CPU oracle and no invalid block; no node
   initialized CUDA; one verifier service a card fleet, each warm on the
   card, launching the prologue and the keyed kernel once a dispatch and the
   generic kernel never (a cuda-only tool's services at least once a node
   flush); the card never held more contexts than this script's, the tool's
   own (its prewarm) and one a live service.  node-bench-4: the saturation's
   every verdict true, prologue = keyed = its 6 calls, generic 0, in the
   tool's process.  catchup-7: the rebooted node caught up within the tool's
   timeout, verified directly (skipped 0) and the fleet's health snapshot
   after recovery reached every node.  overload-4: the determinism leg byte
   identical and equal to ``OVERLOAD_SEEDED``; every rung's admitted and
   intake-shed transactions equal to what its nodes' load generators
   submitted (``mysticeti_client_submitted_total``), and above 0.
   bench_trend: exit 0 and the MAXLOAD, MAXLOAD_TAX and OVERLOAD records
   scored, each tagged with the card its document names.  Prints the peaks,
   where each search ran out of capacity, the same-window ratios, the
   catch-up's three times and the rebooted node's live lanes a flush, the
   rungs' committed over offered and submitted over nominal offered,
   node_bench's committed tx/s and sig/s, and the step's seconds.
Each path of steps 3-20 (the block path and the committee dispatch of step 3
apart) runs with every launch count set to 0 just before it and read just
after (node-proc-10's in its processes, from each verifier's ``ready``;
byzantine-10's for each twin; orchestrator-10's on its verifier service, from
its warm state; step 22's in each tool's own process, which reports them;
step 23's on each tool's verifier services, from their warm state, and the
saturation's in node_bench's process; step 24's in each tool's process and
on its verifier services); every kernel must have launched on some path.
The whole script skips the ``cpu`` control run of steps 11, 13, 14, 15,
netsync-50 of step 12 and health-sim-10 of step 16: their seeded constants
(``CONSENSUS_SEEDED``, ``NETSYNC_SEEDED``, ``STORAGE_SEEDED``,
``EPOCH_SEEDED``, ``INGRESS_SEEDED``, ``HEALTH_SEEDED``) alone hold the card
there (each ``<phase>_only`` keeps the control and its comparison; the
consensus and netsync-50 counts carry a digest of every node's committed
sequence and own blocks, which the control compared).
24. Last tools: the port's ``mesh_ab``, ``dataplane_ab``,
   ``reconfig_matrix``, ``finality_bench`` and ``execution_bench`` as users
   run them, each ``python -m mysticeti_tpu_torch.tools.<name> --verifier
   cuda-only`` in a child on a port base of its own with ``FLEET_HOOK`` on
   its ``PYTHONPATH``, its document under ``build/chip_smoke/``
   (``LAST_TOOL_RUNS``), one at a time: mesh-4 (the in-process 4-validator
   testbed at 300 tx/s a node, 8 s under ``MYSTICETI_MESH_LEGACY=1``, then 8
   s on the broadcast-once plane), dataplane-4 (two 4-validator
   ``perf_attr`` fleets of 12 s at 800 tx/s of 4,096 B,
   ``MYSTICETI_NO_NATIVE=1`` in the first, the nodes behind a verifier
   service the step starts, named by ``MYSTICETI_VERIFIER_SOCKET``, and the
   native microbench best of three)
   and reconfig-live-4 (the live leg: 4 validators at 20 tx/s, validator 3
   registered at stake 0 and activated by a committed ADD, then booting and
   catching up, validator 2 removed and stopped); then finality-4 (4
   validators at 2,000 tx/s for 10 s behind the runner's verifier service,
   then the seeded ``byzantine-at-f`` twice at 2 virtual s over one warm
   ``TorchSignatureVerifier``) and exec-4 (4 validators with the execution
   plane at 1,000 tx/s and a gateway client a node for 10 s, then the seeded
   ``execution-byzantine-at-f`` twice at 2 virtual s).  Checks
   (``last_tool_checks``), each tool: it exits 0 (3 where only its speed
   acceptances fail: mesh's leaders and encode time, dataplane's 25% hot-path
   cut and 2x microbench, finality's 20% server/client tolerance, all
   recorded) and its document names the card and ``cuda-only``; no node
   initialized CUDA; the launches of its process (mesh's validators from
   their warm verifiers, the live leg's but the joiner's warm-up, the sims'
   from their warm backend) and of its verifier services (from warm) are one
   prologue and one keyed launch a dispatch, some, and the generic kernel
   never; the card never held more contexts than before the tool, the
   tool's own and one a live verifier service.  mesh-4: every node commits
   in both modes; under the legacy knob no encode reuse and no zero-copy
   receiver, on the new plane reuse on every node and receivers attached.
   dataplane-4: every node commits in both arms and exits 0 with no batch
   degraded; ``native_active`` non-empty in the native arm and empty in the
   fallback arm.  reconfig-live-4: the leg passes (every survivor at epoch
   2, the removed node at 1 or more, the joiner committing, prefixes
   agreeing).  finality-4: decisions recorded on every node; every fleet's
   last scrape reached every node with no batch degraded and no invalid
   block; the service launched a keyed kernel at least once a node flush;
   the sim leg explains every slot, is byte-identical and equals
   ``FINALITY_SEEDED``.  exec-4: the same fleet checks; roots agree across
   the nodes' windows and with the client's stream, every node executed,
   the subscriber got its resume reply and notifications; the sim passes,
   executes, is byte-identical and equals ``EXEC_SEEDED``.  Prints each
   tool's readings and its seconds.
   Steps 23 and 24 run as a queue of jobs (each of their tools, longest
   first, ``BESIDE_ORDER``), one at a time in a thread beside steps 11-15
   (consensus to ingress) and 20 (byzantine, which runs right after step
   15), whose results no host load can move: simulated cells held to seeded
   counts, and netsync-tcp-10 far above its minimum commits.  The script
   waits for the queue (and prints how long) before steps 16-19 (the
   real-time fleets, the card's context checks, the fixed ports) and 21-22.
   Their speed readings are recorded, not compared.
25. Prints a ``{"kernels": [...]}`` line, the end-to-end readings, and as its
   last line ``{"ok": true, "device": {...}}``.

Every phase runs under ``PYTHONHASHSEED=0`` (``main`` runs the command
again under it when it is not set so): a simulated run's fetches follow
the order of a set of block references, so the seeded counts hold only
under one hash salt.

Exits non-zero, printing no result, when there is no CUDA device or when any
phase fails.

One phase alone: ``python3 -c 'import chip_smoke as c; raise
SystemExit(c.main(c.receive_only))'`` (likewise ``consensus_only``,
``net_sync_only``, ``storage_only``, ``epoch_only``, ``ingress_only``,
``health_only``, ``node_only``, ``orchestrator_only``, ``byzantine_only``,
``tools_only`` (step 22's standalone tools, after the bench),
``fleet_benches_only`` (step 23's runs, then each fleet bench at its own
defaults, ``FLEET_BENCH_DEFAULTS``), ``last_tools_only`` (step 24's runs,
then each of the last tools at its own defaults, ``LAST_TOOL_DEFAULTS``),
and
``sharded_only`` for a
host with several cards).  Not
in the default run: ``receive_split`` (where the receive burst's host time
goes) and ``consensus_trace`` (the card's busy share in step 11, from a
``torch.profiler`` trace).

``python3 chip_smoke.py --times NAMES [CHECKOUT]`` runs only the readings of
step 2 that NAMES lists (``all``, or some of prologue, verify_generic,
verify_keyed, verify_keyed_lanes, flush), optionally on the port of
CHECKOUT, a directory inside this checkout (see ``kernel_times``).
"""
from __future__ import annotations

import asyncio
import json
import os
import random
import statistics
import subprocess
import sys
import threading
import time

SEED = 2026
BUCKET = 16384
COMMITTEE = 50  # BASELINE.json config 4: a 50-validator run
ROUNDS = 20
TX_PER_BLOCK = 4  # 512-byte transactions (the config's size), fewer per block
TX_BYTES = 512
DISTINCT_SIGNATURES = 2000  # signing is ~3 ms each in pure Python
ORACLE_SAMPLE = 300
STRAGGLERS = 8
# Signatures in a keyed chunk: the per-key padding to whole 32-lane tiles
# must fit the bucket (50 keys x 10 tiles = 500 of its 512 tiles), so a
# committee burst of 15,000 signatures fills the 16,384-lane bucket.
KEYED_LANES = 15000
CLASSES = ("valid", "corrupt_R", "corrupt_s", "corrupt_msg", "wrong_key",
           "noncanonical_s", "corrupt_pk")
L = (1 << 252) + 27742317777372353535851937790883648493
P = (1 << 255) - 19

# Least-time bounds (H100 SXM at its published 1.98 GHz boost clock):
# 32-bit integer multiply-add and add/logic run at 64 per SM per clock on
# compute capability 9.0 (half the float32 FMA rate behind the 67 TFLOP/s
# peak), over 132 SMs; device memory moves 3.35 TB/s.
INT_OPS_PER_S = 132 * 64 * 1.98e9
BYTES_PER_S = 3.35e12
# A 255-bit field multiply needs at least 8 x 8 32-bit limb products, a
# squaring 8 squares and 28 cross products (each doubled by a shift).
INT_MULS_PER_FIELD_MUL = 64
INT_MULS_PER_FIELD_SQ = 36
# One SHA-512 compression in 32-bit integer instructions with funnel shifts
# and three-input logic: 80 rounds x 36 + 64 schedule steps x 22.
SHA512_INT_OPS = 80 * 36 + 64 * 22
# A reduction of the 512-bit digest mod L (2^252 < L < 2^253) needs at least
# the folds by 2^252 = -c (mod L), c < 2^125 (four 32-bit words): the top 260
# bits times c (9 x 4 32-bit products), the top 133 bits of what is left
# times c (5 x 4), then the last 7 bits (1 x 4).  Charged whichever design
# the kernel runs.
MOD_L_INT_OPS = 9 * 4 + 5 * 4 + 1 * 4
PROLOGUE_INT_OPS = SHA512_INT_OPS + MOD_L_INT_OPS
# The collector's flush (block_validator.BatchedSignatureVerifier).
FLUSH = 256
# Cycles the card spins before a timed run, so the host has enqueued the run
# before the start event executes: a time is then the device's alone, with
# no host gap inside it (about 2 ms at the card's clock).
BUSY_CYCLES = 4_000_000
# What `--times` measures.
TIMED = ("prologue", "verify_generic", "verify_keyed", "verify_keyed_lanes", "flush")
# The receive phase: config 4's blocks at full width (4,000 transactions of
# 512 B, the JAX package's TRANSACTION_SIZE_DEFAULT), depth cut to 5 rounds =
# 250 blocks, one collector flush (max_batch 256); sent as Blocks frames over
# loopback between two TcpNetwork endpoints.
RECEIVE_ROUNDS = 5
RECEIVE_TX = 4000
# The forged block that fewer than a quorum of authorities' valid blocks
# include (round, author); it must be rejected, not aggregated.
BYZANTINE = (2, 20)
RECEIVE_PAIRS = 3  # cuda-only / cuda-only-agg runs in turns
RECEIVE_KINDS = ("cuda-only", "cuda-only-agg", "cuda-agg")
# The native functions the receive path calls; the phase fails without them.
RECEIVE_NATIVE = ("decode_block", "block_digests", "parse_blocks_spans", "split_frames")
# The bench child: a short run of the benchmark's real shape.
BENCH_ENV = {"BENCH_PROCS": "2", "BENCH_ITERS": "8", "BENCH_TRIALS": "2", "BENCH_MAX_S": "30"}
# The consensus phase: config 4's 50 authorities as syncers under the
# deterministic simulator, each delivery verified by the receiving node's own
# collector before the core takes it; one-way latency of the JAX package's
# simulated network (simulated_network.py: 50-100 ms), the syncer harness's
# 1 s leader timeout and 0.25 s relay pump; depth cut to a virtual duration.
CONSENSUS_VIRTUAL_S = 2.2  # 11 commits a node at SEED
CONSENSUS_LATENCY_S = (0.05, 0.10)
CONSENSUS_LEADER_TIMEOUT_S = 1.0
CONSENSUS_PUMP_S = 0.25
CONSENSUS_FORGE_ONE_IN = 50  # deliveries preceded by a copy with a flipped signature bit
CONSENSUS_MIN_COMMITS = 8
# From ``seeded_counts(consensus_run("cpu", COMMITTEE, CONSENSUS_VIRTUAL_S,
# SEED), CONSENSUS_KEYS)`` under ``PYTHONHASHSEED=0``, as
# ``tests/test_torch_seeded_cells.py`` recomputes it on the CPU: the card
# must commit the same sequences (``chain``) and own blocks.
CONSENSUS_KEYS = ("deliveries", "forged")
CONSENSUS_SEEDED = {
    "rounds": [14] * 50, "commits": [11] * 50, "deliveries": 32631, "forged": 627,
    "chain": "f970a88e10cca045a2bca8d940bdd06476a58c8cd9bbd32def8633ed9e394f92",
}
# The net_sync phase: the node's own network plane (NetworkSyncer) in place
# of the consensus phase's stand-in relay.  netsync-50 runs config 4's 50
# authorities over the port's SimulatedNetwork (its 50-100 ms one way) for
# consensus-50's virtual depth, leader timeout and minimum commits
# (``CONSENSUS_*``), so the two cells compare; netsync-tcp-10 runs config
# 3's shape, 10 validators on one host, over loopback TCP in real time.
NETSYNC_FAULT_ONE_IN = 50  # src->dst batches carrying blocks: forged copy first / re-delivered
NETSYNC_REDELIVER_S = (0.0, 0.1)  # a re-delivery's extra delay: 0, or drawn from this range
NETSYNC_TCP_NODES = 10  # BASELINE.json config 3: 10 validators on one host
NETSYNC_TCP_WALL_S = 10.0
NETSYNC_TCP_MIN_COMMITS = 3
# From ``seeded_counts(netsync_run("cpu", COMMITTEE, CONSENSUS_VIRTUAL_S,
# SEED), NETSYNC_KEYS)`` under ``PYTHONHASHSEED=0``, as
# ``tests/test_torch_seeded_cells.py`` recomputes it on the CPU.
NETSYNC_KEYS = ("received", "fresh", "to_verify", "forged", "forged_injected", "redelivered")
NETSYNC_SEEDED = {
    "rounds": [13] * 50, "commits": [10] * 50, "received": 31057, "fresh": 30759,
    "to_verify": 30438, "forged": 602, "forged_injected": 640, "redelivered": 668,
    "chain": "2b3a38b03c8e978ef41ac72ba1709a4f3bf595945ac05d478dfb6e347b453218",
}
# The storage phase (storage-10): config 3's 10 validators over the
# SimulatedNetwork with the storage lifecycle on
# (``tests/test_storage_lifecycle.py``'s segment, checkpoint and catch-up
# values; its gc_depth 20 becomes 80, so the snapshot window of ~85 rounds
# x 10 blocks spans several 256-lane flushes).  A node's GC runs in its
# cleanup, every 10 virtual s from its start: node 3 is down from 3 s to
# 21 s (~95 rounds, more than the window), past the fleet's pass at 20 s
# that retires its history, and is back for 11 s, long enough for its own
# pass; node 1 crashes at 24 s for 2 s with an 11-byte torn tail and boots
# from a checkpoint.  Crashes are (node, at_s, downtime_s, torn bytes).
STORAGE_10 = {
    "n": 10, "virtual_s": 32.0, "seed": SEED, "fault_one_in": NETSYNC_FAULT_ONE_IN,
    "crashes": ((3, 3.0, 18.0, 0), (1, 24.0, 2.0, 11)), "rejoiner": 3, "rebooter": 1,
    "storage": {"segment_bytes": 16 * 1024, "checkpoint_interval": 5, "gc_depth": 80,
                "snapshot_catchup": True, "catchup_threshold_commits": 50},
    "commits_after_rejoin": 50,
}
# What storage-10 counts at SEED under HASH_SEED (``storage_counts`` of a
# ``cpu``-kind run; the card run must count the same).
STORAGE_SEEDED = {
    "commits": [218, 218, 218, 126, 218, 218, 218, 218, 218, 218],
    "flushes": 16419,
    "dispatched": 20035,
    "catchup_flushes": 8,
    "catchup_lanes": 856,
    "received": 21483,
    "fresh": 20228,
    "to_verify": 20035,
    "forged": 360,
    "forged_rejected": 360,
    "forged_injected": 363,
    "redelivered": 403,
    "snapshot_chunks": 86,
    "snapshot_blocks": 855,
    "on_card": 20035,
    "commit_height": [218, 218, 218, 218, 218, 218, 218, 218, 218, 218],
    "retired_round": [125, 32, 126, 137, 125, 125, 126, 125, 125, 125],
    "wal_written": [3859593, 3810112, 3861556, 3752876, 3866448, 3861943, 3858511, 3860106,
                    3859179, 3860686],
    "replayed_bytes": [0, 38963, 0, 3615, 0, 0, 0, 0, 0, 0],
}
# The epoch phase (epoch-10): storage-10's fleet of config 3's 10 validators,
# each booted by ``open_store`` from its own segmented WAL (16 KiB segments, a
# checkpoint every 5 commits, no GC in the run), with the reconfiguration
# and execution planes on and ``tests/test_reconfig.py``'s churn shape: a
# REWEIGHT of node 1 to stake 3 through node 0 at 2 s, a REMOVE of node 4
# through node 0 at 5 s, node 4 stopped for good at 7 s; every 0.5 s each
# live node plants one execution batch (``scenarios``' execution workload); node
# 2 is down from 8 s to 9.5 s and boots from its checkpoint after both
# boundaries.  Changes are (at_s, via, kind, authority, stake), retirements
# (at_s, node).  The finalization oracle reads the rounds up to
# ``oracle_rounds``, past both boundaries (the last at round 46) and below
# every last committed leader, of three nodes' stores (``oracle_nodes``):
# node 0, through which both changes go, the rebooter and the retiree.  Its
# work grows with blocks times transactions (its seconds grow ~4x from 20
# rounds to 40 and ~17x to 80): on an 8-core CPU host 40.2 s for all ten
# stores at 50 rounds, 10.6 s for these three at 48.
EPOCH_10 = {
    "n": 10, "virtual_s": 12.0, "seed": SEED, "fault_one_in": NETSYNC_FAULT_ONE_IN,
    "storage": {"segment_bytes": 16 * 1024, "checkpoint_interval": 5},
    "changes": ((2.0, 0, "reweight", 1, 3), (5.0, 0, "remove", 4, 0)),
    "retire": ((7.0, 4),), "crashes": ((2, 8.0, 1.5, 0),), "exec_interval_s": 0.5,
    "epochs": 2, "retiree": 4, "rebooter": 2, "oracle_rounds": 48,
}
# What epoch-10 counts at SEED under HASH_SEED (``epoch_counts`` of a
# ``cpu``-kind run; the card run must count the same).
EPOCH_SEEDED = {
    "commits": [124, 124, 124, 124, 66, 124, 125, 124, 124, 124],
    "epochs": [2, 2, 2, 2, 2, 2, 2, 2, 2, 2],
    "boundaries": [[[1, 13], [2, 45]]] * 10,
    "flushes": 8810,
    "dispatched": 10381,
    "received": 10653,
    "fresh": 10481,
    "to_verify": 10383,
    "forged": 184,
    "forged_rejected": 184,
    "forged_injected": 185,
    "redelivered": 202,
    "on_card": 10381,
    "planted": 218,
    "exec_heights": [124, 124, 124, 124, 66, 124, 125, 124, 124, 124],
    # The root at height 124, and node 4's at 66 and node 6's at 125.
    "roots": ["66954b27a53c5013631d0038d513c5e11c8fda97201d35ee8350066ddacc0a4d"] * 4
             + ["401d65671bddf096d8a86f3946b4c6c31db170d9cab94e85ecf48127b0ad3216",
                "66954b27a53c5013631d0038d513c5e11c8fda97201d35ee8350066ddacc0a4d",
                "4bd0b02109df08a634c4b18edef9611a0cfd3099721e1b0a1a90e76b118658a2"]
             + ["66954b27a53c5013631d0038d513c5e11c8fda97201d35ee8350066ddacc0a4d"] * 3,
    "planted_held": [217, 217, 217, 217, 130, 217, 217, 217, 217, 217],
    "notes": [2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 0],
}
# The ingress phase (ingress-10): config 3's 10 validators over the
# SimulatedNetwork (50-100 ms one way), with netsync-50's fault injector,
# each with its ingress plane and one closed-loop load client of the JAX
# package's overload shape (``tests/test_ingress.py``: 1x, then 3x) at the
# upstream default transaction size (512 B): the parameters are the port's
# ``OverloadScenario(**INGRESS_10["scenario"]).ingress_parameters()``.  At
# ~10 rounds a virtual second, 1x offers ~100 transactions a block, below
# the ~2,000 tx/s a node that ``max_per_proposal`` lets through; 3x is
# above it, so the mempool fills and admission must shed.  Cut: blocks carry
# at most 200 transactions (config 3: 2,000), 12 virtual s (at 10 the 3x
# step still enters shed mode but sheds nothing, and the retry path idles).
INGRESS_10 = {
    "n": 10, "virtual_s": 12.0, "seed": SEED, "fault_one_in": NETSYNC_FAULT_ONE_IN,
    "crashes": (),
    "scenario": {"nodes": 10, "duration_s": 12.0, "base_tps": 1000,
                 "multiplier_schedule": ((0.0, 1.0), (5.0, 3.0)), "closed_loop": True,
                 "transaction_size": 512, "max_per_proposal": 200,
                 "mempool_max_transactions": 4000, "leader_timeout_s": 1.0,
                 "clients_per_node": 1},
}
# What ingress-10 counts at SEED under HASH_SEED (``ingress_counts`` of a
# ``cpu``-kind run; the card run must count the same).
INGRESS_SEEDED = {
    "commits": [125] * 10,
    "flushes": 9817, "dispatched": 11667, "received": 11896, "fresh": 11778,
    "to_verify": 11668, "forged": 208, "forged_rejected": 208,
    "forged_injected": 208, "redelivered": 229, "on_card": 11667,
    "server_finality": {"p50_s": 1.437494, "p99_s": 1.888546, "samples": 5120, "completed": 12566},
    "client_finality": {"p50_s": 1.437494, "p99_s": 1.888546, "samples": 5120, "completed": 12566},
    "shed_by_reason": {"mempool_transactions": 1400},
    "committed_tx": [203800] * 10,
    "offered": [24600] * 10,
    "admitted": [24300, 24400, 24400, 24500, 24500, 24500, 24500, 24500, 24500, 24500],
    "digest": [
        "3f98e036e29b4ab7974f866b479c952ae8245c2921ff5e142109f8b5b16ee932",
        "0016aae0194e05ffc293964001a4f3356ed3f298e9d260ba706155320b0145e0",
        "0016aae0194e05ffc293964001a4f3356ed3f298e9d260ba706155320b0145e0",
        "0be804a72c76123ca05109e988366bdd6ca9a601a62cabdfbe257219a7e1c8b8",
        "0be804a72c76123ca05109e988366bdd6ca9a601a62cabdfbe257219a7e1c8b8",
        "fc1029d758d739cb07d766e64cfd959dee93713a6d23ee83b9a73345385d5c68",
        "fc1029d758d739cb07d766e64cfd959dee93713a6d23ee83b9a73345385d5c68",
        "fc1029d758d739cb07d766e64cfd959dee93713a6d23ee83b9a73345385d5c68",
        "1a3cd516628d1f05b9f12ab5aa666dba46c0b6f6bd4445acf28138c4b8caee46",
        "4d05b9241be8f73b53d9e48c9dd759eb56437d120218a60c7ff2257009087690",
    ],
    "wal_bytes": [121586607, 121848810, 121847908, 121903845, 121901765, 122057509,
                  121746234, 121844944, 121691423, 121744122],
    "generators": [
        {"submitted": 24600, "accepted": 24300, "shed_observed": 300, "retries": 300,
         "client_drops": 0, "retry_queue": 0, "client_finality_p50_s": 1.44025,
         "client_finality_p99_s": 1.867981, "client_finality_samples": 512},
        {"submitted": 24600, "accepted": 24400, "shed_observed": 200, "retries": 200,
         "client_drops": 0, "retry_queue": 0, "client_finality_p50_s": 1.389004,
         "client_finality_p99_s": 1.837709, "client_finality_samples": 512},
        {"submitted": 24600, "accepted": 24400, "shed_observed": 200, "retries": 200,
         "client_drops": 0, "retry_queue": 0, "client_finality_p50_s": 1.395376,
         "client_finality_p99_s": 1.837356, "client_finality_samples": 512},
        {"submitted": 24600, "accepted": 24500, "shed_observed": 100, "retries": 100,
         "client_drops": 0, "retry_queue": 0, "client_finality_p50_s": 1.437494,
         "client_finality_p99_s": 1.925933, "client_finality_samples": 512},
        {"submitted": 24600, "accepted": 24500, "shed_observed": 100, "retries": 100,
         "client_drops": 0, "retry_queue": 0, "client_finality_p50_s": 1.444978,
         "client_finality_p99_s": 1.872811, "client_finality_samples": 512},
        {"submitted": 24600, "accepted": 24500, "shed_observed": 100, "retries": 100,
         "client_drops": 0, "retry_queue": 0, "client_finality_p50_s": 1.468663,
         "client_finality_p99_s": 1.942101, "client_finality_samples": 512},
        {"submitted": 24600, "accepted": 24500, "shed_observed": 100, "retries": 100,
         "client_drops": 0, "retry_queue": 0, "client_finality_p50_s": 1.447806,
         "client_finality_p99_s": 1.789268, "client_finality_samples": 512},
        {"submitted": 24600, "accepted": 24500, "shed_observed": 100, "retries": 100,
         "client_drops": 0, "retry_queue": 0, "client_finality_p50_s": 1.406228,
         "client_finality_p99_s": 1.843702, "client_finality_samples": 512},
        {"submitted": 24600, "accepted": 24500, "shed_observed": 100, "retries": 100,
         "client_drops": 0, "retry_queue": 0, "client_finality_p50_s": 1.510483,
         "client_finality_p99_s": 1.92975, "client_finality_samples": 512},
        {"submitted": 24600, "accepted": 24500, "shed_observed": 100, "retries": 100,
         "client_drops": 0, "retry_queue": 0, "client_finality_p50_s": 1.426282,
         "client_finality_p99_s": 1.851647, "client_finality_samples": 512},
    ],
}
# The health phase.  health-tcp-10: config 3's 10 validators with their
# ingress planes over loopback TCP (netsync-tcp-10's start, window, forged
# copies and minimum commits), one closed-loop client a node at ingress-10's
# 1x (1,000 tx/s of 512 B, no overload step), the observability plane on
# every node with the JAX package's ``Validator`` SLOs (``slo``), probes
# sampling every second, a 50 ms blocking-call threshold.
HEALTH_TCP_10 = {
    "n": NETSYNC_TCP_NODES, "wall_s": NETSYNC_TCP_WALL_S, "seed": SEED,
    "fault_one_in": NETSYNC_FAULT_ONE_IN, "min_commits": NETSYNC_TCP_MIN_COMMITS,
    "probe_s": 1.0, "blocking_ms": 50.0,
    "scenario": dict(INGRESS_10["scenario"], duration_s=NETSYNC_TCP_WALL_S,
                     multiplier_schedule=((0.0, 1.0),)),
    "slo": {"max_round_stall_s": 30.0, "max_authority_lag_rounds": 100,
            "max_breaker_open_fraction": 0.5, "max_loop_lag_s": 0.25,
            "max_blocking_call_ms": 50.0, "max_finality_p99_s": 5.0},
}
# health-sim-10: storage-10's node shape (no GC) over the SimulatedNetwork
# with netsync-50's injector, node 3 crashed at 3 virtual s and rebooted from
# its WAL 5 s later, 10 virtual s (12 until the last tools' step came, ~8 s
# of the card run), a fleet monitor tick a virtual second.
# The authority-lag SLO (``lag_rounds``) was chosen from a ``cpu``-kind run:
# the fleet reaches round 81 in 11 virtual s (23 at the crash), no live peer
# is ever seen more than 2 rounds behind, and the crashed node is 6 behind
# at the first tick after its crash, so 5 names it there and no live one.
# Crashes are (node, at_s, downtime_s, torn bytes).
HEALTH_SIM_10 = {
    "n": 10, "virtual_s": 10.0, "seed": SEED, "fault_one_in": NETSYNC_FAULT_ONE_IN,
    "storage": {"segment_bytes": 16 * 1024, "checkpoint_interval": 5},
    "crashes": ((3, 3.0, 5.0, 0),), "down": 3, "tick_s": 1.0, "lag_rounds": 5,
}
# The verifier block's keys stripped from health-sim-10's timeline before it
# is compared: the backend's label differs by kind, and the pipeline depth
# comes from the collector's EMA, which the simulator leaves unseeded.
HEALTH_STRIPPED = ("backend", "pipeline_depth")
# What health-sim-10 counts at SEED under HASH_SEED (``health_sim_counts`` of
# a ``cpu``-kind run; the card run must count the same).
HEALTH_SEEDED = {
    "timeline_sha256": "51c203ce611725c3b499ad873b83d63c15f9d54bd130fedc34077273efa98905",
    "alerts_sha256": "3a3b394781ec5115d7828111f16d1eaa0fc6139cdf1aafd37c5e1e01b91292ca",
    "ticks": 9,
    "alerts": 9,
    "commits": [63, 64, 63, 64, 64, 63, 63, 64, 63, 63],
    "flushes": 5034,
    "dispatched": 6054,
    "received": 6250,
    "fresh": 6109,
    "to_verify": 6056,
    "forged": 101,
    "forged_rejected": 101,
    "forged_injected": 102,
    "redelivered": 121,
    "on_card": 6054,
    "dumps": [1, 1, 1, 0, 1, 1, 1, 1, 1, 1],
}
# The node phase: BASELINE.json config 3's committee (10 validators,
# ``Parameters.new_for_benchmarks``) as ten OS processes, each started by the
# port's CLI (``run``, from the files ``benchmark-genesis`` writes, on its
# ports 1500+i and metrics 2500+i, or on a free base that the phase prints
# when another run holds those) through ``perf_attr.run_fleet`` with the
# environment that sets (``MYSTICETI_PROFILE``, ``MYSTICETI_PERF_REPORT``,
# ``MYSTICETI_EXIT_AFTER``, ``TPS``): 1,000 transactions of 512 B a second a
# node (the upstream size; ingress-10's 1x), a timed clean exit after
# ``exit_after_s`` (12 s; 20 before the orchestrator phase came), a
# flight-recorder dump a node at shutdown.  Three fleets
# in turn: node-proc-10 (``cuda-only``, each node its own CUDA context on
# cuda:0), node-svc-10 (``cuda-only`` through one verifier service on cuda:0
# that this script hosts) and the ``cpu`` kind as the control.
# ``min_commits`` is half the fewest leaders a node committed in any of the
# three fleets on an H100 80GB HBM3 at 700 W at this depth: 43 at 12 s
# (node-proc-10; the fleets committed 43-78 a node); it was 58 at 20 s (116,
# node-proc-10, of 116-309).  A fleet that stalls early fails.
NODE_10 = {"n": 10, "tps": 1000, "transaction_size": 512, "exit_after_s": 12.0,
           "grace_s": 60.0, "min_commits": 21, "scrape_s": 2.0, "port_base": 1500}
# The orchestrator phase (orchestrator-10): BASELINE.json config 3, the
# "10-validator orchestrator run", as the reference's orchestrator runs it:
# the port's ``Orchestrator`` over its ``LocalProcessRunner`` on
# ``cuda-only`` (so one verifier service on cuda:0 that the runner starts,
# its nodes behind it) and a ``ParametersGenerator`` of two fixed loads,
# 10,000 and 30,000 transactions of 512 B a second over the fleet (1,000 and
# 3,000 a node), 12 s a run, a scrape of every node every 4 s.  Cut: depth
# (12 s a run against the CLI's 60 s default and the reference's 180 s).
ORCHESTRATOR_10 = {"n": 10, "loads": (10000, 30000), "duration_s": 12.0, "scrape_s": 4.0,
                   "transaction_size": 512, "verifier": "cuda-only", "port_base": 1500,
                   "min_scrapes": 2}
# The whole script runs orchestrator-10's 10,000 tx/s run alone (traced, step
# 19), to make room for step 23, whose overload-4 3x rung offers 103,635 tx/s
# to a card fleet; ``orchestrator_only`` keeps both loads.
ORCHESTRATOR_SCRIPT_LOADS = (10000,)
# Step 19 (watch and trace the fleet) rides on orchestrator-10's 10,000 tx/s
# run: its nodes trace to ``<working dir>/trace-%p.json``, and the port's
# ``fleetmon`` watches the run as its docstring tells users to watch an
# orchestrator run, every ``interval_s`` for the run's length.
# ``untraced`` is that run's readings without tracing (tps, average latency
# in s), in the script's full runs before this step came (H100 80GB HBM3 at
# 700 W, PERF.md section 6): printed beside the traced readings, not a gate.
WATCH_10 = {"load": 10000, "interval_s": 2.0,
            "untraced": {"tps": (12637.5, 13528.6), "avg_latency_s": (0.638, 0.926)}}
# A run's committed sequences hang on the process's ``bytes`` hash salt (the
# block fetcher requests missing blocks in a set's order), so ``main`` runs
# every phase under this one ``PYTHONHASHSEED``.
# The byzantine phase (byzantine-10): the resilience matrix's
# ``byzantine-at-f`` (``scenarios.default_matrix()``): BASELINE.json config
# 3's committee size, ``Committee.new_for_benchmarks(10)`` with f = 3
# adversaries (node 7 equivocates, node 8 withholds, node 9 signs invalidly),
# seed 7, a 0.3 s leader timeout and the harness's ``TestBlockHandler``
# payload, run as ``scenarios.run_scenario(..., real_crypto=True)``: the
# attacked run and its clean twin, every node's collector (0.002 s window)
# over one ``TorchSignatureVerifier`` on cuda:0.  Depth cut from the
# scenario's 20 virtual s to 10: at 8 the scenario's own verdict fails its
# 0.8 throughput ratio (0.7756; 0.8288 at 10).
BYZANTINE_10 = {"scenario": "byzantine-at-f", "virtual_s": 10.0, "adversaries": (7, 8, 9),
                "equivocator": 7, "invalid_signer": 9}
# From ``byzantine_counts(byzantine_run(scenarios, BYZANTINE_10))`` (the
# port's sim re-sign oracle, whose verdicts the card's must equal, so every
# count below is the card run's too) under ``PYTHONHASHSEED=0``;
# ``tests/test_torch_byzantine.py`` holds it equal to the JAX package's run.
# Recompute it when anything on the path changes.
BYZANTINE_SEEDED = {
    "commits": [67] * 10, "clean_commits": [112, 111, 111, 112, 112, 112, 112, 112, 112, 112],
    "flushes": [8679, 9622], "lanes": [9320, 10259], "rejected": [864, 0],
    "attack_counts": {"equivocate-mint:7": 81, "equivocate:7": 475, "invalid_sig:9": 873,
                      "withhold:8": 680},
    "attack_digest": "07b8af3fce43448e88748db85d3aef736f546d6f97f267be17f9272b49c2fdba",
    "invalid_signature": [96] * 9 + [0],
    "equivocation": [{"authority=7": n} for n in (81, 80, 81, 81, 81, 80, 80, 78, 80, 81)],
    "node9_blocks": [1] * 10,
    "document": "8872bd90488fa125b89d18d1c677193cec0a9ff3ab429e29d2539033d28c5fcf",
}
# The tools step (step 22): the port's kernel and storage tools as a user
# runs them, each ``python -m mysticeti_tpu_torch.tools.<name>`` in a child,
# their artifacts and the bench's trend record under ``TOOLS_DIR``.
# ``KERNEL_PARITY_N`` is the JAX tool's default (12,288 randomized cases, 7
# classes, every bit against the oracle on both dispatch paths);
# ``mesh_scaling`` runs its one-card point at its default batch.
KERNEL_PARITY_N = 12288
# ``storage_probe``'s scenarios on the card (each a ``--scenario``): the
# bounded-disk one alone.  With both the step took 134.3 s on an H100 80GB
# HBM3 at 700 W, the snapshot catch-up 73.75 s of it (9,628 flushes), over
# the step's 90 s; storage-10 drives a snapshot catch-up on the card
# already.
STORAGE_PROBE_SCENARIOS = ("bounded-disk",)
# What ``tools.storage_probe --quick`` reproduces of those scenarios at
# their seeds under HASH_SEED (``storage_probe.deterministic`` of a
# ``--verifier cpu`` run, whose collectors give the oracle's verdicts with
# the same 2 ms window as the card's ``cuda-only``; the JAX tool's own run,
# ``--verifier sim-oracle``, verifies nothing and so commits at another
# pace).  ``tests/test_torch_storage_probe_seeded.py`` recomputes it.
# Recompute it when anything on the path changes.
STORAGE_PROBE_SEEDED = {
    "bounded_disk": {
        "nodes": {
            "0": {"commit_height": 220, "first_live_offset": 336710,
                  "last_checkpoint_height": 220.0, "lifetime_wal_bytes": 1003529,
                  "live_segments": 42, "live_wal_bytes": 666819, "reclaimed_bytes": 336710.0,
                  "retired_round": 80},
            "1": {"commit_height": 220, "first_live_offset": 336778,
                  "last_checkpoint_height": 220.0, "lifetime_wal_bytes": 1001209,
                  "live_segments": 42, "live_wal_bytes": 664431, "reclaimed_bytes": 336778.0,
                  "retired_round": 80},
            "2": {"commit_height": 220, "first_live_offset": 335712,
                  "last_checkpoint_height": 218.0, "lifetime_wal_bytes": 951032,
                  "live_segments": 39, "live_wal_bytes": 615320, "reclaimed_bytes": 335712.0,
                  "retired_round": 80},
            "3": {"commit_height": 220, "first_live_offset": 335179,
                  "last_checkpoint_height": 220.0, "lifetime_wal_bytes": 1002804,
                  "live_segments": 42, "live_wal_bytes": 667625, "reclaimed_bytes": 335179.0,
                  "retired_round": 80},
        },
        "pass": True,
        "restart": {"lifetime_wal_bytes": 951032, "node": 2, "recovered_checkpoint_height": 130,
                    "replay_fraction": 0.0246, "replay_start": 579593, "replayed_bytes": 23360},
        "virtual_duration_s": 20.0,
    },
}
# The fleet benches step (step 23): the port's load and catch-up fleet
# benches as users run them, each ``python -m mysticeti_tpu_torch.tools.<name>``
# in a child on ``FLEET_NODES`` validators (catch-up: 7, the JAX tool's
# default), their documents under ``TOOLS_DIR`` as ``bench_trend`` reads
# them.  Every cut is a depth cut of the tool's own shape: maxload-4 one
# search iteration of 8 s (the tool's 7 of 30 s), its cpu reference probe
# kept; chipwindow-4 one iteration a kind of 8 s (5 of 20 s); node-bench-4 the
# card fleet alone for 8 s (40 s; the cpu fleet is left to
# ``fleet_benches_only`` and tier-1), then the saturation at its 4,096-lane
# batch; catchup-7 one kind, node 6 down 10 s (45 s); overload-4 no
# calibration rung, the 1x and 3x rungs of 15 s (four of 30 s) at
# ``OVERLOAD_BASE_LOAD``, then the seeded determinism leg.  A fleet's first
# commit comes ~4.5 s after its nodes boot (they dial each other with
# backoff), and its tps counts whole seconds from there: 6 s windows read 0.
# At overload-4's loads the first transactions commit ~5.5-6.5 s after they
# are submitted, so its 8 s rungs read 0 on the card: they take 15 s.
FLEET_NODES = 4
# The 1x load of overload-4: what the tool's calibration rung (120,000 tx/s
# offered, 30 s) committed on the ``cuda-only`` kind in ``fleet_benches_only``
# on an H100 80GB HBM3 at 700 W, 34,545.5 tx/s (PERF.md section 5).
OVERLOAD_BASE_LOAD = 34545
FLEET_BENCH_RUNS = (
    ("maxload-4", "maxload_bench", "MAXLOAD_r19.json",
     ("--verifiers", "cuda-only", "--nodes", "4", "--start-load", "400", "--iterations", "1",
      "--duration", "8")),
    ("chipwindow-4", "chip_window_ab", "MAXLOAD_TAX_r19.json",
     ("--card-flavor", "cuda-only", "--nodes", "4", "--iterations", "1", "--duration", "8")),
    ("node-bench-4", "node_bench", "NODE_BENCH_r19.json",
     ("--verifiers", "cuda-only", "--nodes", "4", "--load", "200", "--duration", "8")),
    ("catchup-7", "catchup_bench", "CATCHUP_r19.json",
     ("--verifiers", "cuda-only", "--nodes", "7", "--load", "3200", "--down", "10")),
    ("overload-4", "overload_bench", "OVERLOAD_r19.json",
     ("--verifier", "cuda-only", "--nodes", "4", "--base-load", str(OVERLOAD_BASE_LOAD),
      "--multipliers", "1", "3", "--duration", "15")),
)
# ``fleet_benches_only`` also runs each tool once at its own defaults (the
# card kinds where the tool defaults to another; catch-up over four kinds):
# the recorded readings of the port's fleet benches, not part of the whole
# script.  The two max-load searches start higher than the tools' 400 tx/s:
# from 400, 7 doublings reach 25,600 and 5 reach 6,400, and every probe of
# both kinds kept up there on the card's host, so neither search bisected.
# From 12,800 (3,200) the third probe doubles past the overload ladder's
# saturation, 34,545 tx/s, and the rest bisect.  ``catchup-repeat`` runs the
# ``cuda-only`` kind twice around a ``cpu`` run in one call, to tell a steady
# state of its own from the weather.
FLEET_BENCH_DEFAULTS = (
    ("maxload", "maxload_bench", "MAXLOAD_r19.json",
     ("--verifiers", "cpu", "cuda-only", "--start-load", "12800")),
    ("chipwindow", "chip_window_ab", "MAXLOAD_TAX_r19.json", ("--start-load", "3200")),
    ("node-bench", "node_bench", "NODE_BENCH_r19.json", ()),
    ("catchup", "catchup_bench", "CATCHUP_r19.json",
     ("--verifiers", "cpu", "cpu-agg", "cuda-only", "cuda-agg", "--down", "45")),
    ("catchup-repeat", "catchup_bench", "CATCHUP_REPEAT_r19.json",
     ("--verifiers", "cuda-only", "cpu", "cuda-only", "--down", "45")),
    ("overload", "overload_bench", "OVERLOAD_r19.json", ()),
)
# ``overload_bench.run_determinism_leg()``'s seeded readings (the same on any
# host: a virtual-time sim), which every run must reproduce;
# ``tests/test_torch_overload_bench.py`` recomputes them and holds them equal
# to the JAX tool's leg.
OVERLOAD_SEEDED = {
    "shed_schedule_digest": "ff0aa3a625b5976c17e81e66fb2b017cd0bd1a70d61a6cb630181a5a162b4e1a",
    "sim_committed_1x": 13680, "sim_committed_3x": 13680, "sim_offered_3x": 44760,
    "sim_admitted_3x": 15683,
    "sim_shed_by_reason_3x": {"admission": 22776, "duplicate": 420, "mempool_transactions": 5881},
}
# The last tools step (step 24): the port's data-plane, mesh, reconfiguration,
# finality and execution probes as users run them, each ``python -m
# mysticeti_tpu_torch.tools.<name>`` in a child on the tools' 4 validators
# and at their loads, their documents under ``TOOLS_DIR``.  Every cut is one of
# windows and repeats: mesh-4 one legacy and one mesh testbed of 8 s at 300
# tx/s a node (the tool's two of each, 60 s); dataplane-4 one fallback and
# one native fleet of 12 s at 800 tx/s of 4,096 B (two of each, 45 s), behind
# one verifier service this script starts; reconfig-live-4 the live leg alone
# (its own 25 s schedule at 20 tx/s; the matrix and the determinism leg are
# left to ``last_tools_only``); finality-4 a fleet of 10 s at 2,000 tx/s (30
# s) and the sim leg at 2 virtual s (4); exec-4 a fleet of 10 s at 1,000 tx/s
# with the gateway workload (30 s) and the sim leg at 2 virtual s (5).  Their
# speed readings are recorded, not compared.
LAST_TOOL_RUNS = (
    ("mesh-4", "mesh_ab", "MESH_r20.json",
     ("--verifier", "cuda-only", "--committee", "4", "--tps", "300", "--duration", "8",
      "--repeats", "1")),
    ("dataplane-4", "dataplane_ab", "DATAPLANE_r20.json",
     ("--verifier", "cuda-only", "--committee", "4", "--tps", "800", "--tx-size", "4096",
      "--duration", "12", "--repeats", "1", "--round", "20")),
    ("reconfig-live-4", "reconfig_matrix", "RECONFIG_r20.json",
     ("--no-matrix", "--no-determinism", "--verifier", "cuda-only", "--tps", "20")),
    ("finality-4", "finality_bench", "FINALITY_r20.json",
     ("--verifier", "cuda-only", "--nodes", "4", "--load", "2000", "--duration", "10",
      "--sim-duration", "2")),
    ("exec-4", "execution_bench", "EXEC_r20.json",
     ("--verifier", "cuda-only", "--nodes", "4", "--load", "1000", "--duration", "10",
      "--sim-duration", "2")),
)
# The whole script's queue of steps 23 and 24 (``Beside``), longest first
# (by their seconds in a whole run on an H100 host).
BESIDE_ORDER = ("overload-4", "finality-4", "catchup-7", "exec-4", "maxload-4",
                "chipwindow-4", "dataplane-4", "reconfig-live-4", "node-bench-4", "mesh-4")
# ``last_tools_only`` also runs each tool once at its own defaults on the card
# (reconfig's whole matrix, its determinism leg and its live leg), one at a
# time: the recorded readings of the port's last tools.
LAST_TOOL_DEFAULTS = (
    ("mesh", "mesh_ab", "MESH_r20.json", ()),
    ("dataplane", "dataplane_ab", "DATAPLANE_r20.json", ("--round", "20")),
    ("reconfig", "reconfig_matrix", "RECONFIG_r20.json", ()),
    ("finality", "finality_bench", "FINALITY_r20.json", ()),
    ("exec", "execution_bench", "EXEC_r20.json", ()),
)
# What the finality and execution sim legs read at ``SEEDED_SIM_S`` virtual s
# (step 24's depth; the tools' defaults run 4 and 5) under
# HASH_SEED (the seeded ``byzantine-at-f`` and ``execution-byzantine-at-f``
# twice; the sim re-sign oracle's verdicts, which the card's must equal, so
# the card run reads the same); ``tests/test_torch_finality_bench.py`` and
# ``tests/test_torch_execution_bench.py`` recompute them and hold them equal
# to the JAX tools' legs.  Recompute them when anything on the path changes.
SEEDED_SIM_S = 2.0
FINALITY_SEEDED = {
    "digest": "e01bb48c5d41df17066ef14ebaf0460839a77d4eb413effaeeecc1ec7a94099a",
    "skips_explained": 14,
    "decision_census": {a: {"direct-commit": 13 if a == "1" else 12, "direct-skip": 2}
                        for a in map(str, range(7))},
}
EXEC_SEEDED = {
    "root_chain_digest": "af44d87032751575c86922c4af6f214c99f1ce64fe75c6fd83563290cd4a365f",
    "chain_length": 13,
    "final_root": "5067ad8d9874e29808f083b15516787c8393a73a5d1523ae4f3cbfd29b9ffadb",
    "executed_heights": {a: 13 if a == "1" else 12 for a in map(str, range(7))},
}
HASH_SEED = "0"
HERE = os.path.dirname(os.path.abspath(__file__))
TOOLS_DIR = os.path.join(HERE, "build", "chip_smoke")


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def run_tool(module, *args, timeout=600, env=None):
    """``python -m mysticeti_tpu_torch.<module> ARGS`` in a child from the
    checkout, as a user runs it: ((exit code, stdout, stderr), seconds)."""
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", f"mysticeti_tpu_torch.{module}", *args],
                          cwd=HERE, capture_output=True, text=True, timeout=timeout, env=env)
    return (proc.returncode, proc.stdout, proc.stderr), time.monotonic() - t0


def control_text(cpu) -> str:
    """What a phase's card run was held to besides its seeded constant."""
    return "the cpu run's and " if cpu is not None else ""


def control_seconds(cpu) -> str:
    return f"{cpu['wall_s']:.1f} s on the cpu kind" if cpu is not None else "no cpu run"


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable: {exc!r}"


def sign_cases(signers, n_lanes: int, rng: random.Random, classes=CLASSES, stragglers=None):
    """``n_lanes`` (pk, msg, sig, label) lanes from DISTINCT_SIGNATURES
    signed digests, repeated and corrupted class by class.  With
    ``stragglers`` set, exactly the first that many lanes carry an unknown
    key and the rest of the corrupt-pk class stays valid."""
    pks = [s.public_key.bytes for s in signers]
    base = []
    for i in range(DISTINCT_SIGNATURES):
        k = i % len(signers)
        msg = rng.randbytes(32)
        base.append((k, msg, signers[k].sign(msg)))
    lanes = []
    for j in range(n_lanes):
        k, msg, sig = base[j % len(base)]
        pk = pks[k]
        cls = classes[(j // len(base) + j) % len(classes)]
        if stragglers is not None:
            cls = "corrupt_pk" if j < stragglers else ("valid" if cls == "corrupt_pk" else cls)
        if cls == "corrupt_R":
            pos = rng.randrange(32)
            sig = sig[:pos] + bytes([sig[pos] ^ (1 << rng.randrange(8))]) + sig[pos + 1:]
        elif cls == "corrupt_s":
            pos = 32 + rng.randrange(32)
            sig = sig[:pos] + bytes([sig[pos] ^ (1 << rng.randrange(8))]) + sig[pos + 1:]
        elif cls == "corrupt_msg":
            pos = rng.randrange(32)
            msg = msg[:pos] + bytes([msg[pos] ^ 1]) + msg[pos + 1:]
        elif cls == "wrong_key":
            pk = pks[(k + 1) % len(pks)]
        elif cls == "noncanonical_s":
            sig = sig[:32] + (int.from_bytes(sig[32:], "little") + L).to_bytes(32, "little")
        elif cls == "corrupt_pk":
            pos = rng.randrange(32)
            pk = pk[:pos] + bytes([pk[pos] ^ 1]) + pk[pos + 1:]
        lanes.append((pk, msg, sig, cls))
    return lanes


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events, each
    run enqueued behind BUSY_CYCLES of spinning (a run that waits for the
    host, as an upload does, still counts the host's time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(BUSY_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    import torch

    check(len(got) == len(want), "output counts differ")
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype, f"shape/dtype {g.shape} {w.shape}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, moved: int):
    t_ops, t_bytes = ops / INT_OPS_PER_S * 1e3, moved / BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def int_products(lane_ops) -> int:
    """32-bit limb products of the (B, 2) field squarings and multiplies
    ``lane_ops`` (ed25519_cuda.generic_lane_ops / keyed_lane_ops)."""
    sq, mul = (int(x) for x in lane_ops.sum(axis=0))
    return sq * INT_MULS_PER_FIELD_SQ + mul * INT_MULS_PER_FIELD_MUL


def plain_generic_muls_per_lane() -> int:
    """Field multiplies (squarings among them) of one lane of the generic
    verify's plain version, counted on the CPU: a yardstick that stays the
    same whatever the kernel's design."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import field as F

    count = [0]
    mul = F.mul

    def counting(a, b):
        count[0] += 1
        return mul(a, b)

    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    ok = torch.ones(1, dtype=torch.bool)
    F.mul = counting
    try:
        E.verify_impl(z(1, 20), z(1), z(1, 20), z(1), z(1, 64), z(1, 64), ok)
    finally:
        F.mul = mul
    return count[0]


def oracle(pk: bytes, msg: bytes, sig: bytes) -> bool:
    from mysticeti_tpu_torch import crypto

    try:
        return crypto.PublicKey(pk).verify(sig, msg)
    except ValueError:
        return False


def readings(kernel, plain, args_at, reps: int = 10):
    """``kernel`` against ``plain`` on ``args_at`` ({lanes: args} at BUCKET,
    FLUSH and 1 lanes): the largest difference over the three, the kernel's
    time at each and the plain version's at BUCKET."""
    err = 0
    for args in args_at.values():
        got, want = kernel(*args), plain(*args)
        err = max(err, max_abs_err(*([x] if hasattr(x, "shape") else list(x) for x in (got, want))))
    return dict(max_abs_err=err, ms=cuda_ms(lambda: kernel(*args_at[BUCKET]), reps),
                plain_ms=cuda_ms(lambda: plain(*args_at[BUCKET]), 1),
                ms_at_256_lanes=cuda_ms(lambda: kernel(*args_at[FLUSH]), reps),
                ms_at_1_lane=cuda_ms(lambda: kernel(*args_at[1]), reps))


def lane_sizes(args, lane: int, keep=()):
    """{BUCKET: args, FLUSH: their first FLUSH lanes, 1: lane ``lane``};
    the arguments at the positions ``keep`` stay whole."""
    def cut(sl):
        return tuple(a if i in keep else a[sl] for i, a in enumerate(args))
    return {BUCKET: tuple(args), FLUSH: cut(slice(0, FLUSH)), 1: cut(slice(lane, lane + 1))}


def key_combs(table):
    """The key combs the keyed kernel of the imported port reads: the 51-bit
    lines, or the 13-bit combs of a port from before they existed."""
    return table.neg_combs51() if hasattr(table, "neg_combs51") else table.neg_combs()[0]


def prologue_readings(indexed, words):
    """The prologue on the indexed blob ``indexed`` (BUCKET lanes) and its
    first FLUSH lanes and one lane, against its plain version."""
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    return readings(K.prologue, K._prologue_plain, lane_sizes((indexed, words), 0, keep=(1,)),
                    reps=20)


def generic_readings(k_raw, expected):
    """The generic kernel against its plain version on the prologue outputs
    ``k_raw`` (BUCKET lanes), on their first FLUSH lanes and on one live
    lane; its times at those three sizes."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    got = K.verify_generic(*k_raw)
    check(np.array_equal(got.cpu().numpy(), expected), "generic kernel disagrees with the labels")
    # Every lane runs the whole ladder serially, so one lane is the latency floor.
    lane = int(torch.nonzero(k_raw[-1])[0])
    r = readings(K.verify_generic, E.verify_impl, lane_sizes(k_raw, lane), reps=5)
    check(r["max_abs_err"] == 0, "generic kernel differs from its plain version")
    return r


def keyed_tile_readings(table, pks, msgs, sigs, expected):
    """The tile form of the keyed kernel on the known-key lanes grouped into
    32-lane tiles (the JAX package's layout), against its plain version on
    the 13-bit combs.  Returns the reading and the grouped chunk."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    dev = table.device
    idx = table.indices_for(pks)
    sel = np.flatnonzero(idx >= 0)[:KEYED_LANES]
    blob = E.pack_blob_indexed(idx[sel], [msgs[i] for i in sel], [sigs[i] for i in sel],
                               num_keys=len(table))
    grouping = E.group_blob_for_tiles(blob, len(table), K.KEYED_TILE, BUCKET)
    check(grouping is not None, "keyed lanes do not fit the bucket")
    grouped, tile_keys, positions = grouping
    outs = K.prologue(E.to_device_words(grouped, dev), table.words)
    tile_keys = torch.as_tensor(tile_keys, device=dev)
    args = (tile_keys, key_combs(table), *outs[2:])
    got = K.verify_keyed(*args)
    err = max_abs_err([got], [K.verify_keyed_plain(tile_keys, table.neg_combs()[0], *outs[2:],
                                                   tile=K.KEYED_TILE)])
    check(err == 0, "keyed kernel (tile form) differs from its plain version")
    check(np.array_equal(got.cpu().numpy()[positions], expected[sel]),
          "keyed kernel (tile form) disagrees with the labels")
    r = dict(max_abs_err=err, ms=cuda_ms(lambda: K.verify_keyed(*args), 10),
             plain_ms=cuda_ms(lambda: K.verify_keyed_plain(*args, tile=K.KEYED_TILE), 1))
    return r, (grouped, tile_keys.cpu().numpy(), positions, expected[sel]), (args, outs)


def keyed_lane_readings(table, indexed, expected):
    """The lane form of the keyed kernel on the prologue of the indexed blob
    ``indexed`` (BUCKET lanes, keys in random order), against its plain
    version on the 13-bit combs, at BUCKET, FLUSH and 1 lanes."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    outs = K.prologue(indexed, table.words)
    keys = indexed[:, 24].contiguous()
    acomb13 = table.neg_combs()[0]
    got = K.verify_keyed_lanes(keys, table.neg_combs51(), *outs[2:])
    check(np.array_equal(got.cpu().numpy(), expected), "keyed kernel (lane form) disagrees with the labels")
    lane = int(torch.nonzero(outs[-1])[0])
    return readings(lambda k, *rest: K.verify_keyed_lanes(k, table.neg_combs51(), *rest),
                    lambda k, *rest: K.verify_keyed_plain(k, acomb13, *rest, tile=1),
                    lane_sizes((keys, *outs[2:]), lane))


def flush_reading(table, pks, msgs, sigs, expected, kernels):
    """Device time of the work the committee dispatch launches for one
    FLUSH-signature chunk of committee keys, uploaded beforehand: the
    prologue and the keyed lane form (the generic kernel in a port from
    before the lane form).  The launches must be the dispatch's own."""
    import numpy as np

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    idx = table.indices_for(pks)
    sel = np.flatnonzero(idx >= 0)[:FLUSH]
    chunk = E.pack_blob_indexed(idx[sel], [msgs[i] for i in sel], [sigs[i] for i in sel],
                                num_keys=len(table))
    padded = E.to_device_words(chunk, table.device)
    if hasattr(E, "keyed_chunk_on_device"):
        def device_work():
            return E.keyed_chunk_on_device(padded, table)
    else:  # the generic branch of dispatch_indexed_chunks
        def device_work():
            return K.verify_generic(*K.prologue(padded, table.words))

    def launched(fn):
        for k in kernels:
            k.reset_counts()
        out = fn()
        return {k.name: k.launches for k in kernels if k.launches}, out

    by_dispatch, handles = launched(lambda: E.dispatch_indexed_chunks(chunk, table))
    timed, out = launched(device_work)
    check(timed == by_dispatch, f"the timed flush launches {timed}, the dispatch {by_dispatch}")
    check(np.array_equal(E.fetch_handles(handles), expected[sel]), "flush verdicts disagree with the labels")
    check(np.array_equal(out.cpu().numpy(), expected[sel]), "timed flush disagrees with the labels")
    return dict(signatures=len(sel), keys=len(set(idx[sel].tolist())), launches=timed,
                ms=cuda_ms(device_work, 10))


def shuffled_lanes(signers, rng):
    """BUCKET lanes of the seven case classes with the keys in random order."""
    lanes = sign_cases(signers, BUCKET, rng)
    rng.shuffle(lanes)
    pks, msgs, sigs, labels = (list(x) for x in zip(*lanes))
    return pks, msgs, sigs, labels


def kernel_phase(signers, table, rng, report):
    """Each kernel against its plain version at BUCKET lanes, on the card."""
    import numpy as np

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    dev = table.device
    pks, msgs, sigs, labels = shuffled_lanes(signers, rng)
    expected = np.array([c == "valid" for c in labels])
    sample = rng.sample(range(BUCKET), ORACLE_SAMPLE)
    check(all(oracle(pks[i], msgs[i], sigs[i]) == expected[i] for i in sample),
          "case labels disagree with the Ed25519 oracle")

    # Prologue, raw and indexed layouts.
    raw = E.to_device_words(E.pack_blob(pks, msgs, sigs), dev)
    idx = table.indices_for(pks)
    indexed = E.to_device_words(E.pack_blob_indexed(idx, msgs, sigs, num_keys=len(table)), dev)
    k_raw = K.prologue(raw)
    err = max_abs_err(k_raw, K._prologue_plain(raw, None))
    r = report["prologue"] = prologue_readings(indexed, table.words)
    r["max_abs_err"] = err = max(err, r["max_abs_err"])
    check(err == 0, f"prologue differs from its plain version (max abs err {err})")
    out_bytes = nbytes(*K.prologue(indexed, table.words))
    r["bound_ms"], r["bound_by"] = bound(BUCKET * PROLOGUE_INT_OPS,
                                         nbytes(indexed, table.words) + out_bytes)

    # The generic bound: the squarings and multiplies its lanes do on this
    # run's k (a zero digit adds nothing), and the 51-bit comb it reads.
    # Beside it, the yardstick of the plain version's formulas (every
    # squaring a multiply, the 16-entry table, T everywhere) and 13-bit comb.
    r = report["verify_generic"] = generic_readings(k_raw, expected)
    verdict_bytes = BUCKET  # one byte a lane
    lane_ops = K.generic_lane_ops(k_raw[5], k_raw[6])
    live = int(k_raw[6].sum())
    r["bound_ms"], r["bound_by"] = bound(int_products(lane_ops),
                                         nbytes(*k_raw, E.base_comb51(dev)) + verdict_bytes)
    plain_muls = plain_generic_muls_per_lane()
    r["bound_ms_plain_formulas"] = bound(live * plain_muls * INT_MULS_PER_FIELD_MUL,
                                         nbytes(*k_raw, E.base_comb(dev)) + verdict_bytes)[0]
    r["field_ops_per_lane"] = dict(zip(("squarings", "multiplies"), (lane_ops.sum(axis=0) / live).tolist()))
    r["plain_field_muls_per_lane"] = plain_muls
    r["block_threads"], r["dynamic_smem_bytes"] = K.generic_launch_shape()

    # Keyed, tile form: the known-key lanes grouped, every 32-lane tile under
    # one of the 50 keys (unknown keys ride the generic kernel).  Then the
    # lane form, as the committee dispatch runs it: every lane in random key
    # order under its own key (unknown keys with ok clear).  Its bound: the
    # lanes' field operations and the 51-bit combs it reads.
    r, keyed_chunk, (args, outs) = keyed_tile_readings(table, pks, msgs, sigs, expected)
    lanes = keyed_lane_readings(table, indexed, expected)
    check(lanes["max_abs_err"] == 0, "keyed kernel (lane form) differs from its plain version")
    r["max_abs_err"] = max(r["max_abs_err"], lanes["max_abs_err"])
    r["lane_form_ms"], r["lane_form_plain_ms"] = lanes["ms"], lanes["plain_ms"]
    r["ms_at_256_lanes"], r["ms_at_1_lane"] = lanes["ms_at_256_lanes"], lanes["ms_at_1_lane"]
    lane_ops = K.keyed_lane_ops(outs[-1])
    r["bound_ms"], r["bound_by"] = bound(
        int_products(lane_ops),
        nbytes(args[0], table.neg_combs51(), *outs[2:], E.base_comb51(dev)) + verdict_bytes)
    live = int(outs[-1].sum())
    r["field_ops_per_lane"] = dict(zip(("squarings", "multiplies"), (lane_ops.sum(axis=0) / live).tolist()))
    report["verify_keyed"] = r
    report["flush"] = flush_reading(table, pks, msgs, sigs, expected, K.KERNELS)
    print(f"kernel phase: {BUCKET} lanes x {len(CLASSES)} classes in random key order, prologue, "
          f"generic and keyed (tile and lane forms) kernels equal their plain versions; "
          f"{ORACLE_SAMPLE} lanes held to the oracle; a {FLUSH}-signature flush takes "
          f"{report['flush']['ms']:.3f} ms of device time", flush=True)
    return keyed_chunk


def tampered_kind(serial: int) -> int:
    """How ``build_blocks`` and ``build_receive_blocks`` tamper the block
    with this serial: -1 not at all (one in 25 is), else 0 a signature byte,
    1 a payload byte, 2 a wrong signer."""
    return (serial // 25) % 3 if serial % 25 == 7 else -1


def build_blocks(signers, rng):
    """Serialized blocks of the committee over ROUNDS rounds; one in
    twenty-five tampered (signature byte, payload byte or wrong signer)."""
    from mysticeti_tpu_torch.types import Share, StatementBlock

    n = len(signers)
    prev = [StatementBlock.new_genesis(a).reference for a in range(n)]
    raws = []
    for rnd in range(1, ROUNDS + 1):
        refs = []
        for a in range(n):
            txs = [Share(rng.randbytes(TX_BYTES)) for _ in range(TX_PER_BLOCK)]
            serial = len(raws)
            kind = tampered_kind(serial)
            signer = signers[(a + 1) % n] if kind == 2 else signers[a]
            block = StatementBlock.build(a, rnd, prev, txs, signer=signer)
            refs.append(block.reference)
            raw = bytearray(block.to_bytes())
            if kind == 0:
                raw[-1 - rng.randrange(64)] ^= 1 << rng.randrange(8)
            elif kind == 1:
                raw[-100] ^= 1
            raws.append(bytes(raw))
        prev = refs
    return raws


def main_path(signers, committee, rng, kernels, metrics):
    """The node's verify path, then one committee dispatch of BUCKET lanes.
    The block path runs with ``metrics`` and a span tracer (``metrics_line``
    reads them).  Returns the launch counts of each ({"block": ...,
    "committee": ...}), the dispatch and block rates, the blocks with the
    oracle's verdicts, the committee burst's lanes and the block path's
    metrics reading."""
    import numpy as np

    from mysticeti_tpu_torch import spans
    from mysticeti_tpu_torch.types import StatementBlock
    from mysticeti_tpu_torch.validator import ACCELERATOR_KIND, _make_verifier

    raws = build_blocks(signers, rng)
    verifier = _make_verifier(ACCELERATOR_KIND, committee, metrics=metrics)
    check(verifier.ready.wait(300), "verifier warmup did not finish")
    blocks = [StatementBlock.from_bytes(r) for r in raws]
    for b in blocks:
        b.verify_structure(committee)
    moved_before = transfer_bytes(metrics)
    tracer = spans.SpanTracer()
    previous = spans.install(tracer)
    for k in kernels:
        k.reset_counts()
    t0 = time.monotonic()
    try:
        verdicts = asyncio.run(verifier.verify_blocks(blocks))
    finally:
        spans.install(previous)
    block_s = time.monotonic() - t0
    launches = {"block": {k.name: k.launches for k in kernels}}
    reading = metrics_line(metrics, moved_before, tracer, len(blocks))
    want = [oracle(committee.get_public_key(b.author()).bytes, b.signed_digest(), b.signature)
            for b in blocks]
    check(verdicts == want, "block verdicts differ from the oracle's")
    check(want.count(False) > 0, "no tampered block in the run")
    print(f"block path: {len(blocks)} blocks of a {len(signers)}-authority committee, "
          f"{want.count(False)} tampered, verdicts equal the oracle's "
          f"({len(blocks) / block_s:.1f} blocks/s incl. collector windows)", flush=True)

    lanes = sign_cases(signers, KEYED_LANES, rng, stragglers=STRAGGLERS)
    pks, msgs, sigs, labels = (list(x) for x in zip(*lanes))
    expected = np.array([c == "valid" for c in labels])
    backend = verifier.verifier  # TorchSignatureVerifier: dispatch_batch_table
    check(sum(pk not in set(committee.public_key_bytes()) for pk in pks) == STRAGGLERS,
          "straggler count")
    for k in kernels:
        k.reset_counts()
    got = np.asarray(backend.verify_signatures_async(pks, msgs, sigs).result())
    launches["committee"] = {k.name: k.launches for k in kernels}
    check(np.array_equal(got, expected), "committee dispatch disagrees with the labels")
    sample = rng.sample(range(KEYED_LANES), 100)
    check(all(oracle(pks[i], msgs[i], sigs[i]) == got[i] for i in sample),
          "committee dispatch disagrees with the oracle")
    runs = []
    for _ in range(3):
        t0 = time.monotonic()
        backend.verify_signatures_async(pks, msgs, sigs).result()
        runs.append(time.monotonic() - t0)
    rate = KEYED_LANES / statistics.median(runs)
    print(f"committee dispatch: {KEYED_LANES} signatures in one {BUCKET}-lane bucket ({STRAGGLERS} unknown-key stragglers), "
          f"end to end {rate:.0f} sig/s (median of 3, host pack included)", flush=True)
    return (launches, {"committee_sig_per_s": rate, "block_per_s": len(blocks) / block_s},
            (raws, want), (pks, msgs, sigs, expected), reading)


def sample_sum(metrics, name) -> float:
    """The sum of a counter's samples over all its label values."""
    return sum(sample.value for family in metrics.registry.collect()
               for sample in family.samples if sample.name == name)


def transfer_bytes(metrics) -> dict:
    get = metrics.registry.get_sample_value
    return {d: get("mysticeti_device_transfer_bytes_total", {"direction": d}) or 0.0
            for d in ("to_device", "from_device")}


def metrics_line(metrics, moved_before, tracer, n_blocks) -> dict:
    """The block path's stage seconds and transfers, the run's kernel builds,
    and its Chrome trace written under build/ and read back; printed as one
    ``{"metrics": ...}`` line."""
    from mysticeti_tpu_torch import spans

    get = metrics.registry.get_sample_value
    stages = stage_seconds(metrics)
    for stage, reading in stages.items():
        check(reading["count"], f"no {stage} stage seconds were observed")
    moved = {d: v - moved_before[d] for d, v in transfer_bytes(metrics).items()}
    check(moved["to_device"] > 0 and moved["from_device"] > 0, f"no transfer bytes counted: {moved}")
    builds = {name: get(f"mysticeti_cuda_{name}_total") for name in
              ("builds", "build_seconds", "build_cache_hits", "build_cache_misses")}
    check(builds["build_cache_hits"] + builds["build_cache_misses"] > 0, "no kernel build was counted")
    path = os.path.join(HERE, "build", "chip_smoke_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tracer.write(path)
    events = spans.complete_spans(spans.load_trace_events(path)[0])
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0) + 1
    check(set(by_name) == set(spans.VERIFY_STAGES), f"trace spans {sorted(by_name)}")
    check(by_name["verify_dispatch"] == n_blocks, "a block has no verify_dispatch span")
    reading = {"blocks": n_blocks, "stage_seconds": stages, "transfer_bytes": moved,
               "occupancy": {p: get("mysticeti_verify_occupancy_fraction", {"phase": p})
                             for p in ("pack", "device", "fetch")},
               "builds": builds, "trace": {"path": os.path.relpath(path, HERE), "spans": by_name},
               "dispatches": get("verify_dispatch_batch_size_count")}
    print(json.dumps({"metrics": reading}), flush=True)
    return reading


def flat_phase(table, keyed_chunk, kernels, report):
    """The 15,000-signature grouped chunk of the kernel phase as the flat
    keyed upload: ``verify_keyed_flat`` against the 26-column keyed path."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    grouped, tile_keys, positions, expected = keyed_chunk
    dev = table.device
    acomb = table.neg_combs51()
    flat = E.pack_flat(grouped)
    for k in kernels:
        k.reset_counts()
    got = K.verify_keyed_flat(E.to_device_words(flat, dev), table.words, acomb,
                              torch.as_tensor(tile_keys, device=dev)).cpu().numpy()
    launches = {k.name: k.launches for k in kernels}

    flat_dev = E.to_device_words(flat, dev)
    tk = torch.as_tensor(tile_keys, device=dev)
    outs = K.prologue_flat(flat_dev, table.words, tk)
    err = max_abs_err(outs, K._prologue_flat_plain(flat_dev, table.words, tk, K.KEYED_TILE))
    check(err == 0, f"prologue_flat differs from its plain version (max abs err {err})")
    grouped_dev = E.to_device_words(grouped, dev)
    want = K.verify_keyed(tk, acomb, *K.prologue(grouped_dev, table.words)[2:]).cpu().numpy()
    check(np.array_equal(got, want), "flat keyed verdicts differ from the 26-column keyed path")
    check(np.array_equal(got[positions], expected), "flat keyed verdicts disagree with the labels")

    ms = cuda_ms(lambda: K.prologue_flat(flat_dev, table.words, tk), 20)
    plain_ms = cuda_ms(lambda: K._prologue_flat_plain(flat_dev, table.words, tk, K.KEYED_TILE), 1)
    # At the flush's size and at one lane: the first FLUSH lanes are whole
    # tiles, and their ok bits the first words of the mask.
    head = torch.cat([flat_dev[: FLUSH * 24], flat_dev[BUCKET * 24 : BUCKET * 24 + FLUSH // 32]])
    tk_head = tk[: FLUSH // K.KEYED_TILE].contiguous()
    ms_256 = cuda_ms(lambda: K.prologue_flat(head, table.words, tk_head), 20)
    b_ms, b_by = bound(BUCKET * PROLOGUE_INT_OPS, nbytes(flat_dev, table.words, tk, *outs))
    err = max(err, max_abs_err(K.prologue_flat(head, table.words, tk_head),
                               K._prologue_flat_plain(head, table.words, tk_head, K.KEYED_TILE)))
    check(err == 0, f"prologue_flat differs from its plain version at {FLUSH} lanes")
    report["prologue_flat"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, ms_at_256_lanes=ms_256)

    # Host-to-device copy + prologue + keyed kernel, the two layouts in turns.
    def flat_path():
        K.verify_keyed_flat(E.to_device_words(flat, dev), table.words, acomb,
                            torch.as_tensor(tile_keys, device=dev))

    def col26_path():
        tkd = torch.as_tensor(tile_keys, device=dev)
        outs = K.prologue(E.to_device_words(grouped, dev), table.words)
        K.verify_keyed(tkd, acomb, *outs[2:])

    turns = [("flat", flat_path), ("26col", col26_path), ("26col", col26_path), ("flat", flat_path)]
    times = {"flat": [], "26col": []}
    for name, fn in turns:
        times[name].append(cuda_ms(fn, 5))
    layout = {
        "signatures": int(len(positions)), "lanes": int(grouped.shape[0]),
        "flat_bytes": int(flat.nbytes), "col26_bytes": int(grouped.nbytes),
        "flat_ms": statistics.median(times["flat"]), "col26_ms": statistics.median(times["26col"]),
        "flat_ms_runs": times["flat"], "col26_ms_runs": times["26col"],
    }
    print(f"flat keyed: {len(positions)} signatures in {grouped.shape[0]} lanes, prologue_flat "
          f"equals its plain version, verdicts equal the 26-column keyed path and the labels; "
          f"upload + kernels {layout['flat_ms']:.3f} ms flat ({flat.nbytes} B) vs "
          f"{layout['col26_ms']:.3f} ms 26-column ({grouped.nbytes} B)", flush=True)
    return launches, layout


def sharded_phase(table, burst, rng, kernels):
    """The committee burst through the sharded indexed and fused dispatch."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.parallel import mesh as M

    pks, msgs, sigs, expected = burst
    cards = torch.cuda.device_count()
    if cards >= 2:
        mesh = M.make_mesh(1 << (cards.bit_length() - 1))
    else:
        mesh = M.make_mesh(devices=[table.device] * 4)  # 4 shards on the one card
    # A card's first use (its context, the kernels' module, the comb and key
    # uploads) is set-up: pay it before the timed run.
    M.sharded_verify_batch_indexed(mesh, table, pks, msgs, sigs)
    for k in kernels:
        k.reset_counts()
    t0 = time.monotonic()
    got_i, total_i = M.sharded_verify_batch_indexed(mesh, table, pks, msgs, sigs)
    indexed_s = time.monotonic() - t0
    t0 = time.monotonic()
    got_f, total_f = M.sharded_verify_batch_fused(mesh, pks, msgs, sigs)
    fused_s = time.monotonic() - t0
    launches = {k.name: k.launches for k in kernels}

    single = E.verify_batch_table(table, pks, msgs, sigs)
    for name, got, total in (("indexed", got_i, total_i), ("fused", got_f, total_f)):
        check(np.array_equal(got, single), f"sharded {name} verdicts differ from the single-device dispatch")
        check(np.array_equal(got, expected), f"sharded {name} verdicts disagree with the labels")
        check(total == int(got.sum()), f"sharded {name} valid count {total} != {int(got.sum())}")
    sample = rng.sample(range(len(sigs)), 100)
    check(all(oracle(pks[i], msgs[i], sigs[i]) == got_i[i] for i in sample),
          "sharded verdicts disagree with the oracle")
    if cards >= 2:  # the node's verifier shards over the same cards by itself
        from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier

        node = TorchSignatureVerifier(committee_keys=table._keys)
        check(node._resolve_mesh() == mesh, "mesh='auto' did not take the host's cards")
        check(node.verify_signatures(pks, msgs, sigs) == got_i.tolist(),
              "the node verifier's sharded verdicts differ")
    devices = sorted({str(d) for d in mesh.devices})
    reading = {"shards": mesh.size, "devices": devices, "signatures": len(sigs),
               "indexed_s": indexed_s, "fused_s": fused_s, "valid": int(total_i)}
    print(f"sharded: {len(sigs)} signatures over {mesh.size} shards on {devices}, indexed "
          f"{indexed_s * 1e3:.1f} ms, fused {fused_s * 1e3:.1f} ms (host clock, packing "
          f"included); verdicts equal the single-device dispatch, the labels and the oracle",
          flush=True)
    return launches, reading


def hybrid_phase(committee, blocks_and_want, kernels):
    """The node's block path through the hybrid ``cuda`` kind."""
    import threading

    from mysticeti_tpu_torch.types import StatementBlock
    from mysticeti_tpu_torch.validator import HYBRID_KIND, _make_verifier

    raws, want = blocks_and_want
    verifier = _make_verifier(HYBRID_KIND, committee)
    check(verifier.ready.wait(300), "hybrid verifier warmup did not finish")
    hybrid = verifier.verifier
    routes = {"gpu": 0, "cpu": 0}
    lock = threading.Lock()

    def counted(route, fn):
        def call(*args):
            with lock:
                routes[route] += 1
            return fn(*args)
        return call

    hybrid.tpu.verify_signatures_async = counted("gpu", hybrid.tpu.verify_signatures_async)
    hybrid.cpu.verify_signatures = counted("cpu", hybrid.cpu.verify_signatures)
    calibration = {"tpu_dispatch_s": hybrid.tpu_dispatch_s, "tpu_per_sig_s": hybrid.tpu_per_sig_s,
                   "cpu_per_sig_s": hybrid.cpu_per_sig_s, "threshold": hybrid.threshold()}
    blocks = [StatementBlock.from_bytes(r) for r in raws]
    for k in kernels:
        k.reset_counts()
    t0 = time.monotonic()
    verdicts = asyncio.run(verifier.verify_blocks(blocks))
    block_s = time.monotonic() - t0
    launches = {k.name: k.launches for k in kernels}
    check(verdicts == want, "hybrid block verdicts differ from the oracle's")
    check(routes["gpu"] > 0, "no batch took the GPU route")
    check(sum(launches.values()) > 0, "the GPU route launched no kernel")
    check(not hybrid.breaker_open, "the hybrid breaker is open")
    reading = {"calibration": calibration, "batches": dict(routes),
               "blocks": len(blocks), "blocks_per_s": len(blocks) / block_s,
               "after": {"tpu_dispatch_s": hybrid.tpu_dispatch_s,
                         "tpu_per_sig_s": hybrid.tpu_per_sig_s,
                         "cpu_per_sig_s": hybrid.cpu_per_sig_s, "threshold": hybrid.threshold()}}
    print(f"hybrid: {len(blocks)} blocks through the cuda kind, verdicts equal the oracle's; "
          f"calibration {json.dumps(calibration)}; batches by route {json.dumps(routes)} "
          f"(CPU-routed batches are the cost model's choice); {len(blocks) / block_s:.1f} "
          f"blocks/s; breaker closed", flush=True)
    return launches, reading


def entry_phase(kernels):
    """``entry()`` on the card: every verdict True and the oracle's; a copy
    with a bit flipped in R, A, M and s gives the oracle's verdicts.  Then
    ``dryrun_multichip(4)`` over the cards there are."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch import entry
    from mysticeti_tpu_torch.ops import ed25519 as E

    def lanes_of(msg, s):  # the (pk, msg, sig) bytes of each packed lane
        rows = msg.astype(">u4").tobytes()
        tails = s.astype("<u4").tobytes()
        return [(rows[96 * i + 32: 96 * i + 64], rows[96 * i + 64: 96 * i + 96],
                 rows[96 * i: 96 * i + 32] + tails[32 * i: 32 * i + 32]) for i in range(len(msg))]

    for k in kernels:
        k.reset_counts()
    fn, args = entry.entry()
    check(all(a.device.type == "cuda" for a in args), "entry() did not place its batch on the card")
    got = fn(*args).cpu().numpy()
    msg = args[0].cpu().numpy().view(np.uint32).copy()
    s = args[1].cpu().numpy().view(np.uint32).copy()
    want = [oracle(*lane) for lane in lanes_of(msg, s)]
    check(got.tolist() == [True] * 8 and want == [True] * 8, f"entry verdicts {got.tolist()}")
    for lane, (col, bit) in enumerate([(0, 3), (7, 30), (8, 0), (12, 17), (16, 9), (23, 31)]):
        msg[lane, col] ^= np.uint32(1 << bit)
    s[6, 0] ^= np.uint32(1)
    s[7, 5] ^= np.uint32(1 << 12)
    bad = fn(E.to_device_words(msg, args[0].device), E.to_device_words(s, args[0].device),
             args[2]).cpu().numpy()
    want_bad = [oracle(*lane) for lane in lanes_of(msg, s)]
    check(bad.tolist() == want_bad, f"corrupted entry verdicts {bad.tolist()} != oracle {want_bad}")
    entry_counts = {k.name: k.launches for k in kernels}
    print(f"entry: verify_fused_impl on {args[0].device}, 8 valid signatures True, a copy with "
          f"bits flipped in R, A, M and s gives the oracle's verdicts {want_bad}", flush=True)

    for k in kernels:
        k.reset_counts()
    t0 = time.monotonic()
    entry.dryrun_multichip(4)
    dryrun_s = time.monotonic() - t0
    dryrun_counts = {k.name: k.launches for k in kernels}
    check(dryrun_counts["prologue"] > 0 and dryrun_counts["verify_generic"] > 0,
          f"dryrun_multichip launched {dryrun_counts}")
    print(f"dryrun: dryrun_multichip(4) over {torch.cuda.device_count()} card(s) passed in "
          f"{dryrun_s:.1f} s", flush=True)
    return entry_counts, dryrun_counts


class ServiceThread:
    """A ``VerifierServer`` serving on a unix socket from its own event loop
    in a thread; ``start`` returns once the backend is prewarmed."""

    def __init__(self, path, keys, device):
        import threading

        from mysticeti_tpu_torch.metrics import Metrics
        from mysticeti_tpu_torch.verifier_service import VerifierServer

        self.server = VerifierServer(path, committee_keys=keys, metrics=Metrics(), device=device)
        self._ready = threading.Event()
        self._error = None
        self._loop = None
        self._thread = threading.Thread(target=self._run, name="verifier-service", daemon=True)

    def _run(self):
        async def serve():
            self._loop = asyncio.get_running_loop()
            self._stop = asyncio.Event()
            try:
                await self.server.start()
                await self._loop.run_in_executor(None, self.server.prewarm)
            except Exception as exc:  # noqa: BLE001 - raised again by start()
                self._error = exc
                self._stop.set()
            self._ready.set()
            await self._stop.wait()
            await self.server.stop()

        asyncio.run(serve())

    def start(self):
        self._thread.start()
        check(self._ready.wait(300), "the verifier service did not warm up")
        if self._error is not None:
            self._thread.join(60)
            raise self._error

    def stop(self):
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(60)
        check(not self._thread.is_alive(), "the verifier service thread did not stop")


def service_phase(committee, blocks_and_want, kernels, in_process_per_s):
    """The block path through the shared verifier service, ``cuda-only``
    then ``cuda`` kind."""
    from mysticeti_tpu_torch.block_validator import HybridSignatureVerifier
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.types import StatementBlock
    from mysticeti_tpu_torch.validator import ACCELERATOR_KIND, HYBRID_KIND, _make_verifier
    from mysticeti_tpu_torch.verifier_service import ENV_SOCKET, RemoteSignatureVerifier

    raws, want = blocks_and_want
    path = os.path.join(HERE, "build", "svc", "verifier.sock")
    service = ServiceThread(path, committee.public_key_bytes(), "cuda:0")
    service.start()
    os.environ[ENV_SOCKET] = path
    reading = {"socket": os.path.relpath(path, HERE)}
    try:
        for k in kernels:
            k.reset_counts()
        for kind in (ACCELERATOR_KIND, HYBRID_KIND):
            metrics = Metrics()
            verifier = _make_verifier(kind, committee, metrics=metrics)
            check(verifier.ready.wait(300), f"{kind} warmup through the service did not finish")
            backend = verifier.verifier
            remote = backend.tpu if isinstance(backend, HybridSignatureVerifier) else backend
            check(isinstance(remote, RemoteSignatureVerifier), f"{kind} did not take the service")
            check(remote.dispatch_calibration() is not None, "HELLO_OK carried no calibration")
            check(remote.advertised_backend == "cuda",
                  f"HELLO_OK advertised {remote.advertised_backend!r}, not 'cuda'")
            if kind == HYBRID_KIND:
                check(backend.pinned_backend is None, "the hybrid router is pinned to the CPU")
            blocks = [StatementBlock.from_bytes(r) for r in raws]
            t0 = time.monotonic()
            verdicts = asyncio.run(verifier.verify_blocks(blocks))
            elapsed = time.monotonic() - t0
            check(verdicts == want, f"{kind} verdicts through the service differ from the oracle's")
            get = metrics.registry.get_sample_value
            reading[kind] = {
                "blocks_per_s": len(blocks) / elapsed,
                "calibration": list(remote.dispatch_calibration()),
                "advertised_backend": remote.advertised_backend,
                "wire_bytes": {d: get("verify_wire_bytes_total", {"direction": d})
                               for d in ("sent", "recv")},
            }
        launches = {k.name: k.launches for k in kernels}
    finally:
        os.environ.pop(ENV_SOCKET, None)
        service.stop()
    server_get = service.server.metrics.registry.get_sample_value
    reading["server_dispatches"] = server_get("verify_dispatch_batch_size_count")
    reading["in_process_blocks_per_s"] = in_process_per_s
    check(launches["verify_keyed"] > 0, f"the service launched no keyed kernel: {launches}")
    check(launches["verify_generic"] == 0, f"the service launched the generic kernel: {launches}")
    print(f"service: {len(raws)} blocks through the verifier service on {reading['socket']}, "
          f"cuda-only {reading[ACCELERATOR_KIND]['blocks_per_s']:.1f} blocks/s and hybrid "
          f"{reading[HYBRID_KIND]['blocks_per_s']:.1f} blocks/s (in process cuda-only "
          f"{in_process_per_s:.1f}); verdicts equal the oracle's; HELLO_OK advertised 'cuda' "
          f"with a calibration; server launches {launches}", flush=True)
    return launches, reading


def build_receive_blocks(committee, signers, rng, rounds=RECEIVE_ROUNDS, txs=RECEIVE_TX):
    """Serialized blocks of an aggregation-shaped DAG: as ``build_blocks``,
    but honest children include only the previous round's valid blocks (what
    honest nodes do), and the BYZANTINE block is signed by another key and
    included by the valid blocks of one authority fewer than a quorum.
    Returns the raws, which are valid, and the BYZANTINE block's index."""
    from mysticeti_tpu_torch.types import Share, StatementBlock

    n = len(signers)
    byz_round, byz_author = BYZANTINE
    endorsers = [a for a in range(n) if tampered_kind(byz_round * n + a) < 0]
    endorsers = set(endorsers[: committee.quorum_threshold() - 1])
    prev = [StatementBlock.new_genesis(a).reference for a in range(n)]
    raws, valid, byz_ref, byz_index = [], [], None, None
    for rnd in range(1, rounds + 1):
        good = []
        for a in range(n):
            serial = len(raws)
            kind = tampered_kind(serial)
            byzantine = (rnd, a) == BYZANTINE
            signer = signers[(a + 1) % n] if kind == 2 or byzantine else signers[a]
            includes = list(prev)
            if rnd == byz_round + 1 and a in endorsers:
                includes.append(byz_ref)
            block = StatementBlock.build(
                a, rnd, includes, [Share(rng.randbytes(TX_BYTES)) for _ in range(txs)],
                signer=signer)
            raw = bytearray(block.to_bytes())
            if kind == 0:
                raw[-1 - rng.randrange(64)] ^= 1 << rng.randrange(8)
            elif kind == 1:
                raw[-100] ^= 1
            raws.append(bytes(raw))
            valid.append(kind < 0 and not byzantine)
            if valid[-1]:
                good.append(block.reference)
            if byzantine:
                byz_ref, byz_index = block.reference, serial
        prev = good
    return raws, valid, byz_index


def frames_under_cap(raws, per_round):
    """Each round's blocks split into ``Blocks`` frames, each holding as
    many blocks as fit under MAX_FRAME by their encoded size."""
    from mysticeti_tpu_torch.network import MAX_FRAME

    frames = []
    for start in range(0, len(raws), per_round):
        frame, size = [], 1 + 4  # tag, count
        for raw in raws[start: start + per_round]:
            if frame and size + 4 + len(raw) > MAX_FRAME:
                frames.append(frame)
                frame, size = [], 1 + 4
            frame.append(raw)
            size += 4 + len(raw)
        frames.append(frame)
    return frames


async def over_loopback(frames, streaming=True):
    """Authority 0 sends ``frames`` to authority 1 over two port
    ``TcpNetwork`` endpoints on 127.0.0.1; authority 1 decodes each frame
    with ``from_bytes_many`` on the data-plane offload worker, as it arrives
    (``streaming``, what a node does) or, for ``receive_split``, once the
    last frame is in.  Returns the decoded blocks, the seconds from the first
    send to the last decode, the seconds to the last frame received, the
    decode seconds and the bytes authority 1 received."""
    from mysticeti_tpu_torch.core_task import DataPlaneOffload
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.network import Blocks, TcpNetwork
    from mysticeti_tpu_torch.types import StatementBlock

    addresses = [("127.0.0.1", 0), ("127.0.0.1", 0)]
    receiver_metrics = Metrics()
    net1 = await TcpNetwork.start(1, addresses, receiver_metrics)
    addresses[1] = ("127.0.0.1", net1._server.sockets[0].getsockname()[1])
    net0 = await TcpNetwork.start(0, addresses, Metrics())
    offload = DataPlaneOffload(metrics=receiver_metrics)
    try:
        conn0 = await asyncio.wait_for(net0.connections.get(), 30)
        conn1 = await asyncio.wait_for(net1.connections.get(), 30)
        check(offload.active(), "the data-plane offload is inactive (no native extension)")
        t0 = time.monotonic()

        async def send():
            for frame in frames:
                await conn0.send(Blocks(tuple(frame)))

        async def decode(msg):
            check(offload.should_offload(sum(len(b) for b in msg.blocks)),
                  "a frame too small for the offload")
            d0 = time.monotonic()
            blocks.extend(await offload.run("decode", StatementBlock.from_bytes_many, msg.blocks))
            return time.monotonic() - d0

        sender = asyncio.ensure_future(send())
        blocks, held, decode_s = [], [], 0.0
        for frame in frames:
            msg = await asyncio.wait_for(conn1.recv(), 60)
            check(type(msg) is Blocks and len(msg.blocks) == len(frame),
                  f"received {type(msg).__name__} instead of a {len(frame)}-block frame")
            check(all(type(b) is memoryview for b in msg.blocks),
                  "the frame did not come through the zero-copy receiver")
            if streaming:
                decode_s += await decode(msg)
            else:
                held.append(msg)
        received_s = time.monotonic() - t0
        for msg in held:
            decode_s += await decode(msg)
        wire_s = time.monotonic() - t0
        await sender
        received = receiver_metrics.registry.get_sample_value(
            "mesh_wire_bytes_total", {"direction": "received"})
    finally:
        offload.stop()
        await net0.stop()
        await net1.stop()
    return blocks, wire_s, received_s, decode_s, received


def decode_times(raws):
    """Seconds to decode ``raws`` with ``from_bytes_many`` and have each
    block's signed digest: native, then the per-raw pure-Python fallback in
    this process (the native hooks switched off for the call)."""
    from mysticeti_tpu_torch import types as T

    def timed():
        t0 = time.monotonic()
        blocks = T.StatementBlock.from_bytes_many(raws)
        for b in blocks:
            b.signed_digest()
        return time.monotonic() - t0, blocks

    native_s, native_blocks = timed()
    hooks = T._native_decode, T._native_block_digests
    T._native_decode = T._native_block_digests = None
    try:
        fallback_s, fallback_blocks = timed()
    finally:
        T._native_decode, T._native_block_digests = hooks
    check([b.signed_digest() for b in native_blocks] == [b.signed_digest() for b in fallback_blocks]
          and all(b._stamps is None for b in fallback_blocks),
          "the fallback decode differs from the native one, or did not run")
    return native_s, fallback_s


def receive_phase(committee, signers, rng, kernels):
    """The wire receive path at config 4's full width, then the verifier
    kinds on the received burst (see the module docstring, step 10)."""
    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.native import active_functions
    from mysticeti_tpu_torch.validator import _make_verifier

    active = active_functions()
    check(set(RECEIVE_NATIVE) <= set(active),
          f"the native extension lacks {sorted(set(RECEIVE_NATIVE) - set(active))}")
    n = len(signers)
    t0 = time.monotonic()
    raws, valid, byz_index = build_receive_blocks(committee, signers, rng, RECEIVE_ROUNDS,
                                                  RECEIVE_TX)
    build_s = time.monotonic() - t0
    frames = frames_under_cap(raws, n)
    blocks, wire_s, _, wire_decode_s, received = asyncio.run(over_loopback(frames))
    check([b.to_bytes() for b in blocks] == raws, "the received blocks differ from the sent ones")
    check(all(b._signed_digest is not None and b._stamps is not None for b in blocks),
          "a received block has no precomputed signed digest: the native decode did not run")
    for b in blocks:
        b.verify_structure(committee)
    want = [oracle(committee.get_public_key(b.author()).bytes, b.signed_digest(), b.signature)
            for b in blocks]
    check(want == valid, "the oracle disagrees with the blocks' labels")
    native_s, fallback_s = decode_times(raws)
    reading = {"blocks": len(blocks), "block_bytes": len(raws[0]), "frames": len(frames),
               "blocks_per_frame": [len(f) for f in frames[: len(frames) // RECEIVE_ROUNDS]],
               "bytes_received": received, "wire_s": wire_s, "wire_decode_s": wire_decode_s,
               "decode_native_s": native_s, "decode_fallback_s": fallback_s,
               "native_over_fallback": native_s / fallback_s, "build_s": build_s,
               "tampered": want.count(False), "native_functions": list(active)}
    print(f"receive: {len(blocks)} blocks of {len(raws[0])} B in {len(frames)} frames, "
          f"{received:.0f} B received over loopback in {wire_s:.3f} s decoding each frame as "
          f"it arrives ({wire_decode_s:.3f} s of it decoding); decode native {native_s:.3f} s, "
          f"fallback {fallback_s:.3f} s ({native_s / fallback_s:.3f}x) [{card_line()}]",
          flush=True)

    # Every kind's warmup (kernel loads, key combs, the hybrid's calibration)
    # runs before the counts are zeroed: they count the receive path only.
    verifiers, registries = {}, {}
    for kind in RECEIVE_KINDS:
        registries[kind] = Metrics()
        verifier = verifiers[kind] = _make_verifier(kind, committee, metrics=registries[kind])
        check(verifier.ready.wait(300), f"{kind} warmup did not finish")
        check(verifier.aggregate == kind.endswith("-agg"), f"{kind} aggregate mode")
    for k in kernels:
        k.reset_counts()
    for kind, verifier in verifiers.items():
        metrics = registries[kind]
        t0 = time.monotonic()
        verdicts = asyncio.run(verifier.verify_blocks(blocks))
        elapsed = time.monotonic() - t0
        check(verdicts == want, f"{kind} verdicts differ from the oracle's")
        check(verdicts[byz_index] is False, f"{kind} accepted the forged block")
        check(verifier.aggregated_total + verifier.direct_total == len(blocks),
              f"{kind}: {verifier.aggregated_total} aggregated + {verifier.direct_total} "
              f"direct != {len(blocks)}")
        if verifier.aggregate:
            check(verifier.aggregated_total > 0, f"{kind} skipped no block")
        get = metrics.registry.get_sample_value
        dispatched = get("verify_dispatch_batch_size_sum") or 0.0
        reading[kind] = {"blocks_per_s": len(blocks) / elapsed,
                         "aggregated": verifier.aggregated_total, "direct": verifier.direct_total,
                         "signatures_dispatched": dispatched,
                         "dispatches": get("verify_dispatch_batch_size_count"),
                         "lanes": dispatched + sample_sum(metrics, "verify_padding_wasted_total")}
    launches = {k.name: k.launches for k in kernels}
    check(launches["verify_keyed"] > 0 and launches["prologue"] > 0,
          f"the receive path did not take the prologue and the keyed kernel: {launches}")
    check(launches["verify_generic"] == 0, f"the receive path launched the generic kernel: {launches}")

    rates = {kind: [] for kind in RECEIVE_KINDS[:2]}
    for _ in range(RECEIVE_PAIRS):
        for kind in RECEIVE_KINDS[:2]:
            made = verifiers[kind]
            fresh = BatchedSignatureVerifier(committee, made.verifier, max_delay_s=made.max_delay_s,
                                             aggregate=made.aggregate)
            t0 = time.monotonic()
            verdicts = asyncio.run(fresh.verify_blocks(blocks))
            rates[kind].append(len(blocks) / (time.monotonic() - t0))
            check(verdicts == want, f"{kind} verdicts differ from the oracle's in turn")
    reading["turns_blocks_per_s"] = rates
    reading["median_blocks_per_s"] = {k: statistics.median(v) for k, v in rates.items()}
    only, agg = (reading["median_blocks_per_s"][k] for k in RECEIVE_KINDS[:2])
    reading["agg_over_only"] = agg / only
    reading["card"] = card_line()
    print(f"receive: verdicts equal the oracle's for {', '.join(RECEIVE_KINDS)}; forged block "
          f"{byz_index} rejected; aggregated {reading['cuda-only-agg']['aggregated']} / direct "
          f"{reading['cuda-only-agg']['direct']} (cuda-only-agg), signatures dispatched "
          f"{reading['cuda-only']['signatures_dispatched']:.0f} vs "
          f"{reading['cuda-only-agg']['signatures_dispatched']:.0f}; median blocks/s in turns "
          f"cuda-only {only:.1f}, cuda-only-agg {agg:.1f} ({agg / only:.3f}x); launches "
          f"{launches} [{reading['card']}]", flush=True)
    return launches, reading


def forged_copy(raw: bytes, rng: random.Random) -> bytes:
    """``raw`` with one bit of its signature (the block's last 64 bytes)
    flipped."""
    out = bytearray(raw)
    out[len(out) - 64 + rng.randrange(64)] ^= 1 << rng.randrange(8)
    return bytes(out)


async def consensus_sim(n, tmp_dir, virtual_s, make_collector, forge_one_in):
    """``n`` syncers of a ``Committee.new_for_benchmarks(n)`` under the
    running deterministic loop, the harness of ``tests/test_syncer_sim.py``
    with each delivery verified: the wire bytes are decoded through
    ``from_bytes_many`` (one memoised ``from_bytes`` a block under the
    simulator), awaited in the receiving node's own collector
    (``make_collector(committee)``), and only the accepted blocks reach
    ``add_blocks`` before the node relays.  One delivery in
    ``forge_one_in`` (seeded) is preceded by a copy of its last block with
    a signature bit flipped.  Every node cleans up as often as the node's
    own periodic task does (``net_sync.CLEANUP_INTERVAL_S``).  Returns the
    committed-leader sequences, every node's own-block references, the
    forged copies' references, the rounds reached and the delivery counts."""
    from mysticeti_tpu_torch.block_handler import TestBlockHandler
    from mysticeti_tpu_torch.block_store import BlockStore
    from mysticeti_tpu_torch.commit_observer import TestCommitObserver
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.config import Parameters
    from mysticeti_tpu_torch.core import Core, CoreOptions
    from mysticeti_tpu_torch.net_sync import CLEANUP_INTERVAL_S, AsyncSignals
    from mysticeti_tpu_torch.syncer import Syncer
    from mysticeti_tpu_torch.types import AuthoritySet, StatementBlock
    from mysticeti_tpu_torch.wal import walf

    loop = asyncio.get_running_loop()
    rng = loop.rng
    committee = Committee.new_for_benchmarks(n)
    signers = Committee.benchmark_signers(n)
    parameters = Parameters()
    everyone = AuthoritySet()
    for a in range(n):
        everyone.insert(a)
    syncers, collectors = [], []
    for a in range(n):
        writer, reader = walf(os.path.join(tmp_dir, f"wal-{a}"))
        recovered, _ = BlockStore.open(a, reader, writer, committee)
        handler = TestBlockHandler(last_transaction=a * 1_000_000, committee=committee, authority=a)
        core = Core(block_handler=handler, authority=a, committee=committee, parameters=parameters,
                    recovered=recovered, wal_writer=writer, options=CoreOptions.test(),
                    signer=signers[a])
        observer = TestCommitObserver(core.block_store, committee)
        syncers.append(Syncer(core, parameters.wave_length, AsyncSignals(), observer))
        collectors.append(make_collector(committee))
    counts = {"deliveries": 0, "signatures_verified": 0, "forged": 0, "forged_rejected": 0,
              "honest_rejected": 0}
    forged_refs, errors, inflight = [], [], set()
    cursors = [[0] * n for _ in range(n)]

    def spawn(coro):
        task = asyncio.ensure_future(coro)
        inflight.add(task)
        task.add_done_callback(landed)

    def landed(task):
        inflight.discard(task)
        if not task.cancelled() and task.exception() is not None:
            errors.append(task.exception())

    def arrive(dst, raws, forged):
        if forged is not None:
            spawn(deliver(dst, [forged], True))
        spawn(deliver(dst, raws, False))

    def relay_from(src):
        for dst in range(n):
            if dst == src:
                continue
            blocks = syncers[src].core.block_store.get_own_blocks(cursors[src][dst], 100)
            if not blocks:
                continue
            cursors[src][dst] = max(b.round() for b in blocks)
            low, high = CONSENSUS_LATENCY_S
            delay = low + rng.random() * (high - low)
            raws = [b.to_bytes() for b in blocks]
            forged = forged_copy(raws[-1], rng) if rng.randrange(forge_one_in) == 0 else None
            loop.call_later(delay, arrive, dst, raws, forged)

    async def deliver(dst, raws, forged):
        blocks = StatementBlock.from_bytes_many(raws)
        check(all(b is not None for b in blocks), "a delivered block did not decode")
        verdicts = await collectors[dst].verify_blocks(blocks)
        counts["deliveries"] += 1
        counts["signatures_verified"] += len(blocks)
        if forged:
            counts["forged"] += 1
            forged_refs.append(blocks[0].reference)
            counts["forged_rejected"] += not verdicts[0]
            return
        counts["honest_rejected"] += verdicts.count(False)
        syncers[dst].add_blocks([b for b, ok in zip(blocks, verdicts) if ok], everyone.copy())
        relay_from(dst)

    async def leader_timeout(idx):
        syncer = syncers[idx]
        while True:
            waiter = syncer.signals.round_notify.subscribe()
            round_at_start = syncer.signals.current_round
            try:
                await asyncio.wait_for(waiter.wait(), timeout=CONSENSUS_LEADER_TIMEOUT_S)
            except asyncio.TimeoutError:
                syncer.force_new_block(round_at_start + 1, everyone.copy())
                relay_from(idx)

    async def pump(idx):
        while True:
            await asyncio.sleep(CONSENSUS_PUMP_S)
            relay_from(idx)

    async def cleanup():
        while True:
            await asyncio.sleep(CLEANUP_INTERVAL_S)
            for syncer in syncers:
                syncer.cleanup()

    for idx, syncer in enumerate(syncers):
        syncer.force_new_block(1, everyone.copy())
        relay_from(idx)
    tasks = ([asyncio.ensure_future(leader_timeout(i)) for i in range(n)]
             + [asyncio.ensure_future(pump(i)) for i in range(n)]
             + [asyncio.ensure_future(cleanup())])
    await asyncio.sleep(virtual_s)
    for task in tasks + list(inflight):
        task.cancel()
    await asyncio.gather(*tasks, *inflight, return_exceptions=True)
    check(not errors, f"a delivery failed: {errors[:3]!r}")
    stored_forged = sum(s.core.block_store.block_exists(ref) for s in syncers for ref in forged_refs)
    result = {
        "sequences": [list(s.commit_observer.committed_leaders) for s in syncers],
        "own_blocks": [[b.reference for b in s.core.block_store.get_own_blocks(0, 1 << 30)]
                       for s in syncers],
        "rounds": [s.core.block_store.highest_round() for s in syncers],
        "forged_refs": forged_refs, "forged_stored": stored_forged, **counts,
    }
    for syncer in syncers:
        syncer.core.wal_writer.close()
        syncer.core.block_store.close()  # the WAL reader's mmap and descriptor
    return result


def consensus_run(kind, n, virtual_s, seed, backend=None, metrics=None):
    """One seeded simulation of ``consensus_sim`` in a temporary directory:
    ``kind`` "cuda-only" gives every node a collector over the one shared
    ``backend`` (a ``TorchSignatureVerifier``); "cpu" gives every node the
    ``cpu`` kind's collector (the oracle).  Returns the simulation's result
    with its wall seconds."""
    import tempfile

    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.validator import _make_verifier

    def make_collector(committee):
        if kind == "cpu":
            return _make_verifier("cpu", committee, metrics=metrics)
        check(kind == "cuda-only" and backend is not None, f"no backend for {kind}")
        return BatchedSignatureVerifier(committee, backend, metrics=metrics)

    with tempfile.TemporaryDirectory(prefix="consensus-") as d:
        t0 = time.monotonic()
        result = run_simulation(
            consensus_sim(n, d, virtual_s, make_collector, CONSENSUS_FORGE_ONE_IN), seed=seed)
        result["wall_s"] = time.monotonic() - t0
    return result


def commit_checks(sequences, min_commits) -> list:
    """Every node committed at least ``min_commits`` leaders and the
    committed sequences are prefixes of the longest; returns the commits."""
    commits = [len(seq) for seq in sequences]
    check(min(commits) >= min_commits, f"a node committed fewer than {min_commits} leaders: {commits}")
    longest = max(sequences, key=len)
    for seq in sequences:
        check(seq == longest[: len(seq)], f"the committed sequences fork: {seq} vs {longest}")
    return commits


def chain_digest(result) -> str:
    """SHA-256 over every node's committed sequence and own blocks
    (authority, round, digest of each reference)."""
    import hashlib

    refs = [[[r.authority, r.round, bytes(r.digest).hex()] for r in seq]
            for key in ("sequences", "own_blocks") for seq in result[key]]
    return hashlib.sha256(json.dumps(refs).encode()).hexdigest()


def seeded_counts(result, keys) -> dict:
    """A simulated cell's rounds and commits a node, ``keys`` of ``result``
    and the digest of its sequences and own blocks: what a seeded run must
    reproduce on any host and backend."""
    return {"rounds": result["rounds"], "commits": [len(seq) for seq in result["sequences"]],
            **{key: result[key] for key in keys}, "chain": chain_digest(result)}


def consensus_checks(card, cpu, min_commits) -> dict:
    """Checks 1-4 of the consensus phase on the card run and the ``cpu``
    run of the same seed (with ``cpu`` None, the whole script, the
    comparison is left to ``CONSENSUS_SEEDED``); returns the readings they
    share."""
    commits = commit_checks(card["sequences"], min_commits)
    check(card["forged"] > 0, "no forged copy was delivered")
    check(card["forged_rejected"] == card["forged"],
          f"{card['forged'] - card['forged_rejected']} forged copies were accepted")
    check(card["forged_stored"] == 0, "a forged block is in a node's store")
    check(card["honest_rejected"] == 0, f"{card['honest_rejected']} honest blocks were rejected")
    if cpu is not None:
        check(card["sequences"] == cpu["sequences"],
              "the committed sequences differ from the cpu run's")
        check(card["own_blocks"] == cpu["own_blocks"], "the own blocks differ from the cpu run's")
    return {"commits_min": min(commits), "commits_max": max(commits),
            "rounds_min": min(card["rounds"]), "rounds_max": max(card["rounds"]),
            "deliveries": card["deliveries"], "signatures_verified": card["signatures_verified"],
            "forged": card["forged"], "forged_rejected": card["forged_rejected"]}


def consensus_phase(kernels, control=True):
    """The consensus-50 cell: the same seeded simulation over the card
    (``cuda-only`` collectors sharing one ``TorchSignatureVerifier`` on
    cuda:0) and over the ``cpu`` kind, with the six checks (see the module
    docstring, step 11).  ``control`` False (the whole script) skips the
    ``cpu`` run: ``CONSENSUS_SEEDED`` alone holds the card."""
    from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.metrics import Metrics

    n, virtual_s, seed = COMMITTEE, CONSENSUS_VIRTUAL_S, SEED
    committee = Committee.new_for_benchmarks(n)
    backend = TorchSignatureVerifier(committee_keys=committee.public_key_bytes())
    backend.warmup()  # the kernels' first launches and the combs' upload
    metrics = Metrics()
    for k in kernels:
        k.reset_counts()
    card = consensus_run("cuda-only", n, virtual_s, seed, backend=backend, metrics=metrics)
    launches = {k.name: k.launches for k in kernels}
    cpu = consensus_run("cpu", n, virtual_s, seed) if control else None
    reading = consensus_checks(card, cpu, CONSENSUS_MIN_COMMITS)
    counts = seeded_counts(card, CONSENSUS_KEYS)
    check(counts == CONSENSUS_SEEDED, f"the counts differ from the seeded ones: {counts}")
    check(launches["prologue"] > 0 and launches["verify_keyed"] > 0,
          f"the consensus path did not take the prologue and the keyed kernel: {launches}")
    check(launches["verify_generic"] == 0,
          f"the consensus path launched the generic kernel: {launches}")
    get = metrics.registry.get_sample_value
    label = getattr(backend, "backend_label", type(backend).__name__)
    on_card = sum(get("verified_signatures_total", {"backend": label, "outcome": o}) or 0.0
                  for o in ("accepted", "rejected"))
    dispatched = get("verify_dispatch_batch_size_sum") or 0.0
    flushes = get("verify_dispatch_batch_size_count") or 0.0
    check(on_card == dispatched == card["signatures_verified"],
          f"signatures on the card {on_card:.0f}, dispatched {dispatched:.0f}, deliveries "
          f"verified {card['signatures_verified']}")
    reading.update({
        "committee": n, "virtual_s": virtual_s, "seed": seed, "card_wall_s": card["wall_s"],
        "cpu_wall_s": cpu and cpu["wall_s"],
        "deliveries_per_wall_s": card["deliveries"] / card["wall_s"],
        "signatures_on_card": on_card, "flushes": flushes,
        "mean_live_lanes": dispatched / flushes if flushes else 0.0,
        "stage_seconds": stage_seconds(metrics),
        "launches": launches, "card": card_line()})
    print(f"consensus: {n} authorities, {virtual_s} virtual s, rounds "
          f"{reading['rounds_min']}-{reading['rounds_max']}, commits a node "
          f"{reading['commits_min']}-{reading['commits_max']}, prefixes agree and equal "
          f"{control_text(cpu)}the seeded counts; {card['deliveries']} deliveries "
          f"({card['forged']} forged, all rejected) in {card['wall_s']:.1f} s on the card "
          f"({reading['deliveries_per_wall_s']:.1f}/s), {control_seconds(cpu)}; {flushes:.0f} flushes, "
          f"{reading['mean_live_lanes']:.2f} live lanes a flush; launches {launches} "
          f"[{reading['card']}]", flush=True)
    return launches, reading


class FaultInjector:
    """Forged copies and re-deliveries, seeded from ``rng``.

    As ``SimulatedNetwork.fault_injector``: before one src->dst batch in
    ``one_in`` that carries a ``Blocks`` message, deliver a new ``Blocks``
    message holding a copy of that message's last block with one signature
    bit flipped; and, on an independent draw, deliver one such batch's
    block-carrying messages a second time, right behind the batch (while
    its blocks are still in the verify pipeline: the ``inflight`` dedup's
    case) or up to ``NETSYNC_REDELIVER_S`` later (mostly the ``processed``
    dedup's), so the dedup has re-deliveries to keep off the card.  Over a real transport, ``wrap`` does the forging on a
    connection's sends.  The messages given are never touched: the frame
    cache shares one frame object across subscribers."""

    def __init__(self, rng: random.Random, one_in: int) -> None:
        self.rng = rng
        self.one_in = one_in
        self.forged_refs = set()
        self.redelivered = 0  # blocks sent a second time

    @staticmethod
    def _carrying(messages):
        from mysticeti_tpu_torch.network import Blocks, EncodedFrame

        messages = [m.message if type(m) is EncodedFrame else m for m in messages]
        return [m for m in messages if isinstance(m, Blocks) and m.blocks]

    def _forge(self, carrying):
        """A forged ``Blocks`` message for one draw in ``one_in``, else None."""
        from mysticeti_tpu_torch.network import Blocks
        from mysticeti_tpu_torch.types import StatementBlock

        if not carrying or self.rng.randrange(self.one_in):
            return None
        raw = forged_copy(bytes(carrying[-1].blocks[-1]), self.rng)
        self.forged_refs.add(StatementBlock.from_bytes(raw).reference)
        return Blocks((raw,))

    def filter_batch(self, src, dst, batch):
        carrying = self._carrying(batch)
        forged = self._forge(carrying)
        groups = [(0.0, list(batch) if forged is None else [forged] + list(batch))]
        if carrying and not self.rng.randrange(self.one_in):
            self.redelivered += sum(len(m.blocks) for m in carrying)
            delay = self.rng.choice((0.0, self.rng.uniform(*NETSYNC_REDELIVER_S)))
            groups.append((delay, carrying))
        return groups

    def wrap(self, connection):
        """``connection`` with its ``send`` putting a forged copy before one
        block-carrying message in ``one_in``."""
        send = connection.send

        async def forging_send(msg):
            forged = self._forge(self._carrying([msg]))
            if forged is not None:
                await send(forged)
            await send(msg)

        connection.send = forging_send
        return connection


class ForgingNetwork:
    """The ``TcpNetwork`` surface ``NetworkSyncer`` reads (``connections``,
    ``stop``), with every connection it hands out wrapped by ``injector``."""

    def __init__(self, network, injector: FaultInjector) -> None:
        self._network = network
        self._injector = injector
        self.connections = self

    async def get(self):
        return self._injector.wrap(await self._network.connections.get())

    async def stop(self):
        await self._network.stop()


class ReceiveCounter:
    """Counts what the watched nodes' receive stages and collectors did:
    blocks received, fresh after ``verify_structure``, sent to the verifier,
    and the verdicts on forged and honest blocks; and, a
    node at a time (an incarnation, where nodes restart), the references of
    the blocks in verify calls, with a verdict, and with the card's verdict
    back in the collector (counted where the collector's dispatch returns),
    and the peers each block came fresh from."""

    KEYS = ("received", "fresh", "to_verify", "forged", "forged_rejected", "honest_rejected")

    def __init__(self, forged_refs) -> None:
        self.forged_refs = forged_refs
        self.forged_rejected_refs = set()
        self.counts = dict.fromkeys(self.KEYS, 0)
        # (in verify calls, with a verdict, back from the card, fresh from
        # which peers) a node
        self._nodes = []

    def watch(self, node) -> None:
        from collections import Counter

        counts, forged_refs, rejected = self.counts, self.forged_refs, self.forged_rejected_refs
        opened, verdicts, on_card, senders = Counter(), Counter(), Counter(), {}
        self._nodes.append((opened, verdicts, on_card, senders))
        decode_fresh, verify_accepted = node._decode_fresh, node._verify_accepted
        collector = node.block_verifier
        direct = collector._direct

        async def counted_decode(serialized_blocks, transit=None, peer=None):
            fresh = await decode_fresh(serialized_blocks, transit=transit, peer=peer)
            counts["received"] += len(serialized_blocks)
            counts["fresh"] += len(fresh)
            for block in fresh:
                senders.setdefault(block.reference, set()).add(peer)
            return fresh

        async def counted_verify(blocks):
            refs = [b.reference for b in blocks]
            counts["to_verify"] += len(blocks)
            opened.update(refs)
            accepted = await verify_accepted(blocks)
            opened.subtract(refs)
            verdicts.update(refs)
            kept = {b.reference for b in accepted}
            for ref in refs:
                if ref in forged_refs:
                    counts["forged"] += 1
                    counts["forged_rejected"] += ref not in kept
                    if ref not in kept:
                        rejected.add(ref)
                else:
                    counts["honest_rejected"] += ref not in kept
            return accepted

        async def counted_direct(blocks):
            out = await direct(blocks)
            on_card.update(b.reference for b in blocks)
            return out

        node._decode_fresh, node._verify_accepted = counted_decode, counted_verify
        collector._direct = counted_direct

    def settle(self) -> dict:
        """The counts at stop, with: ``on_card`` (blocks the card gave a
        verdict for), ``verdict_off_card`` (verdicts a node acted on that the
        card never gave), ``card_unclaimed`` (card verdicts that no open
        verify call explains), ``open_on_card`` / ``open_off_card`` (blocks
        in verify calls still open at stop, with and without the card's
        verdict back), ``on_card_twice`` (blocks the card verified twice
        for one node) and ``on_card_twice_one_peer`` (of those, blocks the
        card verified more often than peers sent them fresh: the
        per-connection dedup's misses)."""
        out = dict(self.counts, on_card=0, verdict_off_card=0, card_unclaimed=0,
                   open_on_card=0, open_off_card=0, on_card_twice=0, on_card_twice_one_peer=0)
        for opened, verdicts, on_card, senders in self._nodes:
            opened = +opened
            unacted = on_card - verdicts
            out["on_card"] += sum(on_card.values())
            out["verdict_off_card"] += sum((verdicts - on_card).values())
            out["card_unclaimed"] += sum((unacted - opened).values())
            out["open_on_card"] += sum((unacted & opened).values())
            out["open_off_card"] += sum((opened - unacted).values())
            out["on_card_twice"] += sum(1 for times in on_card.values() if times > 1)
            out["on_card_twice_one_peer"] += sum(
                1 for ref, times in on_card.items() if times > max(1, len(senders.get(ref, ()))))
        return out


def build_netsync_node(committee, signer, authority, tmp_dir, network, parameters, verifier,
                       metrics):
    """One validator as ``tests/test_net_sync_sim.py`` builds it (core,
    ``TestBlockHandler``, ``TestCommitObserver``, a WAL), its whole stack on
    ``metrics``, its own flight recorder, ``verifier`` as its block
    verifier."""
    from mysticeti_tpu_torch.block_handler import TestBlockHandler
    from mysticeti_tpu_torch.block_store import BlockStore
    from mysticeti_tpu_torch.commit_observer import TestCommitObserver
    from mysticeti_tpu_torch.core import Core, CoreOptions
    from mysticeti_tpu_torch.flight_recorder import FlightRecorder
    from mysticeti_tpu_torch.net_sync import NetworkSyncer
    from mysticeti_tpu_torch.wal import walf

    writer, reader = walf(os.path.join(tmp_dir, f"wal-{authority}"))
    recovered, observer_recovered = BlockStore.open(authority, reader, writer, committee,
                                                    metrics=metrics)
    handler = TestBlockHandler(last_transaction=authority * 1_000_000, committee=committee,
                               authority=authority, metrics=metrics)
    core = Core(block_handler=handler, authority=authority, committee=committee,
                parameters=parameters, recovered=recovered, wal_writer=writer,
                options=CoreOptions.test(), signer=signer, metrics=metrics)
    observer = TestCommitObserver(core.block_store, committee, metrics=metrics,
                                  recovered_state=observer_recovered)
    return NetworkSyncer(core, observer, network, parameters=parameters, block_verifier=verifier,
                         metrics=metrics, recorder=FlightRecorder(authority=authority))


def registries(metrics) -> list:
    """``metrics`` as a list: one shared ``Metrics``, or one a node."""
    return metrics if isinstance(metrics, list) else [metrics]


def summed_sample(metrics, name, labels=None):
    """``name``'s sample summed over ``registries(metrics)``; None where no
    registry holds it."""
    values = [m.registry.get_sample_value(name, labels) for m in registries(metrics)]
    values = [v for v in values if v is not None]
    return sum(values) if values else None


def netsync_result(nodes, counter, injector, metrics) -> dict:
    """What the net_sync checks and readings read off finished nodes: the
    committed sequences, own blocks, rounds, the forged copies in stores,
    the settled receive counts, the injected faults, the recorders' and the
    registries' invalid blocks, the signatures verified (every backend) and
    the collectors' dispatched lanes and flushes, read together with the
    counts, the frame caches' builds and reuses and the core queue's
    counters; then every node's WAL is closed.  ``metrics`` is the shared
    ``Metrics`` or a list of them, one a node."""
    forged_refs = injector.forged_refs

    def get(name, labels=None):
        return summed_sample(metrics, name, labels)

    invalid = {reason: sum(get("mysticeti_invalid_blocks_total",
                               {"authority": str(a), "reason": reason}) or 0.0
                           for a in range(len(nodes)))
               for reason in ("signature", "structure", "malformed")}
    recorded = [e for node in nodes for e in node.recorder.events()
                if e["kind"] == "invalid-block" and e.get("reason") == "signature"]
    result = {
        "sequences": [list(node.syncer.commit_observer.committed_leaders) for node in nodes],
        "own_blocks": [[b.reference for b in node.core.block_store.get_own_blocks(0, 1 << 30)]
                       for node in nodes],
        "rounds": [node.core.block_store.highest_round() for node in nodes],
        "forged_stored": sum(node.core.block_store.block_exists(ref)
                             for node in nodes for ref in forged_refs),
        "forged_injected": len(forged_refs), "redelivered": injector.redelivered,
        "invalid": invalid,
        "recorded_signature": sum(e.get("count", 1) for e in recorded),
        "recorder_dropped": sum(node.recorder.dropped for node in nodes),
        "frame_cache": {"builds": sum(node.frame_cache.builds for node in nodes),
                        "reuses": sum(node.frame_cache.reuses for node in nodes)},
        "core_lock": {"enqueued": get("core_lock_enqueued_total"),
                      "dequeued": get("core_lock_dequeued_total")},
        "missing_blocks": get("missing_blocks_total"),
        "on_backend": sum(sample.value for m in registries(metrics)
                          for family in m.verified_signatures_total.collect()
                          for sample in family.samples if sample.name.endswith("_total")),
        "dispatched": get("verify_dispatch_batch_size_sum") or 0.0,
        "flushes": get("verify_dispatch_batch_size_count") or 0.0, **counter.settle(),
    }
    for node in nodes:
        node.core.wal_writer.close()
        node.core.block_store.close()  # the WAL reader's mmap and descriptor
    return result


async def netsync_sim(n, tmp_dir, virtual_s, make_collector, fault_one_in, metrics):
    """``n`` ``NetworkSyncer``s of a ``Committee.new_for_benchmarks(n)``
    under the running deterministic loop, as ``tests/test_net_sync_sim.py``
    runs them: the port's ``SimulatedNetwork`` (50-100 ms one way), a 1 s
    leader timeout, each node's block verifier ``make_collector(committee)``,
    one shared ``metrics`` and a ``FaultInjector`` on the network.  Returns
    ``netsync_result``."""
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.config import Parameters
    from mysticeti_tpu_torch.simulated_network import SimulatedNetwork

    class NodeNetwork:
        """The ``TcpNetwork`` surface ``NetworkSyncer`` reads, over the sim."""

        def __init__(self, queue):
            self.connections = queue

        async def stop(self):
            pass

    committee = Committee.new_for_benchmarks(n)
    signers = Committee.benchmark_signers(n)
    parameters = Parameters(leader_timeout_s=CONSENSUS_LEADER_TIMEOUT_S)
    sim_net = SimulatedNetwork(n)
    injector = FaultInjector(asyncio.get_running_loop().rng, fault_one_in)
    sim_net.fault_injector = injector
    counter = ReceiveCounter(injector.forged_refs)
    nodes = []
    for a in range(n):
        node = build_netsync_node(committee, signers[a], a, tmp_dir,
                                  NodeNetwork(sim_net.node_connections[a]), parameters,
                                  make_collector(committee), metrics)
        counter.watch(node)
        nodes.append(node)
    for node in nodes:
        await node.start()
    await sim_net.connect_all()
    await asyncio.sleep(virtual_s)
    for node in nodes:
        await node.stop()
    sim_net.close()
    return netsync_result(nodes, counter, injector, metrics)


def netsync_run(kind, n, virtual_s, seed, backend=None, metrics=None):
    """One seeded simulation of ``netsync_sim`` in a temporary directory:
    ``kind`` "cuda-only" gives every node a collector over the one shared
    ``backend``; "cpu" the ``cpu`` kind's collector.  Returns the result
    with its wall seconds."""
    import tempfile

    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.validator import _make_verifier

    metrics = metrics if metrics is not None else Metrics()

    def make_collector(committee):
        if kind == "cpu":
            return _make_verifier("cpu", committee, metrics=metrics)
        check(kind == "cuda-only" and backend is not None, f"no backend for {kind}")
        return BatchedSignatureVerifier(committee, backend, metrics=metrics)

    with tempfile.TemporaryDirectory(prefix="netsync-") as d:
        t0 = time.monotonic()
        result = run_simulation(
            netsync_sim(n, d, virtual_s, make_collector, NETSYNC_FAULT_ONE_IN, metrics), seed=seed)
        result["wall_s"] = time.monotonic() - t0
    return result


def forged_checks(result) -> None:
    """Every forged copy that reached a verifier was rejected, counted under
    ``mysticeti_invalid_blocks_total{reason="signature"}`` and by the flight
    recorders, and is in no store; no honest block was rejected."""
    check(result["forged"] > 0, "no forged copy reached a verifier")
    check(result["forged_rejected"] == result["forged"],
          f"{result['forged'] - result['forged_rejected']} forged copies were accepted")
    check(result["invalid"]["signature"] == result["recorded_signature"] == result["forged"],
          f"forged copies verified {result['forged']}, counted invalid "
          f"{result['invalid']['signature']:.0f}, recorded {result['recorded_signature']}")
    check(result["recorder_dropped"] == 0, "a flight recorder dropped events")
    check(result["forged_stored"] == 0, "a forged block is in a node's store")
    check(result["honest_rejected"] == 0 and result["invalid"]["structure"] == 0
          and result["invalid"]["malformed"] == 0,
          f"honest blocks rejected: {result['honest_rejected']}, {result['invalid']}")


def card_checks(result) -> dict:
    """Every verdict a node acted on came back from the card for that node
    (none skipped the card), every card verdict a node did not act on
    belongs to a verify call still open at stop, and the signatures
    verified equal the collectors' dispatched lanes and the blocks back from
    the card; so the blocks sent to a verifier less those on the card are
    exactly the open calls' blocks with no card verdict yet (pending in a
    collector window, or in flight, at ``node.stop()``).  Returns the
    readings."""
    on_backend, dispatched, flushes = result["on_backend"], result["dispatched"], result["flushes"]
    check(result["verdict_off_card"] == 0,
          f"{result['verdict_off_card']} verdicts were acted on without the card's")
    check(result["card_unclaimed"] == 0,
          f"{result['card_unclaimed']} card verdicts belong to no open verify call")
    check(on_backend == dispatched == result["on_card"] <= result["fresh"],
          f"signatures on the verifier {on_backend:.0f}, dispatched {dispatched:.0f}, back from "
          f"the card {result['on_card']}, fresh blocks {result['fresh']}")
    check(result["to_verify"] - result["on_card"] == result["open_off_card"],
          f"{result['to_verify']} blocks sent to a verifier, {result['on_card']} back from the "
          f"card, {result['open_off_card']} in open verify calls without a card verdict")
    return {"on_backend": on_backend, "flushes": flushes,
            "mean_live_lanes": dispatched / flushes if flushes else 0.0,
            "open_at_stop": {"on_card": result["open_on_card"],
                             "off_card": result["open_off_card"]},
            "dedup_saved": result["received"] - result["to_verify"],
            "dedup_saved_by": {"processed": result["received"] - result["fresh"],
                               "inflight": result["fresh"] - result["to_verify"]}}


def netsync_checks(card, cpu, min_commits) -> dict:
    """Checks 1-4 of netsync-50 on the card run and the ``cpu`` run of the
    same seed (with ``cpu`` None, the whole script, the comparison is left
    to ``NETSYNC_SEEDED``); returns the readings they share."""
    commits = commit_checks(card["sequences"], min_commits)
    forged_checks(card)
    if cpu is not None:
        check(card["sequences"] == cpu["sequences"],
              "the committed sequences differ from the cpu run's")
        check(card["own_blocks"] == cpu["own_blocks"], "the own blocks differ from the cpu run's")
    return {"commits_min": min(commits), "commits_max": max(commits),
            "rounds_min": min(card["rounds"]), "rounds_max": max(card["rounds"]),
            "blocks_received": card["received"], "fresh": card["fresh"],
            "to_verify": card["to_verify"], "forged": card["forged"],
            "forged_injected": card["forged_injected"], "forged_rejected": card["forged_rejected"],
            "redelivered": card["redelivered"], "frame_cache": card["frame_cache"],
            "core_lock": card["core_lock"], "missing_blocks": card["missing_blocks"]}


def netsync_signatures(metrics, result) -> dict:
    """Check 6: ``card_checks``, and the dedup kept the re-deliveries off
    the card: some re-delivered blocks arrived and were dropped before a
    verifier, and the card verified no block twice for one node."""
    reading = dict(card_checks(result), stage_seconds=stage_seconds(metrics))
    check(result["redelivered"] > 0 and reading["dedup_saved"] > 0,
          f"no re-delivery was kept off the verifier: {result['redelivered']} re-delivered, "
          f"{reading['dedup_saved']} dropped")
    check(result["on_card_twice"] == 0,
          f"the card verified {result['on_card_twice']} blocks twice for one node")
    return reading


def stage_seconds(metrics) -> dict:
    """The collectors' pack, device and fetch stage seconds: sum and count
    (over a list of ``Metrics`` where each node has its own)."""
    return {stage: {"sum_s": summed_sample(metrics, "verify_pipeline_stage_seconds_sum",
                                           {"stage": stage}),
                    "count": summed_sample(metrics, "verify_pipeline_stage_seconds_count",
                                           {"stage": stage})}
            for stage in ("pack", "device", "fetch")}


async def netsync_tcp(n, tmp_dir, run, make_collector, metrics, on_ready=None):
    """``n`` ``NetworkSyncer``s of a ``Committee.new_for_benchmarks(n)``
    over the port's ``TcpNetwork`` on 127.0.0.1, on the running (real)
    event loop, each with its own ``make_collector(committee)`` and one
    shared ``metrics``, every connection's sends wrapped by a
    ``FaultInjector`` (one forged copy before one block-carrying message in
    ``NETSYNC_FAULT_ONE_IN``), while ``run(nodes)`` is awaited.
    ``on_ready()`` runs once every collector has warmed up, just before the
    nodes start.  Returns ``netsync_result`` with the wall seconds and
    commits a wall second."""
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.config import Parameters
    from mysticeti_tpu_torch.network import TcpNetwork

    committee = Committee.new_for_benchmarks(n)
    signers = Committee.benchmark_signers(n)
    parameters = Parameters(leader_timeout_s=CONSENSUS_LEADER_TIMEOUT_S)
    collectors = [make_collector(committee) for _ in range(n)]
    loop = asyncio.get_running_loop()
    for collector in collectors:  # the accelerator kinds warm up in a thread
        ready = getattr(collector, "ready", None)
        if ready is not None:
            await loop.run_in_executor(None, ready.wait)
    if on_ready is not None:
        on_ready()
    injector = FaultInjector(random.Random(SEED), NETSYNC_FAULT_ONE_IN)
    counter = ReceiveCounter(injector.forged_refs)
    # Each endpoint listens on a port of the kernel's choosing, written into
    # the shared address list as it comes up; the dialers read the list on
    # every attempt and retry until their peer is listening.
    addresses = [("127.0.0.1", 0)] * n
    nodes = []
    for a in range(n):
        network = await TcpNetwork.start(a, addresses, metrics)
        addresses[a] = ("127.0.0.1", network._server.sockets[0].getsockname()[1])
        node = build_netsync_node(committee, signers[a], a, tmp_dir,
                                  ForgingNetwork(network, injector), parameters, collectors[a],
                                  metrics)
        counter.watch(node)
        nodes.append(node)
    t0 = time.monotonic()
    for node in nodes:
        await node.start()
    await run(nodes)
    elapsed = time.monotonic() - t0
    for node in nodes:
        await node.stop()
    result = netsync_result(nodes, counter, injector, metrics)
    result["wall_s"] = elapsed
    result["commits_per_wall_s"] = (
        sum(len(seq) for seq in result["sequences"]) / n / elapsed)
    return result


def netsync_tcp_checks(result, min_commits) -> dict:
    """Checks 1-3 of netsync-tcp-10."""
    commits = commit_checks(result["sequences"], min_commits)
    forged_checks(result)
    return {"commits_min": min(commits), "commits_max": max(commits),
            "rounds_min": min(result["rounds"]), "rounds_max": max(result["rounds"]),
            "blocks_received": result["received"], "fresh": result["fresh"],
            "to_verify": result["to_verify"], "forged": result["forged"],
            "forged_injected": result["forged_injected"],
            "forged_rejected": result["forged_rejected"], "frame_cache": result["frame_cache"],
            "core_lock": result["core_lock"], "missing_blocks": result["missing_blocks"],
            "wall_s": result["wall_s"], "commits_per_wall_s": result["commits_per_wall_s"]}


def net_sync_phase(kernels, control=True):
    """The net_sync phase: netsync-50 over the card and over the ``cpu``
    kind, then netsync-tcp-10 (see the module docstring, step 12).  Returns
    the launches of each part and the readings.  ``control`` False (the
    whole script) skips netsync-50's ``cpu`` run: ``NETSYNC_SEEDED`` alone
    holds the card."""
    import tempfile

    from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.validator import _make_verifier

    n, virtual_s, seed = COMMITTEE, CONSENSUS_VIRTUAL_S, SEED
    committee = Committee.new_for_benchmarks(n)
    backend = TorchSignatureVerifier(committee_keys=committee.public_key_bytes())
    backend.warmup()  # the kernels' first launches and the combs' upload
    metrics = Metrics()
    for k in kernels:
        k.reset_counts()
    card = netsync_run("cuda-only", n, virtual_s, seed, backend=backend, metrics=metrics)
    launches = {k.name: k.launches for k in kernels}
    cpu = netsync_run("cpu", n, virtual_s, seed) if control else None
    reading = netsync_checks(card, cpu, CONSENSUS_MIN_COMMITS)
    counts = seeded_counts(card, NETSYNC_KEYS)
    check(counts == NETSYNC_SEEDED, f"the counts differ from the seeded ones: {counts}")
    check(launches["prologue"] > 0 and launches["verify_keyed"] > 0,
          f"the net_sync path did not take the prologue and the keyed kernel: {launches}")
    check(launches["verify_generic"] == 0, f"the net_sync path launched the generic kernel: {launches}")
    signatures = netsync_signatures(metrics, card)
    reading.update({
        "committee": n, "virtual_s": virtual_s, "seed": seed, "card_wall_s": card["wall_s"],
        "cpu_wall_s": cpu and cpu["wall_s"], "signatures_on_card": signatures.pop("on_backend"),
        **signatures, "launches": launches, "card": card_line()})
    print(f"net_sync netsync-50: {n} authorities, {virtual_s} virtual s, rounds "
          f"{reading['rounds_min']}-{reading['rounds_max']}, commits a node "
          f"{reading['commits_min']}-{reading['commits_max']}, prefixes agree and equal "
          f"{control_text(cpu)}the seeded counts; {card['received']} blocks received, "
          f"{card['fresh']} fresh, "
          f"{reading['signatures_on_card']:.0f} verified on the card, open at stop "
          f"{reading['open_at_stop']}; {card['redelivered']} blocks re-delivered, the dedup "
          f"saved {reading['dedup_saved']} {reading['dedup_saved_by']}; {card['forged']} forged copies verified "
          f"({card['forged_injected']} injected), all rejected and counted; "
          f"{reading['flushes']:.0f} flushes, {reading['mean_live_lanes']:.2f} live "
          f"lanes a flush; core queue {card['core_lock']}, missing {card['missing_blocks']}, "
          f"frame cache {card['frame_cache']}; {card['wall_s']:.1f} s on the card, "
          f"{control_seconds(cpu)}; launches {launches} [{reading['card']}]",
          flush=True)

    # Each node's verifier warms up (one unknown-key batch on the generic
    # kernel, one batch a key) before the counts are set to 0.
    tcp_metrics = Metrics()
    with tempfile.TemporaryDirectory(prefix="netsync-tcp-") as d:
        tcp = asyncio.run(netsync_tcp(
            NETSYNC_TCP_NODES, d, lambda nodes: asyncio.sleep(NETSYNC_TCP_WALL_S),
            lambda c: _make_verifier("cuda-only", c, metrics=tcp_metrics), tcp_metrics,
            on_ready=lambda: [k.reset_counts() for k in kernels]))
    tcp_launches = {k.name: k.launches for k in kernels}
    tcp_reading = netsync_tcp_checks(tcp, NETSYNC_TCP_MIN_COMMITS)
    tcp_card = dict(card_checks(tcp), stage_seconds=stage_seconds(tcp_metrics))
    stages = tcp_card["stage_seconds"]
    tcp_reading.update({
        "nodes": NETSYNC_TCP_NODES, "signatures_verified": tcp_card.pop("on_backend"),
        **tcp_card, "launches": tcp_launches, "card": card_line()})
    print(f"net_sync netsync-tcp-10: {NETSYNC_TCP_NODES} validators over loopback for "
          f"{tcp['wall_s']:.1f} wall s, rounds {tcp_reading['rounds_min']}-"
          f"{tcp_reading['rounds_max']}, commits a node {tcp_reading['commits_min']}-"
          f"{tcp_reading['commits_max']} ({tcp['commits_per_wall_s']:.2f} a wall second), prefixes "
          f"agree; {tcp['received']} blocks received, {tcp['fresh']} fresh, "
          f"{tcp_reading['signatures_verified']:.0f} verified on the card, open at stop "
          f"{tcp_reading['open_at_stop']}; {tcp['forged']} forged copies verified "
          f"({tcp['forged_injected']} injected), all rejected and counted; "
          f"{tcp_reading['flushes']:.0f} flushes, {tcp_reading['mean_live_lanes']:.2f} live lanes "
          f"a flush; stage seconds {stages}; core queue {tcp['core_lock']}, missing "
          f"{tcp['missing_blocks']}, frame cache {tcp['frame_cache']}; launches {tcp_launches} "
          f"[{tcp_reading['card']}]", flush=True)
    check((stages["device"]["count"] or 0) > 0 and (stages["device"]["sum_s"] or 0) > 0,
          f"no dispatch took the collector's executor path: {stages}")
    check(tcp_launches["verify_keyed"] > 0 and tcp_launches["verify_generic"] == 0,
          f"the net_sync_tcp path did not take only the keyed kernel: {tcp_launches}")
    return launches, tcp_launches, {"netsync_50": reading, "netsync_tcp_10": tcp_reading}


class CommitLog:
    """Every node's committed anchors by height, across restarts: a height
    seen again (a WAL replay) keeps its anchor, heights are contiguous
    except wholly below an adopted snapshot baseline, and every node commits
    the same anchor at every height it shares with another (the JAX
    package's ``chaos.SafetyChecker`` on commits)."""

    def __init__(self) -> None:
        self.anchors = {}
        self.adopted = {}  # authority -> (height, anchor, floor) of its snapshot baseline
        self.violations = []

    def note(self, authority, height, anchor) -> None:
        mine = self.anchors.setdefault(authority, {})
        prev = mine.setdefault(height, anchor)
        if prev != anchor:
            self.violations.append((authority, height, prev, anchor))

    def observer_class(self, base):
        """``base`` (a ``TestCommitObserver``) feeding this log."""
        log = self

        class Observer(base):
            def handle_commit(self, committed_leaders):
                committed = super().handle_commit(committed_leaders)
                for commit in committed:
                    log.note(self.logged_authority, commit.height, commit.anchor)
                return committed

            def adopt_snapshot(self, manifest):
                super().adopt_snapshot(manifest)
                log.adopted[self.logged_authority] = (manifest.commit_height,
                                                      manifest.last_committed_leader,
                                                      manifest.gc_round)
                log.note(self.logged_authority, manifest.commit_height,
                         manifest.last_committed_leader)

        return Observer

    def sequences(self, n) -> list:
        """Each node's anchors in height order, checked for contiguity (a
        gap only wholly below its adopted baseline) and for agreement across
        nodes at every shared height."""
        check(not self.violations, f"a node committed two anchors at one height: "
                                   f"{self.violations[:2]}")
        golden, out = {}, []
        for a in range(n):
            mine = self.anchors.get(a, {})
            baseline = self.adopted.get(a, (0, None))[0]
            expect = 1
            for height in sorted(mine):
                check(height == expect or height - 1 <= baseline,
                      f"node {a} has a commit gap at height {expect}")
                expect = height + 1
                check(golden.setdefault(height, mine[height]) == mine[height],
                      f"the nodes fork at height {height}")
            out.append([mine[h] for h in sorted(mine)])
        return out


def build_storage_node(committee, signer, authority, wal_path, network, parameters, verifier,
                       metrics, recorder, observer_class):
    """One validator as the JAX package's ``chaos.ChaosSimHarness`` boots
    it: ``open_store`` on its WAL directory, a ``Core`` over the storage
    lifecycle, a ``TestBlockHandler``, ``observer_class`` (a
    ``TestCommitObserver``), ``verifier`` as its block verifier, and the
    ``metrics`` and ``recorder`` that outlive its restarts."""
    from mysticeti_tpu_torch.block_handler import TestBlockHandler
    from mysticeti_tpu_torch.core import Core, CoreOptions
    from mysticeti_tpu_torch.net_sync import NetworkSyncer
    from mysticeti_tpu_torch.storage import open_store

    recovered, observer_recovered, wal_writer, lifecycle = open_store(
        authority, wal_path, committee, parameters, metrics)
    handler = TestBlockHandler(last_transaction=authority * 1_000_000, committee=committee,
                               authority=authority)
    core = Core(block_handler=handler, authority=authority, committee=committee,
                parameters=parameters, recovered=recovered, wal_writer=wal_writer,
                options=CoreOptions.test(), signer=signer, metrics=metrics, storage=lifecycle)
    observer = observer_class(core.block_store, committee, recovered_state=observer_recovered)
    observer.logged_authority = authority
    lifecycle.recorder = recorder
    return NetworkSyncer(core, observer, network, parameters=parameters, block_verifier=verifier,
                         metrics=metrics, recorder=recorder)


class SnapshotWatch:
    """Forges a copy of the last block of the first snapshot chunk a node
    sends (delivered just ahead of that chunk), and records the snapshot
    streams: the chunks and the blocks sent."""

    def __init__(self, injector: FaultInjector) -> None:
        self.injector = injector
        self.forged = None  # the forged copy's reference
        self.streamed = set()
        self.chunks = 0

    def disseminators(self, node):
        """A ``_disseminators`` map for ``node`` that wraps each
        disseminator's snapshot chunk send as it is registered."""
        watch = self

        class Wrapping(dict):
            def __setitem__(self, peer, disseminator):
                watch._wrap(disseminator)
                super().__setitem__(peer, disseminator)

        return Wrapping(node._disseminators)

    def _wrap(self, disseminator) -> None:
        from mysticeti_tpu_torch.network import Blocks
        from mysticeti_tpu_torch.types import StatementBlock

        send_chunk = disseminator._send_snapshot_chunk

        async def watched(chunk):
            if self.forged is None:
                raw = forged_copy(bytes(chunk[-1]), self.injector.rng)
                self.forged = StatementBlock.from_bytes(raw).reference
                self.injector.forged_refs.add(self.forged)
                await disseminator.connection.send(Blocks((raw,)))
            self.chunks += 1
            self.streamed.update(StatementBlock.from_bytes(bytes(raw)).reference
                                 for raw in chunk)
            await send_chunk(chunk)

        disseminator._send_snapshot_chunk = watched


class SimFleet:
    """``config``'s fleet under the running deterministic loop, as the JAX
    package's ``chaos.ChaosSimHarness`` runs it: ``config["n"]`` validators
    of a ``Committee.new_for_benchmarks`` on ``parameters``, each built by
    ``build_storage_node`` over the port's ``SimulatedNetwork``, with a
    ``FaultInjector`` on the network, a ``SnapshotWatch`` and a
    ``ReceiveCounter`` on every node and a ``CommitLog`` behind every
    observer; each node's block verifier is ``make_collector(committee,
    authority, metrics)``, a fresh one for every incarnation, and each
    node's ``Metrics`` (``metrics``, else new ones) and flight recorder
    outlive its restarts.  ``config["crashes"]`` (node, at_s, downtime_s,
    torn bytes) stop a node, close its WAL writer and block store and tear
    its active segment, and rebuild it from its directory after the
    downtime; ``config.get("retire", ())`` (at_s, node) stop a node for good
    (its store stays open for the readings at the end).  ``on_build(a,
    node)`` sees every incarnation before it starts, ``on_stop(a, node)``
    every crash and retirement before the node stops."""

    def __init__(self, config, tmp_dir, make_collector, parameters, metrics=None,
                 on_build=None, on_stop=None) -> None:
        from mysticeti_tpu_torch.commit_observer import TestCommitObserver
        from mysticeti_tpu_torch.committee import Committee
        from mysticeti_tpu_torch.flight_recorder import FlightRecorder
        from mysticeti_tpu_torch.metrics import Metrics
        from mysticeti_tpu_torch.simulated_network import SimulatedNetwork

        n = config["n"]
        self.config, self.tmp_dir, self.parameters = config, tmp_dir, parameters
        self.make_collector, self.on_build, self.on_stop = make_collector, on_build, on_stop
        self.committee = Committee.new_for_benchmarks(n)
        self.signers = Committee.benchmark_signers(n)
        self.loop = asyncio.get_running_loop()
        self.sim_net = SimulatedNetwork(n)
        self.injector = FaultInjector(self.loop.rng, config["fault_one_in"])
        self.sim_net.fault_injector = self.injector
        self.counter = ReceiveCounter(self.injector.forged_refs)
        self.watch = SnapshotWatch(self.injector)
        self.commits = CommitLog()
        self.observer_class = self.commits.observer_class(TestCommitObserver)
        self.metrics = metrics if metrics is not None else [Metrics() for _ in range(n)]
        self.recorders = [FlightRecorder(authority=a) for a in range(n)]
        self.nodes, self.served, self.retired = [None] * n, [0] * n, {}
        self.flushes = []  # (authority, virtual time, wall time, block references) a flush
        self.events = []  # (kind, authority, virtual time, wall time, height, highest round) a fault

    def wal_path(self, a) -> str:
        return os.path.join(self.tmp_dir, f"wal-{a}")

    def build_node(self, a, network, collector):
        """Node ``a``'s stack over ``network`` with ``collector`` as its
        block verifier: ``build_storage_node``."""
        return build_storage_node(self.committee, self.signers[a], a, self.wal_path(a), network,
                                  self.parameters, collector, self.metrics[a], self.recorders[a],
                                  self.observer_class)

    def build(self, a):
        """Node ``a``'s next incarnation, booted from its directory."""

        class NodeNetwork:
            def __init__(self, queue):
                self.connections = queue

            async def stop(self):
                pass

        collector = self.make_collector(self.committee, a, self.metrics[a])
        node = self.build_node(a, NodeNetwork(self.sim_net.node_connections[a]), collector)
        node._disseminators = self.watch.disseminators(node)
        self.counter.watch(node)
        direct, loop, flushes = collector._direct, self.loop, self.flushes

        async def timed(blocks):
            out = await direct(blocks)
            flushes.append((a, loop.time(), time.monotonic(), [b.reference for b in blocks]))
            return out

        collector._direct = timed
        if self.on_build is not None:
            self.on_build(a, node)
        self.nodes[a] = node
        return node

    def inject(self, via, payload: bytes) -> None:
        """Plant a transaction on ``via``'s block handler: it rides the
        node's next own proposal."""
        self.nodes[via].core.block_handler.inject(payload)

    async def _schedule(self) -> None:
        from mysticeti_tpu_torch.storage import active_wal_file

        config, loop = self.config, self.loop
        plan = sorted([(at, "crash", a, torn) for a, at, _down, torn in config["crashes"]]
                      + [(at + down, "restart", a, 0) for a, at, down, _ in config["crashes"]]
                      + [(at, "retire", a, 0) for at, a in config.get("retire", ())])
        for t, kind, a, torn in plan:
            if t > loop.time():
                await asyncio.sleep(t - loop.time())
            node = self.nodes[a]
            self.events.append((kind, a, loop.time(), time.monotonic(),
                                max(self.commits.anchors.get(a, {0: 0})),
                                node.core.block_store.highest_round() if node else None))
            if kind == "restart":
                await self.build(a).start()
                await self.sim_net.restart(a)
                continue
            self.nodes[a] = None
            self.sim_net.crash(a)
            if self.on_stop is not None:
                self.on_stop(a, node)
            await node.stop()
            self.served[a] += snapshot_served(node)
            if kind == "retire":
                self.retired[a] = node
                continue
            node.core.wal_writer.close()
            node.core.block_store.close()
            target = active_wal_file(self.wal_path(a))
            with open(target, "r+b") as f:
                f.truncate(max(0, os.path.getsize(target) - torn))

    async def run(self, workload=None) -> None:
        """Start every node, run the fault schedule and ``workload(self)`` for
        ``config["virtual_s"]``, then stop every node."""
        for a in range(self.config["n"]):
            await self.build(a).start()
        await self.sim_net.connect_all()
        tasks = [asyncio.ensure_future(self._schedule())]
        if workload is not None:
            tasks.append(asyncio.ensure_future(workload(self)))
        await asyncio.sleep(self.config["virtual_s"])
        for task in tasks:
            task.cancel()
        for node in self.nodes:
            if node is not None:
                await node.stop()
        self.sim_net.close()
        for a, node in enumerate(self.nodes):
            if node is not None:
                self.served[a] += snapshot_served(node)

    def verify_readings(self) -> dict:
        """What ``forged_checks`` and ``card_checks`` read off the finished
        fleet: the forged copies injected and in a live or retired node's
        store, the re-deliveries, the registries' invalid blocks by reason
        and verified signatures, the flight recorders' signature rejections
        and drops, the collectors' dispatched lanes and flushes, and the
        settled receive counts."""
        metrics, recorders, injector = self.metrics, self.recorders, self.injector
        nodes = [node for node in [*self.nodes, *self.retired.values()] if node is not None]
        recorded = [e for r in recorders for e in r.events()
                    if e["kind"] == "invalid-block" and e.get("reason") == "signature"]

        def total(name):
            return sum(m.registry.get_sample_value(name) or 0.0 for m in metrics)

        return {
            "forged_stored": sum(node.core.block_store.block_exists(ref)
                                 for node in nodes for ref in injector.forged_refs),
            "forged_injected": len(injector.forged_refs), "redelivered": injector.redelivered,
            "invalid": {reason: sum(sample.value for m in metrics
                                    for family in m.mysticeti_invalid_blocks_total.collect()
                                    for sample in family.samples
                                    if sample.name.endswith("_total")
                                    and sample.labels["reason"] == reason)
                        for reason in ("signature", "structure", "malformed")},
            "recorded_signature": sum(e.get("count", 1) for e in recorded),
            "recorder_dropped": sum(r.dropped for r in recorders),
            "on_backend": sum(sample.value for m in metrics
                              for family in m.verified_signatures_total.collect()
                              for sample in family.samples if sample.name.endswith("_total")),
            "dispatched": total("verify_dispatch_batch_size_sum"),
            "flushes": total("verify_dispatch_batch_size_count"),
            **self.counter.settle(),
        }

    def close(self) -> None:
        """Close every last incarnation's WAL writer and block store."""
        for node in [*self.nodes, *self.retired.values()]:
            if node is not None:
                node.core.wal_writer.close()
                node.core.block_store.close()


async def storage_sim(config, tmp_dir, make_collector):
    """``config``'s fleet (``STORAGE_10``'s shape) as a ``SimFleet`` with the
    storage lifecycle on.  Returns ``storage_result``."""
    from mysticeti_tpu_torch.config import Parameters, StorageParameters

    parameters = Parameters(leader_timeout_s=CONSENSUS_LEADER_TIMEOUT_S,
                            storage=StorageParameters(**config["storage"]))
    fleet = SimFleet(config, tmp_dir, make_collector, parameters)
    await fleet.run()
    return storage_result(fleet)


def snapshot_served(node) -> int:
    """Snapshot blocks ``node`` has sent: on connections gone and live."""
    return node.snapshot_blocks_served + sum(
        d.snapshot_blocks_sent for d in node._disseminators.values())


def storage_result(fleet) -> dict:
    """What the storage checks and readings read off the finished fleet:
    the committed sequences and adopted baselines, each node's storage
    readings (its lifecycle's boot and adoption counts, WAL bytes written
    and live, first live offset, checkpoint files, reclaimed bytes,
    recoveries), the snapshot blocks served, the settled receive counts, the
    forged copies, the registries' invalid blocks and verified signatures,
    and the flushes in and out of the rejoiner's catch-up; then every
    node's WAL is closed."""
    from mysticeti_tpu_torch.storage import checkpoint_files

    config, nodes, commits, counter = fleet.config, fleet.nodes, fleet.commits, fleet.counter
    watch, metrics = fleet.watch, fleet.metrics
    flushes, events, served = fleet.flushes, fleet.events, fleet.served
    n, rejoiner = config["n"], config["rejoiner"]
    per_node = []
    for a, node in enumerate(nodes):
        lifecycle, writer = node.core.storage, node.core.wal_writer
        get = metrics[a].registry.get_sample_value
        per_node.append({
            "snapshots_adopted": lifecycle.snapshots_adopted,
            "recovered_checkpoint_height": lifecycle.recovered_checkpoint_height,
            "replay_start": lifecycle.replay_start, "replayed_bytes": lifecycle.replayed_bytes,
            "commit_height": lifecycle.commit_height, "retired_round": lifecycle.retired_round,
            "wal_written": writer.position(), "wal_live": writer.size_bytes(),
            "first_base": writer.first_base(),
            "checkpoint_files": len(checkpoint_files(lifecycle.directory)),
            "reclaimed": get("wal_reclaimed_bytes_total") or 0.0,
            "checkpoint_index": get("checkpoint_last_commit_index") or 0.0,
            "recoveries": get("crash_recovery_total") or 0.0, "served": served[a],
        })
    restart = next(e for e in events if e[0] == "restart" and e[1] == rejoiner)
    crash = next(e for e in events if e[0] == "crash" and e[1] == rejoiner)
    # The rejoiner's catch-up: from its restart to its last flush holding a
    # block of the snapshot stream.
    rejoined = [f for f in flushes if f[0] == rejoiner and f[1] >= restart[2]]
    streamed = [f for f in rejoined if watch.streamed.intersection(f[3])]
    end = streamed[-1] if streamed else None
    in_catchup = [f for f in rejoined if end is not None and f[1] <= end[1]]
    crashed = {a for a, *_ in config["crashes"]}
    steady = [f for f in flushes if f[0] not in crashed]
    result = {
        "sequences": commits.sequences(n), "adopted": commits.adopted, "nodes": per_node,
        "crashed_at_height": crash[4], "crashed_at_round": crash[5],
        "snapshot_chunks": watch.chunks,
        "snapshot_blocks": len(watch.streamed),
        "snapshot_forged_rejected": int(watch.forged is not None
                                        and watch.forged in counter.forged_rejected_refs),
        "catchup": {"flushes": len(in_catchup),
                    "lanes": sum(len(f[3]) for f in in_catchup),
                    "virtual_s": end[1] - restart[2] if end else None,
                    "wall_s": end[2] - restart[3] if end else None},
        "steady": {"flushes": len(steady), "lanes": sum(len(f[3]) for f in steady)},
        **fleet.verify_readings(),
    }
    fleet.close()
    return result


def storage_run(kind, config, backend=None, inspect=None) -> dict:
    """One seeded simulation of ``storage_sim`` in a temporary directory:
    ``kind`` "cuda-only" gives every node's every incarnation a collector
    over the one shared ``backend``; "cpu" the ``cpu`` kind's collector.
    Returns the result with its wall seconds and, with ``inspect``, what
    ``inspect(directory, config)`` returned over the closed WALs before the
    directory goes (``result["wal_inspect"]``)."""
    import tempfile

    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.validator import _make_verifier

    def make_collector(committee, authority, metrics):
        if kind == "cpu":
            return _make_verifier("cpu", committee, metrics=metrics)
        check(kind == "cuda-only" and backend is not None, f"no backend for {kind}")
        return BatchedSignatureVerifier(committee, backend, metrics=metrics)

    with tempfile.TemporaryDirectory(prefix="storage-") as d:
        t0 = time.monotonic()
        result = run_simulation(storage_sim(config, d, make_collector), seed=config["seed"])
        result["wall_s"] = time.monotonic() - t0
        if inspect is not None:
            result["wal_inspect"] = inspect(d, config)
    return result


def wal_inspect_run(tmp_dir, config) -> dict:
    """Step 22 on storage-10: ``tools.wal_inspect --json`` as a child over
    node 0's WAL and the rejoiner's: name -> ((exit code, stdout, stderr),
    seconds)."""
    return {name: run_tool("tools.wal_inspect", os.path.join(tmp_dir, f"wal-{a}"), "--json")
            for name, a in (("node0", 0), ("rejoiner", config["rejoiner"]))}


def wal_inspect_checks(inspected, adopted_height) -> dict:
    """Each WAL inspected healthy (exit 0): segmented, a valid checkpoint at
    or above its first live segment, blocks in its census; the rejoiner's
    checkpoints all lie at or above the height of the snapshot it adopted
    (``adopted_height``): what its WAL replays starts from that baseline.
    (The adoption's own snapshot entry is garbage-collected with its segment
    before the run ends.)  Returns each WAL's readings."""
    readings = {}
    for name, ((rc, out, err), seconds) in inspected.items():
        check(rc == 0, f"wal_inspect over {name}'s WAL exited {rc}: {out[-1500:]}{err[-1500:]}")
        doc = json.loads(out)
        valid = [c for c in doc["checkpoints"] if c.get("valid") and "stale" not in c]
        check(doc["layout"] == "segmented" and valid and not doc["problems"],
              f"wal_inspect over {name}'s WAL: layout {doc['layout']}, checkpoints "
              f"{doc['checkpoints']}, problems {doc['problems']}")
        check(doc["census"].get("block", {}).get("entries", 0) > 0,
              f"wal_inspect over {name}'s WAL counts no block: {doc['census']}")
        readings[name] = {"segments": len(doc["segments"]), "checkpoints": len(valid),
                          "checkpoint_heights": [c["commit_height"] for c in valid],
                          "census": {tag: row["entries"] for tag, row in doc["census"].items()},
                          "torn_tail_bytes": doc.get("torn_tail_bytes", 0), "seconds": seconds}
    heights = readings["rejoiner"]["checkpoint_heights"]
    check(min(heights) >= adopted_height,
          f"the rejoiner's checkpoints {heights} lie below its adopted snapshot's height "
          f"{adopted_height}")
    return readings


def storage_counts(result) -> dict:
    """The integers a seeded run must reproduce on any host and backend."""
    keys = ("received", "fresh", "to_verify", "forged", "forged_rejected", "forged_injected",
            "redelivered", "snapshot_chunks", "snapshot_blocks", "on_card")
    return {"commits": [len(seq) for seq in result["sequences"]],
            "flushes": int(result["flushes"]), "dispatched": int(result["dispatched"]),
            "catchup_flushes": result["catchup"]["flushes"],
            "catchup_lanes": result["catchup"]["lanes"],
            **{key: result[key] for key in keys},
            **{key: [node[key] for node in result["nodes"]] for key in (
                "commit_height", "retired_round", "wal_written", "replayed_bytes")}}


def storage_checks(card, cpu, config) -> dict:
    """The storage phase's checks on the card run and the ``cpu`` run of the
    same seed (see the module docstring, step 13); returns the readings.
    With ``cpu`` None (the whole script) the card is held to
    ``STORAGE_SEEDED`` alone."""
    from mysticeti_tpu_torch.storage import CHECKPOINT_KEEP

    if cpu is not None:
        check(card["sequences"] == cpu["sequences"],
              "the committed sequences differ from the cpu run's")
        check(storage_counts(card) == storage_counts(cpu),
              f"the counts differ from the cpu run's: {storage_counts(card)} vs "
              f"{storage_counts(cpu)}")
    rejoiner, rebooter = config["rejoiner"], config["rebooter"]
    threshold = config["storage"]["catchup_threshold_commits"]
    nodes = card["nodes"]
    check(nodes[rejoiner]["snapshots_adopted"] == 1
          and sum(node["snapshots_adopted"] for node in nodes) == 1,
          f"snapshots adopted: {[node['snapshots_adopted'] for node in nodes]}")
    adopted_height, _, floor = card["adopted"][rejoiner]
    check(floor > card["crashed_at_round"],
          f"the snapshot's floor (round {floor}) is not above node {rejoiner}'s last stored round "
          f"({card['crashed_at_round']}): its history was not GC'd")
    crashed_at = card["crashed_at_height"]
    check(adopted_height > crashed_at + threshold // 2,
          f"node {rejoiner} resumed at height {adopted_height}, crashed at {crashed_at}")
    final = nodes[rejoiner]["commit_height"]
    check(final > adopted_height + config["commits_after_rejoin"],
          f"node {rejoiner} committed up to {final} after adopting {adopted_height}")
    boot = nodes[rebooter]
    check(boot["recovered_checkpoint_height"] > 0 and boot["replay_start"] > 0
          and boot["replayed_bytes"] * 5 < boot["wal_written"],
          f"node {rebooter} did not boot from a checkpoint replaying < 1/5 of its WAL: {boot}")
    for a, node in enumerate(nodes):
        check(node["first_base"] > 0 and node["reclaimed"] > 0 and node["checkpoint_index"] > 0,
              f"node {a} reclaimed no segment or wrote no checkpoint: {node}")
        check(node["checkpoint_files"] == CHECKPOINT_KEEP,
              f"node {a} keeps {node['checkpoint_files']} checkpoint files")
    recoveries = [node["recoveries"] for node in nodes]
    check(recoveries == [float(sum(c[0] == a for c in config["crashes"]))
                         for a in range(config["n"])], f"recoveries {recoveries}")
    served = sum(node["served"] for node in nodes)
    check(served > 0 and card["snapshot_blocks"] > 0, "no snapshot block was served")
    forged_checks(card)
    check(card["snapshot_forged_rejected"] == 1,
          "the forged copy ahead of the snapshot stream was not verified and rejected")
    catchup, steady = card["catchup"], card["steady"]
    check(catchup["flushes"] > 0, "the rejoiner verified no snapshot block")
    return {
        "nodes": config["n"], "virtual_s": config["virtual_s"], "seed": config["seed"],
        "commits": [len(seq) for seq in card["sequences"]],
        "rejoiner": {"crashed_at_height": crashed_at, "crashed_at_round": card["crashed_at_round"],
                     "adopted_height": adopted_height, "adopted_floor": floor,
                     "final_height": final},
        "rebooter": {key: boot[key] for key in (
            "recovered_checkpoint_height", "replay_start", "replayed_bytes", "wal_written")},
        "snapshot": {"served": served, "chunks": card["snapshot_chunks"],
                     "blocks": card["snapshot_blocks"]},
        "forged": card["forged"], "forged_injected": card["forged_injected"],
        "forged_rejected": card["forged_rejected"],
        "snapshot_forged_rejected": card["snapshot_forged_rejected"],
        "catchup": dict(catchup, mean_live_lanes=(
            catchup["lanes"] / catchup["flushes"] if catchup["flushes"] else 0.0)),
        "steady": dict(steady, mean_live_lanes=(
            steady["lanes"] / steady["flushes"] if steady["flushes"] else 0.0)),
        "wal_bytes": {"written": sum(node["wal_written"] for node in nodes),
                      "live": sum(node["wal_live"] for node in nodes)},
        "counts": storage_counts(card),
    }


def storage_phase(kernels, control=True):
    """storage-10 over the card (``cuda-only`` collectors, every node's
    every incarnation over one ``TorchSignatureVerifier`` on cuda:0) and
    over the ``cpu`` kind, with the checks of the module docstring, step
    13.  Returns the launches and the readings.  ``control`` False (the
    whole script) skips the ``cpu`` run: ``STORAGE_SEEDED`` alone holds the
    card."""
    from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee

    config = STORAGE_10
    committee = Committee.new_for_benchmarks(config["n"])
    backend = TorchSignatureVerifier(committee_keys=committee.public_key_bytes())
    backend.warmup()  # the kernels' first launches and the combs' upload
    for k in kernels:
        k.reset_counts()
    card = storage_run("cuda-only", config, backend=backend, inspect=wal_inspect_run)
    launches = {k.name: k.launches for k in kernels}
    cpu = storage_run("cpu", config) if control else None
    reading = storage_checks(card, cpu, config)
    reading["wal_inspect"] = wal_inspect_checks(card["wal_inspect"],
                                                reading["rejoiner"]["adopted_height"])
    check(reading["counts"] == STORAGE_SEEDED,
          f"the counts differ from the seeded ones: {reading['counts']}")
    check(launches["prologue"] == launches["verify_keyed"] == card["flushes"]
          and launches["verify_generic"] == 0,
          f"the storage path's launches {launches} are not one prologue and one keyed "
          f"launch a flush ({card['flushes']:.0f})")
    accounted = card_checks(card)
    check(card["on_card_twice"] == 0,
          f"the card verified {card['on_card_twice']} blocks twice for one incarnation "
          f"({card['on_card_twice_one_peer']} of them sent fresh by one peer only)")
    catchup, steady, wal = reading["catchup"], reading["steady"], reading["wal_bytes"]
    reading.update({"card_wall_s": card["wall_s"], "cpu_wall_s": cpu and cpu["wall_s"],
                    "signatures_on_card": accounted["on_backend"],
                    "open_at_stop": accounted["open_at_stop"],
                    "dedup_saved": accounted["dedup_saved"],
                    "launches": launches,
                    "card": card_line()})
    print(f"storage storage-10: {config['n']} validators, {config['virtual_s']} virtual s, "
          f"commits a node {reading['commits']}, prefixes agree and equal "
          f"{control_text(cpu)}the seeded counts; node {config['rejoiner']} crashed at height "
          f"{reading['rejoiner']['crashed_at_height']}, adopted a snapshot at "
          f"{reading['rejoiner']['adopted_height']} ({reading['snapshot']['blocks']} blocks in "
          f"{reading['snapshot']['chunks']} chunks) and reached {reading['rejoiner']['final_height']}; "
          f"node {config['rebooter']} booted from checkpoint "
          f"{reading['rebooter']['recovered_checkpoint_height']} replaying "
          f"{reading['rebooter']['replayed_bytes']} of {reading['rebooter']['wal_written']} WAL "
          f"bytes; {card['forged']} forged copies verified ({card['forged_injected']} injected, "
          f"the snapshot stream's included), all rejected and counted; "
          f"{accounted['flushes']:.0f} flushes; launches {launches} [{reading['card']}]",
          flush=True)
    print(f"storage readings: live lanes a flush in the rejoiner's catch-up "
          f"{catchup['mean_live_lanes']:.2f} ({catchup['flushes']} flushes) against "
          f"{steady['mean_live_lanes']:.2f} in steady state ({steady['flushes']} flushes); "
          f"catch-up {catchup['wall_s']:.3f} wall s on the card ({catchup['virtual_s']:.3f} "
          f"virtual s); WAL bytes written {wal['written']} against {wal['live']} live; "
          f"{card['wall_s']:.1f} s on the card, {control_seconds(cpu)} "
          f"[{reading['card']}]", flush=True)
    for name, r in reading["wal_inspect"].items():
        print(f"wal_inspect (step 22) over storage-10's {name} WAL: exit 0, {r['segments']} "
              f"segments, {r['checkpoints']} valid checkpoints at heights "
              f"{r['checkpoint_heights']}, census {r['census']}, torn tail "
              f"{r['torn_tail_bytes']} B, {r['seconds']:.2f} s", flush=True)
    return launches, reading


async def epoch_sim(config, tmp_dir, make_collector, metrics=None):
    """``config``'s fleet (``EPOCH_10``'s shape) as a ``SimFleet`` with the
    reconfiguration and execution planes on, and the workload of
    ``tests/test_reconfig.py``'s churn test and ``scenarios``' execution workload:
    each ``config["changes"]`` entry (at_s, via, kind, authority, stake)
    plants a ``CommitteeChange`` on node ``via``'s block handler at its
    virtual time, and every ``exec_interval_s`` each live node plants one
    self-contained execution batch (CREATE ``acct-{node}-{batch}`` with
    1,000, two TRANSFERs of 300 in nonce order, one TRANSFER of 500 that
    overdraws).  Every incarnation's collector counts its ``note_committee``
    calls, and the roots its core folds are recorded.  Returns
    ``epoch_result``."""
    from mysticeti_tpu_torch import reconfig
    from mysticeti_tpu_torch.config import Parameters, StorageParameters
    from mysticeti_tpu_torch.execution import OP_CREATE, OP_TRANSFER, ExecTx

    parameters = Parameters(leader_timeout_s=CONSENSUS_LEADER_TIMEOUT_S, reconfig=True,
                            execution=True, leader_liveness_horizon_rounds=4,
                            storage=StorageParameters(**config["storage"]))
    incarnations, roots, conflicts, planted = [], {}, [], []

    def on_build(a, node):
        core = node.core
        incarnation = {"authority": a, "node": node, "notes": 0,
                       "boot_epoch": core.committee.epoch,
                       "boot_height": core.execution.last_height,
                       "boot_root": core.execution.root,
                       "checkpoint_height": core.storage.recovered_checkpoint_height}
        incarnations.append(incarnation)
        collector = node.block_verifier
        note = collector.note_committee

        def counted_note(committee):
            incarnation["notes"] += 1
            note(committee)

        def folded(result):
            mine = roots.setdefault(a, {})
            if mine.setdefault(result.height, result.root) != result.root:
                conflicts.append((a, result.height))

        collector.note_committee = counted_note
        core.execution_listeners.append(folded)

    async def workload(fleet):
        kinds = {"add": reconfig.CHANGE_ADD, "remove": reconfig.CHANGE_REMOVE,
                 "reweight": reconfig.CHANGE_REWEIGHT}

        async def changes():
            for at, via, kind, authority, stake in config["changes"]:
                await asyncio.sleep(at - fleet.loop.time())
                fleet.inject(via, reconfig.CommitteeChange(kinds[kind], authority, stake).to_bytes())

        async def execution():
            batch = 0
            while True:
                await asyncio.sleep(config["exec_interval_s"])
                batch += 1
                for a, node in enumerate(fleet.nodes):
                    if node is None:
                        continue
                    account, sink = f"acct-{a}-{batch}".encode(), f"sink-{a}".encode()
                    planted.append(account)
                    for tx in (ExecTx(OP_CREATE, account, amount=1000),
                               ExecTx(OP_TRANSFER, account, nonce=1, amount=300, dest=sink),
                               ExecTx(OP_TRANSFER, account, nonce=2, amount=300, dest=b"treasury"),
                               ExecTx(OP_TRANSFER, account, nonce=3, amount=500, dest=sink)):
                        fleet.inject(a, tx.to_bytes())

        await asyncio.gather(changes(), execution())

    fleet = SimFleet(config, tmp_dir, make_collector, parameters, metrics, on_build)
    await fleet.run(workload)
    return epoch_result(fleet, incarnations, roots, conflicts, planted)


class RoundPrefix:
    """The rounds up to ``last_round`` of a block store, as
    ``FinalizationInterpreter`` reads a store: a whole DAG, since a block's
    parents lie in lower rounds."""

    def __init__(self, store, last_round: int) -> None:
        self.store, self.last_round = store, last_round

    def highest_round(self) -> int:
        return min(self.last_round, self.store.highest_round())

    def get_blocks_by_round(self, round_):
        return self.store.get_blocks_by_round(round_)

    def get_block(self, reference):
        return self.store.get_block(reference)


def causal_history(store, block) -> set:
    """The references of ``block`` and every block it reaches through its
    includes (``BlockStore.linked``'s relation, in one pass)."""
    seen, stack = {block.reference}, [block]
    while stack:
        for ref in stack.pop().includes:
            if ref not in seen:
                seen.add(ref)
                stack.append(store.get_block(ref))
    return seen


def finalization_reading(node, anchors, last_round) -> dict:
    """``FinalizationInterpreter`` with ``node``'s current committee over
    the rounds up to ``last_round`` of its store: the finalized
    transactions, and how many of them have no certifying block in the
    causal history of the node's last committed leader (``anchors``: its
    committed anchors by height), whose round must lie above
    ``last_round``.  (Over the whole store, transactions certified in the
    rounds above that leader, not yet committed when the run stopped, have
    none; the oracle's work grows with blocks times transactions.)"""
    from mysticeti_tpu_torch.finalization_interpreter import FinalizationInterpreter

    store = node.core.block_store
    last_leader = store.get_block(anchors[max(anchors)])
    history = causal_history(store, last_leader)
    finalized = FinalizationInterpreter(RoundPrefix(store, last_round),
                                        node.core.committee).finalized_tx_certifying_blocks()
    uncovered = sum(history.isdisjoint(certifying) for _tx, certifying in finalized)
    return {"finalized": len(finalized), "uncovered": uncovered,
            "leader_round": last_leader.round()}


def oracle_nodes(config) -> list:
    """The nodes whose stores the epoch phase's finalization oracle reads:
    node 0 (both changes go through it), the rebooter and the retiree."""
    return sorted({0, config["rebooter"], config["retiree"]})


def epoch_result(fleet, incarnations, roots, conflicts, planted) -> dict:
    """What the epoch checks and readings read off the finished fleet: the
    committed sequences; each node's last incarnation's epoch, epoch chain,
    execution height, root, state bytes' digest, the planted accounts it
    holds and how many of those do not read (400, 3) (1,000 less two
    transfers of 300, three nonces: the overdraft rejected), its
    ``mysticeti_execution_txs_total`` by verdict and, for the
    ``oracle_nodes``, the finalization oracle's reading over its
    first ``config["oracle_rounds"]`` rounds; every incarnation's boot
    readings, epoch at its end and ``note_committee`` calls; the roots folded by height; the settled
    receive counts, forged copies, registries' invalid blocks and verified
    signatures; then every node's WAL is closed."""
    import hashlib

    config, metrics = fleet.config, fleet.metrics
    last = {inc["authority"]: inc["node"] for inc in incarnations}

    def verdicts(m):
        return {sample.labels["result"]: sample.value
                for family in m.mysticeti_execution_txs_total.collect()
                for sample in family.samples if sample.name.endswith("_total")}

    per_node, oracle_s = [], 0.0
    for a in range(config["n"]):
        core = last[a].core
        held = [core.execution.probe(account) for account in planted]
        held = [entry for entry in held if entry is not None]
        per_node.append({
            "epoch": core.committee.epoch,
            "chain": [(r.epoch, r.boundary_height, r.boundary_round, r.digest.hex(), list(r.stakes))
                      for r in core.reconfig.chain.records],
            "exec_height": core.execution.last_height, "root": core.execution.root.hex(),
            "state": hashlib.blake2b(core.execution.to_bytes(), digest_size=16).hexdigest(),
            "planted_held": len(held), "planted_off": sum(entry != (400, 3) for entry in held),
            "verdicts": verdicts(metrics[a]),
            "finalization": None,
        })
        if a in oracle_nodes(config):
            t0 = time.monotonic()
            per_node[-1]["finalization"] = finalization_reading(
                last[a], fleet.commits.anchors[a], config["oracle_rounds"])
            oracle_s += time.monotonic() - t0
    result = {
        "sequences": fleet.commits.sequences(config["n"]), "nodes": per_node,
        "incarnations": [{"authority": inc["authority"], "boot_epoch": inc["boot_epoch"],
                          "boot_height": inc["boot_height"], "boot_root": inc["boot_root"].hex(),
                          "checkpoint_height": inc["checkpoint_height"],
                          "end_epoch": inc["node"].core.committee.epoch,
                          "boundaries_crossed": len({r.boundary_height for r in
                                                     inc["node"].core.reconfig.chain.records
                                                     if r.epoch > inc["boot_epoch"]}),
                          "notes": inc["notes"]}
                         for inc in incarnations],
        "roots": {a: {h: r.hex() for h, r in sorted(mine.items())}
                  for a, mine in sorted(roots.items())},
        "root_conflicts": conflicts, "planted": len(planted), "oracle_s": oracle_s,
        **fleet.verify_readings(),
    }
    fleet.close()
    return result


def epoch_run(kind, config, on_ready=None, device=None) -> dict:
    """One seeded simulation of ``epoch_sim`` in a temporary directory,
    every incarnation of every node with its own verifier of ``kind``
    (``_make_verifier``).  The accelerator kinds' verifiers, one for each
    incarnation the schedule boots, are made and warmed (the kernels' first
    launches, the combs' upload) before ``on_ready()`` and the run.  Every
    run reads the finalization oracle over the finished stores.  Returns
    the result with its wall seconds (the oracle's included) and the
    verifiers' warm-up seconds."""
    import tempfile

    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.validator import _make_verifier

    n = config["n"]
    metrics = [Metrics() for _ in range(n)]
    prepared = {a: [] for a in range(n)}
    t0 = time.monotonic()
    if kind != "cpu":
        committee = Committee.new_for_benchmarks(n)
        for a in [*range(n), *(c[0] for c in config["crashes"])]:
            prepared[a].append(_make_verifier(kind, committee, metrics=metrics[a], device=device))
        for verifiers in prepared.values():
            for verifier in verifiers:
                check(verifier.ready.wait(600), f"a {kind} verifier did not warm up")

    def make_collector(committee, authority, m):
        if kind == "cpu":
            return _make_verifier("cpu", committee, metrics=m)
        return prepared[authority].pop(0)

    warmup_s = time.monotonic() - t0
    if on_ready is not None:
        on_ready()
    with tempfile.TemporaryDirectory(prefix="epoch-") as d:
        t0 = time.monotonic()
        result = run_simulation(epoch_sim(config, d, make_collector, metrics),
                                seed=config["seed"])
        result["wall_s"] = time.monotonic() - t0
    result["warmup_s"] = warmup_s
    return result


def epoch_counts(result) -> dict:
    """The values a seeded run must reproduce on any host and backend."""
    keys = ("received", "fresh", "to_verify", "forged", "forged_rejected", "forged_injected",
            "redelivered", "on_card", "planted")
    nodes = result["nodes"]
    return {"commits": [len(seq) for seq in result["sequences"]],
            "epochs": [node["epoch"] for node in nodes],
            "boundaries": [[[epoch, height] for epoch, height, *_ in node["chain"]]
                           for node in nodes],
            "flushes": int(result["flushes"]), "dispatched": int(result["dispatched"]),
            **{key: result[key] for key in keys},
            "exec_heights": [node["exec_height"] for node in nodes],
            "roots": [node["root"] for node in nodes],
            "planted_held": [node["planted_held"] for node in nodes],
            "notes": [inc["notes"] for inc in result["incarnations"]]}


def epoch_checks(card, cpu, config) -> dict:
    """The epoch phase's checks 1-5 and 7 on the card run and the ``cpu``
    run of the same seed (see the module docstring, step 14); returns the
    readings.  With ``cpu`` None (the whole script) the card is held to
    ``EPOCH_SEEDED`` alone."""
    n, epochs, retiree, rebooter = (config["n"], config["epochs"], config["retiree"],
                                    config["rebooter"])
    nodes = card["nodes"]
    live = [a for a in range(n) if a != retiree]
    # 1: epochs and boundaries, fleet-wide and across the runs.
    check([nodes[a]["epoch"] for a in live] == [epochs] * len(live)
          and nodes[retiree]["epoch"] >= 1,
          f"epochs {[node['epoch'] for node in nodes]}: every live node must end in epoch "
          f"{epochs} and node {retiree} see at least epoch 1")
    chains = [node["chain"] for node in nodes]
    longest = max(chains, key=len)
    check(len(longest) == epochs and all(chain == longest[:len(chain)] for chain in chains)
          and all(chains[a] == longest for a in live),
          f"the epoch boundaries differ across the fleet: {chains}")
    check(longest[-1][2] < config["oracle_rounds"],
          f"the last boundary (round {longest[-1][2]}) lies above the oracle's rounds")
    if cpu is not None:
        check(chains == [node["chain"] for node in cpu["nodes"]],
              "the epoch boundaries differ from the cpu run's")
    # 2: committed sequences (CommitLog checked agreement at every height).
    commits = commit_checks(card["sequences"], 1)
    if cpu is not None:
        check(card["sequences"] == cpu["sequences"],
              "the committed sequences differ from the cpu run's")
    # 3: execution roots, verdicts, overdrafts.
    check(not card["root_conflicts"], f"a node folded two roots at one height: "
                                      f"{card['root_conflicts'][:3]}")
    golden = {}
    for a, mine in card["roots"].items():
        for height, root in mine.items():
            check(golden.setdefault(height, root) == root, f"the roots fork at height {height}")
    if cpu is not None:
        check(card["roots"] == cpu["roots"], "the roots differ from the cpu run's")
        check([node["verdicts"] for node in nodes] == [node["verdicts"] for node in cpu["nodes"]],
              "the execution verdicts differ from the cpu run's")
    crashed = {c[0] for c in config["crashes"]}
    for a in live:
        node = nodes[a]
        check(golden.get(node["exec_height"]) == node["root"],
              f"node {a}'s final root is not the fleet's at height {node['exec_height']}")
        check(node["planted_held"] > 0 and node["planted_off"] == 0,
              f"node {a} holds {node['planted_held']} planted accounts, {node['planted_off']} "
              f"not at (400, 3)")
        if a not in crashed:
            held = node["planted_held"]
            check(node["verdicts"] == {"applied": 3.0 * held, "insufficient_balance": 1.0 * held},
                  f"node {a}'s verdicts {node['verdicts']} are not 3 applied and 1 "
                  f"insufficient_balance for each of its {held} planted batches")
    # 4: the checkpoint boot.
    boots = [inc for inc in card["incarnations"] if inc["authority"] == rebooter]
    check(len(boots) == 2, f"node {rebooter} booted {len(boots)} times")
    boot = boots[1]
    check(boot["checkpoint_height"] > 0 and boot["boot_epoch"] == epochs
          and boot["boot_height"] > 0
          and golden.get(boot["boot_height"]) == boot["boot_root"],
          f"node {rebooter}'s checkpoint boot did not re-derive epoch {epochs} and the fleet's "
          f"root: {boot}")
    # 5: forged copies.
    forged_checks(card)
    # 7: the finalization oracle.
    for a in oracle_nodes(config):
        reading = nodes[a]["finalization"]
        check(reading is not None and reading["leader_round"] > config["oracle_rounds"]
              and reading["finalized"] > 0 and reading["uncovered"] == 0,
              f"node {a}'s finalization oracle: {reading}")
    return {
        "nodes": n, "virtual_s": config["virtual_s"], "seed": config["seed"],
        "commits": commits, "epochs": [node["epoch"] for node in nodes],
        "boundaries": [{"epoch": e, "height": h, "round": r, "digest": d[:16]}
                       for e, h, r, d, _ in longest],
        "exec_heights": [node["exec_height"] for node in nodes],
        "shared_heights": len(golden), "planted": card["planted"],
        "planted_held": [node["planted_held"] for node in nodes],
        "reboot": {key: boot[key] for key in ("checkpoint_height", "boot_epoch", "boot_height")},
        "finalized": {a: nodes[a]["finalization"]["finalized"] for a in oracle_nodes(config)},
        "forged": card["forged"], "forged_injected": card["forged_injected"],
        "forged_rejected": card["forged_rejected"],
        "counts": epoch_counts(card),
    }


def epoch_phase(kernels, control=True):
    """epoch-10 over the card (each incarnation its own
    ``_make_verifier("cuda-only")`` on cuda:0) and over the ``cpu`` kind,
    with the checks of the module docstring, step 14.  Returns the launches
    and the readings.  ``control`` False (the whole script) skips the
    ``cpu`` run: ``EPOCH_SEEDED`` alone holds the card."""
    config = EPOCH_10
    card = epoch_run("cuda-only", config, on_ready=lambda: [k.reset_counts() for k in kernels])
    launches = {k.name: k.launches for k in kernels}
    cpu = epoch_run("cpu", config) if control else None
    reading = epoch_checks(card, cpu, config)
    if cpu is not None:
        check(epoch_counts(card) == epoch_counts(cpu),
              f"the counts differ from the cpu run's: {epoch_counts(card)} vs "
              f"{epoch_counts(cpu)}")
    check(reading["counts"] == EPOCH_SEEDED,
          f"the counts differ from the seeded ones: {reading['counts']}")
    # 6: on the card.
    check(launches["verify_generic"] == 0,
          f"the epoch path launched the generic kernel across the boundaries: {launches}")
    check(launches["prologue"] == launches["verify_keyed"] == card["flushes"] > 0,
          f"the epoch path's launches {launches} are not one prologue and one keyed launch a "
          f"flush ({card['flushes']:.0f})")
    accounted = card_checks(card)
    for inc in card["incarnations"]:
        check(inc["notes"] == inc["boundaries_crossed"],
              f"node {inc['authority']}'s collector saw {inc['notes']} committee notes crossing "
              f"{inc['boundaries_crossed']} boundaries (epochs {inc['boot_epoch']}-"
              f"{inc['end_epoch']})")
    reading.update({"card_wall_s": card["wall_s"], "cpu_wall_s": cpu and cpu["wall_s"],
                    "oracle_s": card["oracle_s"], "warmup_s": card["warmup_s"],
                    "signatures_on_card": accounted["on_backend"], "flushes": accounted["flushes"],
                    "mean_live_lanes": accounted["mean_live_lanes"],
                    "open_at_stop": accounted["open_at_stop"],
                    "notes": [(inc["authority"], inc["notes"]) for inc in card["incarnations"]],
                    "launches": launches, "card": card_line()})
    roots_control = " and equal the cpu run's" if cpu is not None else ""
    print(f"epoch epoch-10: {config['n']} validators, {config['virtual_s']} virtual s, commits a "
          f"node {reading['commits']}, prefixes agree and equal {control_text(cpu)}the seeded "
          f"counts; epochs {reading['epochs']}, boundaries {reading['boundaries']}; roots agree at "
          f"{reading['shared_heights']} heights{roots_control}; {reading['planted']} "
          f"batches planted, held {reading['planted_held']}; node {config['rebooter']} booted from "
          f"checkpoint {reading['reboot']}; finalized {reading['finalized']}; {card['forged']} "
          f"forged copies verified ({card['forged_injected']} injected), all rejected and "
          f"counted; {accounted['flushes']:.0f} flushes, {accounted['mean_live_lanes']:.2f} live "
          f"lanes a flush; committee notes {reading['notes']}; {card['wall_s']:.1f} s on the "
          f"card ({card['oracle_s']:.1f} s of it the oracle; the verifiers warmed in "
          f"{card['warmup_s']:.1f} s), {control_seconds(cpu)}; launches "
          f"{launches} [{reading['card']}]",
          flush=True)
    return launches, reading


def build_ingress_node(committee, signer, authority, wal_path, network, parameters, verifier,
                       metrics, recorder, observer_class, ingress_parameters):
    """One validator with its ingress plane, wired as the JAX package's
    ``Validator`` wires it (without the health probe and the gateway): an
    ``IngressPlane`` behind a ``BenchmarkFastPathBlockHandler`` and the
    commit observer, attached to the core, the ``NetworkSyncer`` and
    ``verifier`` (its ``health_state`` feeds admission), its shed-mode
    transitions on ``recorder``.  The WAL writes synchronously, as in the
    JAX package's ``run_overload_sim``: admission reads the WAL backlog,
    and a drain thread's progress is wall-clock state."""
    from mysticeti_tpu_torch.block_handler import BenchmarkFastPathBlockHandler
    from mysticeti_tpu_torch.block_store import BlockStore
    from mysticeti_tpu_torch.core import Core, CoreOptions
    from mysticeti_tpu_torch.ingress import IngressPlane
    from mysticeti_tpu_torch.net_sync import NetworkSyncer
    from mysticeti_tpu_torch.wal import walf

    writer, reader = walf(wal_path, async_writes=False)
    recovered, observer_recovered = BlockStore.open(authority, reader, writer, committee,
                                                    metrics=metrics)
    plane = IngressPlane(ingress_parameters, authority=authority, metrics=metrics)
    handler = BenchmarkFastPathBlockHandler(committee, authority, metrics=metrics, ingress=plane)
    core = Core(block_handler=handler, authority=authority, committee=committee,
                parameters=parameters, recovered=recovered, wal_writer=writer,
                options=CoreOptions.test(), signer=signer, metrics=metrics)
    observer = observer_class(core.block_store, committee, transaction_time=handler.transaction_time,
                              metrics=metrics, recovered_state=observer_recovered)
    observer.logged_authority = authority
    node = NetworkSyncer(core, observer, network, parameters=parameters, block_verifier=verifier,
                         metrics=metrics, recorder=recorder)
    plane.recorder = recorder
    observer.ingress = plane
    plane.attach(core=core, net_syncer=node, block_verifier=verifier)
    return node


class IngressFleet(SimFleet):
    """``config``'s fleet (``INGRESS_10``'s shape) as a ``SimFleet`` whose
    nodes are ``build_ingress_node``'s, each with one closed-loop
    ``TransactionGenerator`` submitting through its block handler at
    ``config["scenario"]``'s offered load and schedule, its commit
    notifications fed back from the plane; the committed transactions are
    counted a node and a virtual second."""

    def __init__(self, config, tmp_dir, make_collector, parameters, metrics=None) -> None:
        from mysticeti_tpu_torch.ingress import OverloadScenario
        from mysticeti_tpu_torch.types import Share

        super().__init__(config, tmp_dir, make_collector, parameters, metrics)
        n = config["n"]
        self.scenario = OverloadScenario(seed=config["seed"], **config["scenario"])
        self.ingress_parameters = self.scenario.ingress_parameters()
        self.planes, self.generators = [None] * n, [None] * n
        self.committed = [0] * n
        self.distinct = [set() for _ in range(n)]  # each transaction's stamp and nonce
        self.per_second = [[0] * (int(config["virtual_s"]) + 1) for _ in range(n)]
        self.load_started = None
        fleet = self

        class Counting(self.observer_class):
            def handle_commit(self, committed_leaders):
                committed = super().handle_commit(committed_leaders)
                a, second = self.logged_authority, int(fleet.loop.time())
                for commit in committed:
                    for block in commit.blocks:
                        for st in block.statements:
                            if isinstance(st, Share):
                                fleet.committed[a] += 1
                                fleet.distinct[a].add(st.transaction[:16])
                                fleet.per_second[a][second] += 1
                return committed

        self.observer_class = Counting

    def build_node(self, a, network, collector):
        from mysticeti_tpu_torch.transactions_generator import TransactionGenerator

        node = build_ingress_node(self.committee, self.signers[a], a, self.wal_path(a), network,
                                  self.parameters, collector, self.metrics[a], self.recorders[a],
                                  self.observer_class, self.ingress_parameters)
        scenario, plane = self.scenario, node.syncer.commit_observer.ingress
        generator = TransactionGenerator(
            submit=node.core.block_handler.submit, seed=scenario.seed * 1000 + a * 16,
            tps=scenario.base_tps, transaction_size=scenario.transaction_size,
            overload_schedule=list(scenario.multiplier_schedule),
            closed_loop=scenario.closed_loop,
            finality_sample_every=self.ingress_parameters.finality_sample_every,
            metrics=self.metrics[a])
        plane.add_commit_sink(
            lambda height, keys, info, g=generator: g.note_commit_notification(keys, info))
        self.planes[a], self.generators[a] = plane, generator
        return node

    async def run(self) -> None:
        """Start every node, then every plane's tick and every generator,
        as the JAX package's ``run_overload_sim`` does; after
        ``config["virtual_s"]`` stop the generators, the planes and the
        nodes."""
        for a in range(self.config["n"]):
            await self.build(a).start()
        await self.sim_net.connect_all()
        for plane in self.planes:
            plane.start()
        self.load_started = self.loop.time()
        for generator in self.generators:
            generator.start()
        await asyncio.sleep(self.config["virtual_s"])
        for generator in self.generators:
            generator.stop()
        for plane in self.planes:
            plane.stop()
        for node in self.nodes:
            await node.stop()
        self.sim_net.close()


def ingress_metrics(m) -> dict:
    """The ingress and finality families' samples that ``ingress_checks``
    holds to the planes' and the generators' own counts."""
    get = m.registry.get_sample_value
    return {
        "admitted_total": get("mysticeti_ingress_admitted_total") or 0.0,
        "shed_total": {sample.labels["reason"]: sample.value
                       for family in m.mysticeti_ingress_shed_total.collect()
                       for sample in family.samples if sample.name.endswith("_total")},
        "admitted_rate": get("mysticeti_ingress_admitted_rate"),
        "shed_mode": get("mysticeti_ingress_shed_mode"),
        "finality_total_count": get("mysticeti_e2e_finality_seconds_count", {"phase": "total"}),
        "client_p50_s": get("mysticeti_client_finality_p50_seconds"),
        "client_p99_s": get("mysticeti_client_finality_p99_seconds"),
    }


def ingress_result(fleet) -> dict:
    """What the ingress checks and readings read off the finished fleet:
    the committed sequences; each node's offered, admitted and shed
    transactions (by reason), shed schedule digest, shed-mode transitions,
    committed transactions (all, distinct, a virtual second), generator
    stats, finality on each side, WAL bytes, the controller's rate and mode
    and the ingress and finality families' samples; the fleet-merged
    finality percentiles; and ``verify_readings``; then every node's WAL is
    closed."""
    from mysticeti_tpu_torch.ingress import _merged_finality

    per_node = []
    for a, (node, plane, generator) in enumerate(zip(fleet.nodes, fleet.planes, fleet.generators)):
        per_node.append({
            "offered": generator.submitted, "admitted": plane.admitted_total,
            "shed": dict(sorted(plane.shed_by_reason.items())),
            "digest": plane.shed_schedule_digest(),
            "first_shed_t": plane.shed_log[0]["t"] if plane.shed_log else None,
            "shed_mode": [(e["t"], e["on"]) for e in fleet.recorders[a].events()
                          if e["kind"] == "shed-mode"],
            "committed_tx": fleet.committed[a], "distinct_tx": len(fleet.distinct[a]),
            "per_second": fleet.per_second[a],
            "generator": generator.stats(),
            "server_finality": plane.finality.state(),
            "client_finality": {"completed": generator.finality.completed,
                                "expired": generator.finality.expired},
            "wal_bytes": node.core.wal_writer.position(),
            "rate": round(plane.controller.rate, 3), "shed_mode_now": plane.controller.shed_mode,
            "metrics": ingress_metrics(fleet.metrics[a]),
        })
    result = {
        "sequences": fleet.commits.sequences(fleet.config["n"]), "nodes": per_node,
        "load_started": fleet.load_started,
        "server_finality": _merged_finality([p.finality for p in fleet.planes]),
        "client_finality": _merged_finality([g.finality for g in fleet.generators]),
        **fleet.verify_readings(),
    }
    fleet.close()
    return result


async def ingress_sim(config, tmp_dir, make_collector, metrics):
    """``config``'s fleet as an ``IngressFleet``: no crashes, no
    reconfiguration, no execution, the scenario's leader timeout.  Returns
    ``ingress_result``."""
    from mysticeti_tpu_torch.config import Parameters

    parameters = Parameters(leader_timeout_s=config["scenario"]["leader_timeout_s"])
    fleet = IngressFleet(config, tmp_dir, make_collector, parameters, metrics)
    await fleet.run()
    return ingress_result(fleet)


def ingress_run(kind, config, on_ready=None) -> dict:
    """One seeded simulation of ``ingress_sim`` in a temporary directory,
    every node with its own verifier of ``kind`` (``_make_verifier``),
    made and warmed (for the accelerator kinds the kernels' first launches
    and the combs' upload) before ``on_ready()`` and the run.  Returns the
    result with its wall seconds and the verifiers' warm-up seconds."""
    import tempfile

    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.validator import _make_verifier

    n = config["n"]
    metrics = [Metrics() for _ in range(n)]
    t0 = time.monotonic()
    committee = Committee.new_for_benchmarks(n)
    verifiers = [_make_verifier(kind, committee, metrics=metrics[a]) for a in range(n)]
    for verifier in verifiers:
        check(verifier.ready.wait(600), f"a {kind} verifier did not warm up")
    warmup_s = time.monotonic() - t0
    if on_ready is not None:
        on_ready()
    with tempfile.TemporaryDirectory(prefix="ingress-") as d:
        t0 = time.monotonic()
        result = run_simulation(
            ingress_sim(config, d, lambda _committee, a, _metrics: verifiers[a], metrics),
            seed=config["seed"])
        result["wall_s"] = time.monotonic() - t0
    result["warmup_s"] = warmup_s
    return result


def ingress_counts(result) -> dict:
    """The values a seeded run must reproduce on any host and backend, all
    of them virtual-time quantities."""
    keys = ("received", "fresh", "to_verify", "forged", "forged_rejected", "forged_injected",
            "redelivered", "on_card", "server_finality", "client_finality")
    nodes = result["nodes"]
    shed = {}
    for node in nodes:
        for reason, count in node["shed"].items():
            shed[reason] = shed.get(reason, 0) + count
    return {"commits": [len(seq) for seq in result["sequences"]],
            "flushes": int(result["flushes"]), "dispatched": int(result["dispatched"]),
            **{key: result[key] for key in keys},
            "shed_by_reason": dict(sorted(shed.items())),
            **{key: [node[key] for node in nodes] for key in (
                "committed_tx", "offered", "admitted", "digest", "wal_bytes")},
            "generators": [node["generator"] for node in nodes]}


def ingress_checks(card, cpu, config) -> dict:
    """The ingress phase's checks 1-3 and 5 on the card run and the ``cpu``
    run of the same seed (see the module docstring, step 15); returns the
    readings.  With ``cpu`` None (the whole script) the card is held to
    ``INGRESS_SEEDED`` alone."""
    n, nodes = config["n"], card["nodes"]
    # 1: the runs agree on every virtual-time quantity.
    commits = commit_checks(card["sequences"], 1)
    if cpu is not None:
        check(card["sequences"] == cpu["sequences"],
              "the committed sequences differ from the cpu run's")
        check(ingress_counts(card) == ingress_counts(cpu),
              f"the counts differ from the cpu run's: {ingress_counts(card)} vs "
              f"{ingress_counts(cpu)}")
    # 2: accounting, no transaction committed twice, shed mode in the 3x step.
    step = card["load_started"] + max(t for t, mult in config["scenario"]["multiplier_schedule"]
                                      if mult > 1.0)
    for a, node in enumerate(nodes):
        check(node["offered"] == node["admitted"] + sum(node["shed"].values()),
              f"node {a} offered {node['offered']}, admitted {node['admitted']}, shed "
              f"{node['shed']}")
        check(node["committed_tx"] == node["distinct_tx"] > 0,
              f"node {a} committed {node['committed_tx']} transactions, "
              f"{node['distinct_tx']} distinct")
        check(all(t >= step for t, on in node["shed_mode"] if on),
              f"node {a} entered shed mode before the overload step at {step}: "
              f"{node['shed_mode']}")
    entered = [a for a, node in enumerate(nodes) if any(on for _t, on in node["shed_mode"])]
    check(entered, "no node entered shed mode")
    # ... and sheds, and the clients retry what was shed.
    shed = sum(sum(node["shed"].values()) for node in nodes)
    retries = sum(node["generator"]["retries"] for node in nodes)
    check(shed > 0 and retries > 0,
          f"the overload step shed {shed} transactions and the clients retried {retries}: "
          f"admission shedding or the client retry path did not run")
    # 3: sampled finality keys closed on both sides.
    for a, node in enumerate(nodes):
        server, client = node["server_finality"], node["client_finality"]
        check(server["completed"] == client["completed"] > 0,
              f"node {a} closed {server['completed']} sampled keys on the server side and "
              f"{client['completed']} on the client side")
    check(card["server_finality"]["samples"] > 0 and card["client_finality"]["samples"] > 0,
          f"no finality samples: {card['server_finality']}, {card['client_finality']}")
    # 5: the new families equal the planes' and the generators' counts.
    for a, node in enumerate(nodes):
        m = node["metrics"]
        check(m["admitted_total"] == node["admitted"]
              and m["shed_total"] == {r: float(c) for r, c in node["shed"].items()}
              and m["finality_total_count"] == node["server_finality"]["completed"]
              and m["admitted_rate"] == node["rate"]
              and m["shed_mode"] == float(node["shed_mode_now"])
              and (round(m["client_p50_s"], 6), round(m["client_p99_s"], 6))
              == (node["generator"]["client_finality_p50_s"],
                  node["generator"]["client_finality_p99_s"]),
              f"node {a}'s ingress and finality families {m} differ from its plane's counts")
    virtual_s = config["virtual_s"]
    return {
        "nodes": n, "virtual_s": virtual_s, "seed": config["seed"], "commits": commits,
        "offered": [node["offered"] for node in nodes],
        "admitted": [node["admitted"] for node in nodes],
        "shed": [node["shed"] for node in nodes],
        "committed_tx": [node["committed_tx"] for node in nodes],
        "committed_tx_s": [round(node["committed_tx"] / virtual_s, 3) for node in nodes],
        "committed_by_second": nodes[0]["per_second"],
        "shed_mode_entered": {a: nodes[a]["shed_mode"][0][0] for a in entered},
        "first_shed_t": [node["first_shed_t"] for node in nodes],
        "server_finality": card["server_finality"], "client_finality": card["client_finality"],
        "wal_bytes": sum(node["wal_bytes"] for node in nodes),
        "forged": card["forged"], "forged_injected": card["forged_injected"],
        "forged_rejected": card["forged_rejected"],
        "counts": ingress_counts(card),
    }


def ingress_phase(kernels, control=True):
    """ingress-10 over the card (each node its own
    ``_make_verifier("cuda-only")`` on cuda:0) and over the ``cpu`` kind,
    with the checks of the module docstring, step 15.  Returns the launches
    and the readings.  ``control`` False (the whole script) skips the
    ``cpu`` run: ``INGRESS_SEEDED`` alone holds the card."""
    config = INGRESS_10
    card = ingress_run("cuda-only", config, on_ready=lambda: [k.reset_counts() for k in kernels])
    launches = {k.name: k.launches for k in kernels}
    cpu = ingress_run("cpu", config) if control else None
    reading = ingress_checks(card, cpu, config)
    check(reading["counts"] == INGRESS_SEEDED,
          f"the counts differ from the seeded ones: {reading['counts']}")
    # 4: on the card.
    forged_checks(card)
    check(launches["verify_generic"] == 0, f"the ingress path launched the generic kernel: {launches}")
    check(launches["prologue"] == launches["verify_keyed"] == card["flushes"] > 0,
          f"the ingress path's launches {launches} are not one prologue and one keyed launch a "
          f"flush ({card['flushes']:.0f})")
    accounted = card_checks(card)
    reading.update({"card_wall_s": card["wall_s"], "cpu_wall_s": cpu and cpu["wall_s"],
                    "warmup_s": card["warmup_s"], "signatures_on_card": accounted["on_backend"],
                    "flushes": accounted["flushes"],
                    "mean_live_lanes": accounted["mean_live_lanes"],
                    "open_at_stop": accounted["open_at_stop"],
                    "launches": launches, "card": card_line()})
    print(f"ingress ingress-10: {config['n']} validators, {config['virtual_s']} virtual s, "
          f"{config['scenario']['base_tps']} tx/s of {config['scenario']['transaction_size']} B a "
          f"node, schedule {config['scenario']['multiplier_schedule']}; commits a node "
          f"{reading['commits']}, prefixes agree and equal {control_text(cpu)}the seeded counts; "
          f"offered {reading['offered']}, admitted {reading['admitted']}, shed {reading['shed']}; "
          f"committed tx {reading['committed_tx']} ({reading['committed_tx_s']} a virtual s; "
          f"node 0 by virtual second {reading['committed_by_second']}); shed mode entered "
          f"{reading['shed_mode_entered']}; finality server {reading['server_finality']}, client "
          f"{reading['client_finality']} (virtual s); {card['forged']} forged copies verified "
          f"({card['forged_injected']} injected), all rejected and counted; "
          f"{accounted['flushes']:.0f} flushes, {accounted['mean_live_lanes']:.2f} live lanes a "
          f"flush; WAL bytes {reading['wal_bytes']}; {card['wall_s']:.1f} s on the card (the "
          f"verifiers warmed in {card['warmup_s']:.1f} s), {control_seconds(cpu)}; "
          f"launches {launches} [{reading['card']}]", flush=True)
    return launches, reading


# The health phase (health-tcp-10 and health-sim-10).
class FanOut:
    """The same call on every one of ``targets``: the one process-wide
    accountant writes its families into every node's ``Metrics`` (one
    sampler sees the whole process, so each node's scrape carries the
    process's account)."""

    def __init__(self, targets) -> None:
        self.targets = targets

    def __getattr__(self, name):
        return FanOut([getattr(t, name) for t in self.targets])

    def labels(self, *values):
        return FanOut([t.labels(*values) for t in self.targets])

    def inc(self, amount=1.0) -> None:
        for t in self.targets:
            t.inc(amount)

    def set(self, value) -> None:
        for t in self.targets:
            t.set(value)


class OtherTally:
    """Beside ``accountant``, counts the sampled stacks it charges to
    "other": by thread class and leaf frame, and how many of them hold a
    frame of the port (the registry's totality on a live node: none may;
    a stack of the standard library alone, asyncio's machinery or a worker
    thread waking the loop, has no port frame to charge)."""

    def __init__(self, accountant) -> None:
        from collections import Counter

        from mysticeti_tpu_torch.profiling import attribute

        self.by_leaf = Counter()
        self.with_port_frame = 0
        ingest = accountant.ingest_census

        def tallied(samples, dt):
            for thread_class, frames in samples:
                if attribute(frames) == "other":
                    leaf = f"{frames[0][0]}:{frames[0][1]}" if frames else "-"
                    self.by_leaf[f"{thread_class} {leaf}"] += 1
                    self.with_port_frame += any(in_pkg for _m, _f, in_pkg in frames)
            ingest(samples, dt)

        accountant.ingest_census = tallied


async def http_get(port: int, path: str):
    """``GET path`` from 127.0.0.1:``port``: the status code and the body."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: localhost\r\n\r\n".encode())
    await writer.drain()
    payload = await reader.read()
    writer.close()
    head, _, body = payload.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), body


def strip_volatile_verifier(timeline) -> list:
    """``timeline`` (a ``FleetHealthMonitor``'s) without the verifier block's
    ``HEALTH_STRIPPED`` keys: the backend's label differs by kind, and the
    pipeline depth comes from an EMA the simulator leaves unseeded."""
    out = []
    for entry in timeline:
        nodes = {}
        for a, snap in entry["nodes"].items():
            snap = dict(snap)
            if "verifier" in snap:
                snap["verifier"] = {k: v for k, v in snap["verifier"].items()
                                    if k not in HEALTH_STRIPPED}
            nodes[a] = snap
        out.append(dict(entry, nodes=nodes))
    return out


def merged_critical_path(probes, top: int = 5) -> list:
    """The fleet's (stage, authority) edges that held commits up, summed over
    every probe's critical-path analyzer, most blocked seconds first."""
    merged = {}
    for probe in probes:
        for row in probe.critical_path.top_blocking(n=1 << 30):
            slot = merged.setdefault((row["stage"], row["authority"]), [0, 0.0])
            slot[0] += row["leaders"]
            slot[1] += row["blocked_s"]
    ranked = sorted(merged.items(), key=lambda kv: (-kv[1][1], kv[0]))[:top]
    return [{"stage": stage, "authority": a, "leaders": count, "blocked_s": round(total, 6)}
            for (stage, a), (count, total) in ranked]


async def health_tcp(config, tmp_dir, collectors, metrics, on_ready=None):
    """``config["n"]`` ingress validators (``build_ingress_node``) of a
    ``Committee.new_for_benchmarks`` over the port's ``TcpNetwork`` on
    127.0.0.1, started as ``netsync_tcp`` starts them, node ``a`` verifying
    through ``collectors[a]`` and recording into ``metrics[a]``; forged
    copies on one block-carrying send in ``fault_one_in``; one closed-loop
    ``TransactionGenerator`` a node at ``config["scenario"]``'s load.  On
    every node the observability plane as the JAX package's ``Validator``
    wires it: a started ``HostMonitor`` as the dispatcher's
    ``blocking_monitor``, a ``HealthProbe`` attached to the core, the
    syncer, the collector, the observer, the ingress plane (which reads it
    back for admission), the host monitor and the node's flight recorder,
    sampling every ``probe_s`` and subscribed to the installed
    ``SpanTracer``'s commit critical path, and a ``serve_metrics`` endpoint
    with ``/health`` and ``/debug/flight-recorder`` on a port of the
    kernel's choosing.  The process-wide sampler (``profiling``'s env
    helpers) covers the window, its accountant bound to every node's
    ``Metrics``.  After ``config["wall_s"]`` wall seconds each node is
    scraped over HTTP (``/health``, ``/metrics``, ``/debug/flight-recorder``)
    before anything stops.  Returns ``netsync_result`` with the scrapes and
    the plane's readings."""
    from mysticeti_tpu_torch import profiling, spans
    from mysticeti_tpu_torch.commit_observer import TestCommitObserver
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.config import Parameters
    from mysticeti_tpu_torch.flight_recorder import FlightRecorder
    from mysticeti_tpu_torch.health import HealthProbe, SLOThresholds
    from mysticeti_tpu_torch.hostattr import HostMonitor
    from mysticeti_tpu_torch.ingress import OverloadScenario
    from mysticeti_tpu_torch.metrics import serve_metrics
    from mysticeti_tpu_torch.network import TcpNetwork
    from mysticeti_tpu_torch.transactions_generator import TransactionGenerator

    n = config["n"]
    committee = Committee.new_for_benchmarks(n)
    signers = Committee.benchmark_signers(n)
    scenario = OverloadScenario(seed=config["seed"], **config["scenario"])
    ingress_parameters = scenario.ingress_parameters()
    parameters = Parameters(leader_timeout_s=scenario.leader_timeout_s)
    slo = SLOThresholds(**config["slo"])
    loop = asyncio.get_running_loop()
    for collector in collectors:  # the accelerator kinds warm up in a thread
        ready = getattr(collector, "ready", None)
        if ready is not None:
            await loop.run_in_executor(None, ready.wait)
    if on_ready is not None:
        on_ready()
    injector = FaultInjector(random.Random(config["seed"]), config["fault_one_in"])
    counter = ReceiveCounter(injector.forged_refs)
    observer_class = CommitLog().observer_class(TestCommitObserver)
    tracer = spans.SpanTracer()
    previous_tracer = spans.install(tracer)
    addresses = [("127.0.0.1", 0)] * n
    nodes, probes, monitors, planes, generators, servers, recorders = [], [], [], [], [], [], []
    try:
        for a in range(n):
            network = await TcpNetwork.start(a, addresses, metrics[a])
            addresses[a] = ("127.0.0.1", network._server.sockets[0].getsockname()[1])
            recorder = FlightRecorder(authority=a, metrics=metrics[a])
            node = build_ingress_node(committee, signers[a], a, os.path.join(tmp_dir, f"wal-{a}"),
                                      ForgingNetwork(network, injector), parameters,
                                      collectors[a], metrics[a], recorder, observer_class,
                                      ingress_parameters)
            node.syncer.commit_observer.logged_authority = a
            counter.watch(node)
            monitor = HostMonitor(metrics=metrics[a], recorder=recorder,
                                  blocking_threshold_ms=config["blocking_ms"])
            node.dispatcher.blocking_monitor = monitor
            plane = node.syncer.commit_observer.ingress
            probe = HealthProbe(a, n, metrics=metrics[a], slo=slo, recorder=recorder)
            probe.attach(core=node.core, net_syncer=node, block_verifier=collectors[a],
                         commit_observer=node.syncer.commit_observer, ingress=plane,
                         host_monitor=monitor)
            probe.attach_critical_path(tracer)
            plane.attach(health=probe)
            generator = TransactionGenerator(
                submit=node.core.block_handler.submit, seed=scenario.seed * 1000 + a * 16,
                tps=scenario.base_tps, transaction_size=scenario.transaction_size,
                overload_schedule=list(scenario.multiplier_schedule),
                closed_loop=scenario.closed_loop,
                finality_sample_every=ingress_parameters.finality_sample_every,
                metrics=metrics[a])
            plane.add_commit_sink(
                lambda height, keys, info, g=generator: g.note_commit_notification(keys, info))
            servers.append(await serve_metrics(metrics[a], "127.0.0.1", 0, health_probe=probe,
                                               flight_recorder=recorder))
            nodes.append(node)
            probes.append(probe)
            monitors.append(monitor)
            planes.append(plane)
            generators.append(generator)
            recorders.append(recorder)
        sampler = profiling.start_from_env()
        check(sampler is not None, "the sampler did not start from the environment")
        other = OtherTally(sampler.accountant)
        profiling.bind_active(FanOut(metrics), leaders_fn=lambda: min(
            len(node.syncer.commit_observer.committed_leaders) for node in nodes))
        t0 = time.monotonic()
        for node in nodes:
            await node.start()
        for a in range(n):
            monitors[a].start()
            probes[a].start(config["probe_s"])
            planes[a].start()
            generators[a].start()
        await asyncio.sleep(config["wall_s"])
        elapsed = time.monotonic() - t0
        scrapes = []
        for server in servers:
            port = server.sockets[0].getsockname()[1]
            scrapes.append({path: await http_get(port, path)
                            for path in ("/health", "/metrics", "/debug/flight-recorder")})
    finally:
        for generator in generators:
            generator.stop()
        for plane in planes:
            plane.stop()
        for probe in probes:
            probe.stop()
        for monitor in monitors:
            monitor.stop()
        for server in servers:
            server.close()
        for node in nodes:
            await node.stop()
        profiling.stop_from_env()
        spans.install(previous_tracer)
    result = netsync_result(nodes, counter, injector, metrics)
    sites = {}
    for recorder in recorders:
        for e in recorder.events():
            if e["kind"] == "blocking-call":
                slot = sites.setdefault(e["site"], {"count": 0, "worst_ms": 0.0})
                slot["count"] += 1
                slot["worst_ms"] = max(slot["worst_ms"], e["ms"])
    result.update({
        "wall_s": elapsed,
        "commits_per_wall_s": sum(len(seq) for seq in result["sequences"]) / n / elapsed,
        "scrapes": scrapes, "alerts": [a.to_dict() for p in probes for a in p.alerts],
        "loop_lag": [(m.loop_lag.percentile(50), m.loop_lag.percentile(99),
                      m.loop_lag.sample_count()) for m in monitors],
        "blocking_sites": dict(sorted(sites.items())),
        "blocking_total": sum(m.blocking_total for m in monitors),
        "critical_path": merged_critical_path(probes),
        "leaders_attributed": sum(p.critical_path.leaders_attributed for p in probes),
        "stage_seconds": stage_seconds(metrics),
        "other_by_leaf": dict(other.by_leaf.most_common(6)),
        "other_with_port_frame": other.with_port_frame,
        "admitted": [p.admitted_total for p in planes],
        "offered": [g.submitted for g in generators],
    })
    return result


def health_tcp_run(kind, config, on_ready=None) -> dict:
    """One run of ``health_tcp`` in a temporary directory, every node with
    its own ``Metrics`` and its own verifier of ``kind`` (``_make_verifier``),
    the sampler's profile and report written there through the environment
    (``MYSTICETI_PROFILE``, ``MYSTICETI_PERF_REPORT``).  Returns the result
    with the accountant's report, the profile's most sampled stacks, the
    sampled seconds inside the collectors' submit and fetch jobs and the
    verifiers' warm-up seconds."""
    import tempfile

    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.profiling import DEFAULT_HZ
    from mysticeti_tpu_torch.validator import _make_verifier

    n = config["n"]
    metrics = [Metrics() for _ in range(n)]
    committee = Committee.new_for_benchmarks(n)
    t0 = time.monotonic()
    collectors = [_make_verifier(kind, committee, metrics=metrics[a]) for a in range(n)]
    for collector in collectors:
        check(collector.ready.wait(600), f"a {kind} verifier did not warm up")
    warmup_s = time.monotonic() - t0
    saved = {key: os.environ.get(key) for key in ("MYSTICETI_PROFILE", "MYSTICETI_PERF_REPORT")}
    with tempfile.TemporaryDirectory(prefix="health-tcp-") as d:
        os.environ["MYSTICETI_PROFILE"] = os.path.join(d, "profile.folded")
        os.environ["MYSTICETI_PERF_REPORT"] = os.path.join(d, "report.json")
        try:
            result = asyncio.run(health_tcp(config, d, collectors, metrics, on_ready))
        finally:
            for key, value in saved.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
        with open(os.path.join(d, "report.json")) as f:
            result["report"] = json.load(f)
        with open(os.path.join(d, "profile.folded")) as f:
            folded = [line.rsplit(" ", 1) for line in f.read().splitlines()]
    result["top_stacks"] = [f"{';'.join(stack.split(';')[-4:])} {count}"
                            for stack, count in folded[:8]]
    # The collectors' executor jobs, by side: submit (pack, upload, launch)
    # and fetch (the wait for the card's verdicts, and the copy back).
    result["dispatch_sampled_s"] = {
        side: round(sum(int(count) for stack, count in folded
                        if f"block_validator:_{side}_dispatch" in stack) / DEFAULT_HZ, 6)
        for side in ("submit", "fetch")}
    result["warmup_s"] = warmup_s
    return result


def health_tcp_checks(result, config, backend, card=True) -> dict:
    """The checks of health-tcp-10 (see the module docstring, step 16) on
    one run whose verifiers' backend is labelled ``backend`` (with ``card``,
    the card's: some sampled tick must be the verifier's); returns the
    readings.  Alerts are findings, not failures: ten nodes share one loop
    and one interpreter lock."""
    from mysticeti_tpu_torch.health import ALERT_STAGES, cluster_snapshot_from_texts
    from mysticeti_tpu_torch.profiling import SUBSYSTEM_NAMES

    n = config["n"]
    reading = netsync_tcp_checks(result, config["min_commits"])
    accounted = card_checks(result)
    diagnoses, texts, dumps = [], {}, []
    for a, scrape in enumerate(result["scrapes"]):
        status, body = scrape["/health"]
        check(status in (200, 503), f"node {a}'s /health answered {status}")
        doc = json.loads(body)
        check((status == 200) == (doc["status"] == "ok"),
              f"node {a}'s /health answered {status} with status {doc['status']}")
        signals = doc["signals"]
        check(signals is not None and signals["verifier"]["backend"] == backend,
              f"node {a}'s verifier block {signals and signals.get('verifier')} is not {backend}'s")
        check(signals["breaker_open_fraction"] == 0,
              f"node {a}'s breaker was open: {signals['breaker_open_fraction']}")
        check(signals["host"]["loop_lag_samples"] > 0, f"node {a}'s loop-lag probe took no sample")
        check("ingress" in signals, f"node {a}'s /health has no ingress block")
        check(all(alert["stage"] == ALERT_STAGES[alert["kind"]] for alert in doc["alerts"]),
              f"node {a} raised an alert at a stage its kind does not name: {doc['alerts']}")
        diagnoses.append(doc)
        status, body = scrape["/metrics"]
        check(status == 200 and b"mysticeti_health_status" in body,
              f"node {a}'s /metrics answered {status} without the health families")
        texts[str(a)] = body.decode()
        status, body = scrape["/debug/flight-recorder"]
        dump = json.loads(body)
        check(status == 200 and dump["authority"] == a and dump["events"],
              f"node {a}'s flight-recorder dump is empty or not its own")
        dumps.append(len(dump["events"]))
    cluster = cluster_snapshot_from_texts(texts, n)
    check(cluster["reachable"] == sorted(texts) and not cluster["unreachable"],
          f"the cluster snapshot reached {cluster['reachable']}, not {sorted(texts)}")
    check(all(alert["stage"] == ALERT_STAGES[alert["kind"]] for alert in result["alerts"]),
          "an alert names a stage its kind does not")
    report = result["report"]
    unknown = {key for key in report["cpu_seconds"] if key.split("/")[0] not in SUBSYSTEM_NAMES}
    check(not unknown, f"ticks charged outside the registry: {unknown}")
    check(result["other_with_port_frame"] == 0,
          f"{result['other_with_port_frame']} sampled stacks holding a port frame were charged "
          f"to 'other': a module is missing from the registry")
    subsystems = report["subsystem_seconds"]
    busy = sum(v for k, v in subsystems.items() if k != "event-loop-idle")
    other = subsystems.get("other", 0.0)
    check(busy > 0 and (not card or subsystems.get("verifier-pack", 0.0) > 0),
          f"no tick was charged to verifier-pack: {subsystems}")
    lags = result["loop_lag"]
    reading.update({
        **{key: accounted[key] for key in ("flushes", "mean_live_lanes", "open_at_stop")},
        "statuses": [doc["status"] for doc in diagnoses],
        "finality_p50_s": [doc["signals"]["ingress"].get("finality", {}).get("p50_s")
                           for doc in diagnoses],
        "finality_p99_s": [doc["signals"]["ingress"].get("finality", {}).get("p99_s")
                           for doc in diagnoses],
        "alerts_by_kind": {kind: sum(a["kind"] == kind for a in result["alerts"])
                           for kind in sorted({a["kind"] for a in result["alerts"]})},
        "cluster": {key: cluster[key] for key in (
            "reachable", "unreachable", "status", "degraded_reasons", "quorum_participation",
            "commit_skew_rounds", "top_cpu_subsystems")},
        "report": report, "top_stacks": result["top_stacks"],
        "other_share": other / busy, "other_by_leaf": result["other_by_leaf"],
        "gil_convoy_ratio": report["gil_convoy_ratio"],
        "loop_lag_p50_s": [round(p50, 6) for p50, _, _ in lags],
        "loop_lag_p99_s": [round(p99, 6) for _, p99, _ in lags],
        "loop_lag_samples": [count for _, _, count in lags],
        "blocking_sites": result["blocking_sites"], "blocking_total": result["blocking_total"],
        "critical_path": result["critical_path"],
        "leaders_attributed": result["leaders_attributed"],
        "stage_seconds": result["stage_seconds"],
        "dispatch_sampled_s": result["dispatch_sampled_s"], "recorder_events": dumps,
        "offered": result["offered"], "admitted": result["admitted"],
        "warmup_s": result["warmup_s"],
    })
    return reading


async def health_sim(config, tmp_dir, make_collector, metrics):
    """``config``'s fleet (``HEALTH_SIM_10``'s shape) as a ``SimFleet`` over
    ``build_storage_node`` (no GC), node ``config["down"]`` crashed and
    rebooted from its WAL as ``config["crashes"]`` says.  Every authority
    has one ``HealthProbe`` that outlives its restarts (as the JAX package's
    chaos harness keeps them), with ``config["lag_rounds"]`` as its
    authority-lag SLO and its node's flight recorder, which dumps on alerts
    to a path in ``tmp_dir``; ``on_build`` attaches it to every incarnation
    with a ``HostMonitor`` on the dispatcher, and a crash detaches it.  A
    ``FleetHealthMonitor`` ticks every ``tick_s`` virtual seconds.  Returns
    the timeline, the alert stream, the dumps and ``verify_readings``."""
    from mysticeti_tpu_torch.config import Parameters, StorageParameters
    from mysticeti_tpu_torch.health import FleetHealthMonitor, HealthProbe, SLOThresholds
    from mysticeti_tpu_torch.hostattr import HostMonitor

    n = config["n"]
    parameters = Parameters(leader_timeout_s=CONSENSUS_LEADER_TIMEOUT_S,
                            storage=StorageParameters(**config["storage"]))
    probes = {}

    def on_build(a, node):
        monitor = HostMonitor(metrics=fleet.metrics[a], recorder=fleet.recorders[a]).start()
        node.dispatcher.blocking_monitor = monitor
        probes[a].attach(core=node.core, net_syncer=node, block_verifier=node.block_verifier,
                         commit_observer=node.syncer.commit_observer, host_monitor=monitor)

    def on_stop(a, node):
        probes[a].detach()

    fleet = SimFleet(config, tmp_dir, make_collector, parameters, metrics, on_build, on_stop)
    slo = SLOThresholds(max_authority_lag_rounds=config["lag_rounds"])
    for a, recorder in enumerate(fleet.recorders):
        recorder.dump_path = os.path.join(tmp_dir, f"flight-recorder-{a}.json")
        recorder.metrics = fleet.metrics[a]
        probes[a] = HealthProbe(a, n, metrics=fleet.metrics[a], slo=slo, recorder=recorder)
    monitor = FleetHealthMonitor(probes.get, n, interval_s=config["tick_s"])

    async def workload(fleet):
        monitor.start()
        try:
            await asyncio.sleep(config["virtual_s"] + 1.0)
        finally:
            monitor.stop()

    await fleet.run(workload)
    timeline = strip_volatile_verifier(monitor.timeline)
    result = {
        "sequences": fleet.commits.sequences(n), "timeline": timeline,
        "alerts": monitor.alert_stream(),
        "timeline_bytes": json.dumps(timeline, sort_keys=True, separators=(",", ":")).encode(),
        "alert_bytes": monitor.alert_stream_bytes(),
        "dumps": [len(r.dumps) for r in fleet.recorders],
        "dump_files": sorted(name for name in os.listdir(tmp_dir) if name.endswith(".alert")),
        "dumps_total": [summed_sample(m, "flight_recorder_dumps_total", {"trigger": "slo-alert"})
                        or 0.0 for m in fleet.metrics],
        **fleet.verify_readings(),
    }
    fleet.close()
    return result


def health_sim_run(kind, config, on_ready=None) -> dict:
    """One seeded simulation of ``health_sim`` in a temporary directory,
    every incarnation with its own verifier of ``kind`` (``_make_verifier``),
    the accelerator kinds' made and warmed before ``on_ready()`` and the
    run.  Returns the result with its wall seconds and the verifiers'
    warm-up seconds."""
    import tempfile

    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.validator import _make_verifier

    n = config["n"]
    metrics = [Metrics() for _ in range(n)]
    committee = Committee.new_for_benchmarks(n)
    prepared = {a: [] for a in range(n)}
    t0 = time.monotonic()
    for a in [*range(n), *(c[0] for c in config["crashes"])]:
        prepared[a].append(_make_verifier(kind, committee, metrics=metrics[a]))
    for verifiers in prepared.values():
        for verifier in verifiers:
            check(verifier.ready.wait(600), f"a {kind} verifier did not warm up")
    warmup_s = time.monotonic() - t0
    if on_ready is not None:
        on_ready()
    with tempfile.TemporaryDirectory(prefix="health-sim-") as d:
        t0 = time.monotonic()
        result = run_simulation(health_sim(config, d, lambda _c, a, _m: prepared[a].pop(0),
                                           metrics), seed=config["seed"])
        result["wall_s"] = time.monotonic() - t0
    result["warmup_s"] = warmup_s
    return result


def health_sim_counts(result) -> dict:
    """The values a seeded run must reproduce on any host and backend: the
    digests of the timeline (``HEALTH_STRIPPED`` keys stripped) and of the
    alert stream, and the counts beside them."""
    import hashlib

    keys = ("received", "fresh", "to_verify", "forged", "forged_rejected", "forged_injected",
            "redelivered", "on_card")
    return {"timeline_sha256": hashlib.sha256(result["timeline_bytes"]).hexdigest(),
            "alerts_sha256": hashlib.sha256(result["alert_bytes"]).hexdigest(),
            "ticks": len(result["timeline"]), "alerts": len(result["alerts"]),
            "commits": [len(seq) for seq in result["sequences"]],
            "flushes": int(result["flushes"]), "dispatched": int(result["dispatched"]),
            **{key: result[key] for key in keys}, "dumps": result["dumps"]}


def health_sim_checks(card, cpu, config) -> dict:
    """The checks of health-sim-10 (see the module docstring, step 16) on
    the card run and the ``cpu`` run of the same seed; returns the
    readings.  With ``cpu`` None (the whole script) the card is held to
    ``HEALTH_SEEDED`` alone (its timeline and alert digests included)."""
    n, down = config["n"], config["down"]
    (_, at, downtime, _), = [c for c in config["crashes"] if c[0] == down]
    commit_checks(card["sequences"], 1)
    if cpu is not None:
        check(card["sequences"] == cpu["sequences"],
              "the committed sequences differ from the cpu run's")
        check(card["timeline_bytes"] == cpu["timeline_bytes"],
              "the health timeline differs from the cpu run's")
        check(card["alert_bytes"] == cpu["alert_bytes"],
              "the alert stream differs from the cpu run's")
        check(health_sim_counts(card) == health_sim_counts(cpu),
              f"the counts differ from the cpu run's: {health_sim_counts(card)} vs "
              f"{health_sim_counts(cpu)}")
    outage = [e for e in card["timeline"] if at < e["t"] < at + downtime]
    check(outage and all(e["nodes"][str(down)] == {"down": True} for e in outage),
          f"node {down} did not read down in every tick of its outage")
    named = {a["observer"] for a in card["alerts"] if a["kind"] == "authority-lag"
             and a["authority"] == down and a["stage"] == "receive" and at < a["t"] <= at + downtime}
    check(named == set(range(n)) - {down},
          f"observers {sorted(set(range(n)) - {down} - named)} did not name node {down}")
    for entry in card["timeline"]:
        for a, snap in entry["nodes"].items():
            host = snap.get("host")
            check(host is None or (host["loop_lag_samples"] == 0 and host["blocking_calls"] == 0
                                   and host["gil_convoy_ratio"] == 0.0),
                  f"node {a}'s host block at {entry['t']} is not all-zero: {host}")
    alerting = [min(1, sum(a["observer"] == o for a in card["alerts"])) for o in range(n)]
    check(card["dumps"] == alerting == [int(v) for v in card["dumps_total"]]
          and len(card["dump_files"]) == sum(alerting),
          f"alert dumps {card['dumps']}, files {card['dump_files']}, counted "
          f"{card['dumps_total']}, observers alerting {alerting}")
    forged_checks(card)
    accounted = card_checks(card)
    return {"nodes": n, "virtual_s": config["virtual_s"], "lag_rounds": config["lag_rounds"],
            "down": [at, at + downtime], "ticks": len(card["timeline"]),
            "outage_ticks": len(outage), "lag_alerts": len(named),
            "alerts_by_kind": {kind: sum(a["kind"] == kind for a in card["alerts"])
                               for kind in sorted({a["kind"] for a in card["alerts"]})},
            "first_lag_alert_t": min((a["t"] for a in card["alerts"]
                                      if a["kind"] == "authority-lag" and a["authority"] == down),
                                     default=None),
            "dumps": card["dumps"], "flushes": accounted["flushes"],
            "mean_live_lanes": accounted["mean_live_lanes"],
            "counts": health_sim_counts(card)}


def health_phase(kernels, control=True):
    """health-tcp-10 and health-sim-10, each over the card (every node its
    own ``_make_verifier("cuda-only")``) and over the ``cpu`` kind, with the
    checks of the module docstring, step 16.  Returns the launches of the
    card's TCP and simulated runs and the readings.  ``control`` False (the
    whole script) skips health-sim-10's ``cpu`` run: ``HEALTH_SEEDED`` alone
    holds the card there (both TCP runs stay: no constant pins them)."""
    tcp_card = health_tcp_run("cuda-only", HEALTH_TCP_10,
                              on_ready=lambda: [k.reset_counts() for k in kernels])
    tcp_launches = {k.name: k.launches for k in kernels}
    tcp_cpu = health_tcp_run("cpu", HEALTH_TCP_10)
    tcp = health_tcp_checks(tcp_card, HEALTH_TCP_10, "TorchSignatureVerifier")
    tcp_oracle = health_tcp_checks(tcp_cpu, HEALTH_TCP_10, "CpuSignatureVerifier", card=False)
    check(tcp_launches["verify_keyed"] > 0 and tcp_launches["verify_generic"] == 0,
          f"the health_tcp path did not take only the keyed kernel: {tcp_launches}")
    sim_card = health_sim_run("cuda-only", HEALTH_SIM_10,
                              on_ready=lambda: [k.reset_counts() for k in kernels])
    sim_launches = {k.name: k.launches for k in kernels}
    sim_cpu = health_sim_run("cpu", HEALTH_SIM_10) if control else None
    sim = health_sim_checks(sim_card, sim_cpu, HEALTH_SIM_10)
    check(sim["counts"] == HEALTH_SEEDED,
          f"the counts differ from the seeded ones: {sim['counts']}")
    check(sim_launches["verify_generic"] == 0,
          f"the health_sim path launched the generic kernel: {sim_launches}")
    check(sim_launches["prologue"] == sim_launches["verify_keyed"] == sim_card["flushes"] > 0,
          f"the health_sim path's launches {sim_launches} are not one prologue and one keyed "
          f"launch a flush ({sim_card['flushes']:.0f})")
    card = card_line()
    for name, r, run in (("card", tcp, tcp_card), ("cpu kind", tcp_oracle, tcp_cpu)):
        print(f"health health-tcp-10 ({name}): {HEALTH_TCP_10['n']} validators over loopback "
              f"for {run['wall_s']:.1f} wall s, commits a node {r['commits_min']}-"
              f"{r['commits_max']} ({run['commits_per_wall_s']:.2f} a wall second), offered "
              f"{sum(r['offered'])} admitted {sum(r['admitted'])}, finality p50 "
              f"{r['finality_p50_s']} p99 {r['finality_p99_s']} (wall s); /health statuses "
              f"{r['statuses']}, alerts {r['alerts_by_kind']}; cluster {r['cluster']}; cpu "
              f"seconds {r['report']['cpu_seconds']}; convoy {r['gil_convoy_ratio']}, other "
              f"{r['other_share']:.4f} of the non-idle ticks (none with a port frame; by leaf "
              f"{r['other_by_leaf']}); loop lag p50 "
              f"{r['loop_lag_p50_s']} p99 {r['loop_lag_p99_s']}; blocking calls "
              f"{r['blocking_sites']}; critical path ({r['leaders_attributed']} leaders) "
              f"{r['critical_path']}; stage seconds {r['stage_seconds']}, sampled in the "
              f"dispatch {r['dispatch_sampled_s']}; {r['flushes']:.0f} "
              f"flushes, {r['mean_live_lanes']:.2f} live lanes a flush; top stacks "
              f"{r['top_stacks']} [{card}]", flush=True)
    print(f"health health-sim-10: {sim['nodes']} validators, {sim['virtual_s']} virtual s, node "
          f"{HEALTH_SIM_10['down']} down {sim['down']}, {sim['ticks']} ticks ({sim['outage_ticks']} "
          f"in the outage, all down), authority-lag ({sim['lag_rounds']} rounds) named by "
          f"{sim['lag_alerts']} observers, first at {sim['first_lag_alert_t']}; alerts "
          f"{sim['alerts_by_kind']}; dumps {sim['dumps']}; timeline and alert stream equal "
          f"{control_text(sim_cpu)}the seeded digests; {sim['flushes']:.0f} flushes, "
          f"{sim['mean_live_lanes']:.2f} live lanes a flush; {sim_card['wall_s']:.1f} s on the "
          f"card (the verifiers warmed in {sim_card['warmup_s']:.1f} s), "
          f"{control_seconds(sim_cpu)}; launches {sim_launches} [{card}]", flush=True)
    reading = {"health_tcp_10": {"card": tcp, "cpu": tcp_oracle, "launches": tcp_launches,
                                 "card_wall_s": tcp_card["wall_s"], "cpu_wall_s": tcp_cpu["wall_s"]},
               "health_sim_10": dict(sim, card_wall_s=sim_card["wall_s"],
                                     cpu_wall_s=sim_cpu and sim_cpu["wall_s"],
                                     warmup_s=sim_card["warmup_s"], launches=sim_launches),
               "card": card}
    return tcp_launches, sim_launches, reading


# -- the node phase: validators as OS processes started by the port's CLI ----


def node_child(argv) -> int:
    """One validator process of the node phase: ``python3 chip_smoke.py
    --node run --authority A ... --private-config-path DIR`` runs the port's
    ``cli.main(["run", ...])`` unchanged and, at exit, writes
    ``DIR/node_smoke.json`` with what only the harness reads: the seconds
    from this process's start to ``Validator.start_benchmarking``'s return,
    to the verifier's ``ready`` and to the stop, the collector's dispatch
    submissions, every kernel's launches and the submissions made since the
    verifier was ready (counted from a moment past the warm-up when no
    submission is in progress, so each launch there belongs to a submission
    counted there), whether this process imported torch and initialized
    CUDA, the committed leaders in order, the health status and loop lag at
    the stop, and the metrics exposition after ``Validator.stop`` (the
    reporter's final sweep)."""
    import threading

    t0 = time.monotonic()
    sys.path.insert(0, HERE)
    from mysticeti_tpu_torch import cli
    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier
    from mysticeti_tpu_torch.validator import Validator

    record = {"argv": argv, "submits": 0, "error": None}
    out_path = os.path.join(argv[argv.index("--private-config-path") + 1], "node_smoke.json")
    start, stop = Validator.start_benchmarking.__func__, Validator.stop
    submit, submit_lock = BatchedSignatureVerifier._submit_dispatch, threading.Lock()
    in_flight, at_ready = [0], {}

    def launches():
        kernels = sys.modules.get("mysticeti_tpu_torch.ops.ed25519_cuda")
        return {k.name: k.launches for k in kernels.KERNELS} if kernels else {}

    def counted_submit(self, *args):
        with submit_lock:
            record["submits"] += 1
            in_flight[0] += 1
        try:
            return submit(self, *args)
        finally:
            with submit_lock:
                in_flight[0] -= 1

    async def started(cls, *args, **kwargs):
        v = await start(cls, *args, **kwargs)
        record["started_s"] = time.monotonic() - t0
        ready = v.network_syncer.block_verifier.ready

        def watch():
            ready.wait()
            record["ready_s"] = time.monotonic() - t0
            while True:
                with submit_lock:
                    if not in_flight[0]:
                        at_ready.update(submits=record["submits"], launches=launches())
                        return
                time.sleep(0.001)

        threading.Thread(target=watch, daemon=True, name="smoke-ready-watch").start()
        return v

    async def stopped(self):
        record["stopping_s"] = time.monotonic() - t0
        doc = self.health.diagnosis()
        record["health"] = {"status": doc["status"],
                            "alerts": sorted({a["kind"] for a in doc["alerts"]})}
        lag = self.host_monitor.loop_lag
        record["loop_lag_s"] = [lag.percentile(50), lag.percentile(99)]
        await stop(self)
        record["committed"] = [[ref.authority, ref.round, ref.digest.hex()]
                               for ref in self.committed_leaders()]
        record["final_metrics"] = self.metrics.expose().decode()

    BatchedSignatureVerifier._submit_dispatch = counted_submit
    Validator.start_benchmarking = classmethod(started)
    Validator.stop = stopped
    try:
        return cli.main(argv)
    except BaseException as exc:
        record["error"] = repr(exc)
        raise
    finally:
        torch = sys.modules.get("torch")
        record.update(
            since_ready={"submits": record["submits"] - at_ready["submits"],
                         "launches": {name: n - at_ready["launches"].get(name, 0)
                                      for name, n in launches().items()}}
            if at_ready else None,
            torch_imported=torch is not None,
            cuda_initialized=bool(torch is not None and torch.cuda.is_initialized()),
            exit_s=time.monotonic() - t0)
        with open(out_path, "w") as f:
            json.dump(record, f)


class RouteProbe:
    """Polls, from a thread, every node's ``/metrics``, ``/health`` and
    ``/debug/consensus`` on 127.0.0.1 until each has answered once;
    ``answered[a][route]`` is the first answer's status and body."""

    ROUTES = ("/metrics", "/health", "/debug/consensus")

    def __init__(self, ports, interval_s: float = 1.0) -> None:
        import threading

        self.ports, self.interval_s = list(ports), interval_s
        self.answered = [{} for _ in self.ports]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="route-probe")

    def _get(self, port, route):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=10) as r:
                return r.status, r.read().decode(errors="replace")
        except urllib.error.HTTPError as exc:  # /health answers 503 while degraded
            return exc.code, exc.read().decode(errors="replace")
        except OSError:
            return None

    def _run(self):
        while not self._stop.is_set():
            for a, port in enumerate(self.ports):
                for route in self.ROUTES:
                    if route not in self.answered[a]:
                        got = self._get(port, route)
                        if got is not None:
                            self.answered[a][route] = got
            if all(len(done) == len(self.ROUTES) for done in self.answered):
                return
            self._stop.wait(self.interval_s)

    def start(self) -> "RouteProbe":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(30)


def final_series(text: str) -> dict:
    """The samples the node phase reads off a node's final exposition."""
    from mysticeti_tpu_torch.orchestrator.measurement import iter_series

    out = {"pct": {}, "invalid_blocks": 0.0, "fallback": 0.0, "flushes": 0.0, "dispatched": 0.0,
           "build": {}, "stage_s": {}}
    for name, labels, value in iter_series(text):
        if name == "histogram_pct":
            out["pct"][(labels["name"], labels["pct"])] = value
        elif name == "mysticeti_invalid_blocks_total":
            out["invalid_blocks"] += value
        elif name == "verifier_fallback_total":
            out["fallback"] += value
        elif name == "verify_dispatch_batch_size_count":
            out["flushes"] += value
        elif name == "verify_dispatch_batch_size_sum":
            out["dispatched"] += value
        elif name.startswith("mysticeti_cuda_build") and name.endswith("_total"):
            out["build"][name] = out["build"].get(name, 0.0) + value
        elif name == "verify_pipeline_stage_seconds_sum":
            out["stage_s"][labels["stage"]] = value
    return out


def free_port_base(n, prefer) -> int:
    """``prefer`` when its node ports (``base+i``) and metrics ports
    (``base+1000+i``), ``i < n``, are all free, else the first base from
    20,000 up, in steps of 100, whose ports are: another run on the machine
    (a second checkout's script, a test) may hold config 3's."""
    import socket

    from mysticeti_tpu_torch.config import DEFAULT_METRICS_PORT_OFFSET

    def free(base):
        for port in [base + i for i in range(n)] + [base + DEFAULT_METRICS_PORT_OFFSET + i
                                                     for i in range(n)]:
            with socket.socket() as s:
                # The servers' bind semantics: TIME_WAIT from an earlier
                # fleet is fine, a live listener is not.
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                try:
                    s.bind(("127.0.0.1", port))
                except OSError:
                    return False
        return True

    for base in [prefer, *range(20000, 40000, 100)]:
        if free(base):
            return base
    raise SmokeFailure(f"no free range of {n} node and {n} metrics ports")


def node_fleet(name, kind, config, root, env=None) -> dict:
    """One fleet of the node phase: ``perf_attr.run_fleet`` with every node
    started as ``python3 chip_smoke.py --node run ...`` (``node_child``),
    ``config``'s load and exit time, each node's flight recorder dumping to
    ``recorder-<authority>.json`` at shutdown, and ``env`` over this
    process's environment; a ``RouteProbe`` on every node meanwhile.
    Returns the fleet's document, every node's record, perf report and
    dump, and the probe's answers."""
    from types import SimpleNamespace

    from mysticeti_tpu_torch.config import DEFAULT_METRICS_PORT_OFFSET
    from mysticeti_tpu_torch.tools import perf_attr

    n, wd = config["n"], os.path.join(root, name)
    os.makedirs(wd, exist_ok=True)
    port_base = free_port_base(n, config["port_base"])
    print(f"node {name}: ports {port_base}+i, metrics {port_base + DEFAULT_METRICS_PORT_OFFSET}+i"
          + ("" if port_base == config["port_base"] else
             f" (config 3's {config['port_base']}+i are in use)"), flush=True)
    args = SimpleNamespace(committee_size=n, duration=config["exit_after_s"], tps=config["tps"],
                           verifier=kind, working_dir=wd, scrape_interval=config["scrape_s"],
                           round=None, port_base=port_base)
    env = dict(env or {}, TRANSACTION_SIZE=str(config["transaction_size"]),
               MYSTICETI_FLIGHT_RECORDER=os.path.join(wd, "recorder-%a.json"),
               PYTHONHASHSEED=HASH_SEED)
    probe = RouteProbe(port_base + DEFAULT_METRICS_PORT_OFFSET + a
                       for a in range(n)).start()
    t0 = time.monotonic()
    try:
        doc = perf_attr.run_fleet(args, node_command=(sys.executable, os.path.join(HERE, "chip_smoke.py"),
                                                      "--node"), env=env)
    finally:
        probe.stop()
    wall_s = time.monotonic() - t0

    def load(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    nodes = []
    for a in range(n):
        node_dir = os.path.join(wd, f"validator-{a}")
        try:
            with open(os.path.join(node_dir, "node.log"), errors="replace") as f:
                log_tail = f.read()[-3000:]
        except OSError:
            log_tail = None
        nodes.append({"record": load(os.path.join(node_dir, "node_smoke.json")),
                      "log_tail": log_tail,
                      "report": load(os.path.join(node_dir, "perf_report.json")),
                      "dump": load(os.path.join(wd, f"recorder-{a}.json")),
                      "routes": probe.answered[a],
                      "exit_code": doc["exit_codes"].get(str(a))})
    return {"name": name, "kind": kind, "doc": doc, "nodes": nodes, "wall_s": wall_s}


def node_checks(fleet, config, in_process=False, service=None) -> dict:
    """The node phase's checks on one fleet (see the module docstring, step
    17); ``in_process`` makes it a fleet whose nodes launch the kernels in
    process, ``service`` (the verifier service's launches and dispatches) one
    whose nodes reach the card through the service.  Returns the readings."""
    n, name = config["n"], fleet["name"]
    sequences, readings = [], []
    for a, node in enumerate(fleet["nodes"]):
        record = node["record"]
        check(node["exit_code"] == 0 and record is not None and record["error"] is None,
              f"{name}: node {a} exited {node['exit_code']} ({record and record['error']}); "
              f"its log ends: {node['log_tail']}")
        check(record["exit_s"] - record["started_s"] <= config["exit_after_s"] + config["grace_s"],
              f"{name}: node {a} took {record['exit_s'] - record['started_s']:.1f} s from its start "
              f"to its exit")
        for route in RouteProbe.ROUTES:
            check(route in node["routes"], f"{name}: node {a} never answered {route}")
        status, body = node["routes"]["/health"]
        check(status in (200, 503) and json.loads(body)["status"] in ("ok", "degraded"),
              f"{name}: node {a}'s /health answered {status}: {body[:200]}")
        status, body = node["routes"]["/debug/consensus"]
        check(status == 200 and json.loads(body)["authority"] == a,
              f"{name}: node {a}'s /debug/consensus answered {status}: {body[:200]}")
        series = final_series(record["final_metrics"])
        check(("proposed_block_size_bytes", "50") in series["pct"],
              f"{name}: node {a}'s final exposition holds no histogram_pct sweep")
        check(series["invalid_blocks"] == 0,
              f"{name}: node {a} counted {series['invalid_blocks']:.0f} invalid blocks")
        check(series["fallback"] == 0,
              f"{name}: node {a} degraded {series['fallback']:.0f} batches to the CPU oracle")
        dump = node["dump"]
        check(dump is not None and dump["authority"] == a and dump["events"],
              f"{name}: node {a} left no flight-recorder dump with events at shutdown")
        check(node["report"] is not None, f"{name}: node {a} wrote no perf report")
        since = record["since_ready"]
        check(since is not None, f"{name}: node {a}'s verifier never became ready")
        launches = since["launches"]
        if in_process:
            check(record["cuda_initialized"], f"{name}: node {a} never initialized CUDA")
            check(launches["verify_generic"] == 0,
                  f"{name}: node {a} launched the generic kernel since its verifier was ready: "
                  f"{launches}")
            check(launches["prologue"] == launches["verify_keyed"] == since["submits"] > 0,
                  f"{name}: node {a}'s launches since its verifier was ready {launches} are not "
                  f"one prologue and one keyed launch for each of its {since['submits']} "
                  f"dispatches since then")
            check(series["flushes"] <= record["submits"],
                  f"{name}: node {a} finished {series['flushes']:.0f} flushes of "
                  f"{record['submits']} dispatched")
        else:
            check(not any(launches.values()), f"{name}: node {a} launched kernels: {launches}")
        if service is not None:
            check(not record["cuda_initialized"],
                  f"{name}: node {a} initialized CUDA behind the verifier service")
        sequences.append([tuple(ref) for ref in record["committed"]])
        window = record["stopping_s"] - record["started_s"]
        report = node["report"]
        readings.append({
            "commits": len(record["committed"]), "window_s": window,
            "flushes": series["flushes"], "dispatched": series["dispatched"],
            "submits": record["submits"], "launches": launches,
            "stage_s": series["stage_s"],
            "verifier_pack_s": report["subsystem_seconds"].get("verifier-pack", 0.0),
            "busy_s": sum(s for k, s in report["subsystem_seconds"].items()
                          if k != "event-loop-idle"),
            "convoy": report["gil_convoy_ratio"], "mean_runnable": report["mean_runnable"],
            "loop_lag_s": record["loop_lag_s"], "health": record["health"],
            "latency_s": [series["pct"].get(("transaction_committed_latency", p))
                          for p in ("50", "99")],
            "ready_s": record.get("ready_s"), "started_s": record["started_s"],
            "build": series["build"], "torch_imported": record["torch_imported"],
            "cuda_initialized": record["cuda_initialized"]})
    commits = commit_checks(sequences, config["min_commits"])
    if service is not None:
        check(service["launches"]["verify_generic"] == 0,
              f"{name}: the verifier service launched the generic kernel: {service}")
        check(service["launches"]["prologue"] == service["launches"]["verify_keyed"]
              == service["dispatches"] > 0,
              f"{name}: the verifier service's launches {service['launches']} are not one prologue "
              f"and one keyed launch for each of its {service['dispatches']:.0f} dispatches")
        submits = sum(r["submits"] for r in readings)
        check(submits == service["dispatches"],
              f"{name}: the nodes dispatched {submits} batches and the verifier service "
              f"{service['dispatches']:.0f}: a node verified off the service")

    def mean(key):
        return statistics.fmean(r[key] for r in readings)

    flushes = sum(r["flushes"] for r in readings)
    statuses = {}
    for r in readings:
        label = r["health"]["status"] + (f" {'+'.join(r['health']['alerts'])}"
                                         if r["health"]["alerts"] else "")
        statuses[label] = statuses.get(label, 0) + 1
    return {
        "kind": fleet["kind"], "nodes": n, "wall_s": fleet["wall_s"],
        "commits": commits, "prefixes_agree": True,
        "commits_per_node_wall_s": statistics.fmean(
            r["commits"] / r["window_s"] for r in readings),
        "flushes": flushes,
        "live_lanes": sum(r["dispatched"] for r in readings) / flushes if flushes else 0.0,
        "submits": sum(r["submits"] for r in readings),
        # The collectors' device stage (submit: pack, upload, launch; or the
        # request to the service) and fetch stage (the wait for verdicts),
        # ms a flush over the fleet.
        "stage_ms_per_flush": {stage: 1e3 * sum(r["stage_s"].get(stage, 0.0) for r in readings)
                               / flushes if flushes else 0.0
                               for stage in ("pack", "device", "fetch")},
        "verifier_pack_s_per_node": mean("verifier_pack_s"),
        "busy_s_per_node": mean("busy_s"), "convoy": mean("convoy"),
        "mean_runnable": mean("mean_runnable"),
        "loop_lag_p50_s": statistics.fmean(r["loop_lag_s"][0] for r in readings),
        "loop_lag_p99_s": statistics.fmean(r["loop_lag_s"][1] for r in readings),
        "health": statuses,
        "committed_latency_p50_s": median_of(r["latency_s"][0] for r in readings),
        "committed_latency_p99_s": median_of(r["latency_s"][1] for r in readings),
        "ready_s": [min(r["ready_s"] or 0.0 for r in readings),
                    max(r["ready_s"] or 0.0 for r in readings)],
        "started_s": [min(r["started_s"] for r in readings),
                      max(r["started_s"] for r in readings)],
        "build": {k: sum(r["build"].get(k, 0.0) for r in readings)
                  for k in sorted({k for r in readings for k in r["build"]})},
        "torch_imported": sum(r["torch_imported"] for r in readings),
        "cuda_initialized": sum(r["cuda_initialized"] for r in readings),
        "launches_by_node": [r["launches"] for r in readings],
        "subsystems": fleet["doc"]["subsystems"],
        **({"service": service} if service is not None else {}),
    }


def median_of(values):
    """The median of the values that are not None (None if there are none):
    a node that committed no transaction has no committed-latency sweep."""
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def node_phase(kernels, config=None):
    """node-proc-10, node-svc-10 and the ``cpu`` kind's fleet, with the
    checks of the module docstring, step 17.  Returns the node-proc fleet's
    launches (summed over its processes, each counted from its verifier's
    ``ready``), the verifier service's, and the readings."""
    import tempfile

    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.verifier_service import ENV_SOCKET

    config = config or NODE_10
    n = config["n"]
    readings = {}
    with tempfile.TemporaryDirectory(prefix="node-") as root:
        proc = node_fleet("node-proc-10", "cuda-only", config, root)
        readings["node_proc_10"] = node_checks(proc, config, in_process=True)
        proc_launches = {k.name: sum(by_node.get(k.name, 0) for by_node in
                                     readings["node_proc_10"]["launches_by_node"])
                         for k in kernels}
        path = os.path.join(HERE, "build", "svc", "node.sock")
        service = ServiceThread(path, Committee.new_for_benchmarks(n).public_key_bytes(), "cuda:0")
        service.start()
        try:
            for k in kernels:
                k.reset_counts()
            svc = node_fleet("node-svc-10", "cuda-only", config, root, env={ENV_SOCKET: path})
            svc_launches = {k.name: k.launches for k in kernels}
        finally:
            service.stop()
        dispatches = service.server.metrics.registry.get_sample_value(
            "verify_dispatch_batch_size_count") or 0.0
        readings["node_svc_10"] = node_checks(
            svc, config, service={"launches": svc_launches, "dispatches": dispatches})
        cpu = node_fleet("node-cpu-10", "cpu", config, root)
        readings["node_cpu_10"] = node_checks(cpu, config)
    readings["card"] = card_line()
    for key in ("node_proc_10", "node_svc_10", "node_cpu_10"):
        r = readings[key]
        print(f"node {key.replace('_', '-')} ({r['kind']}): {n} validator processes, "
              f"{config['exit_after_s']} s each ({r['wall_s']:.1f} s the fleet), commits a node "
              f"{min(r['commits'])}-{max(r['commits'])} ({r['commits_per_node_wall_s']:.3f} a wall "
              f"second), prefixes agree; {r['flushes']:.0f} flushes at {r['live_lanes']:.2f} live "
              f"lanes ({r['submits']} dispatched), stage ms a flush "
              f"{ {k: round(v, 3) for k, v in r['stage_ms_per_flush'].items()} }; a node: "
              f"verifier-pack "
              f"{r['verifier_pack_s_per_node']:.3f} of {r['busy_s_per_node']:.3f} busy thread-s, "
              f"convoy {r['convoy']:.4f}, mean runnable {r['mean_runnable']:.3f}, loop lag p50 "
              f"{r['loop_lag_p50_s']:.4f} p99 {r['loop_lag_p99_s']:.4f} s; /health {r['health']}; "
              f"transaction_committed_latency p50 {r['committed_latency_p50_s']} p99 "
              f"{r['committed_latency_p99_s']} s; verifier ready {r['ready_s']} s after the "
              f"process start (started {r['started_s']}); builds {r['build']}; torch imported "
              f"{r['torch_imported']}, CUDA initialized {r['cuda_initialized']}; "
              f"{'service ' + json.dumps(r['service']) if 'service' in r else ''} "
              f"[{readings['card']}]", flush=True)
    return proc_launches, svc_launches, readings


# -- the orchestrator phase: config 3's fleet through the port's Orchestrator -


# Written by ``orchestrator_phase`` and ``fleet_benches_phase`` as
# ``sitecustomize.py`` into a directory they put first on their children's
# ``PYTHONPATH`` (so on the verifier services' and nodes' a runner starts), with ``SMOKE_FLEET_DIR`` naming where the reports go: a
# verifier service writes ``service-<pid>.start.json`` at start, snapshots its
# launch counts once its warm-up and calibration are done, and on SIGTERM
# (the runner's ``cleanup``) waits half a second for its in-flight dispatches,
# writes ``service-<pid>.json`` (the counts then, the warm snapshot, whether
# CUDA is initialized) and exits; a node (``python -m mysticeti_tpu_torch
# run``) writes ``node-<pid>.start.json`` and, should it ever initialize
# CUDA, ``node-<pid>.cuda.json``.  Every child then runs the site's own
# ``sitecustomize``.
FLEET_HOOK = '''"""Launch and context reporter of chip_smoke.py's fleet phases."""
import os
import sys

_dir = os.environ.get("SMOKE_FLEET_DIR")


def _write(name, doc):
    import json

    path = os.path.join(_dir, name)
    with open(path + ".tmp", "w") as f:
        json.dump(doc, f)
    os.replace(path + ".tmp", path)


def _counts():
    kernels = sys.modules.get("mysticeti_tpu_torch.ops.ed25519_cuda")
    return {k.name: k.launches for k in kernels.KERNELS} if kernels else {}


def _cuda_initialized():
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


if _dir and "verifier-service" in sys.orig_argv:
    import signal
    import time

    _state = {"pid": os.getpid(), "start": time.time(), "warm": None}
    _write(f"service-{os.getpid()}.start.json", _state)

    class _WarmTap:
        """Wraps ``VerifierServer._calibrate`` (the end of the service's
        warm-up) when the module loads: every later launch serves a node."""

        def find_spec(self, name, path=None, target=None):
            if name != "mysticeti_tpu_torch.verifier_service":
                return None
            import importlib.machinery

            sys.meta_path.remove(self)
            spec = importlib.machinery.PathFinder.find_spec(name, path)
            load = spec.loader.exec_module

            def exec_module(module):
                load(module)
                calibrate = module.VerifierServer._calibrate

                def tapped(server):
                    calibrate(server)
                    _state["warm"] = _counts()

                module.VerifierServer._calibrate = tapped

            spec.loader.exec_module = exec_module
            return spec

    sys.meta_path.insert(0, _WarmTap())

    def _stop(signum, frame):
        time.sleep(0.5)
        _write(f"service-{os.getpid()}.json",
               dict(_state, end=time.time(), final=_counts(),
                    cuda_initialized=_cuda_initialized()))
        os._exit(0)

    signal.signal(signal.SIGTERM, _stop)
elif _dir and sys.orig_argv[1:4] == ["-m", "mysticeti_tpu_torch", "run"]:
    import threading
    import time

    _write(f"node-{os.getpid()}.start.json", {"pid": os.getpid(), "start": time.time()})

    def _watch():
        while not _cuda_initialized():
            time.sleep(0.5)
        _write(f"node-{os.getpid()}.cuda.json", {"pid": os.getpid(), "t": time.time()})

    threading.Thread(target=_watch, daemon=True).start()


def _chain():
    import importlib.machinery
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.machinery.PathFinder.find_spec(
        "sitecustomize", [p for p in sys.path if os.path.abspath(p or os.curdir) != here])
    if spec is not None:
        spec.loader.exec_module(importlib.util.module_from_spec(spec))


_chain()
'''
def compute_apps() -> list:
    """``nvidia-smi --query-compute-apps=pid,used_memory`` as a list of lines:
    one a process holding a context on the card.  (On the card's machine
    every pid reads 1, from another pid namespace, so the phases count
    lines.)"""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    check(out.returncode == 0, f"nvidia-smi --query-compute-apps exited {out.returncode}: "
                               f"{out.stderr[-500:]}")
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def runner_tap(runner_cls):
    """``runner_cls`` (the port's ``LocalProcessRunner``) with readings taken
    around its own steps, which it runs unchanged: with each tick's host
    sample the card's compute processes; each node's pid, its last
    ``/metrics`` text and the wall time of the run's last scrape; and in
    ``cleanup``, after the nodes are killed and the service has had a moment
    to answer their last requests, the report ``FLEET_HOOK`` made the
    service write in ``report_dir`` when the runner stopped it (its launch
    counts once warm, before any node booted, and at the stop).  ``watch`` is ``WATCH_10`` with the run's
    length: the run of its load is step 19's: its nodes boot with
    ``MYSTICETI_TRACE`` set (after the service has started, which so traces
    nothing) and ``timestamp_frames`` on in the parameters file, the port's
    ``fleetmon`` starts as a child once the last node is booted, and
    ``cleanup`` waits for it to end before the nodes are killed."""

    class RunnerTap(runner_cls):
        def __init__(self, *args, report_dir, watch, **kwargs):
            super().__init__(*args, **kwargs)
            self.report_dir = report_dir
            self.watch = watch
            self.runs = []

        async def configure(self, committee_size, load_tx_s=0):
            # The card's processes before the fleet; after a first run, once
            # its killed service has left the card.
            apps = await asyncio.to_thread(compute_apps)
            for _ in range(60):
                if not self.runs or len(apps) <= len(self.runs[0]["apps_before"]):
                    break
                await asyncio.sleep(0.5)
                apps = await asyncio.to_thread(compute_apps)
            t0 = time.monotonic()
            await super().configure(committee_size, load_tx_s)
            check(self._verifier_service is not None,
                  f"the runner started no verifier service for the {self.verifier} kind")
            traced = load_tx_s == self.watch["load"]
            if traced:
                # The wire timestamps (tag 12) that give fleet_trace its
                # transit samples: the parameters file's knob, which every
                # node of this fleet understands.
                self.parameters.synchronizer.timestamp_frames = True
                self.parameters.dump(os.path.join(self.working_dir, "parameters.yaml"))
                os.environ["MYSTICETI_TRACE"] = os.path.join(self.working_dir, "trace-%p.json")
            self.runs.append({"load": load_tx_s, "apps_before": apps,
                              "service_boot_s": time.monotonic() - t0,
                              "service_pid": self._verifier_service.pid, "ticks": [],
                              "texts": {}, "t0": time.monotonic(), "traced": traced,
                              "pids": {}})

        async def boot_node(self, authority):
            await super().boot_node(authority)
            run = self.runs[-1]
            run["pids"][authority] = self.processes[authority].pid
            if run["traced"] and len(run["pids"]) == self.committee_size:
                run["fleetmon"] = await asyncio.create_subprocess_exec(
                    sys.executable, "-m", "mysticeti_tpu_torch.tools.fleetmon",
                    "--fleet-dir", self.working_dir, "--no-dashboard",
                    "--interval", str(self.watch["interval_s"]),
                    "--duration", str(self.watch["duration_s"]),
                    "--out", os.path.join(self.working_dir, "fleetmon.json"),
                    cwd=HERE, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)

        async def scrape(self, authority):
            text = await super().scrape(authority)
            if text is not None and self.runs:
                self.runs[-1]["texts"][authority] = text
                self.runs[-1]["last_scrape_wall"] = time.time()
            return text

        async def await_fleetmon(self):
            run = self.runs[-1] if self.runs else {}
            proc = run.pop("fleetmon", None)
            if proc is None:
                return
            try:
                out, err = await asyncio.wait_for(proc.communicate(),
                                                  self.watch["duration_s"] + 60)
                run["fleetmon_rc"] = proc.returncode
            except asyncio.TimeoutError:
                proc.kill()
                out, err = await proc.communicate()
                run["fleetmon_rc"] = None
            run["fleetmon_out"], run["fleetmon_err"] = out.decode(), err.decode()[-2000:]
            os.environ.pop("MYSTICETI_TRACE", None)

        async def host_sample(self):
            if self.runs:
                self.runs[-1]["ticks"].append(await asyncio.to_thread(compute_apps))
            return await super().host_sample()

        async def explain_commits(self):
            """Step 22 on the traced run, while its nodes run: the port's
            ``commit_explain`` as a child over node 0's ``/debug/consensus``,
            its last 10 decisions, then its skips."""
            run = self.runs[-1] if self.runs else {}
            if not run.get("traced") or 0 not in self.processes:
                return
            url = f"http://127.0.0.1:{self.parameters.metrics_address(0)[1]}"
            run["explain"] = {}
            for name, args in (("last", ("--last", "10")), ("skips", ("--skips",))):
                t0 = time.monotonic()
                proc = await asyncio.create_subprocess_exec(
                    sys.executable, "-m", "mysticeti_tpu_torch.tools.commit_explain",
                    "--url", url, *args, cwd=HERE, stdout=asyncio.subprocess.PIPE,
                    stderr=asyncio.subprocess.PIPE)
                out, err = await asyncio.wait_for(proc.communicate(), 60)
                run["explain"][name] = ((proc.returncode, out.decode(), err.decode()[-2000:]),
                                        time.monotonic() - t0)

        async def cleanup(self):
            await self.await_fleetmon()
            await self.explain_commits()
            run = self.runs[-1] if self.runs and self._verifier_service is not None else None
            if run is not None:
                for authority in list(self.processes):
                    await self.kill_node(authority)
                await asyncio.sleep(1.0)
                run["wall_s"] = time.monotonic() - run["t0"]
            await super().cleanup()
            if run is not None:
                path = os.path.join(self.report_dir, f"service-{run['service_pid']}.json")
                check(os.path.exists(path), f"the verifier service (pid {run['service_pid']}) "
                                            f"wrote no launch counts when it was stopped")
                run["service"] = tool_doc(path)

    return RunnerTap


def orchestrator_run_checks(collection, run, path, config) -> dict:
    """The checks of the module docstring, step 18, on one run; returns its
    readings."""
    import math

    from mysticeti_tpu_torch.orchestrator.measurement import MeasurementsCollection

    n, load = config["n"], run["load"]
    what = f"orchestrator-10 at {load} tx/s"
    counts = {a: len(series) for a, series in collection.scrapers.items()}
    check(len(counts) == n and min(counts.values()) >= config["min_scrapes"],
          f"{what}: scrapes by node {counts}, want {n} nodes with {config['min_scrapes']} each")
    duration, tps = collection.benchmark_duration(), collection.aggregate_tps()
    latency, stdev = (collection.aggregate_average_latency_s(),
                      collection.aggregate_stdev_latency_s())
    check(duration > 0 and tps > 0 and math.isfinite(latency) and latency > 0,
          f"{what}: duration {duration} s, tps {tps}, average latency {latency} s")
    check(os.path.exists(path), f"{what}: {path} was not written")
    def document(c):
        return json.dumps({
            "parameters": c.parameters,
            "scrapers": {k: [m.to_dict() for m in v] for k, v in c.scrapers.items()},
            "host_samples": c.host_samples, "health_samples": c.health_samples},
            sort_keys=True)

    check(document(MeasurementsCollection.load(path)) == document(collection),
          f"{what}: {path} does not load back equal")
    last = collection.health_samples[-1] if collection.health_samples else {}
    check(sorted(last.get("reachable", [])) == sorted(str(a) for a in range(n)),
          f"{what}: the last health sample reached {last.get('reachable')}")
    invalid, fallback, flushes, lanes = {}, {}, 0.0, 0.0
    for a in range(n):
        series = final_series(run["texts"][a])
        invalid[a], fallback[a] = series["invalid_blocks"], series["fallback"]
        flushes += series["flushes"]
        lanes += series["dispatched"]
    check(not any(invalid.values()), f"{what}: invalid blocks counted by node {invalid}")
    check(not any(fallback.values()), f"{what}: batches degraded to the CPU oracle {fallback}")
    base = len(run["apps_before"])
    check(run["ticks"] and all(len(apps) == base + 1 for apps in run["ticks"]),
          f"{what}: compute processes on the card by tick {run['ticks']} (before the fleet "
          f"{run['apps_before']}): the verifier service must be the only one added")
    service = run["service"]
    check(service["warm"] is not None and service["cuda_initialized"],
          f"{what}: the verifier service never warmed on the card: {service}")
    warm, final = service["warm"], service["final"]
    launches = {name: final.get(name, 0) - warm.get(name, 0) for name in final}
    check(launches.get("verify_generic", 0) == 0,
          f"{what}: the verifier service launched the generic kernel: {launches}")
    check(launches.get("prologue", 0) == launches.get("verify_keyed", 0) >= flushes > 0,
          f"{what}: the verifier service's launches {launches} are not one prologue and one "
          f"keyed launch a dispatch, at least the {flushes:.0f} its nodes had counted at their "
          f"last scrape")
    return {
        "load": load, "tps": tps, "avg_latency_s": latency, "stdev_latency_s": stdev,
        "benchmark_duration_s": duration, "scrapes": counts,
        "node_flushes": flushes, "live_lanes": lanes / flushes if flushes else 0.0,
        "service_launches": launches, "service_warm_launches": warm,
        "service_boot_s": run["service_boot_s"], "fleet_s": run.get("wall_s"),
        "compute_apps": {"before": run["apps_before"], "ticks": run["ticks"]},
        "health": {k: last.get(k) for k in ("status", "quorum_participation",
                                            "commit_skew_rounds")},
        "host_samples": len(collection.host_samples),
    }


def report_stages(text: str) -> list:
    """The stage column of ``trace_report``'s table."""
    lines = text.splitlines()
    if not lines or not lines[0].startswith("stage"):
        return []
    return [line.split()[0] for line in lines[1:] if line.strip()]


def watch_checks(run, collection, config, traces, report, critical, merged, lint,
                 smoke=None) -> dict:
    """The checks of the module docstring, step 19, on what the traced run
    left: ``run`` is its ``runner_tap`` record (the node pids, the wall time
    of the phase's last scrape, fleetmon's exit code and output),
    ``collection`` the phase's ``MeasurementsCollection`` of it, ``traces``
    every ``trace-*.json`` of the working directory (path -> the parsed
    document, or the error that parsing raised), ``merged`` the
    ``fleet_trace --out`` artifact (or None), and ``report``, ``critical``,
    ``lint`` and ``smoke`` each a child's ``(exit code, stdout, stderr)``:
    ``trace_report`` over node 0's trace, the same with
    ``--critical-path``, the port's lint, and ``trace_report`` over the
    metrics step's trace (None when that step did not run).  Returns the
    step's readings."""
    import re

    n, what = config["n"], "fleet-watch"
    rc, doc = run.get("fleetmon_rc"), run.get("fleetmon_doc")
    check(doc is not None and doc.get("timeline"),
          f"{what}: fleetmon wrote no timeline (exit {rc}): {run.get('fleetmon_err', '')}")
    last = doc["timeline"][-1]
    nodes = sorted(str(a) for a in range(n))
    check(sorted(last["reachable"]) == nodes and not last["unreachable"],
          f"{what}: fleetmon's last snapshot reached {last['reachable']}, not the {n} nodes")
    check(rc in (0, 3) and rc == (3 if last["status"] == "degraded" else 0),
          f"{what}: fleetmon exited {rc} on a last snapshot of status {last['status']}")
    # Agreement with the phase's own last scrape of the same nodes: some
    # fleetmon snapshot within one scrape interval of it, with the same
    # quorum participation and a commit skew apart by no more than the
    # fleet's highest commit round moved between the two (+1).
    phase = collection.health_samples[-1]
    start = doc["window_utc"][0]
    near = [s for s in doc["timeline"]
            if abs(start + s["t"] - run["last_scrape_wall"]) <= config["scrape_s"]]
    agree = [s for s in near
             if s["quorum_participation"] == phase["quorum_participation"]
             and abs(s["commit_skew_rounds"] - phase["commit_skew_rounds"])
             <= abs(s["max_commit_round"] - phase["max_commit_round"]) + 1]
    keys = ("quorum_participation", "commit_skew_rounds", "max_commit_round")
    check(agree, f"{what}: no fleetmon snapshot within {config['scrape_s']} s of the phase's "
                 f"last scrape agrees with it ({[phase[k] for k in keys]}); near, at their "
                 f"t: {[(s['t'], [s[k] for k in keys]) for s in near]}")
    want = {f"trace-{pid}.json" for pid in run["pids"].values()}
    check({os.path.basename(p) for p in traces} == want and len(want) == n,
          f"{what}: trace files {sorted(os.path.basename(p) for p in traces)}, want one a node "
          f"{sorted(want)}")
    bad = {os.path.basename(p): d for p, d in traces.items() if not isinstance(d, dict)}
    check(not bad, f"{what}: trace files that do not parse: {bad}")
    check(report[0] == 0, f"{what}: trace_report exited {report[0]}: {report[2][-1000:]}")
    stages = report_stages(report[1])
    check({"receive", "verify", "dag_add", "commit"} <= set(stages),
          f"{what}: trace_report's stage table holds {stages}")
    check(critical[0] == 0, f"{what}: trace_report --critical-path exited {critical[0]}: "
                            f"{critical[2][-1000:]}")
    found = re.search(r"critical-path attribution over (\d+) committed", critical[1])
    check(found and int(found.group(1)) >= 1,
          f"{what}: the critical path attributes no committed leader: {critical[1][:500]}")
    check(merged is not None, f"{what}: fleet_trace wrote no artifact")
    offsets = merged["skew"]["offsets_us"]
    check(sorted(offsets) == nodes, f"{what}: the merge's skew table covers {sorted(offsets)}")
    check(merged["transit_observations"] > 0,
          f"{what}: the traces hold no transit sample (the wire timestamps were off)")
    committed = [j for j in merged["journeys"]
                 if any("commit" in stages_ for stages_ in j["nodes"].values())]
    check(merged["journeys_total"] >= 1 and committed,
          f"{what}: the merge has {merged['journeys_total']} journeys, none a committed leader's")
    check(lint[0] == 0 and "mysticeti-lint: 0 new finding(s)" in lint[1],
          f"{what}: the port's lint exited {lint[0]}: {lint[1][-2000:]}{lint[2][-1000:]}")
    if smoke is not None:
        check(smoke[0] == 0 and "verify_dispatch" in report_stages(smoke[1]),
              f"{what}: trace_report over the metrics step's trace exited {smoke[0]}: "
              f"{smoke[1][-500:]}{smoke[2][-500:]}")
    return {
        "fleetmon_rc": rc, "fleetmon_status": last["status"],
        "fleetmon_reasons": last.get("degraded_reasons"), "fleetmon_ticks": len(doc["timeline"]),
        "fleetmon_last": {k: last[k] for k in ("quorum_participation", "commit_skew_rounds",
                                               "max_commit_round")},
        "phase_last": {k: phase[k] for k in ("quorum_participation", "commit_skew_rounds",
                                             "max_commit_round")},
        "traces": len(traces), "stages": stages,
        "critical_path_leaders": int(found.group(1)),
        "max_abs_skew_ms": max(abs(v) for v in offsets.values()) / 1e3,
        "skew_authorities": len(offsets),
        "journeys": merged["journeys_total"], "fully_stitched": merged["fully_stitched"],
        "transit_observations": merged["transit_observations"],
        "smoke_trace_stages": report_stages(smoke[1]) if smoke is not None else None,
    }


def explain_checks(run) -> dict:
    """Step 22's ``commit_explain`` on the traced run: both calls exit 0, the
    header names node 0, ``--last 10`` explains 1-10 decisions and every
    explanation names its commit rule (direct or indirect).  Returns the
    explanations counted and the seconds."""
    import re

    explain = run.get("explain")
    check(explain and set(explain) == {"last", "skips"},
          f"commit_explain did not run on the traced run: {explain}")
    readings = {}
    for name, ((rc, out, err), seconds) in explain.items():
        check(rc == 0, f"commit_explain {name} exited {rc}: {out[-1000:]}{err[-1000:]}")
        check(out.startswith("# authority=0 "),
              f"commit_explain {name}: the header does not name node 0: {out[:200]}")
        slots = [line for line in out.splitlines() if line.startswith("slot ")]
        unnamed = [line for line in slots
                   if not re.search(r" via the (direct|indirect) rule$", line)]
        check(not unnamed, f"commit_explain {name}: explanations without a commit rule: "
                           f"{unnamed[:3]}")
        readings[name] = {"explained": len(slots), "seconds": seconds,
                          "rules": sorted({line.rsplit(" ", 2)[1] for line in slots})}
        if name == "skips":
            check(all(" SKIP via " in line for line in slots),
                  f"commit_explain --skips explained a commit: {slots[:3]}")
    check(1 <= readings["last"]["explained"] <= 10,
          f"commit_explain --last 10 explained {readings['last']['explained']} decisions")
    readings["sample"] = explain["last"][0][1].splitlines()[:4]
    return readings


def watch_phase(run, collection, config, wd, smoke_trace=None) -> dict:
    """Step 19 after orchestrator-10: the port's tools as children on what
    the traced run left in ``wd`` (its traces and fleetmon's timeline), the
    metrics step's trace (``smoke_trace``, when given) and the port's lint;
    then ``watch_checks``."""
    import glob

    tool = run_tool
    t0 = time.monotonic()
    path = os.path.join(wd, "fleetmon.json")
    if os.path.exists(path):
        with open(path) as f:
            run["fleetmon_doc"] = json.load(f)
    traces = {}
    for trace in sorted(glob.glob(os.path.join(wd, "trace-*.json"))):
        try:
            with open(trace) as f:
                traces[trace] = json.load(f)
        except ValueError as exc:
            traces[trace] = repr(exc)
    node0 = os.path.join(wd, f"trace-{run['pids'].get(0)}.json")
    report, report_s = tool("tools.trace_report", node0)
    critical, _ = tool("tools.trace_report", node0, "--critical-path")
    out = os.path.join(wd, "fleet-trace.json")
    merge, merge_s = tool("tools.fleet_trace", *sorted(traces), "--out", out)
    merged = None
    if merge[0] == 0 and os.path.exists(out):
        with open(out) as f:
            merged = json.load(f)
    smoke = tool("tools.trace_report", smoke_trace)[0] if smoke_trace else None
    lint, lint_s = tool("analysis", "--no-cache")
    reading = watch_checks(run, collection, config, traces, report, critical, merged, lint, smoke)
    reading.update(
        report_s=report_s, merge_s=merge_s, lint_s=lint_s, step_s=time.monotonic() - t0,
        trace_bytes=sum(os.path.getsize(p) for p in traces), report=report[1],
        critical_path=critical[1].splitlines()[:8], merge_summary=merge[1].splitlines()[:3],
        smoke_report=smoke[1] if smoke is not None else None, lint=lint[1].strip(),
        fleetmon_frame=run.get("fleetmon_out", "").strip())
    return reading


def orchestrator_phase(kernels, config=None, smoke_trace=None):
    """orchestrator-10 with the checks of the module docstring, step 18,
    and step 19 on its 10,000 tx/s run (``watch_phase``; ``smoke_trace`` is
    the metrics step's trace, None when that step did not run).  Returns
    the verifier service's launches over both runs (each counted from the
    service's warm state, before the run's first node boots, to its last
    node's kill) and the readings."""
    import shutil

    from mysticeti_tpu_torch import config as port_config
    from mysticeti_tpu_torch.orchestrator.benchmark import LoadType, ParametersGenerator
    from mysticeti_tpu_torch.orchestrator.logs import analyze_logs
    from mysticeti_tpu_torch.orchestrator.orchestrator import Orchestrator
    from mysticeti_tpu_torch.orchestrator.plot import plot_latency_throughput
    from mysticeti_tpu_torch.orchestrator.runner import LocalProcessRunner

    config = config or ORCHESTRATOR_10
    n = config["n"]
    root = os.path.join(HERE, "build", "orchestrator-10")
    shutil.rmtree(root, ignore_errors=True)
    wd, results, hook, report_dir = (os.path.join(root, d) for d in (
        "fleet", "results", "hook", "reports"))
    for d in (wd, hook, report_dir):
        os.makedirs(d)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(FLEET_HOOK)
    port_base = free_port_base(n, config["port_base"])
    print(f"orchestrator-10: ports {port_base}+i" + (
        "" if port_base == config["port_base"] else
        f" (config 3's {config['port_base']}+i are in use)"), flush=True)
    saved_env = {k: os.environ.get(k) for k in ("PYTHONPATH", "SMOKE_FLEET_DIR",
                                                "MYSTICETI_NO_VERIFIER_SERVICE",
                                                "MYSTICETI_TRACE")}
    saved_base = port_config.DEFAULT_PORT_BASE
    os.environ.update(PYTHONPATH=os.pathsep.join(
        [hook] + ([saved_env["PYTHONPATH"]] if saved_env["PYTHONPATH"] else [])),
        SMOKE_FLEET_DIR=report_dir)
    for k in ("MYSTICETI_NO_VERIFIER_SERVICE", "MYSTICETI_TRACE"):
        os.environ.pop(k, None)
    port_config.DEFAULT_PORT_BASE = port_base
    runner = runner_tap(LocalProcessRunner)(
        wd, verifier=config["verifier"], transaction_size=config["transaction_size"],
        report_dir=report_dir, watch=dict(WATCH_10, duration_s=config["duration_s"]))
    orchestrator = Orchestrator(
        runner, ParametersGenerator(n, LoadType.fixed(list(config["loads"])),
                                    duration_s=config["duration_s"]),
        results_dir=results, scrape_interval_s=config["scrape_s"])
    async def drive():
        try:
            return await orchestrator.run_benchmarks()
        finally:
            await runner.cleanup()

    t0 = time.monotonic()
    try:
        collections = asyncio.run(drive())
    finally:
        port_config.DEFAULT_PORT_BASE = saved_base
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    phase_s = time.monotonic() - t0
    check(len(collections) == len(config["loads"]) == len(runner.runs),
          f"orchestrator-10 ran {len(collections)} of {len(config['loads'])} loads")
    readings = {"runs": [orchestrator_run_checks(c, run, os.path.join(
        results, f"measurements-{i}.json"), config)
        for i, (c, run) in enumerate(zip(collections, runner.runs))]}
    written = plot_latency_throughput(collections, os.path.join(results, "latency-throughput"))
    check(written and written[0].endswith(".txt"), f"the plot wrote {written}")
    analysis = analyze_logs(wd)
    check(sorted(analysis.node_errors) == [f"node-{a}.log" for a in range(n)],
          f"the log analysis read {sorted(analysis.node_errors)}")
    with open(written[0]) as f:
        plot_text = f.read()
    launches = {k.name: sum(r["service_launches"].get(k.name, 0) for r in readings["runs"])
                for k in kernels}
    traced = [i for i, run in enumerate(runner.runs) if run["traced"]]
    check(len(traced) == 1, f"orchestrator-10 traced runs {traced}, want the "
                            f"{WATCH_10['load']} tx/s run's")
    watch = watch_phase(runner.runs[traced[0]], collections[traced[0]], config, wd, smoke_trace)
    explained = explain_checks(runner.runs[traced[0]])
    readings.update(commit_explain=explained, phase_s=phase_s, plot=[os.path.basename(p) for p in written],
                    plot_text=plot_text, logs=analysis.display(), card=card_line(), watch=watch)
    print(analysis.display(), flush=True)
    for r in readings["runs"]:
        print(f"orchestrator-10 at {r['load']} tx/s ({r['load'] // n} a node, "
              f"{config['transaction_size']} B): tps {r['tps']:.1f}, latency avg "
              f"{r['avg_latency_s']:.4f} s stdev {r['stdev_latency_s']:.4f} s, benchmark "
              f"duration {r['benchmark_duration_s']:.3f} s; scrapes {r['scrapes']}; the nodes' "
              f"{r['node_flushes']:.0f} flushes at {r['live_lanes']:.2f} live lanes (last "
              f"scrape), the service's launches {r['service_launches']} (warm-up "
              f"{r['service_warm_launches']}), service boot {r['service_boot_s']:.1f} s, fleet "
              f"{r['fleet_s']:.1f} s; compute processes before {len(r['compute_apps']['before'])}"
              f", by tick {[len(t) for t in r['compute_apps']['ticks']]}; last health "
              f"{r['health']}; the phase {phase_s:.1f} s [{readings['card']}]", flush=True)
    traced_run = readings["runs"][traced[0]]

    def beside(key, value):
        low, high = WATCH_10["untraced"][key]
        where = "inside" if low <= value <= high else "OUTSIDE"
        return f"{where} the untraced {low}-{high}"

    print(f"fleet-watch (step 19) on the {traced_run['load']} tx/s run: fleetmon exit "
          f"{watch['fleetmon_rc']} ({watch['fleetmon_status']}: {watch['fleetmon_reasons']}), "
          f"{watch['fleetmon_ticks']} ticks, last {watch['fleetmon_last']} against the phase's "
          f"last scrape {watch['phase_last']}; {watch['traces']} traces "
          f"({watch['trace_bytes']} B), stages {watch['stages']}, critical path over "
          f"{watch['critical_path_leaders']} committed leaders; merge: {watch['journeys']} "
          f"journeys ({watch['fully_stitched']} fully stitched, "
          f"{watch['transit_observations']} transit samples), largest |skew| "
          f"{watch['max_abs_skew_ms']:.3f} ms over {watch['skew_authorities']} authorities; "
          f"tracing on: tps {traced_run['tps']:.1f} ({beside('tps', traced_run['tps'])}), "
          f"latency avg {traced_run['avg_latency_s']:.4f} s "
          f"({beside('avg_latency_s', traced_run['avg_latency_s'])} s); lint: {watch['lint']} "
          f"in {watch['lint_s']:.2f} s; trace_report {watch['report_s']:.2f} s, fleet_trace "
          f"{watch['merge_s']:.2f} s, the step's tools {watch['step_s']:.1f} s "
          f"[{readings['card']}]", flush=True)
    print(f"commit_explain (step 22) over node 0 of the {traced_run['load']} tx/s run, while it "
          f"ran: --last 10 explained {explained['last']['explained']} decisions (rules "
          f"{explained['last']['rules']}) in {explained['last']['seconds']:.2f} s, --skips "
          f"{explained['skips']['explained']} (rules {explained['skips']['rules']}) in "
          f"{explained['skips']['seconds']:.2f} s; every explanation names its rule "
          f"[{readings['card']}]", flush=True)
    print("\n".join(explained["sample"]), flush=True)
    print(watch["fleetmon_frame"], flush=True)
    print(watch["report"], flush=True)
    print("\n".join(watch["critical_path"]), flush=True)
    if watch["smoke_report"] is not None:
        print(watch["smoke_report"], flush=True)
    return launches, readings


# -- the byzantine phase: the adversary engine's attacks on the card ---------


class VerdictLog:
    """A signature backend that records every dispatch made through it —
    (public keys, digests, signatures, verdicts) — in the order the
    verdicts come back.  Every other attribute is the backend's."""

    def __init__(self, backend):
        self.backend = backend
        self.dispatches = []

    def verify_signatures_async(self, public_keys, digests, signatures):
        args = (list(public_keys), list(digests), list(signatures))
        return LoggedDispatch(self, self.backend.verify_signatures_async(*args), args)

    def __getattr__(self, name):
        return getattr(self.backend, name)


class LoggedDispatch:
    def __init__(self, log, handle, args):
        self.log, self.handle, self.args = log, handle, args

    def result(self):
        out = self.handle.result()
        self.log.dispatches.append((*self.args, [bool(ok) for ok in out]))
        return out


class TwinTap:
    """Interposes on ``scenarios.run_chaos_sim`` for the ``run_scenario``
    calls inside the ``with``: ``before(i)`` runs before twin ``i`` (0 the
    attacked run, 1 the clean twin), and each twin's report, per-node
    registries and wall seconds are kept."""

    def __init__(self, scenarios, before=None):
        self.scenarios, self.before, self.twins = scenarios, before, []

    def __enter__(self):
        self.original = self.scenarios.run_chaos_sim
        self.scenarios.run_chaos_sim = self.run
        return self

    def __exit__(self, *exc):
        self.scenarios.run_chaos_sim = self.original

    def run(self, *args, **kwargs):
        if self.before is not None:
            self.before(len(self.twins))
        t0 = time.monotonic()
        report, harness = self.original(*args, **kwargs)
        self.twins.append({"report": report, "metrics": harness.metrics,
                           "wall_s": time.monotonic() - t0})
        return report, harness


def labelled_sum(metrics, name, **labels) -> float:
    """``name``'s samples whose labels include ``labels``, summed over
    ``metrics`` (one registry a node)."""
    return sum(sample.value for m in metrics for family in m.registry.collect()
               for sample in family.samples if sample.name == name
               and all(sample.labels.get(k) == v for k, v in labels.items()))


def twin_counts(twin) -> dict:
    """A twin's committed leaders a node, the collectors' flushes, live
    lanes and rejected signatures (every node's registry), and its
    detections."""
    report, metrics = twin["report"], [m for m in twin["metrics"] if m is not None]
    sequences = report.sequences
    return {
        "commits": [len(sequences[a]) for a in sorted(sequences)],
        "flushes": int(labelled_sum(metrics, "verify_dispatch_batch_size_count")),
        "lanes": int(labelled_sum(metrics, "verify_dispatch_batch_size_sum")),
        "rejected": int(labelled_sum(metrics, "verified_signatures_total", outcome="rejected")),
    }


def document_digest(doc) -> str:
    import hashlib

    return hashlib.sha256(json.dumps(doc, sort_keys=True, separators=(",", ":"))
                          .encode()).hexdigest()


def byzantine_run(scenarios, config, backend=None, before=None) -> dict:
    """One ``scenarios.run_scenario`` of ``config``'s scenario cut to
    ``config["virtual_s"]``: through ``real_crypto=True`` on ``backend``
    (every node's collector over it), or, with ``backend`` None, through the
    sim re-sign oracle.  ``scenarios`` is the package's module; ``before``
    as ``TwinTap`` takes it.  Returns the verdict document, the twins and
    the wall seconds."""
    import dataclasses
    import tempfile

    scenario = dataclasses.replace(scenarios.scenario_by_name(config["scenario"]),
                                   duration_s=config["virtual_s"])
    with tempfile.TemporaryDirectory(prefix="byzantine-") as root, \
            TwinTap(scenarios, before) as tap:
        t0 = time.monotonic()
        crypto = {} if backend is None else {"real_crypto": True, "backend": backend}
        doc = scenarios.run_scenario(scenario, root, **crypto)
        wall_s = time.monotonic() - t0
    return {"doc": doc, "twins": tap.twins, "wall_s": wall_s}


def byzantine_counts(result) -> dict:
    """The values a seeded run must reproduce on any host and backend."""
    report = result["twins"][0]["report"]
    detections = report.detections
    n = len(report.sequences)
    twins = [twin_counts(twin) for twin in result["twins"]]
    return {
        "commits": twins[0]["commits"], "clean_commits": twins[1]["commits"],
        "flushes": [t["flushes"] for t in twins], "lanes": [t["lanes"] for t in twins],
        "rejected": [t["rejected"] for t in twins],
        "attack_counts": dict(sorted(report.attack_counts.items())),
        "attack_digest": report.attack_digest(),
        "invalid_signature": [int(detections.get(a, {}).get("invalid_blocks", {}).get(
            "authority=9,reason=signature", 0)) for a in range(n)],
        "equivocation": [{label: int(v) for label, v in detections.get(a, {}).get(
            "equivocation", {}).items()} for a in range(n)],
        "node9_blocks": [report.committed_blocks.get(a, {}).get(9, 0) for a in range(n)],
        "document": document_digest(result["doc"]),
    }


def byzantine_checks(result, config, seeded) -> dict:
    """Checks 1, 2 and 5 of byzantine-10 (the module docstring, step 20)
    against ``seeded``; returns the readings."""
    doc = result["doc"]
    # 1: safety and liveness.
    check(doc["safety_ok"] and len(result["twins"]) == 2,
          f"the honest fleet broke safety: {doc['safety_error']}")
    report = result["twins"][0]["report"]
    adversaries = set(config["adversaries"])
    counts = byzantine_counts(result)
    honest = [a for a in range(len(counts["commits"])) if a not in adversaries]
    check(all(d.get("adversary") in adversaries for d in doc["adversary_divergence"]),
          f"a divergence names an honest node: {doc['adversary_divergence']}")
    prefixes = {a: [(r.authority, r.round, bytes(r.digest)) for r in report.sequences[a]]
                for a in honest}
    longest = max(prefixes.values(), key=len)
    check(all(seq == longest[:len(seq)] for seq in prefixes.values()),
          "the honest committed sequences are not prefixes of one sequence")
    check(all(2 * counts["commits"][a] >= seeded["commits"][a] for a in honest),
          f"commits a node {counts['commits']}: an honest node committed less than half of "
          f"{seeded['commits']}")
    # 2: attacks and detections.
    check(counts["attack_counts"] == seeded["attack_counts"]
          and counts["attack_digest"] == seeded["attack_digest"],
          f"the attacks {counts['attack_counts']} ({counts['attack_digest'][:16]}) are not the "
          f"seeded ones")
    check(all(counts["invalid_signature"][a] == seeded["invalid_signature"][a] > 0
              for a in honest),
          f"invalid signatures of node {config['invalid_signer']} counted a node "
          f"{counts['invalid_signature']}, seeded {seeded['invalid_signature']}")
    check(all(set(census) <= {f"authority={config['equivocator']}"}
              for census in counts["equivocation"])
          and any(counts["equivocation"][a] for a in honest),
          f"equivocations attributed {counts['equivocation']}")
    check(all(counts["node9_blocks"][a] <= 1 for a in honest),
          f"node {config['invalid_signer']}'s blocks committed in honest stores: "
          f"{counts['node9_blocks']}")
    # 5: the scenario's own verdict and its document.
    check(doc["passed"] and all(v["ok"] for v in doc["detections"].values())
          and doc["throughput_ratio"] >= doc["scenario"]["min_ratio"],
          f"the scenario's verdict failed: ratio {doc['throughput_ratio']}, detections "
          f"{doc['detections']}")
    check(counts == seeded, f"the counts differ from the seeded ones: {counts}")
    return {"commits": counts["commits"], "clean_commits": counts["clean_commits"],
            "flushes": counts["flushes"], "lanes": counts["lanes"],
            "mean_live_lanes": [lanes / flushes if flushes else 0.0
                                for lanes, flushes in zip(counts["lanes"], counts["flushes"])],
            "rejected": counts["rejected"], "attack_counts": counts["attack_counts"],
            "invalid_signature": counts["invalid_signature"],
            "throughput_ratio": doc["throughput_ratio"],
            "committed_leaders": doc["committed_leaders"],
            "twin_wall_s": [twin["wall_s"] for twin in result["twins"]],
            "wall_s": result["wall_s"]}


def verdict_checks(log, committee) -> dict:
    """Check 3: every verdict the card gave equals the sim re-sign oracle's
    on the same (key, digest, signature).  Runs after the scenario, off its
    timed path."""
    from mysticeti_tpu_torch.scenarios import SimResignOracleVerifier

    t0 = time.monotonic()
    oracle = SimResignOracleVerifier(committee)
    lanes = mismatches = card_rejected = oracle_rejected = 0
    for pks, digests, sigs, verdicts in log.dispatches:
        want = oracle.verify_signatures(pks, digests, sigs)
        lanes += len(want)
        mismatches += sum(got != ok for got, ok in zip(verdicts, want))
        card_rejected += verdicts.count(False)
        oracle_rejected += want.count(False)
    check(lanes > 0 and mismatches == 0 and card_rejected == oracle_rejected > 0,
          f"{mismatches} of {lanes} card verdicts differ from the oracle's (rejected: card "
          f"{card_rejected}, oracle {oracle_rejected})")
    return {"lanes": lanes, "mismatches": mismatches, "card_rejected": card_rejected,
            "oracle_rejected": oracle_rejected, "oracle_s": time.monotonic() - t0}


def byzantine_phase(kernels, oracle_twin=False):
    """byzantine-10 on the card with the checks of the module docstring,
    step 20: ``run_scenario(real_crypto=True)`` over one warmed
    ``TorchSignatureVerifier`` on cuda:0, the launch counts set to 0 before
    each twin and read after it.  ``oracle_twin`` also runs the sim re-sign
    oracle's twin here and requires its document to be the card's.
    Returns the launches (both twins) and the readings."""
    from mysticeti_tpu_torch import scenarios
    from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee

    config, seeded = BYZANTINE_10, BYZANTINE_SEEDED
    committee = Committee.new_for_benchmarks(10)
    t0 = time.monotonic()
    backend = TorchSignatureVerifier(committee_keys=committee.public_key_bytes())
    backend.warmup()  # the kernels' first launches and the combs' upload
    warmup_s = time.monotonic() - t0
    log = VerdictLog(backend)
    twin_launches = []

    def before(i):
        if i:
            twin_launches.append({k.name: k.launches for k in kernels})
        for k in kernels:
            k.reset_counts()

    card = byzantine_run(scenarios, config, backend=log, before=before)
    twin_launches.append({k.name: k.launches for k in kernels})
    reading = byzantine_checks(card, config, seeded)
    # 4: one prologue and one keyed launch a flush in each twin, no generic.
    for twin, launches in zip(("attacked", "clean"), twin_launches):
        flushes = reading["flushes"][0 if twin == "attacked" else 1]
        check(launches["prologue"] == launches["verify_keyed"] == flushes > 0
              and launches["verify_generic"] == 0,
              f"the {twin} twin's launches {launches} are not one prologue and one keyed "
              f"launch a flush ({flushes})")
    check(len(log.dispatches) == sum(reading["flushes"]),
          f"{len(log.dispatches)} dispatches reached the card, the collectors flushed "
          f"{reading['flushes']}")
    verdicts = verdict_checks(log, committee)
    launches = {name: sum(t[name] for t in twin_launches) for name in twin_launches[0]}
    reading.update({"verdicts": verdicts, "launches_by_twin": twin_launches,
                    "warmup_s": warmup_s, "card": card_line()})
    oracle_text = ""
    if oracle_twin:
        oracle = byzantine_run(scenarios, config)
        check(oracle["doc"] == card["doc"],
              "the sim re-sign oracle's verdict document differs from the card's")
        reading["oracle_wall_s"] = oracle["wall_s"]
        oracle_text = f"; oracle twin {oracle['wall_s']:.1f} s, same document"
    print(f"byzantine byzantine-10: 10 validators, f = 3 (node 7 equivocates, 8 withholds, 9 "
          f"signs invalidly), {config['virtual_s']} virtual s a twin; commits a node "
          f"{reading['commits']} (clean twin {reading['clean_commits']}), honest prefixes agree, "
          f"safety held; attacks {reading['attack_counts']}; invalid signatures counted a node "
          f"{reading['invalid_signature']}; ratio {reading['throughput_ratio']}, the verdict "
          f"passed and equals the seeded document; card verdicts {verdicts['lanes']} lanes, "
          f"{verdicts['mismatches']} differ from the oracle's, rejected {verdicts['card_rejected']} "
          f"= oracle {verdicts['oracle_rejected']} (oracle {verdicts['oracle_s']:.1f} s, off the "
          f"timed path); flushes {reading['flushes']}, live lanes a flush "
          f"{[round(x, 3) for x in reading['mean_live_lanes']]}; twins "
          f"{[round(x, 1) for x in reading['twin_wall_s']]} s, the scenario {card['wall_s']:.1f} "
          f"s on the card (the backend warmed in {warmup_s:.1f} s){oracle_text}; launches by "
          f"twin {twin_launches} [{reading['card']}]", flush=True)
    return launches, reading


def bench_phase() -> dict:
    """``python -m mysticeti_tpu_torch.bench`` as a child, on BENCH_ENV."""
    env = dict(os.environ, **BENCH_ENV,
               BENCH_TREND_PATH=os.path.join(TOOLS_DIR, "BENCH_TREND.json"))
    env.pop("BENCH_WORKER", None)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "mysticeti_tpu_torch.bench"], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines,
          f"the bench exited {proc.returncode}: {proc.stderr[-2000:]}")
    record = json.loads(lines[-1])
    check(record.get("metric") == "ed25519_verifies_per_sec" and record.get("rung") == 0
          and record.get("value", 0) > 0, f"bench line {lines[-1]}")
    record["seconds"] = time.monotonic() - t0
    record["env"] = BENCH_ENV
    print(json.dumps({"bench": record}), flush=True)
    return record


def tool_doc(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def tools_phase(kernels) -> tuple:
    """Step 22's standalone tools, each ``python -m
    mysticeti_tpu_torch.tools.<name>`` in a child on the card, with the
    checks of the module docstring: ``kernel_parity``, ``bench_probe``,
    ``mesh_scaling`` on the one card, ``storage_probe --quick --verifier
    cuda-only`` on ``STORAGE_PROBE_SCENARIOS`` and ``bench_trend`` over
    ``TOOLS_DIR``.  Returns the
    launches their processes counted (each from 0, the tool's own path) and
    the readings."""
    from mysticeti_tpu_torch.tools.storage_probe import SCENARIOS, deterministic

    os.makedirs(TOOLS_DIR, exist_ok=True)
    t0 = time.monotonic()
    launches = {k.name: 0 for k in kernels}
    by_tool = {}

    def counted(tool, counts):
        by_tool[tool] = counts
        for name, n in counts.items():
            launches[name] += n

    def ran(tool, result):
        (rc, out, err), seconds = result
        check(rc == 0, f"{tool} exited {rc}: {out[-2000:]}{err[-2000:]}")
        return out, seconds

    # kernel_parity: every bit of both dispatch paths against the oracle.
    path = os.path.join(TOOLS_DIR, "KERNEL_PARITY.json")
    _, parity_s = ran("kernel_parity", run_tool(
        "tools.kernel_parity", "--n", str(KERNEL_PARITY_N), "--seed", str(SEED), "--out", path))
    parity = tool_doc(path)
    check(parity["pass"] and parity["backend"] == "cuda"
          and parity["rfc8032"] == {"accept_all_valid": True, "reject_all_corrupt": True},
          f"kernel_parity: pass {parity['pass']}, backend {parity['backend']}, "
          f"RFC 8032 {parity['rfc8032']}")
    for name, r in parity["randomized"].items():
        check(r["cases"] == KERNEL_PARITY_N and r["mismatches"] == 0
              and set(r["per_class"]) == set(CLASSES)
              and all(c["mismatches"] == 0 for c in r["per_class"].values()),
              f"kernel_parity {name}: {r}")
    counted("kernel_parity", parity["launches"])
    check(all(parity["launches"][k] > 0 for k in ("prologue", "verify_generic", "verify_keyed")),
          f"kernel_parity did not take the prologue, generic and keyed kernels: "
          f"{parity['launches']}")

    # bench_probe: the split of a batch's time.
    out, probe_s = ran("bench_probe", run_tool("tools.bench_probe"))
    probe = json.loads(out.strip().splitlines()[-1])
    keys = ("null_rtt_ms", "h2d_MBps", "kernel_ms_per_batch", "kernel_only_sig_s",
            "e2e_sig_s_16iters", "e2e_ms_per_batch")
    check(probe["backend"] == "cuda" and all(probe[k] > 0 for k in keys)
          and probe["kernel_ms_per_batch"] < probe["e2e_ms_per_batch"],
          f"bench_probe readings {probe}")
    counted("bench_probe", probe["launches"])

    # mesh_scaling: its one-card point, the summed count equal to the batch.
    path = os.path.join(TOOLS_DIR, "MULTICHIP_SCALING.json")
    _, mesh_s = ran("mesh_scaling", run_tool(
        "tools.mesh_scaling", "--sizes", "1", "--real", "--out", path))
    point, = tool_doc(path)["points"]
    check(point["devices"] == 1 and point["psum_total_ok"]
          and point["per_shard_batch"] == point["global_batch"] > 0,
          f"mesh_scaling's one-card point {point}")
    counted("mesh_scaling", point["launches"])

    # storage_probe: both scenarios on the card, their seeded fields.
    path = os.path.join(TOOLS_DIR, "STORAGE_r08.json")
    chosen = [a for name in STORAGE_PROBE_SCENARIOS for a in ("--scenario", name)]
    _, storage_s = ran("storage_probe", run_tool(
        "tools.storage_probe", "--quick", "--verifier", "cuda-only", *chosen, "--out", path,
        timeout=900))
    storage = tool_doc(path)
    scenarios = tuple(SCENARIOS[name] for name in STORAGE_PROBE_SCENARIOS)
    check(all(storage[name]["pass"] for name in scenarios), "storage_probe: a scenario failed")
    seeded = deterministic(storage)
    check(seeded == json.loads(json.dumps(STORAGE_PROBE_SEEDED)),
          f"storage_probe's seeded fields differ from STORAGE_PROBE_SEEDED: {seeded}")
    for name in scenarios:
        counts = storage[name]["launches"]
        check(counts["prologue"] == counts["verify_keyed"] > 0 and counts["verify_generic"] == 0,
              f"storage_probe {name}'s launches {counts} are not one prologue and one keyed "
              f"launch a flush")
    counted("storage_probe", {k.name: sum(storage[n]["launches"][k.name] for n in scenarios)
                              for k in kernels})

    # bench_trend over the records this run wrote (the bench's live append).
    out, trend_s = ran("bench_trend", run_tool("tools.bench_trend", "--repo", TOOLS_DIR))
    scored = int(out.split(" scored record(s)", 1)[0].rsplit(" ", 1)[-1])
    index = tool_doc(os.path.join(TOOLS_DIR, "BENCH_TREND.json"))["records"]
    check(scored >= 1 and index and all(r.get("card") for r in index),
          f"bench_trend: {scored} scored records, index {index}")

    reading = {
        "kernel_parity": {"seconds": parity_s, "cases": {
            c: parity["randomized"]["verify_batch_raw"]["per_class"][c]["cases"]
            for c in CLASSES}, "oracle_accepts": parity["oracle_accepts"],
            "mismatches": {name: r["mismatches"] for name, r in parity["randomized"].items()},
            "rfc8032": parity["rfc8032"], "tool_seconds": parity["seconds"],
            "device": parity["device"], "card": parity["card"]},
        "bench_probe": dict({k: probe[k] for k in keys}, seconds=probe_s, batch=probe["batch"],
                            blob_bytes_per_batch=probe["blob_bytes_per_batch"]),
        "mesh_scaling": dict({k: point[k] for k in ("devices", "mesh", "global_batch", "step_s",
                                                     "sig_per_s")}, seconds=mesh_s),
        "storage_probe": {"seconds": storage_s, "scenarios": list(STORAGE_PROBE_SCENARIOS),
                          "wall_s": {n: storage[n]["wall_s"] for n in scenarios},
                          "launches": {n: storage[n]["launches"] for n in scenarios}},
        "bench_trend": {"seconds": trend_s, "scored": scored, "records": len(index)},
        "launches_by_tool": by_tool, "step_s": time.monotonic() - t0, "card": card_line(),
    }
    kp = reading["kernel_parity"]
    print(f"kernel_parity (step 22): {KERNEL_PARITY_N} cases a path, classes {kp['cases']}, "
          f"{kp['oracle_accepts']} accepted by the oracle; mismatches {kp['mismatches']}; RFC "
          f"8032 {kp['rfc8032']}; {parity_s:.1f} s ({kp['tool_seconds']:.1f} s in the tool); "
          f"launches {parity['launches']} [{reading['card']}]", flush=True)
    print(f"bench_probe (step 22): {json.dumps(reading['bench_probe'])} [{reading['card']}]",
          flush=True)
    print(f"mesh_scaling (step 22): {json.dumps(reading['mesh_scaling'])} [{reading['card']}]",
          flush=True)
    print(f"storage_probe (step 22): {', '.join(STORAGE_PROBE_SCENARIOS)} pass, seeded fields "
          f"equal STORAGE_PROBE_SEEDED; {json.dumps(reading['storage_probe'])} "
          f"[{reading['card']}]", flush=True)
    print(f"bench_trend (step 22): exit 0, {scored} scored record(s) in {len(index)}, "
          f"{trend_s:.1f} s; the step {reading['step_s']:.1f} s (storage-10's wal_inspect and "
          f"orchestrator-10's commit_explain ride their phases) [{reading['card']}]", flush=True)
    return launches, reading


# -- step 23: the load and catch-up fleet benches -----------------------------


# A killed service's context may stay on nvidia-smi's list this long.
SERVICE_GRACE_S = 3.0
# Set when this process fails while fleet tools run beside it (``Beside``).
ABORT = threading.Event()
# Node and metrics ports a fleet bench's genesis takes (base+i, base+1000+i).
FLEET_PORTS = 10


def fleet_reports(report_dir: str) -> dict:
    """What the hook's processes wrote under ``report_dir``."""
    out = {"services": [], "service_starts": [], "nodes": 0, "node_cuda": []}
    for name in sorted(os.listdir(report_dir)):
        if not name.endswith(".json"):
            continue
        doc = tool_doc(os.path.join(report_dir, name))
        if name.startswith("service-"):
            out["service_starts" if name.endswith(".start.json") else "services"].append(doc)
        elif name.endswith(".cuda.json"):
            out["node_cuda"].append(doc)
        elif name.startswith("node-"):
            out["nodes"] += 1
    return out


def hook_env(hook, report_dir) -> dict:
    """A child's environment: this process's, with ``FLEET_HOOK``'s directory
    first on ``PYTHONPATH`` reporting into ``report_dir`` and the trend index
    under ``TOOLS_DIR``."""
    env = dict(os.environ, SMOKE_FLEET_DIR=report_dir,
               BENCH_TREND_PATH=os.path.join(TOOLS_DIR, "BENCH_TREND.json"),
               PYTHONPATH=os.pathsep.join([hook] + ([os.environ["PYTHONPATH"]]
                                                   if os.environ.get("PYTHONPATH") else [])))
    for k in ("MYSTICETI_NO_VERIFIER_SERVICE", "MYSTICETI_TRACE"):
        env.pop(k, None)
    return env


def kill_tree(pid) -> None:
    """SIGKILL the process group of ``pid``, a child started in a session of
    its own: the child and what it started (a tool's fleet, its verifier
    service)."""
    import signal

    try:
        os.killpg(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def run_fleet_tool(name, module, out_name, args, hook, timeout, env=None) -> dict:
    """One fleet bench in a child, as a user runs it, with the hook on its
    ``PYTHONPATH`` (its reports under ``TOOLS_DIR/fleet-reports/name``),
    ``env`` over this process's environment and its document at
    ``TOOLS_DIR/out_name``; samples the card's compute processes every
    second while it runs, and kills it with what it started past
    ``timeout`` seconds or once ``ABORT`` is set.  Returns the run: exit
    code, output tails, seconds, document, samples and the hook's
    reports."""
    import shutil

    report_dir = os.path.join(TOOLS_DIR, "fleet-reports", name)
    shutil.rmtree(report_dir, ignore_errors=True)
    os.makedirs(report_dir)
    out_path = os.path.join(TOOLS_DIR, out_name)
    if os.path.exists(out_path):
        os.unlink(out_path)
    child_env = hook_env(hook, report_dir)
    child_env.update(env or {})
    port_base = free_port_base(FLEET_PORTS, 1500)
    argv = [sys.executable, "-m", f"mysticeti_tpu_torch.tools.{module}", *args,
            "--workdir", os.path.join(TOOLS_DIR, "fleets", name), "--out", out_path,
            "--port-base", str(port_base)]
    before = len(compute_apps())
    t0, wall0 = time.monotonic(), time.time()
    proc = subprocess.Popen(argv, cwd=HERE, env=child_env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    result = {}
    reader = threading.Thread(target=lambda: result.update(
        zip(("out", "err"), proc.communicate())), daemon=True)
    reader.start()
    samples = []
    while proc.poll() is None:
        if time.monotonic() - t0 > timeout or ABORT.is_set():
            kill_tree(proc.pid)
            break
        samples.append((time.time(), len(compute_apps())))
        time.sleep(1.0)
    run = {"name": name, "module": module, "args": list(args), "port_base": port_base,
           "rc": proc.wait(), "seconds": time.monotonic() - t0, "window": [wall0, time.time()],
           "apps_before": before, "samples": samples}
    reader.join(60)
    run.update(out=result.get("out", ""), err=result.get("err", ""),
               doc=tool_doc(out_path) if os.path.exists(out_path) else None)
    run.update(fleet_reports(report_dir))
    return run


def fleet_records(module, doc) -> list:
    """(label, kind, nodes, record) of every fleet a tool's document records,
    the record holding its ``fleet`` counters."""
    out = []
    if module in ("maxload_bench", "chip_window_ab"):
        for run in doc["runs"]:
            for probe in run["probes"]:
                out.append((f"{run['verifier']} at {probe['offered_load_tx_s']}",
                            run["verifier"], run["nodes"], probe))
            ref = run.get("cpu_reference_probe")
            if ref is not None:
                out.append((f"cpu reference at {ref.get('offered_load_tx_s')}", "cpu",
                            run["nodes"], ref))
    elif module in ("node_bench", "catchup_bench"):
        out = [(run["verifier"], run["verifier"], run["nodes"], run) for run in doc["runs"]]
    elif module == "overload_bench":
        out = [(f"{rung['multiplier']}x", doc["verifier"], doc["nodes"], rung)
               for rung in doc["rungs"]]
        if doc.get("calibration"):
            out.insert(0, ("calibration", doc["verifier"], doc["nodes"], doc["calibration"]))
    return out


def fleet_bench_checks(run) -> dict:
    """The checks of the module docstring, step 23, on one tool's run;
    returns its readings (printed, not gated) and the launches its verifier
    services and its own process counted."""
    import math

    name, module, doc = run["name"], run["module"], run["doc"]
    rc_ok = run["rc"] == 0 or (
        module == "overload_bench" and run["rc"] == 3 and doc is not None
        and doc["acceptance"].get("no_collapse") is False
        and doc["acceptance"]["sim_no_collapse"]
        and doc["acceptance"]["shed_schedule_byte_identical"])
    check(rc_ok and doc is not None,
          f"{name}: the tool exited {run['rc']}: {run['out'][-1500:]}{run['err'][-1500:]}")
    fleets = fleet_records(module, doc)
    check(fleets, f"{name}: the document records no fleet")
    card_fleets = [f for f in fleets if f[1].startswith("cuda")]
    reading = {"seconds": run["seconds"], "fleets": len(fleets), "card_fleets": len(card_fleets)}
    for label, kind, n, rec in fleets:
        what = f"{name} {label}"
        if module == "catchup_bench":
            check(not rec.get("error") and rec.get("steady_tps", 0) > 0,
                  f"{what}: {rec.get('error')}, steady tps {rec.get('steady_tps')}")
        else:
            tps = rec.get("tps", rec.get("committed_tx_s"))
            latency = rec.get("avg_latency_s")
            check(tps is not None and tps > 0 and latency is not None
                  and math.isfinite(latency), f"{what}: tps {tps}, average latency {latency}")
        fleet = rec["fleet"]
        check(fleet["verifier_fallback"] == 0,
              f"{what}: {fleet['verifier_fallback']} batches degraded to the CPU oracle")
        check(fleet["invalid_blocks"] == 0, f"{what}: {fleet['invalid_blocks']} invalid blocks")
        check(fleet["scraped_nodes"] == n,
              f"{what}: {fleet['scraped_nodes']} of {n} nodes answered the last scrape")
    # The card's processes: the tool's own (its prewarm) and, while a fleet
    # runs, its one verifier service; no node opens a context.
    check(not run["node_cuda"], f"{name}: nodes initialized CUDA: {run['node_cuda']}")
    services = run["services"]
    check(len(services) == len(run["service_starts"]) == len(card_fleets),
          f"{name}: {len(run['service_starts'])} verifier services started and "
          f"{len(services)} reported their launches at SIGTERM, for {len(card_fleets)} "
          f"card fleets")
    launches = {}
    for svc in services:
        check(svc["warm"] is not None and svc["cuda_initialized"],
              f"{name}: verifier service {svc['pid']} never warmed on the card: {svc}")
        counts = {k: v - svc["warm"].get(k, 0) for k, v in svc["final"].items()}
        check(counts.get("verify_generic", 0) == 0,
              f"{name}: verifier service {svc['pid']} launched the generic kernel: {counts}")
        check(counts.get("prologue", 0) == counts.get("verify_keyed", 0),
              f"{name}: verifier service {svc['pid']}'s launches {counts} are not one prologue "
              f"and one keyed launch a dispatch")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    # Every flush of a cuda-only node is one request to the service; the
    # hybrid (``cuda``) may route a fleet's small flushes all to the oracle.
    flushes = sum(f[3]["fleet"]["flushes"] for f in card_fleets)
    routed = [f for f in card_fleets if f[1] != "cuda"]
    only = all(f[1] == "cuda-only" for f in card_fleets)
    check(not routed or (launches.get("verify_keyed", 0) > 0 and (
        not only or launches["verify_keyed"] >= flushes)),
        f"{name}: the verifier services launched {launches} for the card fleets' "
        f"{flushes} flushes")
    apps_checks(run)
    top = max((count for _, count in run["samples"]), default=0)
    check(not card_fleets or top >= run["apps_before"] + 2,
          f"{name}: the card never showed the tool's and a verifier service's contexts "
          f"(at most {top} with {run['apps_before']} before)")
    reading.update(service_launches=dict(launches), launches=launches,
                   services=len(services), nodes=run["nodes"],
                   compute_apps={"before": run["apps_before"], "max": top,
                                 "samples": len(run["samples"])})
    if module in ("maxload_bench", "chip_window_ab"):
        reading["runs"] = [{k: r.get(k) for k in ("verifier", "max_sustainable_load_tx_s",
                                                  "out_of_capacity_load_tx_s",
                                                  "peak_committed_tx_s",
                                                  "peak_vs_same_window_cpu")}
                           for r in doc["runs"]]
        for r in doc["runs"]:
            if r["verifier"] != "cpu" and module == "maxload_bench":
                check(r.get("peak_vs_same_window_cpu") is not None,
                      f"{name}: {r['verifier']}'s same-window cpu probe read nothing")
        if module == "chip_window_ab":
            check(doc["backend"] == "cuda" and doc["tpu_over_cpu"] is not None and doc["card"],
                  f"{name}: backend {doc['backend']}, ratio {doc['tpu_over_cpu']}, "
                  f"card {doc['card']}")
            reading["tpu_over_cpu"] = doc["tpu_over_cpu"]
    elif module == "node_bench":
        reading["runs"] = [{k: r[k] for k in ("verifier", "committed_tx_s", "avg_latency_s")}
                           for r in doc["runs"]]
        reading["saturation"] = []
        for row in doc["verifier_saturation"]:
            check(row["all_valid"], f"{name}: saturation {row['verifier']} rejected a valid "
                                    f"signature")
            if row["verifier"].startswith("cuda"):
                counts = row["launches"]
                calls = row["iterations"] + 1
                check(counts["prologue"] == counts["verify_keyed"] == calls
                      and counts["verify_generic"] == 0,
                      f"{name}: saturation {row['verifier']} launched {counts} for {calls} calls "
                      f"of {row['batch']} signatures")
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
            reading["saturation"].append({k: row[k] for k in ("verifier", "batch",
                                                                "sig_per_sec", "launches")})
    elif module == "catchup_bench":
        reading["runs"] = []
        for r in doc["runs"]:
            what = f"{name} {r['verifier']}"
            check(r.get("reboot_to_caught_up_s") is not None,
                  f"{what}: the rebooted node did not catch up within the tool's timeout")
            sigs = r.get("catchup_verification") or {}
            check(sigs.get("direct", 0) + sigs.get("skipped", 0) > 0,
                  f"{what}: the rebooted node verified nothing: {sigs}")
            if r["verifier"] in ("cuda-only", "cpu", "cuda"):
                check(sigs["direct"] > 0 and sigs["skipped"] == 0,
                      f"{what}: direct {sigs['direct']}, skipped {sigs['skipped']}")
            health = r.get("health_after_recovery") or {}
            check(sorted(health.get("reachable", [])) == [str(a) for a in range(r["nodes"])],
                  f"{what}: the health snapshot after recovery reached "
                  f"{health.get('reachable')}")
            victim = r["victim_at_finish"]
            reading["runs"].append({
                "verifier": r["verifier"], "backlog_rounds": r.get("backlog_rounds"),
                **{k: r.get(k) for k in ("reboot_to_metrics_s", "reboot_to_first_verify_s",
                                         "reboot_to_caught_up_s", "first_verify_measures")},
                "catchup_verification": sigs,
                "victim_live_lanes": (victim["dispatched_lanes"] / victim["flushes"]
                                      if victim["flushes"] else 0.0),
                "victim_flushes": victim["flushes"], "health": health.get("status")})
    elif module == "overload_bench":
        det = doc["determinism"]
        seeded = {"shed_schedule_digest": det["shed_schedule_digest_run1"],
                  **{k: det[k] for k in OVERLOAD_SEEDED if k in det}}
        check(det["byte_identical"]
              and det["shed_schedule_digest_run1"] == det["shed_schedule_digest_run2"]
              and seeded == OVERLOAD_SEEDED,
              f"{name}: the determinism leg {seeded} (byte identical {det['byte_identical']}) "
              f"differs from OVERLOAD_SEEDED")
        from mysticeti_tpu_torch.tools.overload_bench import intake_sheds

        reading["rungs"] = []
        for rung in doc["rungs"]:
            # The nodes' generators and ingress planes count on one event
            # loop, which also serves the scrape: equal at every scrape.
            taken = rung["admitted_total"] + intake_sheds(rung["shed_total"])
            submitted = rung["fleet"]["submitted"]
            check(submitted > 0 and taken == submitted,
                  f"{name} {rung['multiplier']}x: admitted {rung['admitted_total']} + shed "
                  f"{rung['shed_total']} against {submitted} submitted "
                  f"({rung['offered_tx_s']} tx/s offered)")
            reading["rungs"].append({k: rung[k] for k in (
                "multiplier", "offered_tx_s", "committed_tx_s", "committed_over_offered",
                "avg_latency_s", "admitted_total", "shed_total")})
            reading["rungs"][-1].update(submitted=submitted, submitted_over_nominal=(
                submitted / (rung["offered_tx_s"] * rung["seconds"])))
        reading["acceptance"] = doc["acceptance"]
        reading["exit_code"] = run["rc"]
    return reading


def fleet_benches_phase(kernels, runs=FLEET_BENCH_RUNS, timeout=300) -> tuple:
    """Step 23: ``runs`` (name, tool, document name, arguments) each through
    ``run_fleet_tool`` with the checks of the module docstring, then
    ``bench_trend --repo TOOLS_DIR``.  Returns the launches of the tools'
    verifier services (each from its warm state) and their own saturation
    calls, and the readings."""
    t0 = time.monotonic()
    os.makedirs(TOOLS_DIR, exist_ok=True)
    hook = os.path.join(TOOLS_DIR, "fleet-hook")
    os.makedirs(hook, exist_ok=True)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(FLEET_HOOK)
    launches = {k.name: 0 for k in kernels}
    readings = {"card": card_line()}
    for name, module, out_name, args in runs:
        run = run_fleet_tool(name, module, out_name, args, hook, timeout)
        reading = fleet_bench_checks(run)
        readings[name] = reading
        for k, v in reading["launches"].items():
            launches[k] = launches.get(k, 0) + v
        print(f"fleet bench {name} (step 23): {json.dumps(reading)} [{readings['card']}]",
              flush=True)
    (rc, out, err), trend_s = run_tool("tools.bench_trend", "--repo", TOOLS_DIR)
    check(rc == 0, f"bench_trend exited {rc}: {out[-2000:]}{err[-2000:]}")
    index = tool_doc(os.path.join(TOOLS_DIR, "BENCH_TREND.json"))["records"]
    sources = {out_name for _, _, out_name, _ in runs} & {
        "MAXLOAD_r19.json", "MAXLOAD_TAX_r19.json", "OVERLOAD_r19.json"}
    for source in sorted(sources):
        records = [r for r in index if r.get("source") == source]
        check(records and all(r.get("card") and r.get("value") is not None for r in records),
              f"bench_trend: {source}'s records {records}")
    readings["bench_trend"] = {"seconds": trend_s, "records": {
        source: len([r for r in index if r.get("source") == source]) for source in sources}}
    readings["step_s"] = time.monotonic() - t0
    print(f"fleet benches (step 23): {len(runs)} tools, bench_trend scored "
          f"{readings['bench_trend']['records']}; the step {readings['step_s']:.1f} s "
          f"[{readings['card']}]", flush=True)
    return launches, readings


# -- step 24: the last tools ---------------------------------------------------


def keyed_only(counts, what: str) -> None:
    """``counts`` (launches) are one prologue and one keyed launch a
    dispatch, some, and never the generic kernel."""
    check(counts.get("verify_generic", 0) == 0,
          f"{what}: the generic kernel was launched: {counts}")
    check(counts.get("prologue", 0) == counts.get("verify_keyed", 0) > 0,
          f"{what}: {counts} are not one prologue and one keyed launch a dispatch")


def service_counts(run, what: str) -> dict:
    """The launches of ``run``'s verifier services from their warm state
    (``FLEET_HOOK``'s reports), each held to ``keyed_only``."""
    check(len(run["services"]) == len(run["service_starts"]),
          f"{what}: {len(run['service_starts'])} verifier services started and "
          f"{len(run['services'])} reported their launches at SIGTERM")
    total = {}
    for svc in run["services"]:
        check(svc["warm"] is not None and svc["cuda_initialized"],
              f"{what}: verifier service {svc['pid']} never warmed on the card: {svc}")
        counts = {k: v - svc["warm"].get(k, 0) for k, v in svc["final"].items()}
        keyed_only(counts, f"{what}: verifier service {svc['pid']}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def add_counts(total: dict, counts: dict) -> dict:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def last_tool_checks(run, card) -> dict:
    """The checks of the module docstring, step 24, on one tool's run.
    Returns its readings (printed, not gated) and the launches of its own
    process and its verifier services."""
    name, module, doc = run["name"], run["module"], run["doc"]
    check(run["rc"] in ((0,) if module == "reconfig_matrix" else (0, 3)) and doc is not None,
          f"{name}: the tool exited {run['rc']}: {run['out'][-1500:]}{run['err'][-1500:]}")
    check(doc["card"] == card and doc["verifier"] == "cuda-only",
          f"{name}: the document names card {doc['card']!r} and kind {doc['verifier']!r}")
    check(not run["node_cuda"], f"{name}: nodes initialized CUDA: {run['node_cuda']}")
    reading = {"seconds": run["seconds"], "exit_code": run["rc"]}
    launches = {}
    if module == "mesh_ab":
        for mode, r in ((m, r) for m in ("legacy", "mesh") for r in doc["runs"][m]):
            what = f"{name} {mode}"
            check(all(n["committed_leaders"] > 0 for n in r["nodes"]),
                  f"{what}: a node committed nothing: {r['nodes']}")
            reuse = [n["encode_reuse_total"] for n in r["nodes"]]
            if mode == "legacy":
                check(reuse == [0] * len(reuse) and r["receivers_attached"] == 0,
                      f"{what}: encode reuse {reuse}, {r['receivers_attached']} zero-copy "
                      f"receivers attached under MYSTICETI_MESH_LEGACY=1")
            else:
                check(all(x > 0 for x in reuse) and r["receivers_attached"] > 0,
                      f"{what}: encode reuse {reuse}, {r['receivers_attached']} zero-copy "
                      f"receivers attached")
            keyed_only(r["launches"], f"{what}: the validators")
            add_counts(launches, r["launches"])
        reading.update({k: doc["comparison"][k] for k in (
            "committed_leaders_mean", "mesh_encode_us_per_leader", "critical_path_p50_us")},
            acceptance=doc["acceptance"],
            microbench_speedup=doc["microbench"].get("speedup"))
    elif module == "dataplane_ab":
        for mode, r in ((m, r) for m in ("fallback", "native") for r in doc["runs"][m]):
            what = f"{name} {mode}"
            leaders = r["committed_leaders_by_node"]
            check(len(leaders) == 4 and all(v > 0 for v in leaders.values()),
                  f"{what}: committed leaders {leaders}")
            check(set(r["exit_codes"].values()) == {0}, f"{what}: exit codes {r['exit_codes']}")
            check(set(r["verifier_fallback_by_node"].values()) == {0},
                  f"{what}: batches degraded to the CPU oracle {r['verifier_fallback_by_node']}")
        active = doc["comparison"]["native_active"]
        check(active["native"] and active["fallback"] == [],
              f"{name}: native_active {active} (the native arm must run native, the "
              f"fallback arm nothing native)")
        check(len(run["service_starts"]) == 1, f"{name}: {len(run['service_starts'])} verifier "
                                                f"services for its fleets")
        add_counts(launches, service_counts(run, name))
        reading.update({k: doc["comparison"][k] for k in (
            "committed_leaders_mean", "hotpath_us_per_leader", "hotpath_cpu_reduction_pct")},
            acceptance=doc["acceptance"],
            microbench_passes=doc["microbench"]["combined_speedup_passes"])
    elif module == "reconfig_matrix":
        live = doc["live"]
        check(live["passed"] and live["epochs_reached"] >= 2 and live["joiner_commits"] > 0
              and live["prefix_consistent"] and live["verifier"] == "cuda-only",
              f"{name}: the live leg {live}")
        keyed_only(live["launches"], f"{name}: the validators across both boundaries")
        add_counts(launches, live["launches"])
        reading.update({k: live[k] for k in ("epochs", "joiner_commits", "commits")})
    elif module in ("finality_bench", "execution_bench"):
        fleet, sim = doc["fleet"], doc["sim"]
        counters = fleet["fleet"]
        check(counters["verifier_fallback"] == 0 and counters["invalid_blocks"] == 0
              and counters["scraped_nodes"] == fleet["nodes"],
              f"{name}: the fleet's last scrapes {counters}")
        check(fleet["verifier"] == sim["verifier"] == "cuda-only",
              f"{name}: legs on {fleet['verifier']} and {sim['verifier']}")
        check(len(run["service_starts"]) == 1, f"{name}: {len(run['service_starts'])} verifier "
                                                f"services for one card fleet")
        services = service_counts(run, name)
        check(services.get("verify_keyed", 0) >= counters["flushes"],
              f"{name}: the verifier service launched {services} for the nodes' "
              f"{counters['flushes']} flushes")
        keyed_only(sim["launches"], f"{name}: the sim leg")
        add_counts(add_counts(launches, services), sim["launches"])
        if module == "finality_bench":
            check(fleet["decisions_recorded_all_nodes"],
                  f"{name}: a node recorded no decision: {fleet['per_node']}")
            seeded = {k: sim[k] for k in FINALITY_SEEDED}
            check(sim["every_slot_explained"] and sim["byte_identical"]
                  and (seeded == FINALITY_SEEDED or sim["duration_s"] != SEEDED_SIM_S),
                  f"{name}: the sim leg {seeded}, holes {sim['holes']}, byte identical "
                  f"{sim['byte_identical']}, against FINALITY_SEEDED")
            reading.update({k: fleet[k] for k in ("server", "client", "cross_check")},
                           acceptance=doc["acceptance"])
        else:
            agreement = fleet["root_agreement"]
            check(agreement["agree"] and fleet["all_nodes_executed"]
                  and fleet["subscriber"]["resume_reply"] is not None
                  and fleet["subscriber"]["executed_notifications"] > 0,
                  f"{name}: roots {agreement}, heights {fleet['executed_height_min']}-"
                  f"{fleet['executed_height_max']}, subscriber {fleet['subscriber']}")
            seeded = {k: sim[k] for k in EXEC_SEEDED}
            check(sim["passed"] and sim["execution_ok"] and sim["byte_identical"]
                  and (seeded == EXEC_SEEDED or sim["duration_s"] != SEEDED_SIM_S),
                  f"{name}: the sim leg {seeded} (passed {sim['passed']}, byte identical "
                  f"{sim['byte_identical']}) against EXEC_SEEDED")
            reading.update({k: fleet[k] for k in ("executed_tx_s", "executed_height_max",
                                                  "client")},
                           shared_heights=agreement["shared_heights"],
                           acceptance=doc["acceptance"])
    reading["launches"] = launches
    return reading


def apps_checks(run) -> None:
    """While a tool ran, the card held no more contexts than before it, the
    tool's own (its prewarm, in-process validators and sims) and one a live
    verifier service."""
    import math

    for t, count in run["samples"]:
        alive = sum(1 for svc in run["services"]
                    if svc["start"] <= t <= svc.get("end", math.inf) + SERVICE_GRACE_S)
        check(count <= run["apps_before"] + 1 + alive,
              f"{run['name']}: {count} compute processes on the card at {t:.1f} with "
              f"{run['apps_before']} before the tool, {alive} verifier services alive: a node "
              f"or a second service opened a context")


def last_tools_phase(kernels, runs=LAST_TOOL_RUNS, timeout=300) -> tuple:
    """Step 24: ``runs`` one after another through ``run_fleet_tools``, each
    held to ``last_tool_checks``; dataplane-4's nodes verify through a
    ``tools.ServiceChild`` this step starts (``MYSTICETI_VERIFIER_SOCKET``),
    reporting its launches through ``FLEET_HOOK``.  Every launch it counts
    is a child's, so it can run beside a phase of this process.  Returns the
    launches of the tools' processes and verifier services and the
    readings."""
    import shutil

    from mysticeti_tpu_torch.tools import ServiceChild
    from mysticeti_tpu_torch.verifier_service import ENV_SOCKET

    t0 = time.monotonic()
    os.makedirs(TOOLS_DIR, exist_ok=True)
    hook = os.path.join(TOOLS_DIR, "fleet-hook")
    os.makedirs(hook, exist_ok=True)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(FLEET_HOOK)
    launches = {k.name: 0 for k in kernels}
    readings = {"card": card_line()}
    for name, module, out_name, args in runs:
        service = env = None
        if module == "dataplane_ab":
            report_dir = os.path.join(TOOLS_DIR, "fleet-reports", f"{name}-service")
            shutil.rmtree(report_dir, ignore_errors=True)
            os.makedirs(report_dir)
            service = ServiceChild(os.path.join(TOOLS_DIR, "fleets", f"{name}-service"),
                                   FLEET_NODES, env=hook_env(hook, report_dir))
        try:
            if service is not None:
                try:
                    service.start()
                except RuntimeError as exc:
                    raise SmokeFailure(str(exc)) from exc
                env = {ENV_SOCKET: service.socket}
            run = run_fleet_tool(name, module, out_name, args, hook, timeout, env)
        finally:
            if service is not None:
                service.stop()
        if service is not None:
            reports = fleet_reports(report_dir)
            run["services"] += reports["services"]
            run["service_starts"] += reports["service_starts"]
        reading = last_tool_checks(run, readings["card"])
        apps_checks(run)
        readings[name] = reading
        add_counts(launches, reading["launches"])
        print(f"last tool {name} (step 24): {json.dumps(reading)} [{readings['card']}]",
              flush=True)
    readings["step_s"] = time.monotonic() - t0
    print(f"last tools (step 24): {len(runs)} tools, {readings['step_s']:.1f} s "
          f"[{readings['card']}]", flush=True)
    return launches, readings


class Beside:
    """``jobs`` ((label, fn, args)) run one after another in a thread from the
    ``with`` block's start, beside this process's phases; ``join`` waits for
    them and returns {label: result}, raising the first job's error (the
    jobs after it do not run).  Leaving the block on an exception sets
    ``ABORT``, so that ``run_fleet_tool`` kills its child's process group,
    and waits for the job under way to end."""

    def __init__(self, jobs):
        self.results = {}
        self._jobs = list(jobs)
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="beside")

    def _run(self):
        for label, fn, args in self._jobs:
            if ABORT.is_set():
                return
            try:
                self.results[label] = fn(*args)
            except BaseException as exc:  # noqa: BLE001 - raised again by join
                self._error = exc
                return

    def join(self) -> dict:
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self.results

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            ABORT.set()
            self._thread.join()
        return False


def build_and_report(K, cuda_build) -> None:
    """Build every kernel source (one nvcc each, in parallel); print the
    build time and ptxas's register, stack and spill lines."""
    t0 = time.monotonic()
    K.build_all()
    units = sorted({k.unit for k in K.KERNELS})
    print(f"build: {time.monotonic() - t0:.1f} s for {len(K.KERNELS)} kernels in {len(units)} "
          f"sources, one nvcc each in parallel", flush=True)
    for name, log in sorted(cuda_build.ptxas_reports.items()):
        for line in log.splitlines():
            if "Used" in line or "stack" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}", flush=True)


def run() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from mysticeti_tpu_torch.committee import Committee
        from mysticeti_tpu_torch.ops import cuda_build
        from mysticeti_tpu_torch.ops import ed25519 as E
        from mysticeti_tpu_torch.ops import ed25519_cuda as K
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2

    from mysticeti_tpu_torch.metrics import Metrics

    print(card_line(), flush=True)
    fresh_tools_dir()
    # The run's registry: attributed from the kernels' build on.
    metrics = Metrics()
    E.install_device_attribution(metrics)
    build_and_report(K, cuda_build)

    rng = random.Random(SEED)
    committee = Committee.new_for_benchmarks(COMMITTEE)
    signers = Committee.benchmark_signers(COMMITTEE)
    dev = E.resolve_device(None)
    table = E.KeyTable(committee.public_key_bytes(), device=dev)
    report = {}
    keyed_chunk = kernel_phase(signers, table, rng, report)
    by_path, rates, blocks_and_want, burst, metrics_reading = main_path(
        signers, committee, rng, K.KERNELS, metrics)
    by_path["flat_keyed"], layout = flat_phase(table, keyed_chunk, K.KERNELS, report)
    by_path["sharded"], sharded = sharded_phase(table, burst, rng, K.KERNELS)
    by_path["hybrid"], hybrid = hybrid_phase(committee, blocks_and_want, K.KERNELS)
    by_path["entry"], by_path["dryrun"] = entry_phase(K.KERNELS)
    by_path["service"], service = service_phase(committee, blocks_and_want, K.KERNELS,
                                                rates["block_per_s"])
    by_path["receive"], receive = receive_phase(committee, signers, rng, K.KERNELS)
    # The whole script holds consensus-50, netsync-50, storage, epoch,
    # ingress and health-sim to their seeded constants alone (each
    # ``<phase>_only`` keeps its cpu control).
    # Steps 23 and 24, each fleet tool a child counting its own launches and
    # its services', run one at a time beside this process's phases whose
    # results no host load can move: the simulated cells, held to seeded
    # counts (consensus-50 to ingress-10, then byzantine-10), and
    # netsync-tcp-10, far above its minimum commits.  The queue is joined
    # before the phases that time a fleet, watch the card's contexts or hold
    # fixed ports (health, node, orchestrator) and before the bench and the
    # tools.
    jobs = {run[0]: (f"fleet_benches {run[0]}", fleet_benches_phase, (K.KERNELS, (run,)))
            for run in FLEET_BENCH_RUNS}
    jobs.update({run[0]: (f"last_tools {run[0]}", last_tools_phase, (K.KERNELS, (run,)))
                 for run in LAST_TOOL_RUNS})
    with Beside([jobs[name] for name in BESIDE_ORDER]) as beside:
        by_path["consensus"], consensus = consensus_phase(K.KERNELS, control=False)
        by_path["net_sync"], by_path["net_sync_tcp"], net_sync = net_sync_phase(K.KERNELS,
                                                                              control=False)
        by_path["storage"], storage = storage_phase(K.KERNELS, control=False)
        by_path["epoch"], epoch = epoch_phase(K.KERNELS, control=False)
        by_path["ingress"], ingress = ingress_phase(K.KERNELS, control=False)
        by_path["byzantine"], byzantine = byzantine_phase(K.KERNELS)
        t0 = time.monotonic()
        done = beside.join()
        print(f"beside: waited {time.monotonic() - t0:.1f} s for steps 23 and 24 after "
              f"byzantine-10", flush=True)
    by_path["health_tcp"], by_path["health_sim"], health = health_phase(K.KERNELS,
                                                                       control=False)
    by_path["node_proc"], by_path["node_svc"], node = node_phase(K.KERNELS)
    by_path["orchestrator"], orchestrator = orchestrator_phase(
        K.KERNELS, dict(ORCHESTRATOR_10, loads=ORCHESTRATOR_SCRIPT_LOADS),
        smoke_trace=metrics_reading["trace"]["path"])
    bench = bench_phase()
    by_path["tools"], tools = tools_phase(K.KERNELS)
    fleet_benches, last_tools = {}, {}
    for key, out in (("fleet_benches", fleet_benches), ("last_tools", last_tools)):
        by_path[key] = {k.name: 0 for k in K.KERNELS}
        for label, (launches, reading) in done.items():
            if label.startswith(key):
                add_counts(by_path[key], launches)
                out[label.split(" ", 1)[1]] = reading
    # The block path's flushes take the keyed kernel, one key per lane, and
    # never the generic one; the committee dispatch's 8 stragglers take the
    # generic kernel once.
    block, burst_counts = by_path["block"], by_path["committee"]
    check(block["prologue"] > 0 and block["verify_keyed"] > 0,
          f"the block path did not take the prologue and the keyed kernel: {block}")
    check(block["verify_generic"] == 0, f"the block path launched the generic kernel: {block}")
    check(burst_counts["verify_keyed"] == 1 and burst_counts["verify_generic"] == 1,
          f"the committee dispatch did not take one keyed and one generic launch: {burst_counts}")
    check(by_path["flat_keyed"]["prologue_flat"] > 0, "prologue_flat was not launched")
    check(by_path["sharded"]["verify_generic"] > 0, "the sharded path launched no kernel")
    check(by_path["hybrid"]["verify_generic"] == 0, "the hybrid block path launched the generic kernel")

    rows = []
    for k in K.KERNELS:
        r = report[k.name]
        check(r["max_abs_err"] == 0, f"{k.name} differs from its plain version")
        rows.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": sum(counts[k.name] for counts in by_path.values()),
            "launches_by_path": {path: counts[k.name] for path, counts in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            **{key: r[key] for key in ("field_ops_per_lane", "ms_at_256_lanes", "ms_at_1_lane",
                                       "lane_form_ms", "lane_form_plain_ms",
                                       "bound_ms_plain_formulas", "plain_field_muls_per_lane",
                                       "block_threads", "dynamic_smem_bytes") if key in r},
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"e2e_sig_per_s": rates["committee_sig_per_s"], "signatures": KEYED_LANES,
                      "bucket": BUCKET, "committee": COMMITTEE,
                      "block_path_blocks_per_s": rates["block_per_s"], "flush": report["flush"],
                      "flat_vs_26col": layout, "sharded": sharded, "hybrid": hybrid,
                      "service": service, "receive": receive, "consensus": consensus,
                      "net_sync": net_sync, "storage": storage, "epoch": epoch,
                      "ingress": ingress, "health": health, "node": node,
                      "orchestrator": orchestrator, "byzantine": byzantine,
                      "metrics": metrics_reading,
                      "bench": bench, "tools": tools, "fleet_benches": fleet_benches,
                      "last_tools": last_tools}),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def fresh_tools_dir() -> None:
    """An empty ``TOOLS_DIR`` for this run's tool artifacts and trend index."""
    import shutil

    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)


def tools_only() -> int:
    """Step 22's standalone tools alone, after the bench (whose live record
    ``bench_trend`` reads): ``python3 -c 'import chip_smoke as c; raise
    SystemExit(c.main(c.tools_only))'``.  storage-10's ``wal_inspect`` and
    orchestrator-10's ``commit_explain`` ride ``storage_only`` and
    ``orchestrator_only``."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    fresh_tools_dir()
    bench = bench_phase()
    launches, reading = tools_phase(K.KERNELS)
    print(json.dumps({"tools": reading, "launches": launches, "bench": bench}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def fleet_benches_only(only=None) -> int:
    """Step 23's runs, then each fleet bench once at its own defaults
    (``FLEET_BENCH_DEFAULTS``, the recorded readings), every run checked as
    step 23 checks it: ``python3 -c 'import chip_smoke as c; raise
    SystemExit(c.main(c.fleet_benches_only))'``; ``only`` names the runs of
    either table to take (``c.main(c.fleet_benches_only, ("maxload",
    "overload-4"))``).  A run that fails is printed and the others still
    run; exits 1 when any failed."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    fresh_tools_dir()
    results, failures = {}, []
    for label, runs, timeout in (("step 23", FLEET_BENCH_RUNS, 300),
                                 ("defaults", FLEET_BENCH_DEFAULTS, 2400)):
        for run in runs:
            if only is not None and run[0] not in only:
                continue
            try:
                launches, reading = fleet_benches_phase(K.KERNELS, (run,), timeout)
                results[f"{label} {run[0]}"] = dict(reading, launches=launches)
            except SmokeFailure as exc:
                failures.append(f"{label} {run[0]}: {exc}")
                print(f"chip_smoke: FAILED ({label} {run[0]}): {exc}", file=sys.stderr,
                      flush=True)
    step = sum(r["step_s"] for key, r in results.items() if key.startswith("step 23"))
    print(json.dumps({"fleet_benches": results, "step_23_s": step, "failures": failures}),
          flush=True)
    if failures:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def last_tools_only(only=None) -> int:
    """Step 24's runs, then each of the last tools once at its own defaults
    (``LAST_TOOL_DEFAULTS``, the recorded readings), one at a time, every
    run checked as step 24 checks it: ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.last_tools_only))'``; ``only`` names the runs
    of either table to take (``c.main(c.last_tools_only, ("exec-4",
    "reconfig"))``).  A run that fails is printed and the others still run;
    exits 1 when any failed."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    fresh_tools_dir()
    results, failures = {}, []
    for label, runs, timeout in (("step 24", LAST_TOOL_RUNS, 300),
                                 ("defaults", LAST_TOOL_DEFAULTS, 2400)):
        for run in runs:
            if only is not None and run[0] not in only:
                continue
            key = f"{label} {run[0]}"
            try:
                launches, reading = last_tools_phase(K.KERNELS, (run,), timeout)
                results[key] = dict(reading, launches=launches)
            except SmokeFailure as exc:
                failures.append(f"{key}: {exc}")
                print(f"chip_smoke: FAILED ({key}): {exc}", file=sys.stderr, flush=True)
    step = sum(r["step_s"] for key, r in results.items() if key.startswith("step 24"))
    print(json.dumps({"last_tools": results, "step_24_s": step, "failures": failures}),
          flush=True)
    if failures:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def sharded_only() -> int:
    """The sharded phase alone, for a host with several cards (every other
    phase needs only one): ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.sharded_only))'``."""
    import torch

    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    rng = random.Random(SEED)
    committee = Committee.new_for_benchmarks(COMMITTEE)
    signers = Committee.benchmark_signers(COMMITTEE)
    table = E.KeyTable(committee.public_key_bytes(), device=E.resolve_device(None))
    lanes = sign_cases(signers, KEYED_LANES, rng, stragglers=STRAGGLERS)
    pks, msgs, sigs, labels = (list(x) for x in zip(*lanes))
    launches, reading = sharded_phase(table, (pks, msgs, sigs, [c == "valid" for c in labels]),
                                      rng, K.KERNELS)
    print(json.dumps({"sharded": reading, "launches": launches}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def receive_only() -> int:
    """The receive phase alone: ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.receive_only))'``."""
    import torch

    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    committee = Committee.new_for_benchmarks(COMMITTEE)
    launches, reading = receive_phase(committee, Committee.benchmark_signers(COMMITTEE),
                                      random.Random(SEED), K.KERNELS)
    print(json.dumps({"receive": reading, "launches": launches}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def consensus_only() -> int:
    """The consensus phase alone: ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.consensus_only))'``."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    launches, reading = consensus_phase(K.KERNELS)
    print(json.dumps({"consensus": reading, "launches": launches}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def net_sync_only() -> int:
    """The net_sync phase alone: ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.net_sync_only))'``."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    launches, tcp_launches, reading = net_sync_phase(K.KERNELS)
    print(json.dumps({"net_sync": reading, "launches": {"net_sync": launches,
                                                        "net_sync_tcp": tcp_launches}}),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def storage_only() -> int:
    """The storage phase alone: ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.storage_only))'``."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    launches, reading = storage_phase(K.KERNELS)
    print(json.dumps({"storage": reading, "launches": launches}, default=str), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def epoch_only() -> int:
    """The epoch phase alone: ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.epoch_only))'``."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    launches, reading = epoch_phase(K.KERNELS)
    print(json.dumps({"epoch": reading, "launches": launches}, default=str), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def ingress_only() -> int:
    """The ingress phase alone: ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.ingress_only))'``."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    launches, reading = ingress_phase(K.KERNELS)
    print(json.dumps({"ingress": reading, "launches": launches}, default=str), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def health_only() -> int:
    """The health phase alone: ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.health_only))'``."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    tcp_launches, sim_launches, reading = health_phase(K.KERNELS)
    print(json.dumps({"health": reading, "launches": {"health_tcp": tcp_launches,
                                                      "health_sim": sim_launches}},
                     default=str), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def node_only() -> int:
    """The node phase alone: ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.node_only))'``."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    proc_launches, svc_launches, reading = node_phase(K.KERNELS)
    print(json.dumps({"node": reading, "launches": {"node_proc": proc_launches,
                                                    "node_svc": svc_launches}},
                     default=str), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def orchestrator_only() -> int:
    """The orchestrator phase alone: ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.orchestrator_only))'``."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    launches, reading = orchestrator_phase(K.KERNELS)
    print(json.dumps({"orchestrator": reading, "launches": launches}, default=str), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def byzantine_only() -> int:
    """The byzantine phase alone, with the sim re-sign oracle's twin:
    ``python3 -c 'import chip_smoke as c; raise
    SystemExit(c.main(c.byzantine_only))'``."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    launches, reading = byzantine_phase(K.KERNELS, oracle_twin=True)
    print(json.dumps({"byzantine": reading, "launches": launches}, default=str), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def offload_decode_times(frames):
    """Seconds to decode ``frames`` natively one frame at a time on the
    data-plane offload worker from memoryview slices of one buffer a frame
    (what ``decode_message`` hands over): keeping every block, as the
    receive path does, and dropping each frame's blocks once decoded.  The
    two split the receive path's decode time into the decode's own work and
    what keeping ~1 GB of new blocks costs."""
    from mysticeti_tpu_torch.core_task import DataPlaneOffload
    from mysticeti_tpu_torch.types import StatementBlock

    def views(frame):
        buf = memoryview(bytearray(b"".join(frame)))
        cuts = [0]
        for raw in frame:
            cuts.append(cuts[-1] + len(raw))
        return [buf[a:b] for a, b in zip(cuts, cuts[1:])]

    async def timed(keep):
        offload = DataPlaneOffload()
        kept = []
        try:
            t0 = time.monotonic()
            for batch in framed_views:
                out = await offload.run("decode", StatementBlock.from_bytes_many, batch)
                if keep:
                    kept.extend(out)
            return time.monotonic() - t0
        finally:
            offload.stop()

    framed_views = [views(f) for f in frames]
    return {"kept_s": asyncio.run(timed(True)), "dropped_s": asyncio.run(timed(False))}


def aggregate_bookkeeping_s(committee, blocks, want):
    """Host seconds of the collector's aggregate bookkeeping on ``blocks``
    alone (``aggregate_verify`` and ``_note_endorsements``, the frontier
    answered from ``want`` with no dispatch), median of 3."""
    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier, aggregate_verify

    verdict = {b.reference: ok for b, ok in zip(blocks, want)}

    async def direct(sub):
        return [verdict[b.reference] for b in sub]

    async def once():
        collector = BatchedSignatureVerifier(committee, None, aggregate=True)
        t0 = time.monotonic()
        results = await aggregate_verify(blocks, committee, direct,
                                         prior_endorsers=collector._prior_endorsers,
                                         defer_unresolved=True)
        collector._note_endorsements(blocks, results)
        elapsed = time.monotonic() - t0
        check(results == want, "the aggregate rule disagrees with the oracle")
        return elapsed

    return statistics.median(asyncio.run(once()) for _ in range(3))


def receive_split() -> int:
    """Where the receive burst's time goes, on the host alone (not part of
    the default run): ``python3 -c 'import chip_smoke as c; raise
    SystemExit(c.main(c.receive_split))'``.  The receive phase's blocks and
    frames; the transfer alone (the frames decoded only once the last is
    in); the decode per frame on the offload worker keeping the blocks and
    dropping them; and the host seconds of the aggregate bookkeeping."""
    from mysticeti_tpu_torch.committee import Committee

    print(card_line(), flush=True)
    committee = Committee.new_for_benchmarks(COMMITTEE)
    signers = Committee.benchmark_signers(COMMITTEE)
    raws, valid, _ = build_receive_blocks(committee, signers, random.Random(SEED), RECEIVE_ROUNDS,
                                          RECEIVE_TX)
    frames = frames_under_cap(raws, len(signers))
    blocks, wire_s, transfer_s, after_transfer_s, _ = asyncio.run(
        over_loopback(frames, streaming=False))
    check([b.to_bytes() for b in blocks] == raws, "the held frames differ from the sent ones")
    reading = {"transfer_only_s": transfer_s, "decode_after_transfer_s": after_transfer_s,
               "wire_s": wire_s, "decode_offload": offload_decode_times(frames),
               "aggregate_bookkeeping_s": aggregate_bookkeeping_s(committee, blocks, valid),
               "card": card_line()}
    print(json.dumps({"receive_split": reading}), flush=True)
    return 0


def device_busy(prof) -> dict:
    """The device activity of a ``torch.profiler`` run: the union of its
    kernel and copy intervals in seconds, their count, and the summed
    seconds of the most costly names."""
    from torch.autograd import DeviceType

    def get(event, name):
        value = getattr(event, name)
        return value() if callable(value) else value

    spans, by_name = [], {}
    for event in prof.profiler.kineto_results.events():
        if get(event, "device_type") != DeviceType.CUDA:
            continue
        start, end = get(event, "start_ns"), get(event, "end_ns")
        spans.append((start, end))
        name = get(event, "name")
        by_name[name] = by_name.get(name, 0) + end - start
    busy_ns, reach = 0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy_ns += end - start
            reach = end
        elif end > reach:
            busy_ns += end - reach
            reach = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"busy_s": busy_ns / 1e9, "events": len(spans),
            "top_s": {name[:60]: ns / 1e9 for name, ns in top}}


def consensus_trace() -> int:
    """How busy the card is in the consensus-50 cell (not part of the
    default run): ``python3 -c 'import chip_smoke as c; raise
    SystemExit(c.main(c.consensus_trace))'``.  The consensus phase's card
    run twice with one seed: as the phase runs it, and under
    ``torch.profiler`` with device activity only.  Prints both wall times,
    the device's busy seconds from the trace (the union of its kernel and
    copy intervals) and the busy share of each wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    committee = Committee.new_for_benchmarks(COMMITTEE)
    backend = TorchSignatureVerifier(committee_keys=committee.public_key_bytes())
    backend.warmup()
    plain = consensus_run("cuda-only", COMMITTEE, CONSENSUS_VIRTUAL_S, SEED, backend=backend)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = consensus_run("cuda-only", COMMITTEE, CONSENSUS_VIRTUAL_S, SEED, backend=backend)
        torch.cuda.synchronize()
    check(traced["sequences"] == plain["sequences"], "the traced run committed other leaders")
    busy = device_busy(prof)
    check(busy["events"] > 0, "the trace holds no device activity")
    reading = {"virtual_s": CONSENSUS_VIRTUAL_S, "deliveries": plain["deliveries"],
               "wall_s": plain["wall_s"], "traced_wall_s": traced["wall_s"], **busy,
               "busy_share": busy["busy_s"] / plain["wall_s"],
               "busy_share_traced": busy["busy_s"] / traced["wall_s"],
               "torch": torch.__version__, "card": card_line()}
    print(json.dumps({"consensus_trace": reading}), flush=True)
    return 0


def kernel_times(which: str = "all", root=None) -> int:
    """Kernels alone, each held to its plain version and timed at BUCKET,
    FLUSH and 1 lanes, and the device time of one FLUSH-signature committee
    flush: ``python3 chip_smoke.py --times NAMES [ROOT]``, NAMES ``all`` or
    a comma-separated list of TIMED.  ROOT, a directory inside this checkout
    (an unpacked earlier commit), holds a port that is imported instead of
    this one's, so two versions can be timed in turns in one call; a part
    that port lacks (the keyed lane form before it existed) is null."""
    import numpy as np
    import torch

    names = TIMED if which == "all" else tuple(which.split(","))
    if not set(names) <= set(TIMED):
        print(f"chip_smoke: --times takes 'all' or names from {TIMED}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.realpath(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.realpath(root or here)
    if os.path.commonpath([root, here]) != here:
        print(f"chip_smoke: {root} is not inside {here}", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.ops import cuda_build
    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    build_and_report(K, cuda_build)
    rng = random.Random(SEED)
    committee = Committee.new_for_benchmarks(COMMITTEE)
    signers = Committee.benchmark_signers(COMMITTEE)
    dev = E.resolve_device(None)
    table = E.KeyTable(committee.public_key_bytes(), device=dev)
    pks, msgs, sigs, labels = shuffled_lanes(signers, rng)
    expected = np.array([c == "valid" for c in labels])
    indexed = E.to_device_words(
        E.pack_blob_indexed(table.indices_for(pks), msgs, sigs, num_keys=len(table)), dev)
    times = {}
    if "prologue" in names:
        times["prologue"] = prologue_readings(indexed, table.words)
    if "verify_generic" in names:
        k_raw = K.prologue(E.to_device_words(E.pack_blob(pks, msgs, sigs), dev))
        times["verify_generic"] = generic_readings(k_raw, expected)
    if "verify_keyed" in names:
        times["verify_keyed"] = keyed_tile_readings(table, pks, msgs, sigs, expected)[0]
    if "verify_keyed_lanes" in names:
        times["verify_keyed_lanes"] = (keyed_lane_readings(table, indexed, expected)
                                       if hasattr(K, "verify_keyed_lanes") else None)
    if "flush" in names:
        times["flush"] = flush_reading(table, pks, msgs, sigs, expected, K.KERNELS)
    for name, r in times.items():
        check(r is None or r.get("max_abs_err", 0) == 0, f"{name} differs from its plain version")
    print(json.dumps({"times": times, "package": os.path.dirname(E.__file__),
                      "card": card_line()}), flush=True)
    return 0


def pin_hash_seed() -> None:
    """Run this command again under ``PYTHONHASHSEED=HASH_SEED`` unless it
    already is: the storage phase's counts are held to a run of the same
    seed on another host, and the run's fetches follow the hash salt."""
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        sys.stdout.flush()
        os.execve(sys.executable, [sys.executable, *sys.orig_argv[1:]],
                  dict(os.environ, PYTHONHASHSEED=HASH_SEED))


def main(entry=run, *args) -> int:
    pin_hash_seed()
    try:
        return entry(*args)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--node"]:
        sys.exit(node_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--times"]:
        sys.exit(main(kernel_times, *sys.argv[2:4]))
    sys.exit(main())
