"""Byzantine adversary plane: active-attack injection for the chaos tier.

The port's copy of ``mysticeti_tpu.adversary``.  The paper's headline
property (arXiv 2310.14821) is *Byzantine* fault tolerance — safety and
liveness with up to f < n/3 arbitrary-faulty authorities — yet the chaos
engine only ever exercised benign faults: link loss, partitions,
crash-restarts, torn WAL tails.  This module adds authorities that actively
lie.

An adversary here is an otherwise-honest simulated validator whose
OUTBOUND traffic is rewritten at the network seam (the same
``SimulatedNetwork.fault_injector`` hook the chaos engine owns), which
models the attacks the protocol actually defends against without forking
the consensus code:

* ``equivocate`` — distinct VALID blocks at the same round to disjoint
  peer subsets: one half of the committee receives the node's real
  proposal, the other half a re-signed variant with a different digest.
  Both are structurally valid and correctly signed, so honest nodes
  accept both — detection happens in the DAG index
  (``mysticeti_equivocation_detected_total{authority}``).
* ``withhold`` — proposals are disseminated only to a favored subset
  smaller than a quorum; everyone else sees the authority go silent and
  must recover its blocks through includes + the fetch path.
* ``invalid_sig`` — own blocks ship with tampered Ed25519 signatures
  (digest-consistent, so the structure check passes and rejection happens
  exactly at the batched signature verifier —
  ``mysticeti_invalid_blocks_total{authority, reason="signature"}``).
* ``mangle`` — outbound messages are probabilistically replaced with
  garbage block payloads, exercising the malformed-input drop paths
  (``reason="malformed"``; on real sockets the analogous garbage *frames*
  sever the connection and count on
  ``mysticeti_malformed_frames_total{peer}``, see network.py).
* ``lag`` — own proposals are delayed just under the leader timeout, the
  grey-failure leader that stalls rounds without ever looking dead.

Determinism: the engine's per-message draws come from a dedicated
``random.Random`` seeded from the :class:`~mysticeti_tpu_torch.chaos.FaultPlan`
seed, and every injected action is appended to an :class:`AttackLedger`
whose canonical-JSON serialization is byte-identical across same-seed
runs — the attack schedule is as reproducible as the benign fault log.

The JAX package's ``docs/adversary.md`` documents the behavior catalog,
the detection surfaces, and the trust model; :mod:`scenarios` composes
adversary mixes with the chaos/storage/health planes into the declarative
resilience scenario matrix.
"""
from __future__ import annotations

import asyncio
import json
import random
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import crypto
from .network import Blocks, EncodedFrame, RequestBlocksResponse, TimestampedBlocks
from .tracing import logger
from .types import StatementBlock

log = logger(__name__)

_U64X2 = struct.Struct("<QQ")

BEHAVIORS = ("equivocate", "withhold", "invalid_sig", "mangle", "lag")

# Default favored-subset size for ``withhold``: strictly below any quorum
# for committees the sim tier runs (the attack is "disseminate to < quorum").
DEFAULT_WITHHOLD_KEEP = 2
DEFAULT_MANGLE_P = 0.05
DEFAULT_LAG_S = 0.8


@dataclass(frozen=True)
class AdversarySpec:
    """One Byzantine authority's declared behavior, JSON round-trippable
    (rides inside :class:`~mysticeti_tpu_torch.chaos.FaultPlan` so the attack
    schedule is part of the same declarative, seeded plan as the benign
    faults).  ``start_s``/``end_s`` window the attack; ``params`` carries
    behavior-specific knobs (``keep``, ``mangle_p``, ``lag_s``)."""

    node: int
    behavior: str
    start_s: float = 0.0
    end_s: Optional[float] = None
    params: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.behavior not in BEHAVIORS:
            raise ValueError(
                f"unknown adversary behavior {self.behavior!r} "
                f"(known: {', '.join(BEHAVIORS)})"
            )

    def active(self, t: float) -> bool:
        if t < self.start_s:
            return False
        return self.end_s is None or t < self.end_s

    def param(self, key: str, default: float) -> float:
        for k, v in self.params:
            if k == key:
                return v
        return default

    def to_dict(self) -> dict:
        return {
            "node": self.node,
            "behavior": self.behavior,
            "start_s": self.start_s,
            "end_s": self.end_s,
            "params": {k: v for k, v in self.params},
        }

    @staticmethod
    def from_dict(d: dict) -> "AdversarySpec":
        return AdversarySpec(
            node=int(d["node"]),
            behavior=str(d["behavior"]),
            start_s=float(d.get("start_s", 0.0)),
            end_s=None if d.get("end_s") is None else float(d["end_s"]),
            params=tuple(sorted(
                (str(k), float(v))
                for k, v in (d.get("params") or {}).items()
            )),
        )


def _canonical_json(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class AttackLedger:
    """Every injected attack action, in injection order.

    Under the DeterministicLoop message order is reproducible and the
    engine's draws consume a plan-seeded RNG in that order, so
    :meth:`ledger_bytes` is byte-identical across same-seed runs — the
    adversarial twin of the chaos engine's fault log."""

    def __init__(self) -> None:
        self._entries: List[dict] = []

    def note(self, kind: str, **fields) -> None:
        entry = {"t": asyncio.get_event_loop().time(), "kind": kind}
        entry.update(fields)
        self._entries.append(entry)

    @property
    def entries(self) -> List[dict]:
        return list(self._entries)

    def ledger_bytes(self) -> bytes:
        return _canonical_json(self._entries).encode()

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for entry in self._entries:
            key = f"{entry['kind']}:{entry['node']}"
            out[key] = out.get(key, 0) + 1
        return out


def tamper_signature(raw: bytes) -> bytes:
    """A signature-invalid twin of a serialized block: the trailing Ed25519
    signature is flipped, everything else untouched.  The receiver's
    ``from_bytes`` recomputes the digest over the TAMPERED bytes, so the
    reference stays self-consistent and ``verify_structure`` passes — the
    rejection happens exactly where it should, at the signature verifier
    (the end-to-end path the verifier rejection tests pin)."""
    raw = bytes(raw)
    body, sig = raw[: -crypto.SIGNATURE_SIZE], raw[-crypto.SIGNATURE_SIZE :]
    return body + bytes(b ^ 0xFF for b in sig)


def equivocating_variant(raw: bytes, signer: crypto.Signer) -> bytes:
    """A second VALID block at the same (authority, round): identical
    includes and statements, perturbed creation-time meta, re-signed — a
    different digest that every honest structure/signature check accepts.
    This is real equivocation, not corruption: only the DAG-level
    double-proposal detector can see it."""
    block = StatementBlock.from_bytes(raw)
    variant = StatementBlock.build(
        block.author(),
        block.round(),
        block.includes,
        block.statements,
        meta_creation_time_ns=block.meta_creation_time_ns ^ 1,
        epoch_marker=block.epoch_marker,
        epoch=block.epoch,
        signer=signer,
    )
    assert variant.reference.digest != block.reference.digest
    return variant.to_bytes()


def _block_frames(msg):
    """(kind, payload tuple) when ``msg`` carries serialized blocks."""
    if type(msg) is EncodedFrame:
        msg = msg.message
    if isinstance(msg, (Blocks, RequestBlocksResponse)):
        return msg
    return None


def _rebuild(msg, payload: Tuple[bytes, ...]):
    """Same message type, new block payload (stamps preserved)."""
    if isinstance(msg, TimestampedBlocks):
        return TimestampedBlocks(
            payload,
            sent_monotonic_ns=msg.sent_monotonic_ns,
            sent_wall_ns=msg.sent_wall_ns,
        )
    if isinstance(msg, Blocks):
        return Blocks(payload)
    return RequestBlocksResponse(payload)


def _block_author_round(raw) -> Tuple[int, int]:
    """Author/round of a serialized block without a full decode (the wire
    layout leads with both u64s)."""
    return _U64X2.unpack_from(raw, 0)


class AdversaryEngine:
    """Rewrites adversary nodes' outbound traffic per their specs.

    Mounted by the :class:`~mysticeti_tpu_torch.chaos.ChaosEngine`: its
    ``filter_batch`` routes every (src, dst, batch) through
    :meth:`transform` BEFORE the benign link faults, so Byzantine behavior
    composes with drops/partitions/crashes in one plan.  All state
    (variant cache, favored subsets, RNG) is deterministic from the plan.
    """

    def __init__(
        self,
        specs: Sequence[AdversarySpec],
        signers: Sequence[crypto.Signer],
        n: int,
        seed: int = 0,
    ) -> None:
        self.specs = list(specs)
        self.signers = signers
        self.n = n
        self.ledger = AttackLedger()
        self._rng = random.Random((seed << 2) ^ 0xBAD5EED)
        self._by_node: Dict[int, List[AdversarySpec]] = {}
        for spec in self.specs:
            self._by_node.setdefault(spec.node, []).append(spec)
        # Equivocation variants: raw bytes -> variant bytes (one mint per
        # distinct own block, logged once).
        self._variants: Dict[bytes, bytes] = {}
        # Tampered-signature twins, same caching.
        self._tampered: Dict[bytes, bytes] = {}

    @property
    def adversaries(self) -> Set[int]:
        return set(self._by_node)

    # -- per-behavior peer subsets (pure functions of the spec) --

    def _peers(self, node: int) -> List[int]:
        return [a for a in range(self.n) if a != node]

    def _variant_side(self, node: int) -> Set[int]:
        """The disjoint subset that receives the equivocating variant: the
        upper half of the peer list (a fixed, seed-independent split — the
        schedule must be a pure function of the plan)."""
        peers = self._peers(node)
        return set(peers[len(peers) // 2 :])

    def _favored(self, node: int, keep: int) -> Set[int]:
        return set(self._peers(node)[: max(0, keep)])

    # -- the transform --

    def transform(
        self, src: int, dst: int, batch: list, t: float
    ) -> List[Tuple[float, list]]:
        """One outbound batch src->dst at sim time ``t`` -> delay groups
        ``[(extra_delay_s, messages), ...]`` (the fault-injector group
        shape).  Untouched messages keep their original objects, so the
        sim's zero-serialization EncodedFrame delivery is unchanged when
        no behavior fires."""
        specs = [s for s in self._by_node.get(src, []) if s.active(t)]
        if not specs:
            return [(0.0, batch)]
        on_time: list = []
        delayed: List[Tuple[float, list]] = []
        for msg in batch:
            out_msg, delay = self._transform_message(src, dst, msg, specs)
            if out_msg is None:
                continue
            if delay > 0.0:
                delayed.append((delay, [out_msg]))
            else:
                on_time.append(out_msg)
        out: List[Tuple[float, list]] = []
        if on_time:
            out.append((0.0, on_time))
        out.extend(delayed)
        return out

    def _transform_message(self, src, dst, msg, specs):
        """-> (message or None to drop, extra delay)."""
        delay = 0.0
        for spec in specs:
            if msg is None:
                break
            behavior = spec.behavior
            if behavior == "mangle":
                p = spec.param("mangle_p", DEFAULT_MANGLE_P)
                if self._rng.random() < p:
                    garbage = bytes(
                        self._rng.getrandbits(8) for _ in range(40)
                    )
                    self.ledger.note("mangle", node=src, dst=dst)
                    msg = Blocks((garbage,))
                continue
            frame = _block_frames(msg)
            if frame is None:
                continue
            own = [
                i for i, raw in enumerate(frame.blocks)
                if _block_author_round(raw)[0] == src
            ]
            if not own:
                continue
            if behavior == "withhold":
                keep = int(spec.param("keep", DEFAULT_WITHHOLD_KEEP))
                if dst in self._favored(src, keep):
                    continue
                kept = tuple(
                    raw for i, raw in enumerate(frame.blocks) if i not in own
                )
                self.ledger.note(
                    "withhold", node=src, dst=dst, blocks=len(own)
                )
                msg = _rebuild(frame, kept) if kept else None
            elif behavior == "equivocate":
                if dst not in self._variant_side(src):
                    continue
                payload = list(frame.blocks)
                for i in own:
                    raw = bytes(payload[i])
                    variant = self._variants.get(raw)
                    if variant is None:
                        variant = equivocating_variant(raw, self.signers[src])
                        self._variants[raw] = variant
                        self.ledger.note(
                            "equivocate-mint", node=src,
                            round=_block_author_round(raw)[1],
                        )
                    payload[i] = variant
                self.ledger.note(
                    "equivocate", node=src, dst=dst, blocks=len(own)
                )
                msg = _rebuild(frame, tuple(payload))
            elif behavior == "invalid_sig":
                payload = list(frame.blocks)
                for i in own:
                    raw = bytes(payload[i])
                    tampered = self._tampered.get(raw)
                    if tampered is None:
                        tampered = tamper_signature(raw)
                        self._tampered[raw] = tampered
                    payload[i] = tampered
                self.ledger.note(
                    "invalid_sig", node=src, dst=dst, blocks=len(own)
                )
                msg = _rebuild(frame, tuple(payload))
            elif behavior == "lag":
                lag = spec.param("lag_s", DEFAULT_LAG_S)
                self.ledger.note(
                    "lag", node=src, dst=dst, blocks=len(own), delay_s=lag
                )
                delay = max(delay, lag)
        return msg, delay
