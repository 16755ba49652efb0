"""Deterministic execution plane: account/transfer state machine on commits.

The port's copy of ``mysticeti_tpu.execution``.

The committed leader sequence is a total order every honest node derives
identically (the same property :mod:`.reconfig` anchors epoch changes on),
which makes it a replicated-state-machine log for free.  This module is the
CONSUMER half of ROADMAP item 3: a deterministic account/transfer runtime
folded over the linearized commits, whose per-commit **state root** becomes
a cross-node safety invariant and the object clients actually wait for
(execution-backed finality, the ACE-runtime shape from PAPERS.md).

* ``ExecTx`` — a typed CREATE/MINT/TRANSFER transaction that rides the
  committed sequence as an ordinary ``Share`` payload prefixed with
  ``EXEC_MAGIC``.  Non-magic payloads (benchmark counters, stamped random
  bytes, reconfig changes) are opaque no-ops — the runtime coexists with
  every existing workload.
* ``ExecutionState`` — the per-node state machine owned by the consensus
  core: folds each committed sub-dag (linearized order, one commit at a
  time, the ``ReconfigState.observe_commit`` pattern) and emits a chained
  per-commit state root.
* **State root** — BLAKE2b-256 over ``prev_root ‖ height ‖ sorted account
  deltas`` (canonical serde encoding, accounts sorted by key).  Every
  commit advances the chain — a commit with no execution transactions
  still produces a new root — so two honest nodes can be compared at
  *every* shared height, and a fork anywhere poisons every later root.

Determinism rules (docs/execution.md):

* Inputs are exactly (previous state, commit height, Share payloads in
  sub-dag linearized order).  No clocks, no RNG, no per-node identity.
* Invalid transactions (bad nonce, overdraft, duplicate create, unknown
  account) are deterministic typed no-ops — every node rejects them with
  the same verdict, so duplicates and garbage cannot fork the chain.
* A payload carrying ``EXEC_MAGIC`` that fails to decode is an opaque
  no-op, exactly like :func:`.reconfig.parse_reconfig_tx` — a garbled
  transaction must not fork honest nodes on whether to error.

Concurrency: mutation is single-owner (the consensus core task calls
:meth:`ExecutionState.observe_commit`), but the ingress plane *probes*
account state from submission threads for pre-consensus admission
(bad-nonce / insufficient-balance shed before consensus pays for the tx),
so the account table is guarded by ``_exec_lock`` (lint GUARDED_FIELDS).
"""
from __future__ import annotations

import hashlib
import threading
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

from .serde import Reader, SerdeError, Writer
from .types import Share, StatementBlock

# Share-payload prefix marking an execution transaction.  Same shape as
# RECONFIG_MAGIC: 8 bytes, first byte 0xFF — unreachable for the 8-byte
# little-endian benchmark counters below 2**63.
EXEC_MAGIC = b"\xffEXECTX\x01"

OP_CREATE = 0  # create account with an initial (faucet) balance; nonce must be 0
OP_MINT = 1  # balance += amount on an existing account (nonce-gated)
OP_TRANSFER = 2  # move amount to dest (auto-created at 0); nonce-gated

_OP_NAMES = {OP_CREATE: "create", OP_MINT: "mint", OP_TRANSFER: "transfer"}

# Typed apply verdicts.  The *names* are the metrics label set
# (mysticeti_execution_txs_total{result}) and the ingress shed vocabulary —
# keep them stable.
APPLIED = "applied"
REJECT_EXISTS = "account_exists"
REJECT_UNKNOWN = "unknown_account"
REJECT_BAD_NONCE = "bad_nonce"
REJECT_OVERDRAFT = "insufficient_balance"

MAX_ACCOUNT_KEY_LEN = 64

# Recent (height, root) pairs retained for the /debug document, the gateway
# resume reply, and the chaos state-root audit.  Bounded: old roots are
# recomputable from the WAL and irrelevant to live agreement checks.
ROOT_WINDOW = 1024

GENESIS_ROOT = b"\x00" * 32


@dataclass(frozen=True)
class ExecTx:
    """One typed execution transaction riding the committed sequence."""

    op: int
    account: bytes
    nonce: int = 0
    amount: int = 0
    dest: bytes = b""

    def __post_init__(self) -> None:
        if self.op not in _OP_NAMES:
            raise ValueError(f"unknown execution op {self.op}")
        if not self.account or len(self.account) > MAX_ACCOUNT_KEY_LEN:
            raise ValueError(
                f"account key must be 1..{MAX_ACCOUNT_KEY_LEN} bytes"
            )
        if self.op == OP_TRANSFER:
            if not self.dest or len(self.dest) > MAX_ACCOUNT_KEY_LEN:
                raise ValueError(
                    f"transfer dest must be 1..{MAX_ACCOUNT_KEY_LEN} bytes"
                )
        elif self.dest:
            raise ValueError(f"{_OP_NAMES[self.op]} takes no dest")
        if self.nonce < 0 or self.amount < 0:
            raise ValueError("nonce/amount must be non-negative")

    def to_bytes(self) -> bytes:
        w = Writer()
        w.fixed(EXEC_MAGIC)
        w.u8(self.op)
        w.bytes(self.account)
        w.u64(self.nonce)
        w.u64(self.amount)
        w.bytes(self.dest)
        return w.finish()

    @staticmethod
    def from_bytes(data: bytes) -> "ExecTx":
        r = Reader(data)
        magic = r.fixed(len(EXEC_MAGIC))
        if magic != EXEC_MAGIC:
            raise SerdeError("not an execution transaction")
        op = r.u8()
        account = bytes(r.bytes())
        nonce = r.u64()
        amount = r.u64()
        dest = bytes(r.bytes())
        r.expect_done()
        return ExecTx(op, account, nonce, amount, dest)

    def describe(self) -> str:
        extra = f", dest={self.dest.hex()}" if self.dest else ""
        return (
            f"{_OP_NAMES[self.op]}(account={self.account.hex()}, "
            f"nonce={self.nonce}, amount={self.amount}{extra})"
        )


def parse_exec_tx(payload: bytes) -> Optional[ExecTx]:
    """Decode a Share payload into an :class:`ExecTx`, or None for ordinary
    transactions.  A payload carrying the magic but failing to decode is
    treated as ordinary data (a garbled transaction must not fork honest
    nodes on whether to error — ignoring it is the deterministic choice)."""
    if not payload.startswith(EXEC_MAGIC):
        return None
    try:
        return ExecTx.from_bytes(payload)
    except (SerdeError, ValueError):
        return None


@dataclass(frozen=True)
class ExecutionResult:
    """Outcome of folding one committed sub-dag."""

    height: int
    root: bytes
    applied: int
    rejected: int
    # typed verdict name -> count for this commit (APPLIED included)
    verdicts: Tuple[Tuple[str, int], ...] = ()


class ExecutionState:
    """Deterministic account/transfer state machine on the committed sequence.

    Single-owner mutation (the consensus core task calls
    :meth:`observe_commit` / :meth:`adopt` / :meth:`recover`); concurrent
    *probes* from ingress submission threads go through :meth:`probe` under
    the same lock.
    """

    def __init__(self, metrics=None) -> None:
        self._exec_lock = threading.Lock()
        # account key -> (balance, nonce).  Guarded by _exec_lock (lint
        # GUARDED_FIELDS): the core task folds commits while ingress
        # submission threads probe balances for pre-consensus admission.
        self._exec_accounts: Dict[bytes, Tuple[int, int]] = {}
        self.last_height = 0
        self.root = GENESIS_ROOT
        self.recent_roots: Deque[Tuple[int, bytes]] = deque(maxlen=ROOT_WINDOW)
        self.applied_total = 0
        self.rejected_total = 0
        self.metrics = metrics

    # -- queries ---------------------------------------------------------

    def probe(self, account: bytes) -> Optional[Tuple[int, int]]:
        """(balance, nonce) snapshot, or None for an unknown account.
        Advisory by design: in-flight committed transactions may move the
        account before a submission folded against this snapshot lands."""
        with self._exec_lock:
            return self._exec_accounts.get(account)

    def account_count(self) -> int:
        with self._exec_lock:
            return len(self._exec_accounts)

    def root_at(self, height: int) -> Optional[bytes]:
        """The chained root at ``height`` if still in the recent window."""
        for h, root in reversed(self.recent_roots):
            if h == height:
                return root
            if h < height:
                break
        return None

    def admission_verdict(self, tx: ExecTx) -> Optional[str]:
        """Pre-consensus admission check for the ingress plane: a typed
        reject for transactions that are *already* doomed against current
        state, None for plausibly-valid ones.

        Deliberately weaker than :meth:`_apply`: a nonce *ahead* of the
        account (earlier transactions in flight) and a CREATE for a not-yet
        -existing account are admitted — only verdicts that cannot be cured
        by in-flight traffic (stale nonce, overdraft beyond current funds
        plus any pending mint is still a heuristic — we only shed what is
        wrong *now*) are shed before consensus pays for the transaction."""
        snapshot = self.probe(tx.account)
        if tx.op == OP_CREATE:
            return REJECT_EXISTS if snapshot is not None else None
        if snapshot is None:
            return REJECT_UNKNOWN
        balance, nonce = snapshot
        if tx.nonce < nonce:
            return REJECT_BAD_NONCE
        if tx.op == OP_TRANSFER and tx.nonce == nonce and tx.amount > balance:
            return REJECT_OVERDRAFT
        return None

    # -- the fold --------------------------------------------------------

    def _apply(self, tx: ExecTx, deltas: Dict[bytes, Tuple[int, int]]) -> str:
        """Apply one transaction against the account table (lock held by
        the caller), recording touched accounts into ``deltas``."""
        accounts = self._exec_accounts
        if tx.op == OP_CREATE:
            if tx.account in accounts:
                return REJECT_EXISTS
            if tx.nonce != 0:
                return REJECT_BAD_NONCE
            accounts[tx.account] = (tx.amount, 1)
            deltas[tx.account] = accounts[tx.account]
            return APPLIED
        entry = accounts.get(tx.account)
        if entry is None:
            return REJECT_UNKNOWN
        balance, nonce = entry
        if tx.nonce != nonce:
            return REJECT_BAD_NONCE
        if tx.op == OP_MINT:
            accounts[tx.account] = (balance + tx.amount, nonce + 1)
            deltas[tx.account] = accounts[tx.account]
            return APPLIED
        # OP_TRANSFER
        if tx.amount > balance:
            return REJECT_OVERDRAFT
        dest_balance, dest_nonce = accounts.get(tx.dest, (0, 0))
        if tx.dest == tx.account:
            # Self-transfer: balance unchanged, nonce still consumed.
            accounts[tx.account] = (balance, nonce + 1)
            deltas[tx.account] = accounts[tx.account]
            return APPLIED
        accounts[tx.account] = (balance - tx.amount, nonce + 1)
        accounts[tx.dest] = (dest_balance + tx.amount, dest_nonce)
        deltas[tx.account] = accounts[tx.account]
        deltas[tx.dest] = accounts[tx.dest]
        return APPLIED

    def observe_commit(
        self, height: int, blocks: List[StatementBlock]
    ) -> Optional[ExecutionResult]:
        """Fold one committed sub-dag (linearized block order) into the
        state and advance the root chain.  Returns None when the commit was
        already folded (crash replay re-delivers committed heights —
        exactly the ``ReconfigState.observe_commit`` skip)."""
        if height <= self.last_height:
            return None
        verdicts: Dict[str, int] = {}
        deltas: Dict[bytes, Tuple[int, int]] = {}
        with self._exec_lock:
            for block in blocks:
                for st in block.statements:
                    if not isinstance(st, Share):
                        continue
                    tx = parse_exec_tx(bytes(st.transaction))
                    if tx is None:
                        continue
                    verdict = self._apply(tx, deltas)
                    verdicts[verdict] = verdicts.get(verdict, 0) + 1
        # Chained root: prev ‖ height ‖ sorted account deltas.  The digest
        # input is canonical serde bytes, so it is identical wherever the
        # same commit folds over the same predecessor state.
        h = hashlib.blake2b(digest_size=32)
        h.update(self.root)
        w = Writer()
        w.u64(height)
        w.u32(len(deltas))
        for key in sorted(deltas):
            balance, nonce = deltas[key]
            w.bytes(key)
            w.u64(balance)
            w.u64(nonce)
        h.update(w.finish())
        self.root = h.digest()
        self.last_height = height
        self.recent_roots.append((height, self.root))
        applied = verdicts.get(APPLIED, 0)
        rejected = sum(v for k, v in verdicts.items() if k != APPLIED)
        self.applied_total += applied
        self.rejected_total += rejected
        if self.metrics is not None:
            for verdict, count in verdicts.items():
                self.metrics.mysticeti_execution_txs_total.labels(
                    verdict
                ).inc(count)
            self.metrics.mysticeti_execution_height.set(height)
            self.metrics.mysticeti_execution_accounts.set(
                len(self._exec_accounts)
            )
        return ExecutionResult(
            height,
            self.root,
            applied,
            rejected,
            tuple(sorted(verdicts.items())),
        )

    # -- durability ------------------------------------------------------

    def to_bytes(self) -> bytes:
        """Canonical full-state encoding (checkpoints / snapshot manifests).
        Accounts are sorted by key, so two nodes on the same root encode
        byte-identically."""
        w = Writer()
        w.u64(self.last_height)
        w.fixed(self.root)
        with self._exec_lock:
            items = sorted(self._exec_accounts.items())
        w.u32(len(items))
        for key, (balance, nonce) in items:
            w.bytes(key)
            w.u64(balance)
            w.u64(nonce)
        w.u64(self.applied_total)
        w.u64(self.rejected_total)
        return w.finish()

    def recover(self, data: bytes) -> None:
        """Adopt a persisted state wholesale (checkpoint recovery)."""
        if not data:
            return
        r = Reader(data)
        last_height = r.u64()
        root = r.fixed(32)
        accounts: Dict[bytes, Tuple[int, int]] = {}
        for _ in range(r.u32()):
            key = bytes(r.bytes())
            accounts[key] = (r.u64(), r.u64())
        applied_total = r.u64()
        rejected_total = r.u64()
        r.expect_done()
        with self._exec_lock:
            self._exec_accounts = accounts
        self.last_height = last_height
        self.root = root
        self.applied_total = applied_total
        self.rejected_total = rejected_total
        self.recent_roots.clear()
        if last_height:
            self.recent_roots.append((last_height, root))

    def adopt(self, data: bytes) -> bool:
        """Snapshot catch-up: adopt a remote execution state iff it is
        AHEAD of ours (the :meth:`.reconfig.ReconfigState.adopt_chain`
        shape — a remote at or behind our height carries nothing we need
        and is ignored).  Trust model: the manifest rode the same
        quorum-anchored snapshot the commit baseline did; the adopted root
        is cross-checked against the fleet by the chaos state-root audit
        and re-verified implicitly by every later locally-folded commit."""
        if not data:
            return False
        r = Reader(data)
        remote_height = r.u64()
        if remote_height <= self.last_height:
            return False
        self.recover(data)
        return True

    def state(self) -> dict:
        """Live introspection document (/debug/consensus)."""
        return {
            "height": self.last_height,
            "root": self.root.hex(),
            "accounts": self.account_count(),
            "applied_total": self.applied_total,
            "rejected_total": self.rejected_total,
            "recent_roots": [
                {"height": h, "root": root.hex()}
                for h, root in list(self.recent_roots)[-16:]
            ],
        }
