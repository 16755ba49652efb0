"""The comparison that decides ``correct``: what the window produced against
the plain reference (``reference/``), worked out again from the same wire
bytes once the window has closed.

Every number is a count of disagreements, compared exactly (limit 0):

* ``stage1_mismatch``: blocks stage 1 dropped that the reference finds
  well-formed and structurally valid;
* ``identity_mismatch``: blocks whose author, round, block digest or signed
  digest, as stage 1 derived them, differ from the reference's (every block);
* ``verdict_mismatch``: verdicts that differ from the reference's, on every
  distinct block the traffic forged (where a wrong accept can occur), every
  distinct block the program rejected (up to ``REJECT_CAP``) and a sample of
  ``ACCEPT_SAMPLE`` distinct blocks it accepted, the samples drawn from the
  seed; and distinct blocks that got both verdicts in one run;
* ``no_verdict``: blocks handed to stage 2 that never got a verdict;
* ``lanes_short`` (catch-up): per episode, blocks handed to stage 2 that the
  collector did not dispatch to a device lane, or lanes beyond them
  (``verify_dispatch_batch_size``'s sum against the blocks sent), so no
  verdict is served from a cache.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .reference.blocks import Reference, decode, identity, structure_ok

ACCEPT_SAMPLE = 384
REJECT_CAP = 512
# What became of a block handed to stage 1 (``run.Records.outcome``).
PENDING, ACCEPTED, REJECTED, ERROR, DROPPED = range(5)


def sample(rng: np.random.Generator, items: List[int], k: int) -> List[int]:
    if len(items) <= k:
        return list(items)
    return [items[i] for i in sorted(rng.choice(len(items), size=k, replace=False))]


def compare(pool, rec: dict, episodes, public_keys, epoch: int, seed: int) -> Dict[str, dict]:
    """``rec``: the window's ``run.Records.columns()``."""
    ref = Reference(public_keys, epoch)
    n = len(public_keys)
    stage1 = ident = 0
    ids: Dict[int, tuple] = {}
    verdicts: Dict[int, set] = {}
    outcome = rec["outcome"].tolist()
    for idx, out, author, round_, digests in zip(rec["idx"].tolist(), outcome, rec["author"].tolist(),
                                                 rec["round"].tolist(), rec["digests"]):
        raw = pool.raws[idx]
        if out == DROPPED:
            try:
                stage1 += structure_ok(decode(raw), n, epoch)
            except ValueError:
                pass
            continue
        if idx not in ids:
            a, r, d, s = identity(raw)
            ids[idx] = (a, r, d + s)
        ident += (author, round_, digests.tobytes()) != ids[idx]
        if out in (ACCEPTED, REJECTED):
            verdicts.setdefault(idx, set()).add(out == ACCEPTED)
    no_verdict = sum(1 for out in outcome if out in (PENDING, ERROR))
    mixed = sum(1 for v in verdicts.values() if len(v) > 1)
    rng = np.random.default_rng([seed % 2**64, 3])
    rejected = sorted(i for i, v in verdicts.items() if v == {False})
    accepted = sorted(i for i, v in verdicts.items() if v == {True})
    judged = {i: False for i in sample(rng, rejected, REJECT_CAP)}
    judged.update((i, True) for i in sample(rng, accepted, ACCEPT_SAMPLE))
    forged = [i for i in sorted(verdicts) if pool.forged[i] and len(verdicts[i]) == 1]
    judged.update((i, verdicts[i] == {True}) for i in forged)
    wrong = sum(ref.verdict(pool.raws[i]) != ok for i, ok in judged.items())
    out = {
        "stage1_mismatch": stage1,
        "identity_mismatch": ident,
        "verdict_mismatch": wrong + mixed,
        "no_verdict": no_verdict,
    }
    if episodes:
        out["lanes_short"] = sum(abs(e["sent"] - e["lanes"]) for e in episodes)
    return {k: {"value": int(v), "limit": 0} for k, v in out.items()}
