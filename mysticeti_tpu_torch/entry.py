"""Entry points: the single-card verify step and a multi-card dry run.

The port's counterpart of the repository's ``__graft_entry__.py``.

``entry(device=None)`` returns the flagship step — batched Ed25519
verification of raw signature bytes (``ops.ed25519.verify_fused_impl``: the
prologue kernel's SHA-512 of R||A||M, mod L, point parse and canonicity
checks, then the generic kernel's double-scalar ladder and the compare) —
with an 8-signature example batch on ``device``.

``dryrun_multichip(n, device=None)`` builds an n-shard mesh
(``parallel.mesh``), runs the fused sharded dispatch on 2 signatures a shard
and checks the verdicts and the summed valid count, then the committee-
indexed sharded verify over a 4-key table.  The shards go on the cards there
are, in turn, so fewer cards than ``n`` carry several shards each;
``device="cpu"`` (or a list of devices, e.g. ``["cpu"] * 8``) runs the
kernels' plain versions instead.  There is no fallback to the CPU: with no
card and no explicit CPU request both raise.

``python -m mysticeti_tpu_torch.entry [N]`` runs ``entry()`` on the card and,
with N > 1, ``dryrun_multichip(N)``.
"""
from __future__ import annotations

import random
import sys
from typing import Sequence, Union

import numpy as np
import torch

from .crypto import Ed25519PrivateKey
from .ops import ed25519 as E


def _example_batch(n: int, seed: int = 7):
    """``n`` signatures over random 32-byte messages by keys drawn from
    ``random.Random(seed)``, as the three ``pack_bytes`` arrays."""
    rng = random.Random(seed)
    pks, msgs, sigs = [], [], []
    for _ in range(n):
        key = Ed25519PrivateKey.from_private_bytes(
            bytes(rng.randrange(256) for _ in range(32))
        )
        msg = bytes(rng.randrange(256) for _ in range(32))
        pks.append(key.public_key().public_bytes_raw())
        msgs.append(msg)
        sigs.append(key.sign(msg))
    return E.pack_bytes(pks, msgs, sigs)


def entry(device=None):
    """Returns (fn, example_args): the fused raw-bytes verify step and an
    8-signature batch on ``device`` (``cuda`` unless given)."""
    device = E.resolve_device(device)
    msg_words, s_words, host_ok = _example_batch(8)
    args = (
        E.to_device_words(msg_words, device),
        E.to_device_words(s_words, device),
        torch.as_tensor(host_ok, device=device),
    )
    return E.verify_fused_impl, args


def _mesh_devices(n: int, device) -> list:
    """The device of each of ``n`` shards: ``device`` as given (one device,
    or a list of n), else the cards there are, in turn."""
    if isinstance(device, (list, tuple)):
        if len(device) != n:
            raise ValueError(f"{len(device)} devices for {n} shards")
        return list(device)
    if device is not None and torch.device(device).type != "cuda":
        return [torch.device(device)] * n
    E.resolve_device(device)
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def dryrun_multichip(n_devices: int,
                     device: Union[None, str, torch.device, Sequence] = None) -> None:
    """One step of the sharded verify over an ``n_devices``-shard mesh;
    raises AssertionError on a wrong verdict or count."""
    from .parallel.mesh import (
        _cached_fused_kernel,
        make_mesh,
        sharded_verify_batch_indexed,
    )

    mesh = make_mesh(devices=_mesh_devices(n_devices, device))
    per_shard = 2  # tiny: two signatures a shard
    n = per_shard * n_devices
    msg_words, s_words, host_ok = _example_batch(n)
    blob = np.concatenate([msg_words, s_words, host_ok[:, None].astype(np.uint32)], axis=1)
    oks, total = _cached_fused_kernel(mesh)(blob)
    ok = E.fetch_handles([(n, oks)])
    assert ok.shape == (n,)
    assert ok.all(), "all example signatures must verify"
    assert int(total) == n, "summed valid count mismatch"

    # The deployed wire format: a committee-indexed blob, the key table on
    # every shard's device, the blob sharded on the batch axis.
    rng = random.Random(11)
    keys = [
        Ed25519PrivateKey.from_private_bytes(bytes(rng.randrange(256) for _ in range(32)))
        for _ in range(4)
    ]
    table = E.KeyTable([k.public_key().public_bytes_raw() for k in keys],
                       device=mesh.devices[0])
    pks, msgs, sigs = [], [], []
    for i in range(n):
        k = keys[i % 4]
        m = bytes(rng.randrange(256) for _ in range(32))
        pks.append(k.public_key().public_bytes_raw())
        msgs.append(m)
        sigs.append(k.sign(m))
    ok_idx, total_idx = sharded_verify_batch_indexed(mesh, table, pks, msgs, sigs)
    assert ok_idx.all() and total_idx == n, "indexed sharded verify mismatch"


if __name__ == "__main__":
    shards = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    fn, example = entry()
    print("entry ok:", fn(*example).cpu().numpy().tolist())
    if shards > 1:
        dryrun_multichip(shards)
        print(f"dryrun_multichip({shards}) ok")
