"""On-card kernel correctness artifact (KERNEL_PARITY).

The port's copy of the JAX package's ``tools/kernel_parity.py``.  Runs the
DEPLOYED verification paths on the card (the CUDA kernels behind
``ops/ed25519.py``; ``--device cpu`` runs their plain PyTorch versions) and
checks them against the RFC 8032 vectors and the Ed25519 oracle
(``cryptography``, through ``mysticeti_tpu_torch.crypto``) over >= 10k
randomized sign/verify/corrupt cases.  A wrong-but-fast lane would still post
a high rate; here every accept/reject bit is compared.

Covered paths:
  * verify_batch            — raw bytes (unknown signer set): the prologue
                              and the generic kernel; the RFC vectors'
                              0-2 byte messages hash on the host and take
                              the generic kernel alone
  * verify_batch_table      — committee-indexed: the prologue and the keyed
                              kernel, one key a lane; ``corrupt_pk`` lanes
                              (unknown keys) ride the generic straggler patch
Case classes: valid, corrupted R, corrupted s, corrupted message, wrong key,
non-canonical s (s+L), corrupted pk.

The document adds, against the JAX tool's: ``card`` (``nvidia-smi``'s name
and power limit), ``oracle``, ``seconds`` and the kernels' ``launches``.
Exits 1 when ``pass`` is false (the JAX tool exits 0 either way).

Usage: python -m mysticeti_tpu_torch.tools.kernel_parity --n 12288 [--device cpu]
       [--out build/KERNEL_PARITY.json]
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time

from mysticeti_tpu_torch.tools import build_path, card, launch_counts, write_json

RFC8032_VECTORS = [
    (
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
        "",
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e0652249015"
        "55fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    ),
    (
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
        "72",
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
        "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    ),
    (
        "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
        "af82",
        "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
        "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a",
    ),
]

L = (1 << 252) + 27742317777372353535851937790883648493

DEFAULT_OUT = build_path("KERNEL_PARITY.json")


def oracle_verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    from mysticeti_tpu_torch.crypto import Ed25519PublicKey, InvalidSignature

    try:
        Ed25519PublicKey.from_public_bytes(pk).verify(sig, msg)
        return True
    except (InvalidSignature, ValueError):
        return False


def build_cases(n: int, seed: int):
    """``n`` seeded cases over 16 keys: (committee keys, pks, msgs, sigs,
    labels), byte for byte the JAX tool's for the same ``seed``."""
    from mysticeti_tpu_torch.crypto import Ed25519PrivateKey

    rng = random.Random(seed)
    n_keys = 16
    keys = [
        Ed25519PrivateKey.from_private_bytes(
            bytes(rng.randrange(256) for _ in range(32))
        )
        for _ in range(n_keys)
    ]
    raw_pks = [k.public_key().public_bytes_raw() for k in keys]
    classes = [
        "valid", "valid", "valid", "valid",
        "corrupt_R", "corrupt_s", "corrupt_msg", "wrong_key",
        "noncanonical_s", "corrupt_pk",
    ]
    pks, msgs, sigs, labels = [], [], [], []
    for i in range(n):
        ki = rng.randrange(n_keys)
        msg = bytes(rng.randrange(256) for _ in range(32))
        sig = keys[ki].sign(msg)
        pk = raw_pks[ki]
        cls = classes[rng.randrange(len(classes))]
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
            pk = raw_pks[(ki + 1) % n_keys]
        elif cls == "noncanonical_s":
            s = int.from_bytes(sig[32:], "little") + L
            if s < (1 << 256):
                sig = sig[:32] + s.to_bytes(32, "little")
            else:  # unrepresentable: fall back to a plain valid case
                cls = "valid"
        elif cls == "corrupt_pk":
            pos = rng.randrange(32)
            pk = pk[:pos] + bytes([pk[pos] ^ 1]) + pk[pos + 1:]
        pks.append(pk)
        msgs.append(msg)
        sigs.append(sig)
        labels.append(cls)
    return raw_pks, pks, msgs, sigs, labels


def parity(n: int, seed: int, device=None) -> dict:
    """The KERNEL_PARITY document of ``n`` randomized cases on ``device``
    (default ``cuda``; raises without a card)."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch.crypto import HAVE_CRYPTOGRAPHY
    from mysticeti_tpu_torch.ops import ed25519 as E

    device = E.resolve_device(device)
    on_card = device.type == "cuda"
    out = {
        "metric": "kernel_parity_on_device",
        "device": torch.cuda.get_device_name(device) if on_card else device.type,
        "card": card() if on_card else None,
        "backend": device.type,
        "oracle": "cryptography" if HAVE_CRYPTOGRAPHY else "pure-python RFC 8032",
        "seed": seed,
        "n_randomized": n,
    }
    t0 = time.monotonic()

    # RFC 8032 vectors (variable-length messages -> host-hash packing, the
    # generic kernel alone) + corrupted variants.
    pks = [bytes.fromhex(pk) for pk, _, _ in RFC8032_VECTORS]
    msgs = [bytes.fromhex(m) for _, m, _ in RFC8032_VECTORS]
    sigs = [bytes.fromhex(s) for _, _, s in RFC8032_VECTORS]
    rfc_ok = bool(E.verify_batch(pks, msgs, sigs, device=device).all())
    bad_sigs = [bytearray(s) for s in sigs]
    bad_sigs[0][3] ^= 0x40
    bad_sigs[1][40] ^= 0x01
    bad_msgs = list(msgs)
    bad_msgs[2] = msgs[2] + b"x"
    rfc_rej = not E.verify_batch(
        pks, bad_msgs, [bytes(s) for s in bad_sigs], device=device
    ).any()
    out["rfc8032"] = {"accept_all_valid": rfc_ok, "reject_all_corrupt": rfc_rej}

    committee_keys, pks, msgs, sigs, labels = build_cases(n, seed)
    expected = np.array(
        [oracle_verify(pk, m, s) for pk, m, s in zip(pks, msgs, sigs)], dtype=bool
    )

    table = E.KeyTable(committee_keys, device=device)
    results = {}
    for name, got in (
        ("verify_batch_raw", E.verify_batch(pks, msgs, sigs, device=device)),
        ("verify_batch_table_keyed", E.verify_batch_table(table, pks, msgs, sigs)),
    ):
        got = np.asarray(got, dtype=bool)
        mism = np.nonzero(got != expected)[0]
        per_class = {}
        for lbl in sorted(set(labels)):
            sel = [i for i, l in enumerate(labels) if l == lbl]
            per_class[lbl] = {
                "cases": len(sel),
                "mismatches": int(sum(got[i] != expected[i] for i in sel)),
            }
        results[name] = {
            "cases": n,
            "mismatches": int(mism.size),
            "first_mismatches": mism[:5].tolist(),
            "per_class": per_class,
        }
    out["randomized"] = results
    out["oracle_accepts"] = int(expected.sum())
    out["pass"] = (
        rfc_ok
        and rfc_rej
        and all(r["mismatches"] == 0 for r in results.values())
    )
    out["seconds"] = time.monotonic() - t0
    out["launches"] = launch_counts()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=12288)
    parser.add_argument("--seed", type=int, default=2026)
    parser.add_argument("--out", default=DEFAULT_OUT)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the "
                        "kernels' plain versions)")
    args = parser.parse_args(argv)

    out = parity(args.n, args.seed, args.device)
    write_json(args.out, out, indent=2)
    print(json.dumps({k: out[k] for k in ("device", "card", "backend", "pass")}))
    print(f"wrote {args.out}")
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
