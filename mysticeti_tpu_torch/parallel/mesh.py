"""Device mesh and sharded dispatch for the Ed25519 batch verifier.

The counterpart of ``mysticeti_tpu.parallel.mesh``.  The verify kernel is
embarrassingly parallel over the batch, so the mesh is one axis (``batch``):
every bucket chunk is cut into equal shards, one per mesh device, and each
shard is uploaded from the host straight to its own device and verified
there by the prologue and generic kernels (the JAX package's ``shard_map``
over the Pallas ladder).  The counterpart of its ``psum`` is the per-shard
valid counts summed on the mesh's first device.  As in the JAX package the
dispatch paths compute that total but do not fetch it (padding lanes carry
host_ok=False, so it equals the sum of the fetched verdicts);
``sharded_verify_batch*`` return it.

A mesh is an ordered tuple of ``torch.device``s.  A device may repeat: the
CPU tests run 8 shards on the one CPU device (the JAX tests' 8 virtual
devices), and one card can carry several shards.  The sharded path never
takes the keyed kernel (the JAX package has none there); unknown-key
stragglers of an indexed dispatch ride ``dispatch_sharded_fused``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import ed25519 as E
from ..ops import ed25519_cuda as K


class Mesh(NamedTuple):
    """A 1-D mesh over ``devices`` (in shard order), axis ``batch``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("batch",)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` CUDA devices (axis ``batch``).

    ``devices`` overrides the CUDA device list and may repeat a device, e.g.
    ``["cpu"] * 8`` for eight shards of the kernels' plain versions.  With no
    ``devices`` and no card, raises."""
    if devices is None:
        E.resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [E.device_key(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


def _shards(mesh: Mesh, n: int):
    """(device, row slice) of each shard of an ``n``-row batch."""
    if n % mesh.size:
        raise ValueError(f"batch {n} not a multiple of the mesh size {mesh.size}")
    per = n // mesh.size
    return [(dev, slice(i * per, (i + 1) * per)) for i, dev in enumerate(mesh.devices)]


def _psum(mesh: Mesh, oks) -> torch.Tensor:
    """The valid count over all shards, on the mesh's first device."""
    first = mesh.devices[0]
    return torch.stack([ok.sum().to(first) for ok in oks]).sum()


def sharded_verify_kernel(mesh: Mesh):
    """fn(the seven ``pack_batch`` arrays) -> (per-shard bool tensors,
    global valid count): the generic kernel once per shard.  The batch must
    be a multiple of the mesh size."""

    def upload(x, dev):
        x = np.ascontiguousarray(x)
        E._note_transfer("to_device", x.nbytes)
        return torch.as_tensor(x, device=dev)

    def run(*arrays):
        oks = [
            K.verify_generic(*(upload(x[rows], dev) for x in arrays))
            for dev, rows in _shards(mesh, arrays[0].shape[0])
        ]
        return oks, _psum(mesh, oks)

    return run


def sharded_verify_batch(
    mesh: Mesh,
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
) -> Tuple[np.ndarray, int]:
    """Host convenience: pack (any message length), pad to a multiple of the
    mesh size, dispatch sharded.  Returns (per-item bool, valid count)."""
    n = len(signatures)
    packed = E.pack_batch(public_keys, messages, signatures)
    padded = max(1, -(-n // mesh.size)) * mesh.size
    oks, total = sharded_verify_kernel(mesh)(*(E._pad_to(x, padded) for x in packed))
    return E.fetch_handles([(n, oks)]), _total([total])


def _shard_run(mesh: Mesh, blob: np.ndarray, table: Optional[E.KeyTable] = None):
    """One bucket chunk, sharded: each shard's rows go from the host to its
    device, through the prologue and the generic kernel there.  Returns
    (per-shard verdicts, valid count)."""
    oks = [K.verify_generic(*K.prologue(E.to_device_words(blob[rows], dev),
                                        None if table is None else table.words_on(dev)))
           for dev, rows in _shards(mesh, blob.shape[0])]
    return oks, _psum(mesh, oks)


# Named as in the JAX package, where each caches one compiled shard_map
# program per mesh; eager PyTorch has nothing to compile or cache.
def _cached_fused_kernel(mesh: Mesh):
    """fn(raw (B, 33) blob) -> (per-shard verdicts, valid count)."""
    return functools.partial(_shard_run, mesh)


def _cached_indexed_kernel(mesh: Mesh):
    """fn(indexed (B, 26) blob, KeyTable) -> (per-shard verdicts, valid
    count).  The (K, 8) key table is replicated to every device (a committee
    table is a few KB), the blob shards on the batch axis."""
    return functools.partial(_shard_run, mesh)


def _dispatch_chunks(run, blob: np.ndarray, *args):
    """Every bucket chunk of ``blob`` through ``run``: (fetch_handles
    entries, per-chunk device totals)."""
    handles, totals = [], []
    for start, count, b in E.iter_buckets(blob.shape[0]):
        oks, total = run(E._pad_to(blob[start : start + count], b), *args)
        handles.append((count, oks))
        totals.append(total)
    return handles, totals


def _submit_indexed(mesh, table, public_keys, messages, signatures):
    """(handle, per-chunk device totals) of a sharded indexed dispatch."""
    if len(signatures) == 0:
        return E.VerifyDispatch([]), []
    idx = table.indices_for(public_keys)
    blob = E.pack_blob_indexed(idx, messages, signatures, num_keys=len(table))
    handles, totals = _dispatch_chunks(_cached_indexed_kernel(mesh), blob, table)
    patches = []
    if not (idx >= 0).all():
        stragglers = np.flatnonzero(idx < 0)
        patch, patch_totals = _submit_fused(
            mesh,
            [public_keys[i] for i in stragglers],
            [messages[i] for i in stragglers],
            [signatures[i] for i in stragglers],
        )
        patches.append((stragglers, patch))
        totals += patch_totals
    return E.VerifyDispatch(handles, patches), totals


def _submit_fused(mesh, public_keys, messages, signatures):
    """(handle, per-chunk device totals) of a sharded raw-bytes dispatch."""
    if len(signatures) == 0:
        return E.VerifyDispatch([]), []
    blob = E.pack_blob(public_keys, messages, signatures)
    handles, totals = _dispatch_chunks(_cached_fused_kernel(mesh), blob)
    return E.VerifyDispatch(handles), totals


def _total(totals) -> int:
    """The valid count, one fetch of each chunk's device total."""
    for t in totals:
        E._note_transfer("from_device", t.element_size())
    return int(sum(int(t) for t in totals))


def dispatch_sharded_indexed(
    mesh: Mesh,
    table: E.KeyTable,
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
) -> E.VerifyDispatch:
    """Non-blocking sharded committee-indexed dispatch: pack on the host,
    queue every bucket chunk's shards on their devices, return a handle that
    fetches on demand (one copy to the host per device).  Unknown-key items
    ride a ``dispatch_sharded_fused`` patch."""
    return _submit_indexed(mesh, table, public_keys, messages, signatures)[0]


def sharded_verify_batch_indexed(
    mesh: Mesh,
    table: E.KeyTable,
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
) -> Tuple[np.ndarray, int]:
    """Committee-indexed verification sharded over the mesh (26 words per
    signature on the wire).  Returns (per-item bool, valid count)."""
    handle, totals = _submit_indexed(mesh, table, public_keys, messages, signatures)
    return handle.result(), _total(totals)


def dispatch_sharded_fused(
    mesh: Mesh,
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
) -> E.VerifyDispatch:
    """Non-blocking sharded dispatch of the raw-bytes layout (32-byte
    messages; other lengths verify False, as in the JAX package)."""
    return _submit_fused(mesh, public_keys, messages, signatures)[0]


def sharded_verify_batch_fused(
    mesh: Mesh,
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
) -> Tuple[np.ndarray, int]:
    """Raw-bytes verification sharded over the mesh batch axis, in the fixed
    bucket shapes (each divisible by any power-of-two mesh up to 256
    devices).  Returns (per-item bool, valid count)."""
    handle, totals = _submit_fused(mesh, public_keys, messages, signatures)
    return handle.result(), _total(totals)
