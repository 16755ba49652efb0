"""The port's write-ahead log held to ``tests/test_wal.py``.

The reference suite runs here with the port in place
(``torch_reference.suite_on_port``): round trip, replay, reopen, torn
tails, corrupt payloads, the syncer thread, the async writer and its
read-after-write.  Beyond it, the same seeded appends (single and
vectored, empty and large payloads, both writer modes, a reopen between
two openings of the log) must give the JAX package's positions, replay and file
bytes.
"""
import random

import pytest

from mysticeti_tpu import wal as JW
from mysticeti_tpu_torch import wal as PW
from torch_reference import suite_on_port

globals().update(suite_on_port("test_wal.py"))


def wal_openings(wal, path, seed, async_writes):
    rng = random.Random(seed)
    out = []
    for opening in range(2):
        w, r = wal.walf(path, async_writes=async_writes)
        for _ in range(40):
            tag = rng.randrange(8)
            parts = [bytes([rng.randrange(256)]) * rng.choice((0, 1, 7, 300, 5000))
                     for _ in range(rng.randrange(1, 4))]
            out.append(w.write(tag, parts[0]) if len(parts) == 1 else w.writev(tag, parts))
        w.sync()
        out.append(list(r.iter_until(w.position())))
        w.close()
        r.close()
        out.append(opening)
    with open(path, "rb") as f:
        return out, f.read()


@pytest.mark.parametrize("async_writes", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("seed", range(2))
def test_wal_bytes_as_the_jax_package(tmp_path, seed, async_writes):
    port = wal_openings(PW, str(tmp_path / "port.wal"), seed, async_writes)
    jax = wal_openings(JW, str(tmp_path / "jax.wal"), seed, async_writes)
    assert port == jax
    assert PW.HEADER_SIZE == JW.HEADER_SIZE and PW.POSITION_MAX == JW.POSITION_MAX
