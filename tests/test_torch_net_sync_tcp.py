"""Four port ``NetworkSyncer``s over loopback ``TcpNetwork`` on a real
event loop, each node's collector the ``cpu`` kind, one forged copy before
one block-carrying send in 50: every node commits a leader within 30 s, the
committed sequences agree, every forged copy that reached a verifier is
rejected and counted, and every verdict came from the verifier.  Lenient
by design (one commit each, a wide limit): it shares the host with other
test workers."""
import asyncio
import time

import chip_smoke


def _until_each_commits(metrics, limit_s=30.0):
    """Wait until every node has committed a leader and a forged copy has
    been rejected, or for ``limit_s``."""
    def forged_rejected():
        return sum(sample.value
                   for family in metrics.mysticeti_invalid_blocks_total.collect()
                   for sample in family.samples
                   if sample.name.endswith("_total") and sample.labels["reason"] == "signature")

    async def run(nodes):
        t0 = time.monotonic()
        while time.monotonic() - t0 < limit_s:
            if forged_rejected() and all(node.syncer.commit_observer.committed_leaders
                                         for node in nodes):
                return
            await asyncio.sleep(0.1)

    return run


def test_four_tcp_nodes_commit_and_agree(tmp_path):
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.validator import _make_verifier

    metrics = Metrics()
    result = asyncio.run(chip_smoke.netsync_tcp(
        4, str(tmp_path), _until_each_commits(metrics),
        lambda c: _make_verifier("cpu", c, metrics=metrics), metrics))
    reading = chip_smoke.netsync_tcp_checks(result, min_commits=1)
    assert reading["blocks_received"] >= reading["fresh"] > 0
    assert result["core_lock"]["enqueued"] > 0
    chip_smoke.card_checks(result)
    # The real loop takes the collector's executor hop: device time > 0.
    stages = chip_smoke.stage_seconds(metrics)
    assert stages["device"]["count"] > 0 and stages["device"]["sum_s"] > 0
