"""The port's counterpart of ``tests/test_net_sync_sim.py``'s
``test_fifty_nodes_commit``: 50 authorities with uneven stakes and
stake-weighted leader election, whole ``NetworkSyncer``s over the port's
simulated network for 6 virtual seconds.  In a file of its own so that
``--dist loadfile`` gives it a worker of its own (it takes about as long as
the reference's, ~2.5-3 minutes on one CPU core)."""
from test_torch_net_sync import PORT, _assert_prefix_consistent, _committed, _sim


def test_fifty_nodes_commit(tmp_path):
    from mysticeti_tpu_torch.committee import STAKE_WEIGHTED, Authority, Committee

    n = 50
    signers = Committee.benchmark_signers(n)
    committee = Committee(
        [Authority(1 + (i % 3), s.public_key) for i, s in enumerate(signers)],
        leader_election=STAKE_WEIGHTED,
    )
    nodes = _sim(PORT, tmp_path, 29, n, 6.0, committee=committee)
    sequences = [_committed(node) for node in nodes]
    _assert_prefix_consistent(sequences)
    assert all(len(s) >= 12 for s in sequences), sorted(len(s) for s in sequences)[:5]
    lengths = sorted(len(s) for s in sequences)
    assert lengths[-1] - lengths[0] <= 8, (lengths[0], lengths[-1])
    # Stake-weighted election rotated leaders across the committee.
    leaders = {ref.authority for seq in sequences for ref in seq}
    assert len(leaders) >= 10, sorted(leaders)
