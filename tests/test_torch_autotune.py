"""I/O configuration auto-tuner (paper §5.3 future work)."""
from repro_torch.storage.autotune import autotune_io, default_space


def test_space_is_reasonable():
    space = default_space(8)
    assert len(space) >= 8
    assert any(c.transport == "posix" for c in space)
    assert any(c.io_mode == "separated" for c in space)


def test_autotune_prefers_colocated_small_groups():
    """The paper's finding: co-located + small groups wins; the tuner
    should rediscover it from the virtual-time model."""
    res = autotune_io(num_writers=8, workload_chunks=32)
    assert res.best.io_mode == "colocated"
    assert res.best.io_group_size <= 4
    assert res.virtual_s > 0
    # the winner must come from the final (full-workload) round
    finals = res.trials[-4:]
    assert res.virtual_s == min(t for _, t in finals)


def test_autotune_equals_the_reference():
    """The same search in both packages: the same trials, virtual times and
    winner (the DISK cost model runs in virtual time)."""
    import dataclasses

    from repro.storage.autotune import autotune_io as j_autotune_io
    from repro.storage.autotune import default_space as j_default_space

    assert [dataclasses.astuple(c) for c in default_space(8)] == [
        dataclasses.astuple(c) for c in j_default_space(8)]
    got = autotune_io(num_writers=8, workload_chunks=32)
    want = j_autotune_io(num_writers=8, workload_chunks=32)
    assert dataclasses.astuple(got.best) == dataclasses.astuple(want.best)
    assert got.virtual_s == want.virtual_s
    assert [(dataclasses.astuple(c), t) for c, t in got.trials] == [
        (dataclasses.astuple(c), t) for c, t in want.trials]
