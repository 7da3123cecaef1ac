"""The readers of the program's own spans and counters (host waits and
readbacks, replay copies, the round left outside every phase) on a
made-up context: each value from its inputs, and nothing (no error) from
a program that has not got the span or counter."""

import pytest

from vo_bench import cells

CTX = dict(
    lanes=8, rounds=4, frames=32, round_s=[0.2, 0.3, 0.25, 0.25],
    stage_s={"wait.stage_end": 0.16, "wait.readback": 0.064,
             "track": 1.0, "round.pyramid": 1.6, "round.kf_opt": 6.0},
    loops={"fetches": 96, "copies": 640, "reads": 0, "captures": 1})

# the parent's context: the old spans and counters only
OLD = dict(CTX, stage_s={"track": 1.0, "kf.opt": 2.0},
           loops={"reads": 0, "captures": 1})

WANT = {
    "host.stage_wait_ms_per_frame": 1000.0 * 0.16 / 32,
    "host.readback_ms_per_frame": 1000.0 * 0.064 / 32,
    "host.readbacks_per_frame": 96 / 32,
    "loop.replay_copies_per_frame": 640 / 32,
    # mean round 250 ms, the phases (1.6 + 6.0) s over 8 lanes x 4 rounds
    "fleet.unspanned_ms_per_round": 250.0 - 1000.0 * 7.6 / 32,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_value(name):
    assert cells.reader(name).read(CTX) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_from_an_older_program(name):
    assert cells.reader(name).read(OLD) is None
