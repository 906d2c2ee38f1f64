"""The fleet chip_smoke phases (mixed robots, multistart seeds, tracking
ticks) at toy size on the CPU: the same entry points, solver parameters and
f64-oracle comparison as on the card."""

import pytest

import chip_smoke

TOY = {
    "mixed": lambda: chip_smoke.phase_mixed(16, n_check=4),
    "multistart": lambda: chip_smoke.phase_multistart(16, batches=2,
                                                      n_check=4),
    "tracking": lambda: chip_smoke.phase_tracking((8, 16), T=4, n_check=4),
}


@pytest.mark.parametrize("name", list(TOY))
def test_phase_toy(name):
    rec = TOY[name]()
    assert rec["pass"], rec
    assert rec["peak_bytes_in_use"] is None  # CPU: no device memory stats
    assert name in chip_smoke.json.dumps(rec)  # printable as its phase line
