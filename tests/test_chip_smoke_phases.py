"""The single-robot chip_smoke phases at toy size on the CPU: the same
entry points, solver parameters and f64-oracle comparison as on the card
(the fleet phases are in tests/test_chip_smoke_fleet.py)."""

import pytest

import chip_smoke

TOY = {
    "flagship": lambda: chip_smoke.phase_standard("flagship", 16, n_check=4),
    "solo12": lambda: chip_smoke.phase_standard("solo12", 16, n_check=4),
    "talos": lambda: chip_smoke.phase_standard("talos", 8, n_check=2),
}


@pytest.mark.parametrize("name", list(TOY))
def test_phase_toy(name):
    rec = TOY[name]()
    assert rec["pass"], rec
    assert rec["peak_bytes_in_use"] is None  # CPU: no device memory stats
    assert name in chip_smoke.json.dumps(rec)  # printable as its phase line
