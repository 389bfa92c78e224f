"""CPU rehearsals of the cells of the video driver (drivers/video.py) at
a tiny size: the driver end to end, the reference against the port's CPU
path, the control and the faults that the check has to catch."""

import time

import pytest

from vosbench.drivers import video
from vosbench.harness import common
from vosbench.tests.faults import FAULTS, planted
from vosbench.tests.tiny import args, tiny_cell

CELLS = common.cells('video')


def _run(cell, seed=2 ** 33 + 7, trace=0):
    return video.run(cell, args(seed, trace), {'platform': 'cpu'},
                     time.perf_counter(), dev='cpu')


@pytest.mark.parametrize('name', CELLS)
def test_driver_end_to_end_and_reference_agrees(name, tmp_tmpdir):
    """Sound runs: the port's CPU path in float32 and the reference give the
    same masks (consolidation included: 24 frames, a memory frame every 3)."""
    res, checks = _run(tiny_cell(name))
    assert res['correct'], checks
    assert checks['confident_mismatch']['value'] == 0.0
    assert res['info']['pixels_differing'] < 1e-3
    assert res['info']['consolidations'] >= 1
    assert res['attempted'] >= 1 and res['failed'] == 0
    # the card's time (device_ms_per_frame) is recorded only on the card
    assert set(res['metrics']) == {'setup_s'}


def test_the_control_fails(tmp_tmpdir):
    """The reference in float8 in the program's place reads above the
    limit (the same comparison as a run's)."""
    from vosbench.tests.readings import readings
    cell = tiny_cell('vos480-2obj')
    rows = readings(cell, [2 ** 33 + 11], control=1, dev='cpu')
    assert rows[0]['program'] == 0.0
    assert rows[0]['control'] > cell.traffic['check']['limit']


@pytest.mark.parametrize('fault', FAULTS)
@pytest.mark.parametrize('name', CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, tmp_tmpdir):
    """The faults a video cell can have (one card: no exchange between
    cards), planted in the program under the driver: correct is false."""
    with planted(fault):
        res, checks = _run(tiny_cell(name))
    assert not res['correct'], checks
    assert checks['confident_mismatch']['value'] > \
        checks['confident_mismatch']['limit']


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(card, tmp_tmpdir):
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, 'vosbench/run.py', '--workload',
                          'vos480-2obj', '--seed', str(2 ** 33 + 3),
                          '--seconds', '2', '--trace', '0'], cwd=root,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['correct'] and line['device']['kind'] == card


@pytest.mark.card
@pytest.mark.parametrize('fault', FAULTS)
@pytest.mark.parametrize('name', CELLS)
def test_a_broken_timed_path_is_not_correct_on_the_card(name, fault, card,
                                                         tmp_tmpdir):
    """The same faults at the cell's own size on the card (one whole video
    as the window)."""
    from vosbench.harness import common
    with planted(fault):
        res, checks = video.run(common.Cell(name), args(2 ** 33 + 9),
                                common.check_device(1), time.perf_counter())
    assert not res['correct'], checks
