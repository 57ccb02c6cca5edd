"""The host-side helpers of ``chip_smoke.py`` that read a profile, on
synthetic device events, and the script's refusal to run without a card."""

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

import chip_smoke


def _event(name, start, end, stream=7):
    """A device event as chip_smoke reads it from torch.profiler: times in
    microseconds."""
    return SimpleNamespace(name=name, device_resource_id=stream,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("spans,busy", [
    ([(0, 10), (20, 30)], 20),              # apart
    ([(0, 10), (10, 30)], 30),              # touching
    ([(0, 10), (5, 30)], 30),               # partly over each other
    ([(0, 100), (10, 20), (30, 40)], 100),  # inside a longer one
    ([(30, 40), (0, 10), (5, 35)], 40),     # out of order, chained
])
def test_busy_ms_is_the_union_of_spans(spans, busy):
    events = [_event(f"k{i}", s, e) for i, (s, e) in enumerate(spans)]
    assert chip_smoke.busy_ms(events) == pytest.approx(busy / 1e3)


def test_overlaps_name_the_overlapping_pairs():
    """The overlapped time, by (earlier, later) kernel, adds up to the sum
    of durations less the busy time where no three events meet."""
    events = [_event("a", 0, 10), _event("b", 8, 20, stream=9),
              _event("a", 30, 40), _event("b", 35, 50, stream=9),
              _event("c", 60, 70)]
    streams, pairs = chip_smoke.overlaps(events)
    assert streams == [7, 9]
    assert pairs == [(("a", "b"), [pytest.approx(7e-3), 2])]
    device_ms = sum(e.time_range.end - e.time_range.start
                    for e in events) / 1e3
    assert device_ms - chip_smoke.busy_ms(events) == pytest.approx(7e-3)


def test_refuses_without_a_card(tmp_path):
    """Alone in a directory and without CUDA, the script exits non-zero
    and prints no result line."""
    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
    assert "FAILED" in run.stderr
