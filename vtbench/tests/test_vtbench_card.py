"""The real command on a card (skips without one): a short run of a
one-card cell ends with a correct result line on the card.

    python -m pytest vtbench/tests/test_vtbench_card.py -q
"""

import json
import subprocess
import sys

import pytest

from vtbench.tests import tiny


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    r = subprocess.run(
        [sys.executable, "vtbench/run.py", "--workload", "edit_8192",
         "--seed", "4000000007", "--seconds", "3", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["count"] == 1
