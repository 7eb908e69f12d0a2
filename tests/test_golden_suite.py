"""Run the reference's full small regression suite through our driver.

The reference's run.sh diffs driver output against stored .output files
(/root/reference/tests/element_centered_preconitioners/run.sh).  Our pinned
contract is the iteration count, parsed from those same .output files.  The
AMG config runs against our direct coarse solver (same 1-iteration result at
this size, documented deviation).
"""

import json
import os
import re

import pytest

REF_DIR = "/root/reference/tests/element_centered_preconitioners/small"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF_DIR), reason="reference golden files not available")


def _cases():
    if not os.path.isdir(REF_DIR):
        return []
    names = sorted(
        f[:-5] for f in os.listdir(REF_DIR) if f.endswith(".json"))
    return names


def _expected_iterations(name: str) -> int:
    with open(os.path.join(REF_DIR, name + ".output")) as f:
        m = re.search(r"n iterations:\s+(\d+)", f.read())
    assert m, f"no iteration count in {name}.output"
    return int(m.group(1))


def _expected_evs(name: str) -> list[tuple[float, float]]:
    """All (min ev, max ev) pairs printed by the reference run, in order."""
    with open(os.path.join(REF_DIR, name + ".output")) as f:
        text = f.read()
    mins = [float(m) for m in re.findall(r"min ev:\s+([\d.e+-]+)", text)]
    maxs = [float(m) for m in re.findall(r"max ev:\s+([\d.e+-]+)", text)]
    return list(zip(mins, maxs))


@pytest.mark.parametrize("name", _cases())
def test_golden_config(name):
    from dealii_asm.models.poisson import run_config

    with open(os.path.join(REF_DIR, name + ".json")) as f:
        params = json.load(f)
    lines: list[str] = []
    result = run_config(params, log=lambda *a: lines.append(" ".join(map(str, a))))
    assert result["converged"]
    assert result["n_dofs"] == 625
    assert result["it"] == _expected_iterations(name)

    # eigenvalue-estimate contract vs the reference's pinned values: our
    # estimates use deal.II's i%11 start vector under a different (lexico-
    # graphic) DoF numbering, so they deviate by a few percent — assert the
    # deviation stays small (the iteration count above is the exact contract)
    ref_evs = _expected_evs(name)
    text = "\n".join(lines)
    got_mins = [float(m) for m in re.findall(r"min ev:\s+([\d.e+-]+)", text)]
    got_maxs = [float(m) for m in re.findall(r"max ev:\s+([\d.e+-]+)", text)]
    if ref_evs:
        # a driver regression that changes how many 'min ev' lines are logged
        # must FAIL the contract, not silently disable it
        assert len(got_mins) == len(ref_evs), (name, got_mins, ref_evs)
        assert len(got_maxs) == len(ref_evs), (name, got_maxs, ref_evs)
        for (rmin, rmax), gmin, gmax in zip(ref_evs, got_mins, got_maxs):
            assert abs(gmin / rmin - 1) < 0.08, (name, rmin, gmin)
            assert abs(gmax / rmax - 1) < 0.08, (name, rmax, gmax)
